"""K3: the port's texture sample in every mode against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import texture_sample as jax_texture
from raytracer_tpu_torch.config import MipmapFilter, TextureSampleMode
from raytracer_tpu_torch.ops import texture_sample
from torch_parity import fields, jax_scene, texture_lanes, torch_config

TEX_FIELDS = ("tex_data", "tex_width", "tex_height", "tex_levels", "tex_offsets", "tex_quad")


@pytest.fixture(scope="module")
def atlas():
    scene, cfg = jax_scene("config3")
    f = fields(scene)
    return tuple(f[k] for k in TEX_FIELDS), cfg


def test_texture_matches_jax(atlas):
    tex, cfg = atlas
    lanes = texture_lanes(tex)
    jtex = tuple(jnp.asarray(a) for a in tex)
    ref = np.asarray(jax_texture.sample(
        jtex, *(jnp.asarray(a) for a in lanes), cfg, data4=jax_texture.expand_quads(jtex)))
    ttex = tuple(torch.from_numpy(a) for a in tex)
    out = texture_sample.sample(
        ttex, *(torch.from_numpy(a) for a in lanes), torch_config(cfg),
        data4=texture_sample.expand_quads(ttex)).numpy()
    # log2 differs by an ulp between XLA and torch, which flips round-half
    # level choices: max abs <= 1e-5 on >= 99.9% of lanes
    err = np.abs(out - ref).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    # the level-0 (level < 0), mip and top cases are all exercised
    lf = tex[3][lanes[0]]
    assert (lf > 1).any() and (lf == 1).any()


MODES = {
    "nearest": dict(texture_sample_mode=TextureSampleMode.NEAREST),
    "bilinear": dict(texture_sample_mode=TextureSampleMode.BILINEAR),
    "trilinear": dict(mipmap_filter=MipmapFilter.TRILINEAR),
    "ewa": dict(mipmap_filter=MipmapFilter.EWA),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_texture_mode_matches_jax(atlas, mode):
    """NEAREST, BILINEAR, TRILINEAR and EWA (the full 16 x 16 window) against eager
    jax_texture.sample on 4,096 seeded lanes: max abs <= 1e-5 on >= 99.9% of
    lanes (measured: every lane, at most 2.4e-7), and every branch of the mode
    is taken."""
    tex, cfg = atlas
    cfg = cfg.replace(**MODES[mode])
    assert cfg.ewa_max_span == 16
    lanes = texture_lanes(tex, n=4096)
    jtex = tuple(jnp.asarray(a) for a in tex)
    ref = np.asarray(jax_texture.sample(jtex, *(jnp.asarray(a) for a in lanes), cfg))
    ttex = tuple(torch.from_numpy(a) for a in tex)
    tlanes = tuple(torch.from_numpy(a) for a in lanes)
    tcfg = torch_config(cfg)
    out = texture_sample.sample(ttex, *tlanes, tcfg).numpy()
    err = np.abs(out - ref).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    # on the mipmapped lanes: the level-0 tap (level < 0, or EWA's degenerate
    # ellipses), the top texel and the filter itself (EWA's window) all occur
    mip = torch.from_numpy(tex[3][lanes[0]] > 1)
    work = texture_sample.lane_work(ttex, tuple(x[mip] for x in tlanes), tcfg)
    if mode in ("trilinear", "ewa"):
        assert min(work["bilinear"], work["top"], work["filter"]) > 0, work
    else:
        assert work["filter"] == int(mip.sum())
    if mode == "ewa":
        assert 0 < work["weighted"] < work["taps"], work


TAP_MODES = {"aniso": {}, **MODES}


@pytest.mark.parametrize("mode", list(TAP_MODES))
def test_tap_rows_name_the_rows_the_gradient_reaches(atlas, mode):
    """tap_rows_plain (K4's scatter, slot by slot, as the kernel's warp form
    take it) names exactly the quad rows whose data4 gradient autograd of
    sample_plain makes nonzero, and the texel rows whose data gradient it makes
    nonzero (EWA: its window's texels of weight 0, at the gaussian table's last
    entry, are named and add 0); a lane with a zero cotangent names nothing; and
    the per-lane values summed in float64 are autograd's atlas gradients within
    1e-6 l2-relative."""
    tex, cfg = atlas
    cfg = torch_config(cfg.replace(**TAP_MODES[mode]))
    lanes = tuple(torch.from_numpy(a) for a in texture_lanes(tex, n=4096, seed=5))
    ttex = tuple(torch.from_numpy(a) for a in tex)
    rng = np.random.default_rng(9)
    cot = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
    cot[rng.random(4096) < 0.3] = 0.0
    data = ttex[0].clone().requires_grad_()
    data4 = texture_sample.expand_quads(ttex).detach().requires_grad_()
    out = texture_sample.sample_plain((data, *ttex[1:]), *lanes, cfg, data4)
    g_data, g_data4 = torch.autograd.grad(out, [data, data4], cot, allow_unused=True)
    g_data = torch.zeros_like(data) if g_data is None else g_data
    g_data4 = torch.zeros_like(data4) if g_data4 is None else g_data4
    quad, texel = texture_sample.tap_rows_plain(ttex, lanes, cfg, cot)
    assert quad.shape[1] == texel.shape[1] == 4096
    zero = ~(cot != 0).any(dim=1)
    assert bool((quad[:, zero] == -1).all()) and bool((texel[:, zero] == -1).all())
    named4 = torch.zeros(data4.shape[0], dtype=torch.bool)
    named4[quad[quad >= 0]] = True
    assert torch.equal(named4, (g_data4 != 0).any(dim=1))
    named = torch.zeros(data.shape[0], dtype=torch.bool)
    named[texel[texel >= 0]] = True
    nonzero = (g_data != 0).any(dim=1)
    if mode == "ewa":
        assert bool(nonzero[~named].logical_not().all()) and int(nonzero.sum()) > 100
    else:
        assert torch.equal(named, nonzero)
    expect = {"nearest": (0, 1), "bilinear": (1, 0), "trilinear": (2, 1), "aniso": (8, 1),
              "ewa": (1, 1 + 16 * 16)}[mode]
    assert (quad.shape[0], texel.shape[0]) == expect
    sums = texture_sample.scatter_sums_plain(
        texture_sample.tap_slots_plain(ttex, lanes, cfg, cot), data.shape[0])
    for got, want in zip(sums, (g_data, g_data4)):
        scale = float(want.double().norm())
        assert float((got - want.double()).norm()) <= 1e-6 * scale if scale else not got.any()


def test_warp_runs_counts_runs_within_warps():
    """K4's run statistics on hand-made keys: a run never crosses a warp's end,
    -1 lanes add nothing, and the distinct rows a warp names."""
    from raytracer_tpu_torch.microbench import scatter

    rows = torch.tensor([5] * 3 + [-1] * 2 + [7] * 27 + [7] * 4 + [5, 7, 5] + [-1] * 25,
                        dtype=torch.int64)
    got = scatter.warp_runs(rows)
    # warp 0: runs of 3 (row 5) and 27 (row 7); warp 1: 4, 1, 1, 1
    assert (got["lanes"], got["runs"]) == (37, 6)
    assert got["lanes_a_run_mean"] == pytest.approx(37 / 6)
    assert got["lanes_a_run_p50"] == pytest.approx(2.0)
    assert got["distinct_rows_a_warp"] == pytest.approx(2.0)
    assert scatter.warp_runs(torch.full((40,), -1, dtype=torch.int64))["runs"] == 0


def test_k4_patterns_and_run_counts(atlas):
    """microbench.scatter's K4 patterns and counts on seeded lanes: one_row puts
    every lane of a warp on one row a slot, the permutation keeps the lanes'
    rows, zero90 zeroes ~90% of the cotangents; K4's atomics are 3 a run."""
    from raytracer_tpu_torch.microbench import scatter

    tex, cfg = atlas
    tcfg = torch_config(cfg)
    ttex = tuple(torch.from_numpy(a) for a in tex)
    lanes = tuple(torch.from_numpy(a) for a in texture_lanes(tex, n=2048, seed=8))
    cot = torch.from_numpy(np.random.default_rng(4).normal(size=(2048, 3)).astype(np.float32))
    runs = scatter.k4_runs(ttex, lanes, tcfg, cot)
    assert runs["atomics"] == 3 * sum(x["runs"] for x in runs["slots"])
    assert [x["slot"] for x in runs["slots"]] == [f"quad {k}" for k in range(8)] + ["top texel"]
    pats = scatter.k4_patterns(lanes, cot, ttex, tcfg)
    assert list(pats) == list(scatter.K4_PATTERNS)
    one = scatter.k4_runs(ttex, pats["one_row"][0], tcfg, pats["one_row"][1])
    assert [x["runs"] for x in one["slots"] if x["runs"]] == [2048 // 32]
    perm = scatter.k4_runs(ttex, pats["permutation"][0], tcfg, pats["permutation"][1])
    assert [x["lanes"] for x in perm["slots"]] == [x["lanes"] for x in runs["slots"]]
    zero = scatter.k4_runs(ttex, pats["zero90"][0], tcfg, pats["zero90"][1])
    assert 0.85 <= zero["zero_cotangent_share"] <= 0.95
    assert zero["atomics"] < 0.2 * runs["atomics"]


def test_ewa_weight_table_matches_jax():
    """EWA's weights as K3 reads them: the 128-entry table
    (``ewa_weight_table``, built as ``csrc/texture.cu`` builds it) at every
    bucket against JAX's ``_ewa_weight``, and through the kernel's lookup
    (``ewa_weight_lookup``) on 200,000 seeded r2 in [-0.01, 1) and every bucket
    edge, negative indices among them: the same bits as the port's own
    ``_ewa_weight``, and within 6e-8 of JAX's (one float32 ulp in [0.5, 1):
    XLA's exp and torch's differ by one on 13 of the 128 buckets)."""
    table = texture_sample.ewa_weight_table()
    assert table.shape == (128,) and table.dtype == torch.float32
    buckets = np.arange(128, dtype=np.float32) / 128  # r2 at the centre of bucket i
    ref = np.asarray(jax_texture._ewa_weight(jnp.asarray(buckets)))
    assert np.abs(table.numpy() - ref).max() <= 6e-8
    rng = np.random.default_rng(0)
    edges = (np.arange(129, dtype=np.float32) - 0.5) / 128
    r2 = np.concatenate([rng.uniform(-0.01, 1.0, 200_000), edges, [-0.5 / 128, -0.004]])
    r2 = r2[r2 < 1.0].astype(np.float32)
    assert (np.floor(r2 * 128 + 0.5) < 0).sum() > 1000  # the lookup's other path
    got = texture_sample.ewa_weight_lookup(table, torch.from_numpy(r2))
    assert torch.equal(got, texture_sample._ewa_weight(torch.from_numpy(r2)))
    ref = np.asarray(jax_texture._ewa_weight(jnp.asarray(r2)))
    assert np.abs(got.numpy() - ref).max() <= 6e-8


def test_sample_forward_refuses_before_launching():
    """K3's wrapper checks data4's 16-byte alignment before it builds or
    launches anything (here, on the CPU, there is nothing to launch: a check
    that passed would try to build the kernels)."""
    rng = np.random.default_rng(1)
    tex = (torch.from_numpy(rng.random((5, 3), dtype=np.float32)),
           *(torch.ones(1, dtype=torch.int32) for _ in range(3)),
           torch.zeros((1, 16), dtype=torch.int32), torch.zeros((5, 4), dtype=torch.int32))
    lanes = (torch.zeros(4, dtype=torch.int32), *(torch.full((4,), 0.5) for _ in range(6)))
    data4 = texture_sample.expand_quads(tex)
    off = torch.empty(data4.numel() + 1)[1:].view(data4.shape)
    off.copy_(data4)
    filt = texture_sample.Filter("bilinear", 8.0, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        texture_sample.sample_forward(tex, lanes, filt, off)
