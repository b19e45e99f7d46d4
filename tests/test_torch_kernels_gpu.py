"""Each CUDA kernel of raytracer_tpu_torch against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one.  On a machine with a card, from
the repo root (``--noconftest``: tests/conftest.py imports JAX, which that machine
may lack and these tests do not use):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q
"""

import re
import types

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import (
    MipmapFilter, RenderConfig, TextureSampleMode, TraversalStrategy,
)
from raytracer_tpu_torch.ops import (
    compaction, framebuffer, fxaa, gather, hits, intersect, sky_sample, texture_sample, traversal,
    traversal_wide,
)
from raytracer_tpu_torch.ops.intersect import Hits, Rays
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes, textures
from raytracer_tpu_torch.scene.device import ScenePacker
from raytracer_tpu_torch.utils import trace
from test_torch_wide_stack import SIZE as DEEP_SIZE
from test_torch_wide_stack import deep_scene
from torch_quant_rays import made_up_rays

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_sky_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    sky = torch.from_numpy(rng.random((64 * 64, 3), dtype=np.float32)).to(cuda)
    d = torch.from_numpy(_unit(rng, 65536)).to(cuda)
    k = sky_sample.sample_sky(sky, d)
    p = sky_sample.sample_sky_plain(sky, d)
    # acosf may differ from torch's acos by an ulp: <= 1e-3 of lanes may pick
    # the neighbouring texel
    assert float((k != p).any(dim=1).float().mean()) <= 1e-3


TILE = compaction.TILE


@pytest.mark.parametrize("view", ["aligned", "flags[1:]"])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 1000, 1024, 1025, TILE - 1, TILE,
                               TILE + 1, 300_000, 4_147_200])
def test_compact_kernel_matches_plain(cuda, n, density, view):
    """K6 exact against compact_plain around its 16-byte loads and its tiles, on
    an aligned array and on a view one byte in; compact_launch leaves the same
    count on the device that compact reads back."""
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.random(n + 1) < density).to(cuda)
    flags = base[:n] if view == "aligned" else base[1:]
    assert flags.data_ptr() % 16 == (0 if view == "aligned" else 1)
    before = trace.counters["launch.k6"]
    k_idx, k_n = compaction.compact(flags)
    out, count = compaction.compact_launch(flags)
    assert trace.counters["launch.k6"] == before + 2
    p_idx, p_n = compaction.compact_plain(flags)
    assert k_n == p_n == int(count.item())
    assert torch.equal(k_idx, p_idx)
    assert out.shape == (n,) and count.device == flags.device
    assert torch.equal(out[:p_n], p_idx)


def _random_texture_inputs(cuda, seed=1, n=50_000):
    rng = np.random.default_rng(seed)
    texs = [textures.from_array(rng.random((h, w, 3), dtype=np.float32), srgb=False)
            for h, w in ((64, 64), (16, 32), (8, 8))]
    atlas = textures.build_atlas(texs)
    tex = tuple(torch.from_numpy(np.asarray(a)).to(cuda) for a in (
        atlas.data, atlas.width, atlas.height, atlas.mip_levels, atlas.mip_offsets,
        atlas.quad_idx))
    tex_id = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(cuda)
    st = torch.from_numpy(rng.uniform(-2, 3, (2, n)).astype(np.float32)).to(cuda)
    # derivatives from 1e-5 to 10 texture widths: every level, level < 0 and top
    der = torch.from_numpy(
        (10.0 ** rng.uniform(-5, 1, (4, n)) * rng.choice([-1, 1], (4, n)))
        .astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda)
    lanes = (tex_id, st[0].contiguous(), st[1].contiguous(), *(x.contiguous() for x in der))
    return tex, lanes, cot


def _forward(form, tex, lanes, cfg, data4):
    """K3 in ``form``: the renderer's form through ``sample``, the first through
    ``sample_forward``; each launches once, on its own count."""
    mode = texture_sample.filter_of(cfg).mode
    key = f"launch.k3.{mode}" + ("" if form == "vector" else ".first")
    before = trace.counters[key]
    if form == "vector":
        k = texture_sample.sample(tex, *lanes, cfg, data4=data4)
    else:
        k = texture_sample.sample_forward(tex, lanes, texture_sample.filter_of(cfg), data4,
                                          form)
    assert trace.counters[key] == before + 1
    return k


@pytest.mark.parametrize("form", texture_sample.FWD_FORMS)
def test_texture_kernel_matches_plain(cuda, form):
    tex, lanes, _ = _random_texture_inputs(cuda)
    cfg = RenderConfig()
    data4 = texture_sample.expand_quads(tex)
    k = _forward(form, tex, lanes, cfg, data4)
    p = texture_sample.sample_plain(tex, *lanes, cfg, data4)
    err = (k - p).abs().amax(dim=1)
    assert float((err <= 1e-5).float().mean()) >= 0.999


def _texture_grads(sample, tex, lanes, cot, cfg):
    """Gradients of data, data4 and the six float lane inputs through ``sample``
    (zeros for an input the mode does not differentiate)."""
    data = tex[0].detach().clone().requires_grad_()
    data4 = texture_sample.expand_quads(tex).detach().requires_grad_()
    floats = [x.detach().clone().requires_grad_() for x in lanes[1:]]
    out = sample((data, *tex[1:]), lanes[0], *floats, cfg, data4)
    inputs = [data, data4, *floats]
    grads = torch.autograd.grad(out, inputs, cot, allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if g is None else g
                          for x, g in zip(inputs, grads)]


def test_texture_backward_kernel_matches_plain(cuda):
    """K4 against autograd of sample_plain, on lanes whose forward agrees (a lane
    that takes another mip level in K3 sends its gradient elsewhere)."""
    tex, lanes, cot = _random_texture_inputs(cuda)
    cfg = RenderConfig()
    _check_texture_backward(tex, lanes, cot, cfg)


def _check_texture_backward(tex, lanes, cot, cfg):
    """K4 in cfg's mode against autograd of sample_plain: the atlas gradients
    within 1e-5 l2-relative, each lane gradient within 1e-5 of its max on >= 99.9%
    of lanes; a gradient the mode does not produce is 0 in both."""
    mode = texture_sample.filter_of(cfg).mode
    before = trace.counters[f"launch.k4.{mode}"]
    k_out, _ = _texture_grads(texture_sample.sample, tex, lanes, cot, cfg)
    p_out, _ = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    same = (k_out - p_out).abs().amax(dim=1) <= 1e-5
    assert float(same.float().mean()) >= 0.999
    cot = cot * same[:, None]
    _, kg = _texture_grads(texture_sample.sample, tex, lanes, cot, cfg)
    _, pg = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    assert trace.counters[f"launch.k4.{mode}"] == before + 2
    for name, a, b in zip(("data", "data4"), kg[:2], pg[:2]):
        nb = float(b.norm())
        assert float((a - b).norm()) <= 1e-5 * nb if nb else not a.any(), name
    for a, b in zip(kg[2:], pg[2:]):
        if not b.any():
            assert not a.any()
            continue
        err = (a - b).abs() / b.abs().max()
        assert float((err <= 1e-5).float().mean()) >= 0.999


NEW_MODES = {
    "nearest": dict(texture_sample_mode=TextureSampleMode.NEAREST),
    "bilinear": dict(texture_sample_mode=TextureSampleMode.BILINEAR),
    "trilinear": dict(mipmap_filter=MipmapFilter.TRILINEAR),
    "ewa": dict(mipmap_filter=MipmapFilter.EWA),
}


def _mode_inputs(cuda, mode):
    """_random_texture_inputs with exact ties |dt_dy| == |ds_dx| on a quarter of
    the lanes (TRILINEAR's max splits there) and degenerate footprints (ds_dy =
    dt_dy = 0: EWA's level-0 fallback) on another quarter."""
    tex, lanes, cot = _random_texture_inputs(cuda, seed=5)
    tex_id, s, t, sx, sy, tx, ty = lanes
    k = torch.arange(s.shape[0], device=cuda) % 4
    ty = torch.where(k == 1, -sx, ty)
    sy = torch.where(k == 2, 0.0, sy)
    ty = torch.where(k == 2, 0.0, ty)
    cfg = RenderConfig(**NEW_MODES[mode])
    return tex, (tex_id, s, t, sx, sy.contiguous(), tx, ty.contiguous()), cot, cfg


@pytest.mark.parametrize("form", texture_sample.FWD_FORMS)
@pytest.mark.parametrize("mode", list(NEW_MODES))
def test_texture_mode_kernel_matches_plain(cuda, mode, form):
    """K3 in NEAREST, BILINEAR, TRILINEAR and EWA (16 x 16 window), in both
    forms, against sample_plain: max abs <= 1e-5 on >= 99.9% of lanes, one
    launch, and under TRILINEAR and EWA every branch (level-0 tap, top texel,
    filter) taken."""
    tex, lanes, _, cfg = _mode_inputs(cuda, mode)
    data4 = None if mode == "nearest" else texture_sample.expand_quads(tex)
    k = _forward(form, tex, lanes, cfg, data4)
    p = texture_sample.sample_plain(tex, *lanes, cfg, data4)
    err = (k - p).abs().amax(dim=1)
    assert float((err <= 1e-5).float().mean()) >= 0.999
    if mode in ("trilinear", "ewa"):
        mip = tex[3][lanes[0].long()] > 1
        work = texture_sample.lane_work(tex, tuple(x[mip] for x in lanes), cfg)
        assert min(work["bilinear"], work["top"], work["filter"]) > 0, work


@pytest.mark.parametrize("mode", list(NEW_MODES))
def test_texture_mode_backward_kernel_matches_plain(cuda, mode):
    tex, lanes, cot, cfg = _mode_inputs(cuda, mode)
    _check_texture_backward(tex, lanes, cot, cfg)


ALL_MODES = {"aniso": {}, **NEW_MODES}


def _bits(x):
    return x.contiguous().view(torch.int32)


def _odd_texture_inputs(cuda, n=40_000, seed=11):
    """Textures of 1x1, 3x5, 7x13 (one level each: not powers of 2), 2x64 and
    64x64; lanes with s and t on texel edges and centres of every texture
    around [0, 1] (taps that wrap across every edge, and s in [-3, 4] beyond);
    derivatives at a mip level's rounding boundary (log2 within a few ulps of
    k + 1/2, under both the trilinear and the anisotropic level) and up to 40
    texture widths (windows cut at the span)."""
    rng = np.random.default_rng(seed)
    texs = [textures.from_array(rng.random((h, w, 3), dtype=np.float32), srgb=False)
            for h, w in ((1, 1), (5, 3), (13, 7), (64, 2), (64, 64))]
    atlas = textures.build_atlas(texs)
    tex = tuple(torch.from_numpy(np.asarray(a)).to(cuda) for a in (
        atlas.data, atlas.width, atlas.height, atlas.mip_levels, atlas.mip_offsets,
        atlas.quad_idx))
    k = atlas.width.shape[0]
    tex_id = rng.integers(0, k, n).astype(np.int32)
    size = atlas.width[tex_id].astype(np.float32), atlas.height[tex_id].astype(np.float32)
    st = []
    for extent in size:
        edge = rng.integers(-2, 3, n) + rng.integers(0, 3, n) * 0.5  # edges and centres
        x = np.where(rng.random(n) < 0.5, edge / extent, rng.uniform(0, 1, n) + edge.round())
        far = rng.random(n) < 0.1
        st.append(np.where(far, rng.uniform(-3, 4, n), x).astype(np.float32))
    mag = 2.0 ** (rng.integers(-9, 2, n) + 0.5)
    mag = mag * (1 + rng.integers(-3, 4, n) * np.finfo(np.float32).eps)
    mag = np.where(rng.random(n) < 0.15, 10.0 ** rng.uniform(-1, 1.6, n), mag)
    ratio = np.where(rng.random(n) < 0.5, 1.0, rng.integers(1, 9, n))
    der = np.stack([mag, mag / ratio * rng.uniform(0.5, 1, n), mag / ratio * 0.25,
                    mag * rng.uniform(0, 0.5, n)]) * rng.choice([-1.0, 1.0], (4, n))
    lanes = (torch.from_numpy(tex_id).to(cuda),
             *(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda)
               for x in (*st, *der)))
    return tex, lanes


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("mode,span", [(m, 16) for m in ALL_MODES] + [("ewa", 3)])
def test_texture_forms_bit_identical(cuda, mode, span, case):
    """K3's vector form against its first form, every mode: the same bits on
    every lane (EWA keeps the first form's dj-major order, and its table holds
    the first form's weights); both within the texture tolerance of
    sample_plain.  Seeded lanes over three textures, and made-up lanes on
    textures of 1x1 and of widths that are not powers of 2, on texel edges,
    wrapping across every edge, at mip-level rounding boundaries, and EWA
    windows cut at ewa_max_span (16, and 3)."""
    if case == "random":
        tex, lanes, _ = _random_texture_inputs(cuda, seed=21)
    else:
        tex, lanes = _odd_texture_inputs(cuda)
    cfg = RenderConfig(**ALL_MODES[mode], ewa_max_span=span)
    data4 = None if mode == "nearest" else texture_sample.expand_quads(tex)
    vec = _forward("vector", tex, lanes, cfg, data4)
    first = _forward("first", tex, lanes, cfg, data4)
    assert torch.equal(_bits(vec), _bits(first))
    plain = texture_sample.sample_plain(tex, *lanes, cfg, data4)
    err = (vec - plain).abs().amax(dim=1)
    assert float((err <= 1e-5).float().mean()) >= 0.999
    if mode not in ("nearest", "bilinear"):
        work = texture_sample.lane_work(tex, lanes, cfg)
        assert work["filter"] > 0 and work["top"] > 0 and work["bilinear"] > 0, work


def test_texture_vector_form_refuses_a_misaligned_quad_atlas(cuda):
    """The vector form reads data4's rows as 16-byte vectors: a view 4 bytes
    off alignment raises, and nothing is launched; the first form takes it."""
    tex, lanes, _ = _random_texture_inputs(cuda, n=1000)
    data4 = texture_sample.expand_quads(tex)
    flat = torch.empty(data4.numel() + 1, device=cuda)
    off = flat[1:].view(data4.shape)
    off.copy_(data4)
    assert off.data_ptr() % 16 == 4
    filt = texture_sample.filter_of(RenderConfig())
    before = dict(trace.counters)
    with pytest.raises(ValueError, match="16-byte aligned"):
        texture_sample.sample_forward(tex, lanes, filt, off)
    assert trace.counters == before
    first = texture_sample.sample_forward(tex, lanes, filt, off, "first")
    assert torch.equal(_bits(first), _bits(texture_sample.sample_forward(tex, lanes, filt,
                                                                          data4)))


def _pattern_inputs(cuda, mode, pattern, n):
    """K4's scatter patterns: every lane a copy of one lane (one row a slot),
    a permutation of the 64 x 64 texture's texels at level 0 (no two lanes of a
    warp on one row), 90% of the cotangents all +-0 (half of them -0), and one
    NaN cotangent."""
    tex, lanes, cot = _random_texture_inputs(cuda, seed=n + 1, n=n)
    cfg = RenderConfig(**ALL_MODES[mode])
    rng = np.random.default_rng(n)
    if pattern == "one_row":
        lanes = tuple(x[:1].expand(n).contiguous() for x in lanes)
    elif pattern == "permutation":
        texel = np.resize(rng.permutation(64 * 64), n)
        st = (np.stack([texel % 64, texel // 64]) + 0.75) / 64  # a quarter into the texel
        tiny = torch.full((n,), 1e-6, device=cuda)  # level < 0: the level-0 tap
        lanes = (torch.ones(n, dtype=torch.int32, device=cuda),
                 *(torch.from_numpy(x.astype(np.float32)).to(cuda) for x in st),
                 tiny, tiny.clone(), tiny.clone(), tiny.clone())
    elif pattern == "zero90":
        zero = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
        cot = torch.where(zero[:, None], 0.0, cot)
        half = torch.arange(n, device=cuda) < n // 2
        cot = torch.where((zero & half)[:, None], -0.0, cot)
    else:
        cot[n // 2, 1] = float("nan")
    return tex, lanes, cot, cfg


@pytest.mark.parametrize("n", [1, 31, 33, 20_000])
@pytest.mark.parametrize("pattern", ["one_row", "permutation", "zero90", "nan"])
@pytest.mark.parametrize("mode", list(ALL_MODES))
def test_texture_backward_kernel_patterns(cuda, mode, pattern, n):
    """K4 in every mode where its warp aggregation matters: the data and data4
    gradients within 1e-5 l2-relative of the plain version's per-lane values
    summed in float64 (a float32 sum of 20,000 lanes on one row is itself
    ~1e-5 off); the lane gradients equal the per-lane form's, and on 20,000
    independent lanes each is within 1e-5 of its max against autograd of
    sample_plain on >= 99.9% of lanes (a single lane may be 2e-5 off its own
    max: the chain rule by hand and autograd round apart); a NaN cotangent
    reaches its rows (NaN in both); zero lanes leave the gradients free of -0."""
    tex, lanes, cot, cfg = _pattern_inputs(cuda, mode, pattern, n)
    filt = texture_sample.filter_of(cfg)
    data4 = None if mode == "nearest" else texture_sample.expand_quads(tex)
    same = (texture_sample.sample(tex, *lanes, cfg, data4=data4)
            - texture_sample.sample_plain(tex, *lanes, cfg, data4)).abs().amax(dim=1) <= 1e-5
    assert float(same.float().mean()) >= 0.999 or n < 1000
    cot = torch.where(same[:, None] | cot.isnan(), cot, 0.0)
    before = trace.counters[f"launch.k4.{mode}"]
    kd, kd4, kl = texture_sample.sample_backward(tex, lanes, filt, data4, cot, True,
                                                 data4 is not None, True)
    assert trace.counters[f"launch.k4.{mode}"] == before + 1
    wd, wd4 = texture_sample.scatter_sums_plain(
        texture_sample.tap_slots_plain(tex, lanes, cfg, cot), tex[0].shape[0])
    for name, k, w in (("data", kd, wd), ("data4", kd4, wd4)):
        if k is None:
            continue
        k = k.double()
        assert torch.equal(k.isnan(), w.isnan()), name
        k, w = k.nan_to_num(), w.nan_to_num()
        nw = float(w.norm())
        assert float((k - w).norm()) <= 1e-5 * nw if nw else not k.any(), name
        if pattern == "zero90":
            assert not bool((torch.signbit(k) & (k == 0)).any()), name
    if pattern == "nan":  # the NaN lane reached its rows
        assert bool(kd.isnan().any()) or (kd4 is not None and bool(kd4.isnan().any()))
    # the lane gradients are the per-lane form's, value for value (only the atlas sums'
    # order changed), and, on 20,000 independent lanes, within 1e-5 of their
    # max against autograd of sample_plain on >= 99.9% of lanes, as before
    _, _, ll = texture_sample.sample_backward(tex, lanes, filt, data4, cot, False, False, True,
                                              "lane")
    assert bool(((kl == ll) | (kl.isnan() & ll.isnan())).all())
    if n < 20_000 or pattern == "one_row":
        return
    _, pg = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    keep = ~cot.isnan().any(dim=1)
    for a, b in zip(kl, pg[2:]):
        a, b = a[keep], b[keep]
        if not b.any():
            assert not a.any()
            continue
        err = (a - b).abs() / b.abs().max()
        assert float((err <= 1e-5).float().mean()) >= 0.999


def test_sky_backward_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    sky = torch.from_numpy(rng.random((64 * 64, 3), dtype=np.float32)).to(cuda)
    d = torch.from_numpy(_unit(rng, 65536)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(65536, 3)).astype(np.float32)).to(cuda)
    same = (sky_sample.sample_sky(sky, d) == sky_sample.sample_sky_plain(sky, d)).all(dim=1)
    cot = cot * same[:, None]
    before = trace.counters["launch.k5.bwd"]
    grads = []
    for fn in (sky_sample.sample_sky, sky_sample.sample_sky_plain):
        leaf = sky.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(leaf, d), [leaf], cot)[0])
    assert trace.counters["launch.k5.bwd"] == before + 1
    k, p = grads
    assert float((k - p).norm() / p.norm()) <= 1e-5


def _texel_directions(texels, size):
    """Unit directions that read the probe texels ``texels`` (row py * size + px):
    the angular map inverted at each texel's centre, which lies inside the
    disc the map covers."""
    px, py = texels % size, texels // size
    a, b = px / size - 0.5, py / size - 0.5
    rho = np.hypot(a, b)
    theta = 2 * np.pi * rho
    s = np.where(rho > 0, np.sin(theta) / np.maximum(rho, 1e-30), 2 * np.pi)
    d = np.stack([a * s, b * s, np.cos(theta)], axis=1)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _disc_texels(size):
    """The probe's texels well inside its disc (the angular map's image)."""
    p = np.arange(size * size)
    a, b = (p % size) / size - 0.5, (p // size) / size - 0.5
    return p[np.hypot(a, b) < 0.45]


@pytest.mark.parametrize("n", [1, 31, 33, 2_073_600])
@pytest.mark.parametrize("pattern", ["one_texel", "runs25", "random", "zero90", "nan"])
def test_sky_backward_kernel_patterns(cuda, pattern, n):
    """K5 bwd against autograd of sample_sky_plain within 1e-5 l2-relative
    where the scatter's aggregation matters: every lane on one texel, runs of
    25 lanes a texel (config3's primary rays), random texels, 90% of the lanes
    with an all-zero cotangent, and one NaN cotangent, which must reach its
    texel and no other.  The plain version runs on a float64 copy of the probe
    and cotangent, so that its sums are exact to well below the tolerance: a
    float32 sum of 2 M lanes on one texel is ~3e-5 off in any order."""
    size = 256
    rng = np.random.default_rng(n)
    disc = _disc_texels(size)
    lane = np.arange(n)
    if pattern == "one_texel":
        texels = np.full(n, disc[len(disc) // 3])
    elif pattern == "random":
        texels = rng.choice(disc, n)
    else:
        texels = disc[(lane // 25 * 7919) % len(disc)]
    sky = torch.from_numpy(rng.random((size * size, 3), dtype=np.float32)).to(cuda)
    d = torch.from_numpy(_texel_directions(texels, size)).to(cuda)
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    if pattern == "zero90":
        cot[rng.random(n) < 0.9] = 0.0
        cot[: n // 2][cot[: n // 2, 0] == 0.0] = -0.0  # -0 is a zero lane too
    nan_lane = n // 2
    if pattern == "nan":
        cot[nan_lane, 1] = np.nan
    cot = torch.from_numpy(cot).to(cuda)
    index = sky_sample.texel_index(size, d)
    assert torch.equal(index.cpu(), torch.from_numpy(texels))
    same = (sky_sample.sample_sky(sky, d) == sky_sample.sample_sky_plain(sky, d)).all(dim=1)
    assert bool(same.all())
    before = trace.counters["launch.k5.bwd"]
    leaf = sky.clone().requires_grad_()
    (k,) = torch.autograd.grad(sky_sample.sample_sky(leaf, d), [leaf], cot)
    assert trace.counters["launch.k5.bwd"] == before + 1
    leaf = sky.double().requires_grad_()
    (p,) = torch.autograd.grad(sky_sample.sample_sky_plain(leaf, d), [leaf], cot.double())
    k = k.double()
    if pattern == "nan":
        t = int(texels[nan_lane])
        assert bool(torch.isnan(k[t, 1])) and bool(torch.isnan(p[t, 1]))
        k[t, 1] = p[t, 1] = 0.0
        assert bool(torch.isfinite(k).all())
    assert float((k - p).norm() / p.norm().clamp_min(1e-30)) <= 1e-5
    # lanes with an all-zero cotangent leave their texels at +0
    untouched = torch.ones(size * size, dtype=torch.bool, device=cuda)
    untouched[index[(cot != 0).any(dim=1) | cot.isnan().any(dim=1)]] = False
    assert not bool(k[untouched].any()) and not bool(torch.signbit(k[untouched]).any())


@pytest.mark.parametrize("n", [1, 33, 1_000_000])
@pytest.mark.parametrize("pattern", ["queue", "runs25", "one_pixel", "zero90"])
def test_framebuffer_scatter_kernel_matches_plain(cuda, pattern, n):
    """The framebuffer scatter (rt_scatter_add3) adds in place what index_add_
    adds, within 1e-5 l2-relative of index_add_ in float64: a later
    generation's queue (reflection then refraction children of ascending
    pixels), runs of 25 lanes a pixel, every lane on one pixel, and 90% of the
    lanes adding zero (their pixels keep their bits)."""
    rng = np.random.default_rng(n)
    pixels = 1920 * 1080
    if pattern == "queue":
        half = np.sort(rng.choice(pixels, (n + 1) // 2, replace=False))
        pixel = np.concatenate([half, half])[:n]
    elif pattern == "one_pixel":
        pixel = np.full(n, 777)
    else:
        pixel = (np.arange(n) // 25 * 7919) % pixels
    c = rng.normal(size=(n, 3)).astype(np.float32)
    if pattern == "zero90":
        c[rng.random(n) < 0.9] = 0.0
    fb = torch.from_numpy(rng.normal(size=(pixels, 3)).astype(np.float32)).to(cuda)
    pixel = torch.from_numpy(pixel.astype(np.int32)).to(cuda)
    c = torch.from_numpy(c).to(cuda)
    want = fb.double().index_add_(0, pixel, c.double())
    before = trace.counters["launch.fb_scatter"]
    got = framebuffer.accumulate(fb.clone(), pixel, c)
    assert trace.counters["launch.fb_scatter"] == before + 1
    assert float((got.double() - want).norm() / want.norm()) <= 1e-5
    untouched = torch.ones(pixels, dtype=torch.bool, device=cuda)
    untouched[pixel[(c != 0).any(dim=1)]] = False
    assert torch.equal(got[untouched], fb[untouched])


def _config1(device, w=32, h=32):
    desc, cfg = scenes.config1_monkey()
    cfg = cfg.replace(width=w, height=h)
    return renderer.Renderer(cfg, device=device), ScenePacker(desc, w, h).frame()


def test_traversal_kernels_match_plain(cuda):
    rend, packed = _config1(cuda, 64, 64)
    scene = rend.upload(packed)
    bvh = traversal_wide.build_scene_bvh(scene)
    rays = renderer.generate_primary_rays(scene, rend.cfg)
    n = rays.count
    t_max = torch.full((n,), float("inf"), device=cuda)
    active = torch.ones((n,), dtype=torch.bool, device=cuda)
    k = traversal_wide.trace_closest(bvh, rays.origin, rays.direction, t_max, active,
                                     rend.cfg)
    w = traversal_wide.trace_plain(bvh, rays.origin, rays.direction, t_max, active,
                                   rend.cfg.wide_stack_size, True, any_hit=False)
    best = torch.where(k.tri >= 0, (k.tri << 8) | (k.inst + 1), -1)
    assert torch.equal(best, w.best) and torch.equal(k.steps, w.steps)
    assert torch.equal(k.t, w.t)
    assert int(k.incomplete) == 0 and int(w.incomplete) == 0

    hit = k.tri >= 0
    point = rays.origin + torch.where(hit, k.t, 0.0)[:, None] * rays.direction
    to_light = torch.nn.functional.normalize(scene.sl_pos[0] - point, dim=1)
    dist = torch.linalg.norm(scene.sl_pos[0] - point, dim=1)
    found, inc = traversal_wide.trace_any(bvh, point, to_light.contiguous(), dist, hit,
                                          rend.cfg)
    wa = traversal_wide.trace_plain(bvh, point, to_light.contiguous(), dist, hit,
                                    rend.cfg.wide_stack_size, True, any_hit=True)
    assert torch.equal(found, wa.found)
    assert int(inc) == 0


def test_render_on_card_matches_cpu(cuda):
    rend, packed = _config1(cuda)
    img, stats = rend(rend.upload(packed))
    cpu = renderer.Renderer(rend.cfg, device="cpu")
    cimg, cstats = cpu(cpu.upload(packed))
    assert [int(x) for x in stats] == [int(x) for x in cstats]
    d = (img.cpu() - cimg).abs()
    assert float(d.mean()) <= 1e-4
    assert float((d.amax(dim=-1) <= 1e-3).float().mean()) >= 0.995


def test_traversal_refuses_gradients_sky_and_texture_take_them(cuda):
    """The walk is discrete: a traversal input that asks for a gradient is
    refused (the renderer detaches them).  Sky and texture differentiate."""
    rend, packed = _config1(cuda, 8, 8)
    scene = rend.upload(packed)
    bvh = traversal_wide.build_scene_bvh(scene)
    rays = renderer.generate_primary_rays(scene, rend.cfg)
    n = rays.count
    t_max = torch.full((n,), float("inf"), device=cuda)
    active = torch.ones((n,), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="discrete"):
        traversal_wide.trace_closest(bvh, rays.origin, rays.direction.requires_grad_(),
                                     t_max, active, rend.cfg)
    with pytest.raises(ValueError, match="discrete"):
        traversal_wide.trace_any(bvh, rays.origin, rays.direction, t_max, active, rend.cfg)
    sky = torch.rand(16, 3, device=cuda, requires_grad=True)
    d = torch.nn.functional.normalize(torch.randn(8, 3, device=cuda), dim=1)
    sky_sample.sample_sky(sky, d.requires_grad_()).sum().backward()
    assert float(sky.grad.sum()) > 0


def test_render_grads_on_card_match_cpu(cuda):
    """config1 fwd+bwd of the image loss: the card (K1-K6 and the two backward
    kernels) against the CPU (plain versions under autograd)."""
    from raytracer_tpu_torch.diff import train

    rend, packed = _config1(cuda)
    cpu = renderer.Renderer(rend.cfg, device="cpu")
    target = torch.from_numpy(np.random.default_rng(4).random((32, 32, 3), dtype=np.float32))
    out = []
    for r in (rend, cpu):
        scene = r.upload(packed)
        params = train.extract_params(scene)
        loss = train.render_loss(params, scene, target.to(r.device), r.cfg)
        loss.backward()
        out.append((float(loss.detach()), {k: p.grad for k, p in params.items()}))
    (gl, gg), (cl, cg) = out
    assert abs(gl - cl) <= 1e-5 * cl
    for k, c in cg.items():
        if c is None:
            assert gg[k] is None, k
            continue
        g = gg[k].cpu()
        assert torch.isfinite(g).all(), k
        if c.norm() > 0:
            assert float((g - c).norm() / c.norm()) <= 1e-3, k


def _fxaa_form(form, img):
    """K8 in ``form``: the renderer's through ``fxaa``, the first through
    ``fxaa_form``; each launches once, on its own count."""
    key = "launch.k8" if form == "tile" else "launch.k8.first"
    before = trace.counters[key]
    k = fxaa.fxaa(img) if form == "tile" else fxaa.fxaa_form(form, img)
    assert trace.counters[key] == before + 1
    return k


@pytest.mark.parametrize("form", fxaa.FORMS)
@pytest.mark.parametrize("h,w", [(1, 7), (37, 53), (600, 900)])
def test_fxaa_kernel_matches_plain(cuda, h, w, form):
    """K8 in both forms against fxaa_plain: values outside [0, 1], hard edges,
    odd sizes."""
    rng = np.random.default_rng(h * w)
    img = rng.uniform(-0.2, 1.4, (h, w, 3)).astype(np.float32)
    img[:, w // 2:] *= 0.05
    img = torch.from_numpy(img).to(cuda)
    k = _fxaa_form(form, img)
    p = fxaa.fxaa_plain(img)
    d = (k - p).abs().amax(dim=-1)
    assert float((d <= 1e-5).float().mean()) >= 0.999 and float(d.mean()) <= 1e-6


@pytest.mark.parametrize("special", ["none", "nan_inf"])
@pytest.mark.parametrize("h,w", [(1, 7), (7, 1), (5, 5), (1, 1), (16, 32), (17, 33), (37, 53),
                                 (600, 900), (1080, 1920)])
def test_fxaa_forms_bit_identical(cuda, h, w, special):
    """K8's tile form against its first form, the same bits on every pixel:
    images smaller than a tile, sizes that are and are not multiples of the
    32 x 16 tile, hard edges on the tile boundaries (x = 32k, y = 16k), values
    outside [0, 1], and NaN and inf pixels (a NaN centre or diagonal gives a
    NaN direction, whose taps leave the tile and read the image)."""
    rng = np.random.default_rng(h * 7919 + w)
    img = rng.uniform(-0.2, 1.4, (h, w, 3)).astype(np.float32)
    img[:, (np.arange(w) // 32) % 2 == 1] *= 0.05
    img[(np.arange(h) // 16) % 2 == 1, :, 1] = 0.0
    if special == "nan_inf":
        for value in (np.nan, np.inf, -np.inf):
            pick = rng.random((h, w)) < 0.01
            img[pick, rng.integers(0, 3)] = value
        img[0, 0, 0] = np.nan
    img = torch.from_numpy(img).to(cuda)
    tile = _fxaa_form("tile", img)
    first = _fxaa_form("first", img)
    assert torch.equal(_bits(tile), _bits(first))
    if special == "none":
        d = (tile - fxaa.fxaa_plain(img)).abs().amax(dim=-1)
        assert float((d <= 1e-5).float().mean()) >= 0.999 and float(d.mean()) <= 1e-6
    else:
        assert bool(tile.isnan().any())


def _primitive_inputs(cuda, n=200_000, seed=3):
    """Three spheres (two of them equal: a tie) and two planes, with seeded rays,
    some starting inside a sphere and some parallel to a plane."""
    rng = np.random.default_rng(seed)
    prims = types.SimpleNamespace(
        sph_center=torch.tensor([[0, 0, 5], [0, 0, 5], [2, 0.5, 8]], dtype=torch.float32),
        sph_radius=torch.tensor([1.0, 1.0, 1.5]),
        pln_normal=torch.tensor([[0, 1, 0], [0, 0, -1]], dtype=torch.float32),
        pln_distance=torch.tensor([1.0, 20.0]))
    prims = types.SimpleNamespace(**{k: v.to(cuda) for k, v in vars(prims).items()})
    o = rng.uniform([-3, -0.5, -2], [3, 3, 9], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32) + np.float32([0, -0.2, 1.5])
    d[::5, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0, 25, n).astype(np.float32)
    tmax[::7] = np.inf
    active = rng.random(n) < 0.9
    return prims, *(torch.from_numpy(x).to(cuda) for x in (o, d, tmax, active))


def test_primitive_kernels_match_plain(cuda):
    """K9 closest and any hit against their plain versions: identical winners, t
    and blocked flags on every lane."""
    prims, o, d, tmax, active = _primitive_inputs(cuda)
    keys = ("launch.k9.closest", "launch.k9.any")
    before = [trace.counters[k] for k in keys]
    kw, kt = intersect.pick_closest(prims, o, d)
    pw, pt = intersect.pick_closest_plain(prims, o, d)
    kb = intersect.pick_any(prims, o, d, tmax, active)
    pb = intersect.pick_any_plain(prims, o, d, tmax, active)
    assert [trace.counters[k] for k in keys] == [before[0] + 1, before[1] + 1]
    assert torch.equal(kw, pw) and torch.equal(kt, pt) and torch.equal(kb, pb)
    assert int((kw == 1).sum()) == 0 and int((kw == 0).sum()) > 0  # ties to sphere 0
    assert bool(kb.any()) and not bool(kb.all())
    with pytest.raises(ValueError, match="discrete"):
        intersect.pick_closest(prims, o, d.clone().requires_grad_())


def _hit_inputs(cuda, seed=3):
    """K7 inputs on the card: config4 (48x32, frame 2) primaries with seeded dO,
    K9's record as the prior, the wide walk's ids; then 8 lanes appended whose
    triangles (appended rows) clamp both denominators (|e1 . (d x e2)| = 1e-21)
    with finite (t, u, v), on an appended identity instance.  Returns (scene,
    rays, res, prior)."""
    desc, cfg = scenes.config4_dynamic(48, 32)
    packer = ScenePacker(desc, 48, 32)
    desc.update(1.0 / 60.0)
    desc.update(1.0 / 60.0)
    rend = renderer.Renderer(cfg, device=cuda)
    scene = rend.upload(packer.frame())
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        rays = renderer.generate_primary_rays(scene, rend.cfg)
        n = rays.count
        rays = rays._replace(**{k: torch.from_numpy((rng.normal(size=(n, 3)) * 1e-2).astype(
            np.float32)).to(cuda) for k in ("dO_dx", "dO_dy")})
        winner, t_max = intersect.pick_closest(scene, rays.origin, rays.direction)
        prior = intersect.primitive_hits(scene, rays, winner)
        res = traversal_wide.trace_closest(traversal_wide.build_scene_bvh(scene), rays.origin,
                                           rays.direction, t_max,
                                           torch.ones(n, dtype=torch.bool, device=cuda),
                                           rend.cfg)
    k, m = 8, scene.tr_p0.shape[0]
    kk = torch.arange(k, dtype=torch.float32, device=cuda)
    o = torch.stack([0.1 * kk, 0.5 + 0 * kk, -1.0 - 0.25 * kk], dim=1)
    s = torch.stack([0 * kk, 0.5 + 0.1 * kk, -2.0 + 0 * kk], dim=1)

    def rows(*v):
        return torch.tensor(v, dtype=torch.float32, device=cuda).expand(k, len(v))

    ident = torch.eye(3, 4, device=cuda)[None]
    n_inst = scene.inst_inv.shape[0]
    extra = dict(inst_inv=ident, inst_world=ident,
                 tr_p0=o - s, tr_e1=rows(1e-21, 0.0, 0.0), tr_e2=rows(0.0, 1.0, 0.0),
                 tr_n0=rows(0.0, 0.0, -1.0), tr_ne1=rows(0.0, 0.0, 0.0),
                 tr_ne2=rows(0.0, 0.0, 0.0), tr_t0=rows(0.25, 0.75), tr_te1=rows(0.0, 0.0),
                 tr_te2=rows(0.0, 0.0))
    scene = scene._replace(**{f: torch.cat([getattr(scene, f), v]).contiguous()
                              for f, v in extra.items()},
                           tr_material=torch.cat([scene.tr_material, torch.ones(
                               k, dtype=torch.int32, device=cuda)]))
    small = torch.from_numpy((rng.normal(size=(4, k, 3)) * 1e-3).astype(np.float32)).to(cuda)
    rays = Rays(*(torch.cat([a, b]).contiguous() for a, b in zip(
        rays, (o, rows(0.0, 0.0, 1.0), *small))))
    res = res._replace(tri=torch.cat([res.tri, m + torch.arange(k, dtype=torch.int32,
                                                                 device=cuda)]),
                       inst=torch.cat([res.inst, torch.full((k,), n_inst, dtype=torch.int32,
                                                            device=cuda)]),
                       steps=torch.cat([res.steps, torch.ones(k, dtype=torch.int32,
                                                              device=cuda)]))
    miss = intersect.make_miss_hits(k, cuda)
    prior = Hits(*(torch.cat([a, b]).contiguous() for a, b in zip(prior, miss)))
    return scene, rays, res, prior


@pytest.mark.parametrize("object_space", [False, True])
def test_hits_kernel_matches_plain(cuda, object_space):
    """K7 forward against mesh_hits_plain on the card: the merged record equal on
    every lane (ids, material, steps, t and every float field), the prior kept
    where no triangle was hit, and the clamped lanes finite."""
    scene, rays, res, prior = _hit_inputs(cuda)
    before = trace.counters["launch.k7"]
    with torch.no_grad():
        k = hits.mesh_hits(scene, rays, res, prior, object_space)
        p = hits.mesh_hits_plain(scene, rays, res, prior, object_space)
    assert trace.counters["launch.k7"] == before + 1
    for name, a, b in zip(Hits._fields, k, p):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, float((a.float() - b.float()).abs().nan_to_num().max()))
    assert torch.isfinite(k.t[-8:]).all() and torch.isfinite(k.normal[-8:]).all()


@pytest.mark.parametrize("object_space", [False, True])
def test_hits_backward_kernel_matches_plain(cuda, object_space):
    """K7 backward against autograd of mesh_hits_plain on the card, a seeded
    cotangent on all 13 float outputs: the ray fields, the prior record's fields,
    the nine triangle tables and both instance tables (the clamped lanes'
    triangles among the rows) within 1e-5 l2-relative."""
    scene, rays, res, prior = _hit_inputs(cuda)
    rng = np.random.default_rng(5)
    cots = {f: torch.from_numpy(rng.normal(size=tuple(getattr(prior, f).shape)).astype(
        np.float32)).to(cuda) for f in hits.FLOAT_FIELDS}
    tables = hits.GEOMETRY + ("inst_inv", "inst_world")
    grads = []
    for fn in (hits.mesh_hits, hits.mesh_hits_plain):
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in tables}
        r = Rays(*(x.detach().clone().requires_grad_() for x in rays))
        prior_leaves = prior._replace(**{f: getattr(prior, f).detach().clone().requires_grad_()
                                         for f in hits.FLOAT_FIELDS})
        out = fn(scene._replace(**leaves), r, res, prior_leaves, object_space)
        inputs = [*r, *(getattr(prior_leaves, f) for f in hits.FLOAT_FIELDS), *leaves.values()]
        grads.append(torch.autograd.grad([getattr(out, f) for f in hits.FLOAT_FIELDS], inputs,
                                         [cots[f] for f in hits.FLOAT_FIELDS]))
    names = [*Rays._fields, *(f"prior_{f}" for f in hits.FLOAT_FIELDS), *tables]
    for name, k, p in zip(names, *grads):
        assert torch.isfinite(k).all(), name
        if float(p.norm()) == 0:
            assert float(k.norm()) == 0, name
        else:
            assert float((k - p).norm() / p.norm()) <= 1e-5, name


def _threaded_scene(device, name, strategy):
    """(bvh, cfg, primary rays, shadow rays of every light from their plain hits)
    of config1 at 64x64 or config4 (rotated instances; its directional light
    points along an axis) at 96x64 under the threaded walk, on ``device``."""
    w, h = (64, 64) if name == "config1" else (96, 64)
    desc, cfg = scenes.make_scene(name)
    cfg = cfg.replace(width=w, height=h, traversal_kernel="threaded",
                      traversal_strategy=TraversalStrategy[strategy])
    rend = renderer.Renderer(cfg, device=device)
    scene = rend.upload(ScenePacker(desc, w, h).frame())
    bvh = traversal.build_scene_bvh(scene)
    rays = renderer.generate_primary_rays(scene, cfg)
    n = rays.count
    prim = (rays.origin, rays.direction, torch.full((n,), float("inf"), device=device),
            torch.ones((n,), dtype=torch.bool, device=device))
    w0 = traversal.trace_plain(bvh, *prim, True, False)
    hit = w0.best >= 0
    point = prim[0] + torch.where(hit, w0.t, 0.0)[:, None] * prim[1]
    lights = torch.cat([scene.pl_pos, scene.sl_pos])
    to_l = lights[:, None, :] - point[None]
    dist = torch.linalg.norm(to_l, dim=2)
    n_dl = scene.dl_neg_dir.shape[0]
    k = lights.shape[0] + n_dl
    shadow = (point.repeat(k, 1),
              torch.cat([(to_l / dist[..., None]).reshape(-1, 3),
                         scene.dl_neg_dir.repeat_interleave(n, dim=0)]),
              torch.cat([dist.reshape(-1), torch.full((n_dl * n,), float("inf"),
                                                      device=device)]),
              hit.repeat(k))
    return bvh, cfg, prim, tuple(x.contiguous() for x in shadow)


def _threaded_form_matches_plain(form, bvh, cfg, rays, any_hit):
    """K10 in ``form`` equals trace_plain bit for bit: best, t, steps, found,
    incomplete 0."""
    ordered = cfg.traversal_strategy == TraversalStrategy.ORDERED
    w = traversal.trace_plain(bvh, *rays, ordered, any_hit)
    t, best, steps, found, inc = traversal.trace_form(form, any_hit, bvh, *rays, cfg)
    if any_hit:
        assert torch.equal(found, w.found), form
    else:
        assert torch.equal(best, w.best) and torch.equal(steps, w.steps), form
        assert torch.equal(t.view(torch.int32), w.t.view(torch.int32)), form
    assert int(inc) == 0, form
    return w


@pytest.mark.parametrize("form", list(traversal.FORMS))
@pytest.mark.parametrize("name, strategy", [("config1", "ORDERED"), ("config1", "NAIVE"),
                                            ("config4", "ORDERED"), ("config4", "NAIVE")])
def test_threaded_traversal_kernels_match_plain(cuda, name, strategy, form):
    """K10 closest and any hit in each form against traversal.trace_plain on the
    card: ids, t, steps and found equal on every lane, on the primaries and the
    shadow rays of every light (config4's axis-aligned directional light gives 0
    direction components and infinite reciprocals); trace_closest / trace_any
    launch the octant form (any hit over the active lanes K6 lists), each
    launch counted where it is made."""
    bvh, cfg, prim, shadow = _threaded_scene(cuda, name, strategy)
    w = _threaded_form_matches_plain(form, bvh, cfg, prim, any_hit=False)
    wa = _threaded_form_matches_plain(form, bvh, cfg, shadow, any_hit=True)
    assert int(wa.found.sum()) > 0 and int(w.steps.sum()) > 0
    keys = ("launch.k10.closest", "launch.k10.any", "launch.k10.split.closest",
            "launch.k10.split.any")
    before = [trace.counters[k] for k in keys]
    k = traversal.trace_closest(bvh, *prim, cfg)
    found, inc = traversal.trace_any(bvh, *shadow, cfg)
    best = torch.where(k.tri >= 0, (k.tri << 8) | (k.inst + 1), -1)
    assert torch.equal(best, w.best) and torch.equal(k.steps, w.steps)
    assert torch.equal(k.t, w.t) and int(k.incomplete) == 0
    assert torch.equal(found, wa.found) and int(inc) == 0
    assert [trace.counters[k] for k in keys] == [before[0] + 1, before[1] + 1, *before[2:]]


def _box_rays(bvh, n, seed):
    """{set: (o, d, t_max)} aimed at the table's node boxes, taken as world space:
    axis-parallel rays (two components +0 or -0) from outside or inside a box;
    origins inside a box with random directions; each with t_max infinite and
    finite (a random share of the box's diagonal)."""
    rng = np.random.default_rng(seed)
    box = bvh.box.cpu().numpy()
    pick = rng.integers(0, box.shape[0], n)
    lo, hi = box[pick, :3], box[pick, 3:]
    size = np.maximum(hi - lo, 1e-3).astype(np.float32)
    inside = (lo + rng.random((n, 3), np.float32) * size).astype(np.float32)
    axis = rng.integers(0, 3, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    d_axis = np.where(rng.random((n, 3)) < 0.5, np.float32(0.0), np.float32(-0.0))
    d_axis[np.arange(n), axis] = sign
    back = inside.copy()
    back[np.arange(n), axis] -= sign * (2 * size[np.arange(n), axis] + 1)
    o_axis = np.where((rng.random(n) < 0.5)[:, None], inside, back).astype(np.float32)
    d_rand = rng.normal(size=(n, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    diag = np.linalg.norm(size, axis=1).astype(np.float32)
    out = {}
    for label, (o, d) in (("axis", (o_axis, d_axis)), ("inside", (inside, d_rand))):
        out[f"{label}_inf"] = (o, d, np.full(n, np.inf, np.float32))
        out[f"{label}_finite"] = (o, d, (rng.random(n) * 2 * diag).astype(np.float32))
    return out


@pytest.mark.parametrize("name", ["config1", "config4"])
def test_threaded_kernels_made_up_rays(cuda, name):
    """Every form against trace_plain on axis-parallel rays, origins inside
    boxes, infinite and finite t_max, ORDERED and NAIVE, and on an all-inactive
    wavefront (t_max, -1, 0 steps and no hit on every lane)."""
    for strategy in ("ORDERED", "NAIVE"):
        bvh, cfg, _, _ = _threaded_scene(cuda, name, strategy)
        for label, arrays in _box_rays(bvh, 20_000, seed=3).items():
            rays = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in arrays)
            rays = (*rays, torch.rand((rays[0].shape[0],), device=cuda) < 0.9)
            for form in traversal.FORMS:
                _threaded_form_matches_plain(form, bvh, cfg, rays, any_hit=False)
                _threaded_form_matches_plain(form, bvh, cfg, rays, any_hit=True)
        o, d, t_max = (torch.from_numpy(x).to(cuda) for x in _box_rays(bvh, 1000, 4)["axis_inf"])
        idle = (o, d, t_max, torch.zeros((1000,), dtype=torch.bool, device=cuda))
        for form in traversal.FORMS:
            w = _threaded_form_matches_plain(form, bvh, cfg, idle, any_hit=False)
            assert int(w.steps.sum()) == 0 and bool((w.best == -1).all())
            _threaded_form_matches_plain(form, bvh, cfg, idle, any_hit=True)


def test_threaded_walk_refuses_misaligned_or_misshapen_records(cuda):
    """The octant form reads records, pair rows and matrices with 16-byte loads,
    and the records and pair rows in their own shapes."""
    bvh, cfg, prim, _ = _threaded_scene(cuda, "config1", "ORDERED")
    for field in ("rec", "pairs", "inst_mat"):
        x = getattr(bvh, field)
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
        bad = bvh._replace(**{field: flat[1:].view(x.shape)})
        with pytest.raises(ValueError, match="16-byte"):
            traversal.trace_closest(bad, *prim, cfg)
    for field, match in (("rec", "rec \\[8U"), ("pairs", "pairs \\[T/2")):
        x = getattr(bvh, field)
        with pytest.raises(ValueError, match=match):
            traversal.trace_any(bvh._replace(**{field: x[:-1]}), *prim, cfg)


def test_threaded_render_on_card_matches_cpu(cuda):
    """config1 under traversal_kernel="threaded": K10 and K7 on the card against
    the plain versions on the CPU."""
    rend, packed = _config1(cuda)
    cfg = rend.cfg.replace(traversal_kernel="threaded")
    rend = renderer.Renderer(cfg, device=cuda)
    img, stats = rend(rend.upload(packed))
    cpu = renderer.Renderer(cfg, device="cpu")
    cimg, cstats = cpu(cpu.upload(packed))
    assert [int(x) for x in stats] == [int(x) for x in cstats]
    d = (img.cpu() - cimg).abs()
    assert float(d.mean()) <= 1e-4
    assert float((d.amax(dim=-1) <= 1e-3).float().mean()) >= 0.995


def _gather_table(cuda, rows, width, seed, wild=False):
    """A table of values in [0, 1), or with wild=True, of any size and sign with
    a NaN and infinities among them (a chain's next index stays in the table)."""
    rng = np.random.default_rng(seed)
    if not wild:
        return torch.from_numpy(rng.random((rows, width), dtype=np.float32)).to(cuda)
    tab = (rng.standard_normal((rows, width)) * 10.0 ** rng.uniform(-2, 10, (rows, 1)))
    tab.flat[rng.integers(0, tab.size, 64)] = [np.nan, np.inf, -np.inf, 0.0] * 16
    return torch.from_numpy(tab.astype(np.float32)).to(cuda)


def _gather_idx(cuda, rows, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, rows, shape).astype(np.int32)).to(cuda)


@pytest.mark.parametrize("n", [1, 7, 513, 65541])
@pytest.mark.parametrize("width", [20, 72, 128, 384, 452])
def test_row_gather_staged_ring(cuda, width, n):
    """K11 staged's ring (8 stages of 16 rows, one bulk copy a row, persistent
    blocks) against ``table[idx]``: the same bits at every width it holds, a
    ragged last stage and fewer stages than blocks among them."""
    table = _gather_table(cuda, 70_000, width, 8, wild=True)
    idx = _gather_idx(cuda, 70_000, n, 9)
    before = trace.counters["launch.k11.staged"]
    got = gather.row_gather(table, idx, "staged")
    assert trace.counters["launch.k11.staged"] == before + 1
    want = gather.row_gather_plain(table, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_row_gather_staged_refuses_rows_its_ring_cannot_hold(cuda):
    """Rows above 452 floats (1,808 B) would take the ring past the shared memory
    a block may have."""
    table = torch.zeros((100, 456), device=cuda)
    idx = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 452 floats"):
        gather.row_gather(table, idx, "staged")
    assert torch.equal(gather.row_gather(table, idx, "direct"), table[:4])


@pytest.mark.parametrize("n", [1, 1025, 65536])
@pytest.mark.parametrize("width", [72, 128])
@pytest.mark.parametrize("schedule", ["direct", "staged"])
def test_row_gather_kernel_matches_plain(cuda, schedule, width, n):
    """K11 in both schedules against ``table[idx]``: the same bits (NaNs among them)."""
    table = _gather_table(cuda, 400_000, width, 1, wild=True)
    idx = _gather_idx(cuda, 400_000, n, 2)
    before = trace.counters[f"launch.k11.{schedule}"]
    got = gather.row_gather(table, idx, schedule)
    assert trace.counters[f"launch.k11.{schedule}"] == before + 1
    want = gather.row_gather_plain(table, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("width", [72, 128, 20])
def test_chained_gather_kernel_matches_plain(cuda, width, wild):
    """K12 chained and indep against the plain loops: acc and j equal on every
    lane (both sum a row left to right); width 20 takes the kernel's generic row
    loop."""
    table = _gather_table(cuda, 5000, width, 3, wild)
    idx = _gather_idx(cuda, 5000, 65536, 4)
    idx_all = _gather_idx(cuda, 5000, (8, 65536), 5)
    keys = ("launch.k12.chained", "launch.k12.indep")
    before = [trace.counters[k] for k in keys]
    acc, j = gather.chained_gather(table, idx, 32)
    pacc, pj = gather.chained_gather_plain(table, idx, 32)
    assert torch.equal(j, pj)
    assert torch.equal(acc, pacc) or (wild and torch.equal(acc.isnan(), pacc.isnan())
                                      and torch.equal(acc.nan_to_num(), pacc.nan_to_num()))
    got = gather.indep_gather(table, idx_all)
    want = gather.indep_gather_plain(table, idx_all)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert [trace.counters[k] for k in keys] == [before[0] + 1, before[1] + 1]


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("width", [6, 5, 8])
def test_chained_gather_scalar_loads_match_plain(cuda, width, wild):
    """K12 with 32-bit loads (rows of any width from a 4-byte aligned base, the
    threaded walk's 24-byte box rows among them) against the plain loop: acc
    and j equal on every lane; width 6 takes the unrolled row."""
    table = _gather_table(cuda, 5001, width, 8, wild)[1:]
    idx = _gather_idx(cuda, 5000, 65536, 9)
    before = trace.counters["launch.k12.chained"]
    acc, j = gather.chained_gather(table, idx, 54, loads="scalar")
    pacc, pj = gather.chained_gather_plain(table, idx, 54)
    assert trace.counters["launch.k12.chained"] == before + 1
    assert torch.equal(j, pj)
    assert torch.equal(acc.nan_to_num(), pacc.nan_to_num())
    assert torch.equal(acc.isnan(), pacc.isnan())


@pytest.mark.parametrize("c", [72, 71])
def test_table_rowsum_kernel_matches_plain(cuda, c):
    """K13 single and chained against the plain versions: equal on every lane
    (the chain's next index depends on the float sum)."""
    tab = _gather_table(cuda, c, 128, 6)
    idx = _gather_idx(cuda, 128, 131072, 7)
    keys = ("launch.k13.rowsum", "launch.k13.rowsum_chain")
    before = [trace.counters[k] for k in keys]
    assert torch.equal(gather.table_rowsum(tab, idx), gather.table_rowsum_plain(tab, idx))
    acc, j = gather.table_rowsum_chain(tab, idx, 32)
    pacc, pj = gather.table_rowsum_chain_plain(tab, idx, 32)
    assert torch.equal(acc, pacc) and torch.equal(j, pj)
    assert [trace.counters[k] for k in keys] == [before[0] + 1, before[1] + 1]


def _equal_nan(got, want) -> bool:
    """Equal on every lane, a NaN against a NaN (its payload aside)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
               if a.is_floating_point() else torch.equal(a, b) for a, b in zip(got, want))


def _same_bits(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))


@pytest.mark.parametrize("iters", [0, 1, 32])
@pytest.mark.parametrize("n", [1, 31, 33, 65541])
@pytest.mark.parametrize("width", [32, 72, 128, 20])
def test_chained_gather_warp_form_matches_plain_and_first(cuda, width, n, iters):
    """K12's warp form, chained and indep, on a wild table (NaNs, infinities,
    any magnitude): equal to the plain loops on every lane and the same bits as
    the first form; partial warps (n = 1, 31, 33, 65,541) load and write only
    their own lanes; width 20 takes the kernel's generic row loop."""
    table = _gather_table(cuda, 5000, width, 10, wild=True)
    idx = _gather_idx(cuda, 5000, n, 11)
    idx_all = _gather_idx(cuda, 5000, (iters, n), 12)
    keys = ("launch.k12.chained", "launch.k12.indep")
    before = [trace.counters[k] for k in keys]
    got = gather.chained_gather(table, idx, iters)
    assert _equal_nan(got, gather.chained_gather_plain(table, idx, iters))
    assert _same_bits(got, gather.chained_gather(table, idx, iters, form="first"))
    got = gather.indep_gather(table, idx_all)
    assert _equal_nan(got, gather.indep_gather_plain(table, idx_all))
    assert _same_bits(got, gather.indep_gather(table, idx_all, form="first"))
    assert [trace.counters[k] for k in keys] == [before[0] + 2, before[1] + 2]


def test_chained_gather_warp_form_on_the_harness_table(cuda):
    """K12's warp form on ``microbench.table_gather``'s [4680, 128] table at its
    131,072 lanes x 32 steps: the plain loop's and the first form's bits."""
    from raytracer_tpu_torch.microbench import table_gather

    table, idx = table_gather.inputs(cuda)
    got = gather.chained_gather(table, idx, 32)
    assert _same_bits(got, gather.chained_gather_plain(table, idx, 32))
    assert _same_bits(got, gather.chained_gather(table, idx, 32, form="first"))
    idx_all = _gather_idx(cuda, table.shape[0], (32, idx.shape[0]), 13)
    got = gather.indep_gather(table, idx_all)
    assert _same_bits(got, gather.indep_gather_plain(table, idx_all))
    assert _same_bits(got, gather.indep_gather(table, idx_all, form="first"))


@pytest.mark.parametrize("c,u,n", [(72, 128, 131073), (5, 33, 1000)])
def test_table_rowsum_sm_form_matches_plain(cuda, c, u, n):
    """K13's form "sm", single and chained, against the plain versions and the
    first form: the same bits on every lane, n not a multiple
    of the 1024-thread block, and an odd [5, 33] table (its 165 floats no whole
    number of 16-byte pieces: the bulk copy takes the first 164, a thread the
    last)."""
    tab = _gather_table(cuda, c, u, 14)
    idx = _gather_idx(cuda, u, n, 15)
    got = gather.table_rowsum(tab, idx)
    assert _same_bits(got, gather.table_rowsum_plain(tab, idx))
    assert _same_bits(got, gather.table_rowsum(tab, idx, form="first"))
    got = gather.table_rowsum_chain(tab, idx, 32)
    assert _same_bits(got, gather.table_rowsum_chain_plain(tab, idx, 32))
    assert _same_bits(got, gather.table_rowsum_chain(tab, idx, 32, form="first"))


def test_chained_gather_warp_form_refuses_rows_its_slot_cannot_hold(cuda):
    """A warp's slot holds 32 rows of at most 1,804 floats in the shared memory a
    block may have; the first form takes any width."""
    table = _gather_table(cuda, 40, 1808, 23)
    idx = _gather_idx(cuda, 40, 33, 24)
    with pytest.raises(ValueError, match="at most 1804 floats"):
        gather.chained_gather(table, idx, 2)
    assert _same_bits(gather.chained_gather(table, idx, 2, form="first"),
                      gather.chained_gather_plain(table, idx, 2))
    assert _same_bits(gather.chained_gather(table[:, :1804].contiguous(), idx, 2),
                      gather.chained_gather_plain(table[:, :1804].contiguous(), idx, 2))


def test_table_rowsum_sm_form_from_an_unaligned_base(cuda):
    """A table view 4 bytes past a 16-byte boundary: the form "sm"'s threads
    copy it all (no bulk copy from a base that is not 16-byte aligned)."""
    base = _gather_table(cuda, 1, 72 * 128 + 1, 16)[0]
    tab = base[1:].view(72, 128)
    assert tab.data_ptr() % 16
    idx = _gather_idx(cuda, 128, 5000, 17)
    assert _same_bits(gather.table_rowsum(tab, idx), gather.table_rowsum_plain(tab, idx))
    assert _same_bits(gather.table_rowsum_chain(tab, idx, 8),
                      gather.table_rowsum_chain_plain(tab, idx, 8))


def _launched(fn) -> list:
    """The names of the CUDA kernels ``fn`` launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()]


def test_each_gather_form_launches_the_kernel_it_names(cuda):
    """Each form of K12 and K13 launches its own kernel (by name, in the
    profiler's trace) and counts one launch under its kind's key, the first form
    also under that key's ``.first``."""
    table, idx = _gather_table(cuda, 5000, 128, 18), _gather_idx(cuda, 5000, 4096, 19)
    idx_all = _gather_idx(cuda, 5000, (4, 4096), 20)
    tab, ridx = _gather_table(cuda, 72, 128, 21), _gather_idx(cuda, 128, 4096, 22)
    cases = [
        ("chained", "chain_warp_kernel", lambda: gather.chained_gather(table, idx, 4)),
        ("chained", "chain_kernel",
         lambda: gather.chained_gather(table, idx, 4, form="first")),
        ("indep", "chain_warp_kernel", lambda: gather.indep_gather(table, idx_all)),
        ("indep", "chain_kernel", lambda: gather.indep_gather(table, idx_all, form="first")),
        ("rowsum", "rowsum_sm_kernel", lambda: gather.table_rowsum(tab, ridx)),
        ("rowsum", "rowsum_kernel", lambda: gather.table_rowsum(tab, ridx, form="first")),
        ("rowsum_chain", "rowsum_sm_kernel", lambda: gather.table_rowsum_chain(tab, ridx, 4)),
        ("rowsum_chain", "rowsum_kernel",
         lambda: gather.table_rowsum_chain(tab, ridx, 4, form="first")),
    ]
    kernels = {"chain_warp_kernel", "chain_kernel", "rowsum_sm_kernel", "rowsum_kernel"}
    for key, kernel, fn in cases:
        fn()  # built and loaded outside the trace
        count = (gather.LAUNCH[key], gather.LAUNCH[key] + ".first")
        before = [trace.counters[k] for k in count]
        names = _launched(fn)
        first = kernel in ("chain_kernel", "rowsum_kernel")
        assert [trace.counters[k] for k in count] == [before[0] + 1, before[1] + first]
        # demangled ("::chain_kernel<") or mangled ("12chain_kernelI")
        ran = {k for k in kernels for nm in names if re.search(rf"(::|\d){k}[<I]", nm)}
        assert ran == {kernel}, (key, kernel, names)


def test_gather_kernels_refuse_misaligned_rows(cuda):
    """cp.async and the 16-byte loads need 16-byte rows from a 16-byte aligned base."""
    base = torch.zeros(1000 * 72 + 1, device=cuda)
    idx = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        gather.row_gather(base[1:].view(1000, 72), idx, "staged")
    with pytest.raises(ValueError, match="16-byte"):
        gather.chained_gather(base[:1000 * 70].view(1000, 70), idx, 2)


def _walk_scene(cuda, name, strategy=TraversalStrategy.ORDERED):
    """(bvh, cfg, primary rays, a light's shadow rays from their plain hits) of
    config1 at 64x64 or config4 (rotated instances) at 96x64, on the card."""
    w, h = (64, 64) if name == "config1" else (96, 64)
    desc, cfg = scenes.make_scene(name)
    cfg = cfg.replace(width=w, height=h, traversal_strategy=strategy)
    rend = renderer.Renderer(cfg, device=cuda)
    scene = rend.upload(ScenePacker(desc, w, h).frame())
    bvh = traversal_wide.build_scene_bvh(scene)
    rays = renderer.generate_primary_rays(scene, cfg)
    n = rays.count
    prim = (rays.origin, rays.direction, torch.full((n,), float("inf"), device=cuda),
            torch.ones((n,), dtype=torch.bool, device=cuda))
    wk = traversal_wide.trace_plain(bvh, *prim, cfg.wide_stack_size,
                                    strategy == TraversalStrategy.ORDERED, any_hit=False)
    hit = wk.best >= 0
    point = prim[0] + torch.where(hit, wk.t, 0.0)[:, None] * prim[1]
    light = torch.cat([scene.pl_pos, scene.sl_pos])[0]
    dist = torch.linalg.norm(light - point, dim=1)
    shadow = (point, ((light - point) / dist[:, None]).contiguous(), dist, hit)
    return bvh, cfg, prim, shadow


def _forms_match_plain(bvh, cfg, rays, any_hit):
    """Both forms of K1 / K2 equal trace_plain bit for bit: best, t, steps,
    found and incomplete; the quantised form's counters equal the plain walk's."""
    w = traversal_wide.trace_plain(bvh, *rays, cfg.wide_stack_size,
                                   cfg.traversal_strategy == TraversalStrategy.ORDERED,
                                   any_hit, quantised=True)
    assert w.quant["bits_differ"] == 0
    for form in traversal_wide.FORMS:
        t, best, steps, found, inc = traversal_wide.trace_form(form, any_hit, bvh, *rays, cfg)
        if any_hit:
            assert torch.equal(found, w.found), form
        else:
            assert torch.equal(best, w.best) and torch.equal(steps, w.steps), form
            assert torch.equal(t.view(torch.int32), w.t.view(torch.int32)), form
        assert int(inc) == int(w.incomplete), form
    stats = traversal_wide.walk_stats(any_hit, bvh, *rays, cfg)
    assert stats == {k: w.quant[k] for k in traversal_wide.STATS}


@pytest.mark.parametrize("name, strategy", [("config1", TraversalStrategy.ORDERED),
                                            ("config4", TraversalStrategy.ORDERED),
                                            ("config4", TraversalStrategy.NAIVE)])
def test_quantised_walks_match_plain(cuda, name, strategy):
    """K1 and K2, the renderer's quantised form and the exact-record form, on
    primary and shadow rays (NAIVE: every ray reads octant 0's rows);
    trace_closest / trace_any launch the quantised form, trace_form("exact")
    the other, each counted where it launches."""
    bvh, cfg, prim, shadow = _walk_scene(cuda, name, strategy)
    _forms_match_plain(bvh, cfg, prim, any_hit=False)
    _forms_match_plain(bvh, cfg, shadow, any_hit=True)
    keys = ("launch.k1", "launch.k2", "launch.k1.exact", "launch.k2.exact")
    before = [trace.counters[k] for k in keys]
    res = traversal_wide.trace_closest(bvh, *prim, cfg)
    found, _ = traversal_wide.trace_any(bvh, *shadow, cfg)
    traversal_wide.trace_form("exact", False, bvh, *prim, cfg)
    traversal_wide.trace_form("exact", True, bvh, *shadow, cfg)
    assert [trace.counters[k] for k in keys] == [b + 1 for b in before]
    w = traversal_wide.trace_plain(bvh, *prim, cfg.wide_stack_size,
                                   strategy == TraversalStrategy.ORDERED, any_hit=False)
    assert torch.equal(res.steps, w.steps)


@pytest.mark.parametrize("name", ["config1", "config4"])
def test_quantised_walks_made_up_rays(cuda, name):
    """Both forms on rays with +-0 direction components, origins on child
    planes, through corners and edges, and t_max at a child's entry t (aimed at
    the children of the table's node rows, taken as world space)."""
    bvh, cfg, _, _ = _walk_scene(cuda, name)
    rows = bvh.table[:bvh.node_rows].cpu().numpy()
    for label, (_, o, d, t_max) in made_up_rays(rows, 20_000, seed=3).items():
        rays = tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(cuda)
                     for x in (o, d, t_max))
        rays = (*rays, torch.ones((o.shape[0],), dtype=torch.bool, device=cuda))
        _forms_match_plain(bvh, cfg, rays, any_hit=False)
        _forms_match_plain(bvh, cfg, rays, any_hit=True)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walks_at_the_stack_bound_lose_no_ray(cuda, any_hit):
    """K1 / K2 in both forms on the deep scene (its stack bound above 16): at the
    default stack, the scene's bound, bit-equal to trace_plain with no ray lost;
    at a set 16 entries they lose the rays the plain walk loses."""
    scene, o, d = deep_scene(cuda)
    bvh = traversal_wide.build_scene_bvh(scene)
    assert bvh.stack_bound > 16
    n = o.shape[0]
    t_max = (torch.linspace(2.0, 12.0, n, device=cuda) if any_hit
             else torch.full((n,), float("inf"), device=cuda))
    rays = (o, d, t_max, torch.ones((n,), dtype=torch.bool, device=cuda))
    cfg = RenderConfig(width=DEEP_SIZE, height=DEEP_SIZE)
    _forms_match_plain(bvh, cfg, rays, any_hit)
    assert int(traversal_wide.trace_plain(bvh, *rays, None, True, any_hit).incomplete) == 0
    _forms_match_plain(bvh, cfg.replace(wide_stack_size=16), rays, any_hit)
    assert int(traversal_wide.trace_plain(bvh, *rays, 16, True, any_hit).incomplete) > 0


def test_quantised_walk_refuses_a_misaligned_record_table(cuda):
    """The quantised form reads its records with 16-byte loads."""
    bvh, cfg, prim, _ = _walk_scene(cuda, "config1")
    flat = torch.zeros(bvh.qrec.numel() + 1, dtype=torch.int32, device=cuda)
    bad = bvh._replace(qrec=flat[1:].view(bvh.qrec.shape))
    with pytest.raises(ValueError, match="16-byte"):
        traversal_wide.trace_closest(bad, *prim, cfg)
