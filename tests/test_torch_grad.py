"""Gradients of the port's differentiable kernels (K3 texture, K5 sky) against the
JAX package's VJPs, the plumbing of their autograd Functions, and the traversal's
gradient stop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import texture_sample as jax_texture
from raytracer_tpu.ops.sky_sample import sample_sky as jax_sample_sky
from raytracer_tpu.scene import sky as jax_sky
from raytracer_tpu_torch.config import MipmapFilter, TextureSampleMode
from raytracer_tpu_torch.diff import train
from raytracer_tpu_torch.ops import framebuffer, sky_sample, texture_sample, traversal_wide
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes
from raytracer_tpu_torch.scene.device import ScenePacker
from torch_parity import (fields, jax_scene, private_bvh_cache, texture_lanes,
                          torch_config)

TEX_FIELDS = ("tex_data", "tex_width", "tex_height", "tex_levels", "tex_offsets", "tex_quad")
LANE_NAMES = ("s", "t", "ds_dx", "ds_dy", "dt_dx", "dt_dy")


def l2rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def atlas():
    scene, cfg = jax_scene("config3")
    f = fields(scene)
    return tuple(f[k] for k in TEX_FIELDS), cfg


def _torch_texture_grads(tex, lanes, cot, cfg, sample=texture_sample.sample_plain):
    """Autograd of expand_quads + ``sample`` over CPU tensors: grads of data and
    the six float lane inputs (zeros for an input the mode does not
    differentiate, as JAX gives)."""
    data = torch.from_numpy(tex[0]).requires_grad_()
    ttex = (data, *(torch.from_numpy(a) for a in tex[1:]))
    floats = [torch.from_numpy(a).requires_grad_() for a in lanes[1:]]
    out = sample(ttex, torch.from_numpy(lanes[0]), *floats, torch_config(cfg),
                 texture_sample.expand_quads(ttex))
    inputs = [data, *floats]
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot), allow_unused=True)
    return [(torch.zeros_like(x) if g is None else g).numpy() for x, g in zip(inputs, grads)]


def _jax_texture_grads(tex, lanes, cot, cfg):
    """jax.vjp of sample (which expands the quad atlas itself) w.r.t. data and the
    six float lane inputs, eager."""
    jtex_rest = tuple(jnp.asarray(a) for a in tex[1:])
    tex_id = jnp.asarray(lanes[0])

    def f(data, *floats):
        return jax_texture.sample((data, *jtex_rest), tex_id, *floats, cfg)

    _, vjp = jax.vjp(f, jnp.asarray(tex[0]), *(jnp.asarray(a) for a in lanes[1:]))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def test_texture_vjp_matches_jax(atlas):
    tex, cfg = atlas
    lanes = texture_lanes(tex)
    cot = np.random.default_rng(11).normal(size=(lanes[0].shape[0], 3)).astype(np.float32)
    ref = _jax_texture_grads(tex, lanes, cot, cfg)
    got = _torch_texture_grads(tex, lanes, cot, cfg)
    for name, g, r in zip(("tex_data",) + LANE_NAMES, got, ref):
        assert g.shape == r.shape
        assert np.isfinite(g).all(), name
        assert l2rel(g, r) <= 1e-6, (name, l2rel(g, r))
    # the atlas gradient reaches many texels, and the lanes take all branches
    assert (np.abs(ref[0]).sum(axis=1) > 0).sum() > 1000


def _trilinear_ties(lanes):
    """TRILINEAR's width = 2 max(max(|ds_dx|, |ds_dy|), max(|dt_dx|, |dt_dy|)) with
    exact ties: |dt_dy| == |ds_dx| on every lane (the outer max), and also
    |ds_dy| == |ds_dx| on every third lane (an inner max), the other two smaller."""
    tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy = lanes
    k = np.arange(ds_dx.shape[0])
    sign = np.where(k % 2 == 0, 1.0, -1.0).astype(np.float32)
    ds_dy = np.where(k % 3 == 0, -ds_dx, np.float32(0.25) * ds_dy * (np.abs(ds_dx) /
                                                                     np.abs(ds_dy)))
    return (tex_id, s, t, ds_dx, ds_dy.astype(np.float32),
            (np.float32(0.5) * dt_dx * (np.abs(ds_dx) / np.abs(dt_dx))).astype(np.float32),
            sign * ds_dx)


# mode -> (config change, lanes)
VJP_MODES = {
    "nearest": (dict(texture_sample_mode=TextureSampleMode.NEAREST), 20_000),
    "bilinear": (dict(texture_sample_mode=TextureSampleMode.BILINEAR), 20_000),
    "trilinear": (dict(mipmap_filter=MipmapFilter.TRILINEAR), 20_000),
    "trilinear_ties": (dict(mipmap_filter=MipmapFilter.TRILINEAR), 20_000),
    "ewa": (dict(mipmap_filter=MipmapFilter.EWA), 1024),
}


@pytest.mark.parametrize("mode", list(VJP_MODES))
def test_texture_vjp_mode_matches_jax(atlas, mode):
    """Autograd of sample_plain against jax.vjp of jax_texture.sample in NEAREST,
    BILINEAR, TRILINEAR (also with exact ties in its max of |derivatives|, where
    both split the cotangent in half) and EWA (the full 16 x 16 window, 1,024
    lanes): tex_data and the six lane gradients within 1e-6 l2-relative; the
    modes that send no gradient to a lane input send none in both."""
    tex, cfg = atlas
    change, n = VJP_MODES[mode]
    cfg = cfg.replace(**change)
    lanes = texture_lanes(tex, n=n)
    if mode == "trilinear_ties":
        lanes = _trilinear_ties(lanes)
    cot = np.random.default_rng(13).normal(size=(n, 3)).astype(np.float32)
    ref = _jax_texture_grads(tex, lanes, cot, cfg)
    got = _torch_texture_grads(tex, lanes, cot, cfg)
    for name, g, r in zip(("tex_data",) + LANE_NAMES, got, ref):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert l2rel(g, r) <= 1e-6, (name, l2rel(g, r))
    assert (np.abs(ref[0]).sum(axis=1) > 0).sum() > 100
    lane_norms = [float(np.linalg.norm(r)) for r in ref[1:]]
    if mode == "nearest":
        assert not any(lane_norms)  # round carries no gradient
    elif mode == "bilinear":
        assert all(lane_norms[:2]) and not any(lane_norms[2:])
    elif mode == "ewa":  # the window's weights come through floor: only the
        # level-0 fallback sends a gradient, to s and t
        assert all(lane_norms[:2]) and not any(lane_norms[2:])
    elif mode == "trilinear":
        assert all(lane_norms)
    else:  # dt_dx never reaches the max; each tie splits the cotangent in half
        assert all(lane_norms[:4]) and lane_norms[4] == 0 and lane_norms[5] > 0
        split = (ref[3] != 0) & (np.abs(ref[3]) == np.abs(ref[6]))  # ds_dx, dt_dy
        assert split.sum() > 100, split.sum()


def _scatter_pattern(lanes, cot, pattern):
    """K4's scatter patterns at test size: every lane a copy of one filtered
    lane (all on one set of quad rows), 90% of the cotangents all zero (half of
    them -0), or one NaN cotangent."""
    n = cot.shape[0]
    if pattern == "one_row":
        lanes = tuple(np.full(n, a[7], dtype=a.dtype) for a in lanes)
    elif pattern == "zero90":
        rng = np.random.default_rng(17)
        cot = cot.copy()
        cot[rng.random(n) < 0.9] = 0.0
        cot[: n // 2][cot[: n // 2, 0] == 0.0] = -0.0
    else:
        cot = cot.copy()
        cot[n // 3, 2] = np.nan
    return lanes, cot


@pytest.mark.parametrize("mode", ["aniso", "trilinear"])
@pytest.mark.parametrize("pattern", ["one_row", "zero90", "nan"])
def test_texture_vjp_scatter_patterns_match_jax(atlas, pattern, mode):
    """Autograd of sample_plain (what K4 is held to on the card) against jax.vjp
    of jax_texture.sample where the scatter's aggregation matters: every lane on
    one quad row a slot, 90% zero cotangents, and a NaN cotangent, which reaches
    the rows and lane gradients of its own lane in both, and nothing else (at
    that lane JAX's max also sends 0 x NaN to the smaller operand; the port
    sends it nothing, as torch.maximum does).
    tex_data and the six lane gradients within 1e-6 l2-relative, as the other
    texture VJP checks; zero lanes leave tex_data free of -0."""
    tex, cfg = atlas
    if mode == "trilinear":
        cfg = cfg.replace(mipmap_filter=MipmapFilter.TRILINEAR)
    n = 2048
    lanes = texture_lanes(tex, n=n, seed=19)
    cot = np.random.default_rng(23).normal(size=(n, 3)).astype(np.float32)
    lanes, cot = _scatter_pattern(lanes, cot, pattern)
    ref = _jax_texture_grads(tex, lanes, cot, cfg)
    got = _torch_texture_grads(tex, lanes, cot, cfg)
    for name, g, r in zip(("tex_data",) + LANE_NAMES, got, ref):
        assert g.shape == r.shape, name
        if pattern == "nan" and name != "tex_data":
            # the NaN lane alone: JAX's max multiplies the cotangent by 0 for the
            # smaller operand (NaN), torch's and K4's send it nothing
            assert set(np.flatnonzero(np.isnan(g))) <= set(np.flatnonzero(np.isnan(r))) \
                <= {n // 3}, name
            g, r = np.delete(g, n // 3), np.delete(r, n // 3)
        assert np.array_equal(np.isnan(g), np.isnan(r)), name
        g, r = np.nan_to_num(g), np.nan_to_num(r)
        assert l2rel(g, r) <= 1e-6, (name, l2rel(g, r))
    if pattern == "nan":
        assert np.isnan(got[0]).any() and np.isnan(got[0]).sum() <= 16 * 3
    else:
        assert np.isfinite(got[0]).all()
        assert not (np.signbit(got[0]) & (got[0] == 0)).any()
    assert (np.abs(np.nan_to_num(ref[0])).sum(axis=1) > 0).sum() > 0


def test_sky_vjp_matches_jax():
    data, size = jax_sky.procedural_probe(256)
    data = data.astype(np.float32)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(65_536, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cot = rng.normal(size=d.shape).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda s, x: jax_sample_sky(s, jnp.int32(size), x),
                           jnp.asarray(data), jnp.asarray(d))
    sky = torch.from_numpy(data).requires_grad_()
    direction = torch.from_numpy(d).requires_grad_()
    out = sky_sample.sample_sky(sky, direction)
    # acos differs by an ulp between XLA and torch, which moves <= 1e-3 of the
    # lanes to a neighbouring texel (1 of 65,536 here, test_torch_sky.py); such a
    # lane's cotangent lands on another texel, so both sides drop it
    same = np.all(out.detach().numpy() == np.asarray(ref_out), axis=1)
    assert same.mean() >= 1 - 1e-3, same.mean()
    cot = cot * same[:, None]
    ref_sky, ref_dir = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    g_sky, g_dir = torch.autograd.grad(out, [sky, direction], torch.from_numpy(cot),
                                       allow_unused=True)
    assert l2rel(g_sky.numpy(), ref_sky) <= 1e-6, l2rel(g_sky.numpy(), ref_sky)
    # floor to a texel: no gradient reaches the direction in either package
    assert not ref_dir.any()
    assert g_dir is None or not g_dir.any()


def _camera_directions(w, h, fov_deg, forward):
    """[h*w, 3] unit directions of a pinhole camera's pixel centres, row-major."""
    forward = np.asarray(forward, np.float64) / np.linalg.norm(forward)
    right = np.cross(forward, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    half = np.tan(np.radians(fov_deg) / 2)
    sx = (2 * (np.arange(w) + 0.5) / w - 1) * half
    sy = (1 - 2 * (np.arange(h) + 0.5) / h) * half * h / w
    d = (forward + sx[None, :, None] * right + sy[:, None, None] * up).reshape(-1, 3)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_sky_vjp_matches_jax_on_main_path_pattern():
    """The pattern the main path gives K5's backward: neighbouring lanes are
    neighbouring pixels (config3's 0.057 deg a pixel, so ~25 of a row share a
    1.4 deg texel of the 256² probe), and the cotangent is zero on the ~90% of
    lanes whose ray hit a surface.  Autograd of the plain version and
    ``sample_backward`` on the CPU against ``jax.vjp``."""
    data, size = jax_sky.procedural_probe(256)
    data = data.astype(np.float32)
    w, h = 160, 90
    d = _camera_directions(w, h, 0.057 * w, (0.9, 0.1, 0.4))
    rng = np.random.default_rng(6)
    cot = rng.normal(size=d.shape).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    miss = ((xx - 0.6 * w) ** 2 + (yy - 0.4 * h) ** 2 < (0.12 * w) ** 2).reshape(-1)
    cot[~miss] = 0.0
    ref_out, vjp = jax.vjp(lambda s, x: jax_sample_sky(s, jnp.int32(size), x),
                           jnp.asarray(data), jnp.asarray(d))
    sky = torch.from_numpy(data).requires_grad_()
    direction = torch.from_numpy(d)
    out = sky_sample.sample_sky(sky, direction)
    same = np.all(out.detach().numpy() == np.asarray(ref_out), axis=1)
    assert same.mean() >= 1 - 1e-3, same.mean()
    cot = cot * same[:, None]
    index = sky_sample.texel_index(size, direction).to(torch.int32).numpy()
    runs = np.count_nonzero(np.diff(index[miss])) + 1
    assert 0.85 <= 1 - miss.mean() <= 0.95 and miss.sum() / runs >= 10, (miss.mean(), runs)
    ref_sky = np.asarray(vjp(jnp.asarray(cot))[0])
    (g_sky,) = torch.autograd.grad(out, [sky], torch.from_numpy(cot))
    assert l2rel(g_sky.numpy(), ref_sky) <= 1e-6, l2rel(g_sky.numpy(), ref_sky)
    g_bwd = sky_sample.sample_backward(torch.from_numpy(index), torch.from_numpy(cot),
                                       data.shape[0])
    assert l2rel(g_bwd.numpy(), ref_sky) <= 1e-6, l2rel(g_bwd.numpy(), ref_sky)


def _plain_texture_forward(cfg, tex, lanes, filt, data4):
    assert filt == texture_sample.filter_of(cfg)
    return texture_sample.sample_plain(tex, *lanes, cfg, data4)


def _plain_texture_backward(cfg, tex, lanes, filt, data4, cot, need_data, need_data4,
                            need_lanes):
    with torch.enable_grad():
        data = tex[0].detach().requires_grad_()
        d4 = data4.detach().requires_grad_()
        floats = [x.detach().requires_grad_() for x in lanes[1:]]
        out = _plain_texture_forward(cfg, (data, *tex[1:]), (lanes[0], *floats), filt, d4)
        grads = torch.autograd.grad(out, [data, d4, *floats], cot)
    return (grads[0] if need_data else None, grads[1] if need_data4 else None,
            torch.stack(grads[2:]) if need_lanes else None)


def test_texture_function_plumbing(atlas, monkeypatch):
    """TextureSample's argument order, saved tensors and gradient routing, with its
    two launches replaced by the plain version: equal to autograd of
    sample_plain, and K3 / K4 each called once with the config's Filter."""
    tex, cfg = atlas
    tcfg = torch_config(cfg)
    lanes = texture_lanes(tex, n=4000, seed=7)
    cot = np.random.default_rng(12).normal(size=(4000, 3)).astype(np.float32)
    calls = []
    monkeypatch.setattr(texture_sample, "sample_forward", lambda *a: calls.append(
        "fwd") or _plain_texture_forward(tcfg, *a))
    monkeypatch.setattr(texture_sample, "sample_backward", lambda *a: calls.append(
        "bwd") or _plain_texture_backward(tcfg, *a))

    def through_function(ttex, tex_id, *floats_and_rest):
        *floats, fcfg, data4 = floats_and_rest
        data, width, height, levels, offsets, _ = ttex
        return texture_sample.TextureSample.apply(
            texture_sample.filter_of(fcfg), data, data4, width, height, levels, offsets,
            tex_id, *floats)

    got = _torch_texture_grads(tex, lanes, cot, cfg, sample=through_function)
    ref = _torch_texture_grads(tex, lanes, cot, cfg)
    assert calls == ["fwd", "bwd"]
    for name, g, r in zip(("tex_data",) + LANE_NAMES, got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7, err_msg=name)


def test_sky_function_plumbing(monkeypatch):
    """SkySample with its two launches replaced by plain torch: the forward keeps
    the texel index only when a gradient is needed, and the backward scatters
    cot / pi there, as autograd of sample_sky_plain does."""
    rng = np.random.default_rng(8)
    sky = torch.from_numpy(rng.random((64 * 64, 3), dtype=np.float32))
    d = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(d, dim=1)
    cot = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32))
    seen = {}

    def fwd(sky_data, direction, want_index):
        seen["want_index"] = want_index
        out = sky_sample.sample_sky_plain(sky_data, direction)
        index = sky_sample.texel_index(sky_sample.probe_size(sky_data), direction)
        return out, index.to(torch.int32) if want_index else None

    def bwd(index, c, rows):
        return torch.zeros((rows, 3)).index_add_(0, index.long(), c * (1.0 / torch.pi))

    monkeypatch.setattr(sky_sample, "sample_forward", fwd)
    monkeypatch.setattr(sky_sample, "sample_backward", bwd)
    leaf = sky.clone().requires_grad_()
    (g,) = torch.autograd.grad(sky_sample.SkySample.apply(leaf, d, True), [leaf], cot)
    ref_leaf = sky.clone().requires_grad_()
    (ref,) = torch.autograd.grad(sky_sample.sample_sky_plain(ref_leaf, d), [ref_leaf], cot)
    assert seen["want_index"] is True
    np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        sky_sample.SkySample.apply(leaf, d, False)
    assert seen["want_index"] is False


def test_framebuffer_function_plumbing(monkeypatch):
    """FramebufferAdd with its launch replaced by index_add_: it adds in place,
    and its backward passes the frame's gradient through and gathers it at
    each lane's pixel, as autograd of index_add_ does."""
    rng = np.random.default_rng(9)
    pixel = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    c0 = torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    monkeypatch.setattr(framebuffer, "scatter_add", framebuffer.accumulate_plain)
    grads = []
    for add in (framebuffer.FramebufferAdd.apply, framebuffer.accumulate_plain):
        base = c0[:50].clone().requires_grad_()
        c = c0.clone().requires_grad_()
        fb = base * 2.0
        out = add(fb, pixel, c)
        assert out is fb
        grads.append(torch.autograd.grad((out * w).sum(), [base, c]))
    for g, r in zip(*grads):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_traversal_gets_no_gradient(monkeypatch):
    """A render under autograd hands the traversal entry points only tensors that
    ask for no gradient (the walk is discrete; JAX stops gradients there)."""
    with private_bvh_cache():
        desc, cfg = scenes.config1_monkey()
        cfg = cfg.replace(width=16, height=16)
        packed = ScenePacker(desc, 16, 16).frame()
    scene = renderer.Renderer(cfg, device="cpu").upload(packed)
    params = train.extract_params(scene)
    calls = []
    for name in ("trace_closest", "trace_any"):
        orig = getattr(traversal_wide, name)

        def spy(*args, _orig=orig, _name=name):
            calls.append((_name, [a.requires_grad for a in args if torch.is_tensor(a)]))
            return _orig(*args)

        monkeypatch.setattr(traversal_wide, name, spy)
    loss = train.render_loss(params, scene, torch.zeros(16, 16, 3), cfg)
    loss.backward()
    assert {c[0] for c in calls} == {"trace_closest", "trace_any"}
    assert not any(any(flags) for _, flags in calls), calls
    assert params["cam_pos"].grad is not None and params["cam_pos"].grad.abs().sum() > 0
