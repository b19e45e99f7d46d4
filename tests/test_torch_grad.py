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
from raytracer_tpu_torch.diff import train
from raytracer_tpu_torch.ops import sky_sample, texture_sample, traversal_wide
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
    the six float lane inputs."""
    data = torch.from_numpy(tex[0]).requires_grad_()
    ttex = (data, *(torch.from_numpy(a) for a in tex[1:]))
    floats = [torch.from_numpy(a).requires_grad_() for a in lanes[1:]]
    out = sample(ttex, torch.from_numpy(lanes[0]), *floats, torch_config(cfg),
                 texture_sample.expand_quads(ttex))
    grads = torch.autograd.grad(out, [data, *floats], torch.from_numpy(cot))
    return [g.numpy() for g in grads]


def test_texture_vjp_matches_jax(atlas):
    tex, cfg = atlas
    lanes = texture_lanes(tex)
    cot = np.random.default_rng(11).normal(size=(lanes[0].shape[0], 3)).astype(np.float32)
    jtex_rest = tuple(jnp.asarray(a) for a in tex[1:])
    tex_id = jnp.asarray(lanes[0])

    def f(data, *floats):  # JAX expands the quad atlas itself (data4=None)
        return jax_texture.sample((data, *jtex_rest), tex_id, *floats, cfg)

    _, vjp = jax.vjp(f, jnp.asarray(tex[0]), *(jnp.asarray(a) for a in lanes[1:]))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    got = _torch_texture_grads(tex, lanes, cot, cfg)
    for name, g, r in zip(("tex_data",) + LANE_NAMES, got, ref):
        assert g.shape == r.shape
        assert np.isfinite(g).all(), name
        assert l2rel(g, r) <= 1e-6, (name, l2rel(g, r))
    # the atlas gradient reaches many texels, and the lanes take all branches
    assert (np.abs(ref[0]).sum(axis=1) > 0).sum() > 1000


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


def _plain_texture_forward(tex, lanes, max_anisotropy, data4):
    cfg = torch_config(jax_scene("config3")[1]).replace(max_anisotropy=max_anisotropy)
    return texture_sample.sample_plain(tex, *lanes, cfg, data4)


def _plain_texture_backward(tex, lanes, max_anisotropy, data4, cot, need_data,
                            need_data4, need_lanes):
    with torch.enable_grad():
        data = tex[0].detach().requires_grad_()
        d4 = data4.detach().requires_grad_()
        floats = [x.detach().requires_grad_() for x in lanes[1:]]
        out = _plain_texture_forward((data, *tex[1:]), (lanes[0], *floats),
                                     max_anisotropy, d4)
        grads = torch.autograd.grad(out, [data, d4, *floats], cot)
    return (grads[0] if need_data else None, grads[1] if need_data4 else None,
            torch.stack(grads[2:]) if need_lanes else None)


def test_texture_function_plumbing(atlas, monkeypatch):
    """TextureSample's argument order, saved tensors and gradient routing, with its
    two launches replaced by the plain version: equal to autograd of
    sample_plain, and K3 / K4 each called once."""
    tex, cfg = atlas
    lanes = texture_lanes(tex, n=4000, seed=7)
    cot = np.random.default_rng(12).normal(size=(4000, 3)).astype(np.float32)
    calls = []
    monkeypatch.setattr(texture_sample, "sample_forward",
                        lambda *a: calls.append("fwd") or _plain_texture_forward(*a))
    monkeypatch.setattr(texture_sample, "sample_backward",
                        lambda *a: calls.append("bwd") or _plain_texture_backward(*a))

    def through_function(ttex, tex_id, *floats_and_rest):
        *floats, tcfg, data4 = floats_and_rest
        data, width, height, levels, offsets, _ = ttex
        return texture_sample.TextureSample.apply(
            float(tcfg.max_anisotropy), data, data4, width, height, levels, offsets,
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
