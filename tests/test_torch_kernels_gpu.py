"""Each CUDA kernel of raytracer_tpu_torch against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one.  On a machine with a card, from
the repo root (``--noconftest``: tests/conftest.py imports JAX, which that machine
may lack and these tests do not use):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import (
    MipmapFilter, RenderConfig, TextureSampleMode, TraversalStrategy,
)
from raytracer_tpu_torch.ops import (
    compaction, fxaa, hits, intersect, sky_sample, texture_sample, traversal, traversal_wide,
)
from raytracer_tpu_torch.ops.intersect import Hits, Rays
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes, textures
from raytracer_tpu_torch.scene.device import ScenePacker

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


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 300_000])
def test_compact_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    flags = torch.from_numpy(rng.random(n) < 0.3).to(cuda)
    k_idx, k_n = compaction.compact(flags)
    p_idx, p_n = compaction.compact_plain(flags)
    assert k_n == p_n
    assert torch.equal(k_idx, p_idx)


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


def test_texture_kernel_matches_plain(cuda):
    tex, lanes, _ = _random_texture_inputs(cuda)
    cfg = RenderConfig()
    data4 = texture_sample.expand_quads(tex)
    k = texture_sample.sample(tex, *lanes, cfg, data4=data4)
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
    before = texture_sample.bwd_launches[mode]
    k_out, _ = _texture_grads(texture_sample.sample, tex, lanes, cot, cfg)
    p_out, _ = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    same = (k_out - p_out).abs().amax(dim=1) <= 1e-5
    assert float(same.float().mean()) >= 0.999
    cot = cot * same[:, None]
    _, kg = _texture_grads(texture_sample.sample, tex, lanes, cot, cfg)
    _, pg = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    assert texture_sample.bwd_launches[mode] == before + 2
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


@pytest.mark.parametrize("mode", list(NEW_MODES))
def test_texture_mode_kernel_matches_plain(cuda, mode):
    """K3 in NEAREST, BILINEAR, TRILINEAR and EWA (16 x 16 window) against
    sample_plain: max abs <= 1e-5 on >= 99.9% of lanes, one launch, and under
    TRILINEAR and EWA every branch (level-0 tap, top texel, filter) taken."""
    tex, lanes, _, cfg = _mode_inputs(cuda, mode)
    before = texture_sample.launches[mode]
    data4 = None if mode == "nearest" else texture_sample.expand_quads(tex)
    k = texture_sample.sample(tex, *lanes, cfg, data4=data4)
    p = texture_sample.sample_plain(tex, *lanes, cfg, data4)
    assert texture_sample.launches[mode] == before + 1
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


def test_sky_backward_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    sky = torch.from_numpy(rng.random((64 * 64, 3), dtype=np.float32)).to(cuda)
    d = torch.from_numpy(_unit(rng, 65536)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(65536, 3)).astype(np.float32)).to(cuda)
    same = (sky_sample.sample_sky(sky, d) == sky_sample.sample_sky_plain(sky, d)).all(dim=1)
    cot = cot * same[:, None]
    before = sky_sample.bwd_launches
    grads = []
    for fn in (sky_sample.sample_sky, sky_sample.sample_sky_plain):
        leaf = sky.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(leaf, d), [leaf], cot)[0])
    assert sky_sample.bwd_launches == before + 1
    k, p = grads
    assert float((k - p).norm() / p.norm()) <= 1e-5


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


@pytest.mark.parametrize("h,w", [(1, 7), (37, 53), (600, 900)])
def test_fxaa_kernel_matches_plain(cuda, h, w):
    """K8 against fxaa_plain: values outside [0, 1], hard edges, odd sizes."""
    rng = np.random.default_rng(h * w)
    img = rng.uniform(-0.2, 1.4, (h, w, 3)).astype(np.float32)
    img[:, w // 2:] *= 0.05
    img = torch.from_numpy(img).to(cuda)
    before = fxaa.launches
    k = fxaa.fxaa(img)
    p = fxaa.fxaa_plain(img)
    assert fxaa.launches == before + 1
    d = (k - p).abs().amax(dim=-1)
    assert float((d <= 1e-5).float().mean()) >= 0.999 and float(d.mean()) <= 1e-6


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
    before = (intersect.closest_launches, intersect.any_launches)
    kw, kt = intersect.pick_closest(prims, o, d)
    pw, pt = intersect.pick_closest_plain(prims, o, d)
    kb = intersect.pick_any(prims, o, d, tmax, active)
    pb = intersect.pick_any_plain(prims, o, d, tmax, active)
    assert (intersect.closest_launches, intersect.any_launches) == (before[0] + 1,
                                                                    before[1] + 1)
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
    before = hits.launches
    with torch.no_grad():
        k = hits.mesh_hits(scene, rays, res, prior, object_space)
        p = hits.mesh_hits_plain(scene, rays, res, prior, object_space)
    assert hits.launches == before + 1
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


@pytest.mark.parametrize("strategy", ["ORDERED", "NAIVE"])
def test_threaded_traversal_kernels_match_plain(cuda, strategy):
    """K10 closest and any hit against traversal.trace_plain on the card: ids,
    t, steps and found equal on every lane."""
    rend, packed = _config1(cuda, 64, 64)
    cfg = rend.cfg.replace(traversal_kernel="threaded",
                           traversal_strategy=TraversalStrategy[strategy])
    scene = rend.upload(packed)
    bvh = traversal.build_scene_bvh(scene)
    rays = renderer.generate_primary_rays(scene, cfg)
    n = rays.count
    t_max = torch.full((n,), float("inf"), device=cuda)
    active = torch.ones((n,), dtype=torch.bool, device=cuda)
    ordered = strategy == "ORDERED"
    before = (traversal.closest_launches, traversal.any_launches)
    k = traversal.trace_closest(bvh, rays.origin, rays.direction, t_max, active, cfg)
    w = traversal.trace_plain(bvh, rays.origin, rays.direction, t_max, active, ordered, False)
    best = torch.where(k.tri >= 0, (k.tri << 8) | (k.inst + 1), -1)
    assert torch.equal(best, w.best) and torch.equal(k.steps, w.steps)
    assert torch.equal(k.t, w.t) and int(k.incomplete) == 0

    hit = k.tri >= 0
    point = rays.origin + torch.where(hit, k.t, 0.0)[:, None] * rays.direction
    to_light = torch.nn.functional.normalize(scene.sl_pos[0] - point, dim=1).contiguous()
    dist = torch.linalg.norm(scene.sl_pos[0] - point, dim=1)
    found, inc = traversal.trace_any(bvh, point, to_light, dist, hit, cfg)
    wa = traversal.trace_plain(bvh, point, to_light, dist, hit, ordered, True)
    assert torch.equal(found, wa.found) and int(inc) == 0
    assert (traversal.closest_launches, traversal.any_launches) == (before[0] + 1,
                                                                    before[1] + 1)


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
