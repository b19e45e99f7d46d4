"""Each CUDA kernel of raytracer_tpu_torch against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one.  On a machine with a card, from
the repo root (``--noconftest``: tests/conftest.py imports JAX, which that machine
may lack and these tests do not use):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import compaction, sky_sample, texture_sample, traversal_wide
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
    """Gradients of data, data4 and the six float lane inputs through ``sample``."""
    data = tex[0].detach().clone().requires_grad_()
    data4 = texture_sample.expand_quads(tex).detach().requires_grad_()
    floats = [x.detach().clone().requires_grad_() for x in lanes[1:]]
    out = sample((data, *tex[1:]), lanes[0], *floats, cfg, data4)
    return out.detach(), torch.autograd.grad(out, [data, data4, *floats], cot)


def test_texture_backward_kernel_matches_plain(cuda):
    """K4 against autograd of sample_plain, on lanes whose forward agrees (a lane
    that takes another mip level in K3 sends its gradient elsewhere)."""
    tex, lanes, cot = _random_texture_inputs(cuda)
    cfg = RenderConfig()
    before = texture_sample.bwd_launches
    k_out, _ = _texture_grads(texture_sample.sample, tex, lanes, cot, cfg)
    p_out, _ = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    same = (k_out - p_out).abs().amax(dim=1) <= 1e-5
    assert float(same.float().mean()) >= 0.999
    cot = cot * same[:, None]
    _, kg = _texture_grads(texture_sample.sample, tex, lanes, cot, cfg)
    _, pg = _texture_grads(texture_sample.sample_plain, tex, lanes, cot, cfg)
    assert texture_sample.bwd_launches == before + 2
    for name, a, b in zip(("data", "data4"), kg[:2], pg[:2]):
        assert float((a - b).norm() / b.norm()) <= 1e-5, name
    for a, b in zip(kg[2:], pg[2:]):
        err = (a - b).abs() / b.abs().max()
        assert float((err <= 1e-5).float().mean()) >= 0.999


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
