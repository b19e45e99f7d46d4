"""The no-grad children kernels (``ops/spawn``, ``csrc/spawn.cu``) against the
torch glue they replace (``renderer._compact(renderer._spawn(...))``), on the
card: the next queue's ten fields bit for bit, in the same order, and the
same counts.

These tests need a CUDA card and skip without one.  On a machine with a card,
from the repo root (``--noconftest``: tests/conftest.py imports JAX, which that
machine may lack and these tests do not use):

    python -m pytest tests/test_torch_spawn_gpu.py -m gpu --noconftest -q
"""

import collections

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops import intersect, shade, spawn, texture_sample
from raytracer_tpu_torch.ops.intersect import Rays
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes
from raytracer_tpu_torch.scene.device import ScenePacker
from raytracer_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

KEYS = ("launch.spawn.flags", "launch.spawn.write")
WALKS = ("threaded", "wide")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _config3(cuda, walk):
    """Config3 (textures, a refractive magnifier, all three light types) at
    192x108 on ``walk``."""
    desc, cfg = scenes.config3_sponza(192, 108, target_triangles=20_000)
    cfg = cfg.replace(width=192, height=108, traversal_kernel=walk)
    rend = renderer.Renderer(cfg, device=cuda)
    return rend, rend.upload(ScenePacker(desc, cfg.width, cfg.height).frame())


def _fields(gen):
    return {**gen.rays._asdict(), "weight": gen.weight, "sigma": gen.sigma, "pixel": gen.pixel,
            "active": gen.active}


def _same_bits(a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _stats(cuda, refl=0, refr=0):
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    return renderer.RenderStats(zero, zero, zero + refl, zero + refr, zero, zero)


def _both_paths(gen, hits, w, refl_c, trans_c, ior, stats):
    """The next queue and stats by the glue and by the kernels, held equal;
    returns the kernels'."""
    cand, glue_stats = renderer._spawn(gen, hits, w, refl_c, trans_c, ior, stats)
    glue = renderer._compact(cand)
    before = {k: trace.counters[k] for k in KEYS}
    parents = spawn.flags(gen.rays, gen.pixel, hits, w, refl_c, trans_c, ior)
    nxt, kern_stats = renderer._next_queue(parents, stats)
    n = gen.pixel.shape[0]
    assert trace.counters[KEYS[0]] == before[KEYS[0]] + (n > 0)
    assert trace.counters[KEYS[1]] == before[KEYS[1]] + 1
    want, got = _fields(glue), _fields(nxt)
    differ = [f for f in want if not _same_bits(got[f], want[f])]
    assert not differ, differ
    assert bool(nxt.active.all())
    assert int(kern_stats.num_reflection) == int(glue_stats.num_reflection)
    assert int(kern_stats.num_refraction) == int(glue_stats.num_refraction)
    return nxt, kern_stats


@pytest.mark.parametrize("walk", WALKS)
@torch.no_grad()
def test_children_match_the_glue_each_generation(cuda, walk):
    """Generations 0-2 of config3, each traced and shaded by the kernels of
    the renderer's no-grad path, then spawned by both paths."""
    rend, scene = _config3(cuda, walk)
    cfg = rend.cfg
    n = cfg.num_pixels
    bvh = renderer._traversal_module(cfg).build_scene_bvh(scene)
    tex4 = texture_sample.expand_quads(renderer._tex_tuple(scene))
    pixel = torch.arange(n, dtype=torch.int32, device=cuda)
    gen = renderer._Generation(
        rays=renderer.primary_rays_for(scene, cfg, pixel),
        weight=torch.ones((n, 3), device=cuda), sigma=torch.zeros((n, 3), device=cuda),
        pixel=pixel, active=torch.ones((n,), dtype=torch.bool, device=cuda))
    stats = _stats(cuda)
    fb = torch.zeros((n, 3), device=cuda)
    sizes = []
    for bounce in range(3):
        hits, incomplete = renderer.trace_scene(scene, bvh, gen.rays, gen.active, cfg)
        surf = shade.surface(scene, hits, gen.rays.direction, gen.weight, gen.sigma, gen.active,
                             cfg, tex4)
        blocked, shadow_incomplete = renderer.intersect_scene(scene, bvh, *surf.shadow, cfg)
        fb, _, _ = shade.lights(scene.ambient, surf, blocked, fb,
                                None if bounce == 0 else gen.pixel, stats.num_shadow,
                                stats.num_incomplete, incomplete, shadow_incomplete)
        gen, stats = _both_paths(gen, hits, surf.w, surf.refl_c, surf.trans_c, surf.ior, stats)
        sizes.append(gen.pixel.shape[0])
    assert sizes[1] > 0 and int(stats.num_refraction) > 0, sizes


def _made_generation(cuda, n=4096, seed=19):
    """A generation of ``n`` made-up lanes (numpy, seeded): misses, a
    dielectric of ior 1.5 met from either side (so with total internal
    reflection where it is left at a grazing angle), a mirror, a material with
    both children and one with neither; every other field random."""
    rng = np.random.default_rng(seed)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=cuda)

    kind = rng.integers(0, 4, size=n)  # 0 neither, 1 mirror, 2 glass, 3 both
    refl_c = np.where((kind == 1) | (kind == 3), 1.0, 0.0)[:, None] * rng.uniform(0.1, 1, (n, 3))
    trans_c = np.where(kind >= 2, 1.0, 0.0)[:, None] * rng.uniform(0.5, 1, (n, 3))
    ior = np.where(kind >= 2, 1.5, rng.uniform(1.0, 2.5, n))
    hit = rng.uniform(size=n) < 0.8
    rows = {k: f32(rng.normal(size=(n, 3))) for k in ("dO_dx", "dO_dy", "dD_dx", "dD_dy",
                                                      "dN_dx", "dN_dy", "point")}
    pixel = torch.tensor(rng.permutation(4 * n)[:n].astype(np.int32), device=cuda)
    rays = Rays(origin=f32(rng.normal(size=(n, 3))), direction=f32(unit(n)),
                dO_dx=f32(rng.normal(size=(n, 3))), dO_dy=f32(rng.normal(size=(n, 3))),
                dD_dx=rows["dD_dx"], dD_dy=rows["dD_dy"])
    gen = renderer._Generation(rays=rays, weight=f32(rng.uniform(0, 1, (n, 3))),
                               sigma=f32(np.zeros((n, 3))), pixel=pixel,
                               active=torch.ones((n,), dtype=torch.bool, device=cuda))
    hits = intersect.make_miss_hits(n, cuda)._replace(
        hit=torch.tensor(hit, device=cuda), normal=f32(unit(n)), point=rows["point"],
        dO_dx=rows["dO_dx"], dO_dy=rows["dO_dy"], dN_dx=rows["dN_dx"], dN_dy=rows["dN_dy"])
    return gen, hits, f32(rng.uniform(0, 1, (n, 3))), f32(refl_c), f32(trans_c), f32(ior)


@torch.no_grad()
def test_children_match_the_glue_on_made_lanes(cuda):
    """Entering and leaving lanes, total internal reflection, misses, a lane
    with both children and a material with neither, held to the glue; and
    counts carried in from earlier generations."""
    gen, hits, w, refl_c, trans_c, ior = _made_generation(cuda)
    d, nrm = gen.rays.direction, hits.normal
    entering = (d * nrm).sum(1) < 0
    cos = (d * nrm).sum(1).abs()
    refracting = hits.hit & ((trans_c * trans_c).sum(1) > 0)
    eta = torch.where(entering, 1.0 / ior, ior)
    tir = refracting & (1 - eta * eta * (1 - cos * cos) < 0)
    both = refracting & ~tir & ((refl_c * refl_c).sum(1) > 0)
    neither = hits.hit & ((refl_c * refl_c).sum(1) == 0) & ~refracting
    cases = {"entering": refracting & entering, "leaving": refracting & ~entering & ~tir,
             "tir": tir, "miss": ~hits.hit, "both": both, "neither": neither}
    assert all(int(m.sum()) > 0 for m in cases.values()), {k: int(m.sum())
                                                           for k, m in cases.items()}
    _both_paths(gen, hits, w, refl_c, trans_c, ior, _stats(cuda, 7, 11))


@torch.no_grad()
def test_an_empty_generation_and_one_without_children(cuda):
    """n = 0 launches no flags and writes an empty queue; a generation of
    misses has no child; both leave the counts as they were."""
    for n, hit in ((0, False), (1000, False)):
        gen, hits, w, refl_c, trans_c, ior = _made_generation(cuda, n=n)
        hits = hits._replace(hit=torch.full((n,), hit, device=cuda))
        nxt, stats = _both_paths(gen, hits, w, refl_c, trans_c, ior, _stats(cuda, 3, 5))
        assert nxt.pixel.shape[0] == 0
        assert (int(stats.num_reflection), int(stats.num_refraction)) == (3, 5)


def _profiled(fn):
    """(fn's result, the rt.* host ranges' names by start, {index: parent})."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.name.startswith("rt.")
                     and e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda r: (r[1], -r[2]))
    parent, stack = {}, []
    for i, (_, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] < b:
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return out, [r[0] for r in ranges], parent


@pytest.mark.parametrize("walk", WALKS)
def test_a_frame_takes_the_kernels_without_a_gradient(cuda, walk):
    """``Renderer`` (no_grad) spawns every generation but the last through the
    kernels, each spawning generation's stages as before and as many host reads
    as the glue's frame; a render that asks a camera gradient alone takes the
    glue on the same card and gives the same frame within 1e-6 relative (the
    framebuffer scatter's atomics may add in another order) and counts."""
    rend, scene = _config3(cuda, walk)
    before = {k: trace.counters[k] for k in KEYS}
    (image, stats), names, parent = _profiled(lambda: rend(scene))
    spawned = {k: trace.counters[k] - before[k] for k in KEYS}
    assert spawned == {k: rend.cfg.num_bounces for k in KEYS}, spawned
    kids = collections.defaultdict(list)
    for i, p in parent.items():
        kids[p].append(names[i])
    gens = [i for i, n in enumerate(names) if n == "rt.gen"]
    assert len(gens) == rend.cfg.num_bounces + 1
    for g in gens[:-1]:
        assert kids[g] == ["rt.trace", "rt.shade", "rt.shadow", "rt.shade", "rt.spawn",
                           "rt.compact"]

    cam = scene._replace(cam_x=scene.cam_x.clone().requires_grad_())
    before = {k: trace.counters[k] for k in KEYS}
    (glue_image, glue_stats), glue_names, _ = _profiled(
        lambda: renderer.render_with_stats(cam, rend.cfg))
    assert {k: trace.counters[k] for k in KEYS} == before
    assert glue_image.requires_grad
    assert names.count("rt.host_read") == glue_names.count("rt.host_read") > 0
    torch.testing.assert_close(image, glue_image.detach(), rtol=1e-6, atol=0)
    assert {k: int(v) for k, v in stats._asdict().items()} == \
        {k: int(v) for k, v in glue_stats._asdict().items()}
