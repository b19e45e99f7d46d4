"""The no-grad shading kernels (``ops/shade``, ``csrc/shade.cu``) against the
torch glue they replace (``renderer._surface_glue``, ``_lights_glue``), on the
card, generation by generation.

These tests need a CUDA card and skip without one.  On a machine with a card,
from the repo root (``--noconftest``: tests/conftest.py imports JAX, which that
machine may lack and these tests do not use):

    python -m pytest tests/test_torch_shade_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.accel.blas import build_blas
from raytracer_tpu_torch.config import MeshAccelerator, RenderConfig, TextureSampleMode
from raytracer_tpu_torch.ops import framebuffer, shade, texture_sample
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import meshgen, scenes
from raytracer_tpu_torch.scene.description import SceneDescription
from raytracer_tpu_torch.scene.device import ScenePacker
from raytracer_tpu_torch.scene.sky import procedural_probe
from raytracer_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

SURFACE_FIELDS = ("w", "refl_c", "trans_c", "ior", "miss", "w_albedo", "shadow_active")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _dark_untextured():
    """Spheres, a plane and a mesh, no texture and no light: the albedo is the
    diffuse colour, and only the sky and the ambient term light the frame."""
    desc = SceneDescription()
    data, size = procedural_probe(16)
    desc.set_sky(data, size)
    glass = desc.add_sphere((0.0, 1.0, 6.0), 1.0)
    desc.material(glass).reflection = np.array([0.2, 0.2, 0.2])
    desc.material(glass).transmittance = np.array([0.7, 0.8, 0.9])
    desc.material(glass).index_of_refraction = 1.5
    desc.add_plane((0.0, -1.0, 0.0))
    desc.register_blas("box", build_blas(meshgen.box((1.0, 1.0, 1.0)), MeshAccelerator.BVH,
                                         cache_dir=None))
    desc.add_instance("box", (2.0, 0.6, 7.0))
    desc.camera.position = np.array([0.0, 1.4, 0.0])
    return desc, RenderConfig(width=48, height=32, num_bounces=3)


def _scene(name):
    """(desc, cfg) of each scene the path must hold on."""
    if name == "config3_threaded":  # textures, all three light types, the threaded walk
        desc, cfg = scenes.config3_sponza(96, 54, target_triangles=20_000)
        return desc, cfg.replace(width=96, height=54, traversal_kernel="threaded")
    if name == "config4_offset":  # spheres and planes, the wide walk, a normal offset
        desc, cfg = scenes.config4_dynamic(96, 64)
        return desc, cfg.replace(enable_fxaa=False, shadow_normal_offset=1e-3)
    if name == "config2":  # eight bounces through dielectrics
        desc, cfg = scenes.config2_dielectric()
        return desc, cfg.replace(width=64, height=64)
    return _dark_untextured()


SCENES = ("config3_threaded", "config4_offset", "config2", "dark_untextured")


def _same_bits(a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _upload(cuda, name):
    desc, cfg = _scene(name)
    rend = renderer.Renderer(cfg, device=cuda)
    return rend, rend.upload(ScenePacker(desc, cfg.width, cfg.height).frame())


@pytest.mark.parametrize("name", SCENES)
@torch.no_grad()
def test_shading_kernels_match_the_glue_each_generation(cuda, name):
    """Each generation's trace fed to both paths: _spawn's inputs, the sky and
    albedo terms, the lights' terms and the any-hit call's operands bit for
    bit; the walk's ``found`` on either operands identical; the counters equal;
    the frame within 1e-6 relative (the framebuffer scatter's atomics may add
    in another order)."""
    rend, scene = _upload(cuda, name)
    cfg = rend.cfg
    n = cfg.num_pixels
    walk = renderer._traversal_module(cfg)
    bvh = walk.build_scene_bvh(scene) if scene.n_instances else None
    tex4 = None
    if scene.tex_data.shape[0] > 1 and cfg.texture_sample_mode != TextureSampleMode.NEAREST:
        tex4 = texture_sample.expand_quads(renderer._tex_tuple(scene))
    pixel = torch.arange(n, dtype=torch.int32, device=cuda)
    gen = renderer._Generation(
        rays=renderer.primary_rays_for(scene, cfg, pixel),
        weight=torch.ones((n, 3), device=cuda), sigma=torch.zeros((n, 3), device=cuda),
        pixel=pixel, active=torch.ones((n,), dtype=torch.bool, device=cuda))
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    stats = renderer.RenderStats(zero + n, zero, zero, zero, zero, zero)
    fb_glue = torch.zeros((n, 3), device=cuda)
    fb_kernel = torch.zeros((n, 3), device=cuda)
    n_lights = scene.n_point_lights + scene.n_spot_lights + scene.n_directional_lights
    traced = 0
    for bounce in range(cfg.num_bounces + 1):
        hits, incomplete = renderer.trace_scene(scene, bvh, gen.rays, gen.active, cfg)
        glue = renderer._surface_glue(scene, gen, hits, cfg, tex4)
        before = trace.counters["launch.shade.surface"]
        kern = shade.surface(scene, hits, gen.rays.direction, gen.weight, gen.sigma, gen.active,
                             cfg, tex4)
        assert trace.counters["launch.shade.surface"] == before + 1
        for f in SURFACE_FIELDS:
            assert _same_bits(getattr(kern, f), getattr(glue, f)), (bounce, f)
        assert (kern.shadow is None) == (glue.shadow is None) == (n_lights == 0)
        blocked = shadow_incomplete = None
        if n_lights:
            assert _same_bits(kern.contribs, torch.stack(glue.contribs)), bounce
            for k, (a, b) in enumerate(zip(kern.shadow, glue.shadow)):
                assert _same_bits(a, b), (bounce, k)
            traced += int(kern.shadow[3].sum())
            if bvh is not None:
                found_k, _ = walk.trace_any(bvh, *kern.shadow, cfg)
                found_g, _ = walk.trace_any(bvh, *glue.shadow, cfg)
                assert torch.equal(found_k, found_g), bounce
            blocked, shadow_incomplete = renderer.intersect_scene(scene, bvh, *kern.shadow, cfg)

        contribution, want = renderer._lights_glue(scene, glue, blocked, stats, incomplete,
                                                   shadow_incomplete)
        identity = bounce == 0
        if identity:
            fb_glue = fb_glue + contribution
        else:
            fb_glue = framebuffer.accumulate(fb_glue, gen.pixel, contribution)
        before = trace.counters["launch.shade.lights"]
        fb_kernel, num_shadow, num_incomplete = shade.lights(
            scene.ambient, kern, blocked, fb_kernel, None if identity else gen.pixel,
            stats.num_shadow, stats.num_incomplete, incomplete, shadow_incomplete)
        assert trace.counters["launch.shade.lights"] == before + 1
        assert int(num_shadow) == int(want.num_shadow) == traced
        assert int(num_incomplete) == int(want.num_incomplete)
        torch.testing.assert_close(fb_kernel, fb_glue, rtol=1e-6, atol=0)
        stats = want
        if bounce == cfg.num_bounces:
            break
        cand_glue, stats_glue = renderer._spawn(gen, hits, glue.w, glue.refl_c, glue.trans_c,
                                                glue.ior, stats)
        cand, stats = renderer._spawn(gen, hits, kern.w, kern.refl_c, kern.trans_c, kern.ior,
                                      stats)
        assert int(stats.num_reflection) == int(stats_glue.num_reflection)
        assert int(stats.num_refraction) == int(stats_glue.num_refraction)
        assert all(_same_bits(cand[k], cand_glue[k]) for k in cand), bounce
        gen = renderer._compact(cand)
        if gen.pixel.shape[0] == 0:
            break
    if name != "dark_untextured":
        assert traced > 0 and bounce > 0


@pytest.mark.parametrize("name", SCENES)
def test_a_frame_takes_the_kernels_without_a_gradient(cuda, name):
    """``Renderer`` (no_grad) shades every generation through the kernels; a
    render that asks a gradient of a shading input takes the glue on the same
    card and gives the same frame within 1e-6 relative, and the same counters."""
    rend, scene = _upload(cuda, name)
    keys = ("launch.shade.surface", "launch.shade.lights")
    before = {k: trace.counters[k] for k in keys}
    image, stats = rend(scene)
    gens = trace.counters["launch.shade.surface"] - before[keys[0]]
    assert gens >= 1 and trace.counters["launch.shade.lights"] - before[keys[1]] == gens

    before = {k: trace.counters[k] for k in keys}
    grad_scene = scene._replace(ambient=scene.ambient.clone().requires_grad_())
    glue_image, glue_stats = renderer.render_with_stats(grad_scene, rend.cfg)
    assert {k: trace.counters[k] for k in keys} == before
    assert glue_image.requires_grad
    torch.testing.assert_close(image, glue_image.detach(), rtol=1e-6, atol=0)
    assert {k: int(v) for k, v in stats._asdict().items()} == \
        {k: int(v) for k, v in glue_stats._asdict().items()}
