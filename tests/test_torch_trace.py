"""The port's spans and counters (``raytracer_tpu_torch/utils/trace.py``) on the
CPU, on a tiny scene built by the port alone: under ``torch.profiler`` the
frame's span tree (each generation's stages tiling it, one ``rt.host_read``
range a read of a tensor's value on the host); with no profiler, no span
enters ``record_function``; and each kernel wrapper's launch counted once under
its key."""

import collections

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import kernels
from raytracer_tpu_torch.accel.blas import build_blas
from raytracer_tpu_torch.config import MeshAccelerator, RenderConfig
from raytracer_tpu_torch.ops import (
    compaction, framebuffer, fxaa, hits, intersect, shade, sky_sample, spawn, texture_sample,
    traversal, traversal_wide,
)
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import meshgen
from raytracer_tpu_torch.scene.description import PointLight, SceneDescription
from raytracer_tpu_torch.scene.device import pack_scene
from raytracer_tpu_torch.scene.sky import procedural_probe
from raytracer_tpu_torch.utils import trace

# 24 x 16 pixels, one bounce after the primary rays: two generations, the first
# spawning (the glass sphere refracts and reflects); the cell's walk, K10
CFG = RenderConfig(width=24, height=16, num_bounces=1, traversal_kernel="threaded")
STAGES = {"rt.trace", "rt.shade", "rt.shadow", "rt.spawn", "rt.compact"}
# the ways a tensor's value reaches the host
READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__")


def _desc(instance: bool = True):
    """The tiny scene: a glass sphere, a textured floor, one point light and,
    with ``instance``, a box mesh."""
    desc = SceneDescription()
    data, size = procedural_probe(16)
    desc.set_sky(data, size)
    glass = desc.add_sphere((0.0, 1.0, 6.0), 1.0)
    desc.material(glass).reflection = np.array([0.2, 0.2, 0.2])
    desc.material(glass).transmittance = np.array([0.7, 0.8, 0.9])
    desc.material(glass).index_of_refraction = 1.5
    floor = desc.add_plane((0.0, -1.0, 0.0))
    ch = np.indices((8, 8)).sum(0) % 2
    desc.material(floor).texture_array = np.stack([0.2 + 0.6 * ch] * 3, -1).astype(np.float32)
    if instance:
        ico = meshgen.box((1.0, 1.0, 1.0))
        desc.register_blas("ico", build_blas(ico, MeshAccelerator.BVH, cache_dir=None))
        desc.add_instance("ico", (2.0, 0.6, 7.0))
    desc.point_lights.append(PointLight(np.array([12.0, 10.0, 9.0]), np.array([0.0, 5.0, 3.0])))
    desc.camera.position = np.array([0.0, 1.4, 0.0])
    return desc


def _scene():
    return pack_scene(_desc(), CFG.width, CFG.height)


@pytest.fixture(scope="module")
def scene():
    rend = renderer.Renderer(CFG, device="cpu")
    return rend, rend.upload(_scene())


def _ranges(prof):
    """[(name, start, end)] of the profile's ``rt.*`` host ranges, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("rt.") and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _tree(ranges):
    """{index: parent index or None}: each range's innermost enclosing range."""
    parent, stack = {}, []
    for i, (_, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] < b:
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def _covered(ranges, parent, i) -> float:
    """The share of range i that its child ranges cover."""
    kids = sorted((ranges[k][1], ranges[k][2]) for k, p in parent.items() if p == i)
    covered, end = 0, ranges[i][1]
    for a, b in kids:
        covered += max(0, b - max(a, end))
        end = max(end, b)
    return covered / max(ranges[i][2] - ranges[i][1], 1)


@pytest.mark.parametrize("frame", ["first", "second"])
def test_span_tree_of_a_frame(scene, monkeypatch, frame):
    """One ``rt.render``, tiled by ``rt.tables``, ``rt.primary`` and one ``rt.gen``
    a generation; each spawning generation tiled by the five stages, the last by
    trace, shade and shadow; and as many ``rt.host_read`` ranges as reads.  A
    renderer's first frame builds the tables (K10's record check reads once in
    ``rt.tables``); its second reuses them, and ``rt.tables`` reads nothing."""
    _, s = scene
    rend = renderer.Renderer(CFG, device="cpu")
    if frame == "second":
        rend(s)
    reads = collections.Counter()
    for name in READS:
        method = getattr(torch.Tensor, name)

        def counted(self, *a, _method=method, _name=name, **kw):
            reads[_name] += 1
            return _method(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, stats = rend(s)
    monkeypatch.undo()
    ranges = _ranges(prof)
    parent = _tree(ranges)
    names = [r[0] for r in ranges]
    kids = collections.defaultdict(list)
    for i, p in parent.items():
        kids[p].append(names[i])

    (root,) = [i for i, n in enumerate(names) if n == "rt.render"]
    assert parent[root] is None and kids[None] == ["rt.render"]
    gens = [i for i, n in enumerate(names) if n == "rt.gen"]
    assert kids[root] == ["rt.tables", "rt.primary"] + ["rt.gen"] * (CFG.num_bounces + 1)
    for g in gens[:-1]:
        assert kids[g] == ["rt.trace", "rt.shade", "rt.shadow", "rt.shade", "rt.spawn",
                           "rt.compact"]
    assert kids[gens[-1]] == ["rt.trace", "rt.shade", "rt.shadow", "rt.shade"]
    assert int(stats.num_refraction) > 0 and int(stats.num_reflection) > 0
    # the reads: K10's record check in rt.tables (a build only), K6's count in
    # each rt.compact, the plain walks' loop tests in rt.trace and rt.shadow;
    # nothing else
    host_reads = [i for i, n in enumerate(names) if n == "rt.host_read"]
    assert len(host_reads) == sum(reads.values()) > 0
    where = collections.Counter(names[parent[i]] for i in host_reads)
    built = frame == "first"
    assert set(where) == {"rt.compact", "rt.trace", "rt.shadow"} | ({"rt.tables"} if built
                                                                      else set())
    assert where["rt.tables"] == built and where["rt.compact"] == CFG.num_bounces
    assert all(not kids[i] for i in host_reads)
    # every span other than a read has a stage as parent
    for i, n in enumerate(names):
        if n in STAGES:
            assert names[parent[i]] == "rt.gen"
    # the stages tile their parents: what lies between them is a few statements
    assert _covered(ranges, parent, root) >= 0.9
    for g in gens:
        assert _covered(ranges, parent, g) >= 0.9


def test_no_span_enters_record_function_without_a_profiler(scene, monkeypatch):
    """With no profiler recording, rendering never calls ``record_function``;
    under a profiler, every span does."""
    rend, s = scene

    def refuse(*a, **kw):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    image, _ = rend(s)
    assert image.shape == (CFG.height, CFG.width, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            rend(s)


def _launches():
    return {k: n for k, n in trace.counters.items() if k.startswith("launch.")}


def test_a_frame_on_the_cpu_counts_no_launch(scene):
    """The plain versions of the kernels launch nothing: a frame on the CPU
    leaves every launch counter as it was."""
    rend, s = scene
    before = _launches()
    rend(s)
    assert _launches() == before


SHADE_KEYS = ("launch.shade.surface", "launch.shade.lights", "launch.shade.tex_id",
              "launch.spawn.flags", "launch.spawn.write")


def test_the_cpu_and_a_gradient_take_the_glue(scene):
    """The shading and children kernels run only on the card and only where
    autograd records nothing: a render that asks gradients of the materials
    and the lights dispatches to the glue (``_wants_grad``), launches no
    shading or children kernel, and its loss backpropagates into
    ``mat_diffuse`` and the lights."""
    _, s = scene
    gen = renderer._Generation(
        rays=renderer.generate_primary_rays(s, CFG), weight=torch.ones((CFG.num_pixels, 3)),
        sigma=torch.zeros((CFG.num_pixels, 3)),
        pixel=torch.arange(CFG.num_pixels, dtype=torch.int32),
        active=torch.ones((CFG.num_pixels,), dtype=torch.bool))
    hits = intersect.make_miss_hits(CFG.num_pixels, "cpu")
    fb = torch.zeros((CFG.num_pixels, 3))
    with torch.no_grad():
        assert not renderer._wants_grad(s, gen, hits, fb, None)
    assert not renderer._wants_grad(s, gen, hits, fb, None)
    for field in ("mat_diffuse", "pl_colour", "ambient", "sky_data"):
        asked = s._replace(**{field: getattr(s, field).clone().requires_grad_()})
        assert renderer._wants_grad(asked, gen, hits, fb, None), field
    lit = hits._replace(point=hits.point.clone().requires_grad_())
    assert renderer._wants_grad(s, gen, lit, fb, None)

    params = {f: getattr(s, f).clone().requires_grad_() for f in ("mat_diffuse", "pl_colour")}
    before = {k: trace.counters[k] for k in SHADE_KEYS}
    rgb, _ = renderer.render_wavefront(s._replace(**params), CFG)
    rgb.square().sum().backward()
    assert {k: trace.counters[k] for k in SHADE_KEYS} == before
    for f, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), f
        assert float(p.grad.abs().sum()) > 0, f


@pytest.mark.parametrize("field", intersect.Rays._fields)
def test_a_gradient_of_any_ray_field_takes_the_glue(scene, field):
    """The children read every field of the generation's rays (the
    differentials among them): a gradient asked of any one alone keeps the
    generation on the glue."""
    _, s = scene
    rays = renderer.generate_primary_rays(s, CFG)
    asked = rays._replace(**{field: getattr(rays, field).clone().requires_grad_()})
    gen = renderer._Generation(
        rays=asked, weight=torch.ones((CFG.num_pixels, 3)),
        sigma=torch.zeros((CFG.num_pixels, 3)),
        pixel=torch.arange(CFG.num_pixels, dtype=torch.int32),
        active=torch.ones((CFG.num_pixels,), dtype=torch.bool))
    hits = intersect.make_miss_hits(CFG.num_pixels, "cpu")
    assert renderer._wants_grad(s, gen, hits, torch.zeros((CFG.num_pixels, 3)), None)


def test_a_camera_gradient_alone_takes_the_glue(scene):
    """A render that asks a gradient of the camera alone launches no shading
    or children kernel, and autograd records it back to the camera."""
    _, s = scene
    cam_x = s.cam_x.clone().requires_grad_()
    before = {k: trace.counters[k] for k in SHADE_KEYS}
    rgb, _ = renderer.render_wavefront(s._replace(cam_x=cam_x), CFG)
    rgb.square().sum().backward()
    assert {k: trace.counters[k] for k in SHADE_KEYS} == before
    assert cam_x.grad is not None


def _surface(s, n=4):
    """A generation's surface terms of n lanes under the tiny scene's one light."""
    z3 = torch.zeros((n, 3))
    return shade.Surface(w=z3, refl_c=z3, trans_c=z3, ior=torch.zeros(n), miss=z3, w_albedo=z3,
                         shadow_active=torch.ones(n, dtype=torch.bool),
                         contribs=torch.zeros((1, n, 3)),
                         shadow=(z3, z3, torch.zeros(n), torch.ones(n, dtype=torch.bool)),
                         num_shadow=torch.ones(1, dtype=torch.int32))


def _shade_lights(s, fb):
    i0 = torch.zeros((), dtype=torch.int32)
    return shade.lights_launch(s.ambient, _surface(s), torch.zeros(4, dtype=torch.bool), fb,
                               i0, i0, i0, i0)


def _wide(s):
    bvh = traversal_wide.build_scene_bvh(s)
    o = torch.zeros((4, 3))
    d = torch.nn.functional.normalize(torch.ones((4, 3)), dim=1)
    return bvh, o, d, torch.full((4,), 1e30), torch.ones((4,), dtype=torch.bool)


def _threaded(s):
    bvh = traversal.build_scene_bvh(s)
    return (bvh, *_wide(s)[1:])


def _parents(n=4):
    z3 = torch.zeros((n, 3))
    rays = intersect.Rays(z3, z3, z3, z3, z3, z3)
    return spawn.flags(rays, torch.arange(n, dtype=torch.int32),
                       intersect.make_miss_hits(n, "cpu"), z3, z3, z3, torch.zeros(n))


def _texture(s, mode, n=4):
    """K3's and K4's arguments for n lanes of texture 1 in ``mode``."""
    tex = renderer._tex_tuple(s)
    lanes = (torch.ones(n, dtype=torch.int32), *(torch.full((n,), 0.25) for _ in range(6)))
    return tex, lanes, texture_sample.Filter(mode, 8.0, 8), texture_sample.expand_quads(tex)


def _mesh(s, n=4):
    """K7's ids, rays and tables for n lanes: (tri, inst, rays, geom, material,
    inst_inv, inst_world)."""
    ids = torch.zeros(n, dtype=torch.int32)
    rays = intersect.Rays(*(torch.zeros((n, 3)) for _ in intersect.Rays._fields))
    return (ids, ids, rays, tuple(getattr(s, k) for k in hits.GEOMETRY), s.tr_material,
            s.inst_inv, s.inst_world)


def _mesh_forward(s, n=4):
    tri, inst, *rest = _mesh(s, n)
    return hits.hits_forward(tri, inst, torch.zeros(n, dtype=torch.int32), *rest,
                             intersect.make_miss_hits(n, "cpu"), False)


def _mesh_backward(s, n=4):
    miss = intersect.make_miss_hits(n, "cpu")
    cots = [getattr(miss, f).contiguous() for f in hits.FLOAT_FIELDS]
    return hits.hits_backward(*_mesh(s, n), cots, False, [True] * len(intersect.Rays._fields),
                              [True] * len(cots), [True] * len(hits.GEOMETRY), [True, True])


LAUNCHES = {
    "launch.k6": lambda s: compaction._launch(torch.tensor([True, False, True])),
    "launch.fb_scatter": lambda s: framebuffer.scatter_add(
        torch.zeros((4, 3)), torch.tensor([1, 2], dtype=torch.int32), torch.ones((2, 3))),
    "launch.k5": lambda s: sky_sample.sample_forward(
        s.sky_data, torch.nn.functional.normalize(torch.ones((4, 3)), dim=1), False),
    "launch.k10.closest": lambda s: traversal._launch(False, *_threaded(s), CFG),
    "launch.k10.any": lambda s: traversal._launch(True, *_threaded(s), CFG),
    "launch.k1": lambda s: traversal_wide._launch(False, *_wide(s), CFG),
    "launch.k2": lambda s: traversal_wide._launch(True, *_wide(s), CFG),
    **{f"launch.k3.{mode}": lambda s, mode=mode: texture_sample.sample_forward(
        *_texture(s, mode)) for mode in texture_sample.MODES},
    **{f"launch.k4.{mode}": lambda s, mode=mode: texture_sample.sample_backward(
        *_texture(s, mode), torch.ones((4, 3)), True, True, True)
       for mode in texture_sample.MODES},
    "launch.k5.bwd": lambda s: sky_sample._backward_launch(
        torch.zeros(4, dtype=torch.int32), torch.ones((4, 3)), 16),
    "launch.k7": _mesh_forward,
    "launch.k7.bwd": _mesh_backward,
    "launch.k8": lambda s: fxaa._launch(torch.zeros((4, 4, 3))),
    "launch.k9.closest": lambda s: intersect._closest_launch(s, *_wide(s)[1:3]),
    "launch.k9.any": lambda s: intersect._any_launch(s, *_wide(s)[1:]),
    "launch.shade.tex_id": lambda s: shade.tex_ids(s, intersect.make_miss_hits(4, "cpu")),
    "launch.shade.surface": lambda s: shade.surface_launch(
        s, intersect.make_miss_hits(4, "cpu"), torch.ones((4, 3)), torch.zeros((4, 3)),
        torch.ones(4, dtype=torch.bool), torch.zeros((4, 3)), None, CFG),
    "launch.shade.lights": lambda s: _shade_lights(s, torch.zeros((4, 3))),
    "launch.spawn.flags": lambda s: _parents(),
    "launch.spawn.write": lambda s: spawn.write(
        _parents(0), torch.zeros((0,), dtype=torch.int32), torch.zeros((), dtype=torch.int32),
        torch.zeros((), dtype=torch.int32)),
}


@pytest.mark.parametrize("key", list(LAUNCHES))
def test_a_launch_counts_once_under_its_key(scene, monkeypatch, key):
    """A wrapper's launch (its C entry point stubbed: the kernels build only on
    the card) adds one to its key of ``trace.counters`` and to no other."""
    _, s = scene
    monkeypatch.setattr(kernels, "entry", lambda *a: lambda *args: 0)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    # K7's contract asks for CUDA tensors: its check goes with the entry
    monkeypatch.setattr(hits, "_check", lambda what, tri, *args: tri.shape[0])
    before = dict(trace.counters)
    LAUNCHES[key](s)
    after = dict(trace.counters)
    assert after.pop(key) == before.pop(key, 0) + 1
    assert after == before
