"""The wide walk's stack bound (``accel/wide.py:stack_bound``): the most entries
any ray's walk of an 8-wide BVH can push, which the walk's stack holds by default
(``RenderConfig.wide_stack_size=None``), so that no ray is lost.

The bound against a brute-force enumeration of root-to-leaf paths; a "deep"
scene whose bound exceeds 16, where a 16-entry stack loses rays and the default
loses none, its hits held to a brute-force loop over every triangle; a scene
beyond the walk's capacity refused at pack time; a BLAS cache written without the
bound.  Plain PyTorch on the CPU; the kernels on this scene are
``tests/test_torch_kernels_gpu.py``'s.  No JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.accel import blas as blas_mod
from raytracer_tpu_torch.accel import wide
from raytracer_tpu_torch.config import MeshAccelerator, RenderConfig
from raytracer_tpu_torch.ops import traversal_wide
from raytracer_tpu_torch.render.renderer import Renderer
from raytracer_tpu_torch.scene import description, meshgen
from raytracer_tpu_torch.scene.device import ScenePacker
from raytracer_tpu_torch.scene.tensors import scene_from_numpy

SIZE = 16  # the deep scene's view: SIZE x SIZE pixels


def _tree(children):
    """A WideBVH of ``children``: per node, a list of "n<k>" (internal node k),
    "l" (a leaf record) or "i<k>" (an instance entry of instance k); the other
    slots empty."""
    w = len(children)
    kind = np.full((w, 8), wide.KIND_EMPTY, np.int32)
    payload = np.zeros((w, 8), np.int32)
    fbs = np.zeros((w, 8), np.int32)
    for n, slots in enumerate(children):
        for j, c in enumerate(slots):
            if c == "l":
                kind[n, j], payload[n, j] = wide.KIND_LEAF, 0
            elif c[0] == "n":
                kind[n, j], payload[n, j] = wide.KIND_INTERNAL, int(c[1:])
            else:
                kind[n, j], payload[n, j], fbs[n, j] = wide.KIND_INTERNAL, 0, int(c[1:]) + 1
    box = np.zeros((w, 8, 3), np.float32)
    return wide.WideBVH(child_min=box, child_max=box + 1, child_kind=kind,
                        child_payload=payload, child_fb=fbs,
                        order=np.tile(np.arange(8, dtype=np.int8), (8, w, 1)), depth=0)


def _brute(children, node=0, entry=()):
    """The largest sum of (children - 1) over root-to-leaf paths, by enumeration."""
    slots = children[node]
    own = max(len(slots) - 1, 0)
    below = [0]
    for c in slots:
        if c[0] == "n":
            below.append(_brute(children, int(c[1:]), entry))
        elif c[0] == "i":
            below.append(entry[int(c[1:])])
    return own + max(below)


BLAS_A = [["n1", "l", "n2"], ["l"] * 8, ["l", "n3"], ["l"] * 5]  # 2 + 7
BLAS_B = [["l", "l", "n1"], ["n2", "l", "l", "l"], ["l"] * 6]  # 2 + 3 + 5
TLAS = [["n1", "i0"], ["i1", "i2", "i0"]]  # instances 0, 2 of A, 1 of B


def test_bound_of_hand_built_trees_is_the_longest_path():
    rng = np.random.default_rng(7)
    trees = [BLAS_A, BLAS_B, [["l"]], [["l"] * 8]]
    for _ in range(20):  # random trees: each node's children point deeper
        w = int(rng.integers(1, 12))
        trees.append([[("n%d" % int(rng.integers(k + 1, w))) if k + 1 < w and rng.random() < 0.3
                       else "l" for _ in range(int(rng.integers(1, 9)))] for k in range(w)])
    for t in trees:
        assert wide.stack_bound(_tree(t)) == _brute(t)
    a, b = wide.stack_bound(_tree(BLAS_A)), wide.stack_bound(_tree(BLAS_B))
    assert (a, b) == (9, 10)
    inst = [a, b, a]
    assert wide.stack_bound(_tree(TLAS), inst) == _brute(TLAS, entry=inst) == 1 + 2 + 10
    with pytest.raises(ValueError):  # instance entries need their BLASes' bounds
        wide.stack_bound(_tree(TLAS))


def _mesh(n):
    """``n`` large triangles stacked along +z, each the lower-left half of a
    square far wider than the view: every ray crosses every box, and the rays
    of the upper-right half miss every triangle, so they walk the whole tree."""
    z = 2.0 + 0.01 * np.arange(n)
    zero = np.zeros(n)
    p0 = np.stack([zero - 50.0, zero - 50.0, z], 1)
    p1 = np.stack([zero + 50.0, zero - 50.0, z + 0.005], 1)
    p2 = np.stack([zero - 50.0, zero + 50.0, z + 0.005], 1)
    nrm = np.tile([0.0, 0.0, -1.0], (n, 1))
    uv = np.zeros((n, 2))
    return meshgen.MeshData(p0, p1, p2, nrm, nrm, nrm, uv, uv, uv, np.zeros(n, np.int32),
                            [description.Material()])


def deep_scene(device="cpu", n=700):
    """(packed scene as tensors on ``device``, primary rays (o, d)) of ``n``
    stacked triangles seen by a SIZE x SIZE camera; the stack bound exceeds 16."""
    desc = description.SceneDescription(camera_fov_deg=60.0)
    desc.set_sky(np.full((16, 3), 0.3, np.float32), 4)
    desc.register_blas("deep", blas_mod.build_blas(_mesh(n), MeshAccelerator.BVH,
                                                   cache_dir=None))
    desc.add_instance("deep", (0.0, 0.0, 0.0))
    desc.camera.position = np.array([0.0, 0.0, 0.0])
    scene = scene_from_numpy(ScenePacker(desc, SIZE, SIZE).frame()._asdict(), device)
    cam = (scene.cam_top_left, scene.cam_x, scene.cam_y)
    j, i = torch.meshgrid(torch.arange(SIZE, device=device), torch.arange(SIZE, device=device),
                          indexing="ij")
    u = ((i.reshape(-1) + 0.5) / SIZE)[:, None]
    v = ((j.reshape(-1) + 0.5) / SIZE)[:, None]
    d = torch.nn.functional.normalize(cam[0] + u * cam[1] + v * cam[2], dim=1)
    o = scene.cam_pos.expand_as(d).contiguous()
    return scene, o, d.contiguous()


def brute_force(scene, o, d, t_max):
    """(t, triangle, found) of every ray against every packed triangle: the walk's
    Moller-Trumbore test in float32, the least t and the earliest triangle on a tie."""
    e1, e2 = scene.tr_e1[None], scene.tr_e2[None]
    dd, oo = d[:, None], o[:, None]
    h = torch.cross(dd.expand(-1, e2.shape[1], -1), e2.expand(dd.shape[0], -1, -1), dim=2)
    a = (e1 * h).sum(2)
    f = 1.0 / torch.where(a.abs() < 1e-30, 1e-30, a)
    s = oo - scene.tr_p0[None]
    u = f * (s * h).sum(2)
    q = torch.cross(s, e1.expand(s.shape[0], -1, -1), dim=2)
    v = f * (dd * q).sum(2)
    t = f * (e2 * q).sum(2)
    hit = (u > 0) & (u < 1) & (v > 0) & (u + v < 1) & (t > 0.005) & (t < t_max[:, None])
    t = torch.where(hit, t, torch.inf)
    tmin, tri = t.min(dim=1)
    return tmin, torch.where(hit.any(1), tri, -1), hit.any(1)


@pytest.fixture(scope="module")
def deep():
    return deep_scene()


def test_deep_scene_loses_rays_at_16_and_none_at_its_bound(deep):
    scene, o, d = deep
    bvh = traversal_wide.build_scene_bvh(scene)
    assert bvh.stack_bound == scene.stack_bound > 16
    n = o.shape[0]
    active = torch.ones(n, dtype=torch.bool)
    far = torch.full((n,), torch.inf)
    spread = torch.linspace(2.0, 12.0, n)  # shadow rays of many lengths
    for any_hit, t_max in ((False, far), (True, spread)):
        lossy = traversal_wide.trace_plain(bvh, o, d, t_max, active, 16, True, any_hit)
        assert int(lossy.incomplete) > 0  # the test bites
        w = traversal_wide.trace_plain(bvh, o, d, t_max, active, None, True, any_hit)
        assert int(w.incomplete) == 0
        t, tri, found = brute_force(scene, o, d, t_max)
        if any_hit:
            assert torch.equal(w.found, found)
        else:
            assert torch.equal(w.t, torch.where(found, t, t_max))
            assert torch.equal(torch.where(w.best >= 0, w.best >> 8, -1), tri)
        assert 0 < int(found.sum()) < n  # some rays hit, the rest walk the whole tree


def test_deep_scene_renders_lossless_by_default(deep):
    scene, *_ = deep
    cfg = RenderConfig(width=SIZE, height=SIZE, num_bounces=0)
    assert cfg.wide_stack_size is None
    _, stats = Renderer(cfg, device="cpu")(scene)
    assert int(stats.num_incomplete) == 0 and int(stats.num_primary) == SIZE * SIZE
    _, stats = Renderer(cfg.replace(wide_stack_size=16), device="cpu")(scene)
    assert int(stats.num_incomplete) > 0  # a set size is honoured, and counted


def test_a_scene_beyond_the_walks_capacity_is_refused_at_pack():
    """The scene's bound is the TLAS's (instances - 1 for one root) plus the
    largest BLAS bound: 1 + 127 fits the 128-entry walk, 2 + 127 does not."""
    b = blas_mod.build_blas(meshgen.icosphere(1.0, 0), MeshAccelerator.BVH, cache_dir=None)
    big = dataclasses.replace(b, wide_stack_bound=np.int64(wide.STACK_CAPACITY - 1))
    desc = description.SceneDescription()
    desc.set_sky(np.full((16, 3), 0.3, np.float32), 4)
    desc.register_blas("big", big)
    for x in (-3.0, 3.0):
        desc.add_instance("big", (x, 0.0, 5.0))
    assert ScenePacker(desc, 8, 8).frame().stack_bound == wide.STACK_CAPACITY
    desc.add_instance("big", (0.0, 3.0, 5.0))
    with pytest.raises(ValueError, match=str(wide.STACK_CAPACITY + 1)):
        ScenePacker(desc, 8, 8).frame()


def test_a_cached_blas_without_the_bound_computes_it(tmp_path):
    mesh = meshgen.icosphere(1.0, 1)
    blas_mod.clear_cache()
    b = blas_mod.build_blas(mesh, MeshAccelerator.BVH, cache_dir=str(tmp_path))
    assert b.stack_bound == wide.stack_bound(b.wide) > 0
    (path,) = tmp_path.glob("*.npz")
    with np.load(path) as data:
        old = {k: data[k] for k in data.files if k != "wide_stack_bound"}
    np.savez(path, **old)
    blas_mod.clear_cache()
    loaded = blas_mod.build_blas(mesh, MeshAccelerator.BVH, cache_dir=str(tmp_path))
    blas_mod.clear_cache()
    assert loaded.stack_bound == b.stack_bound
