"""Tensor-parallel scene sharding in the port (``parallel/scene_shard.py``):
triangle geometry split over `sp`, pixels over `dp`.  The host packing is held
field for field to the JAX package's ``ShardedScenePacker``; two gloo ranks on
the CPU (dp=1 x sp=2) render and train on the two shards, and the combined
results must match the port's single-process render of the whole scene, as
``tests/test_scene_shard.py`` holds the JAX package to its own.

The ranks are spawned once for the file (``shard_group``) by
``test_torch_parallel.spawn_group``; JAX is imported only inside the tests.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.accel import wide
from raytracer_tpu_torch.accel.blas import build_blas
from raytracer_tpu_torch.config import RenderConfig, TextureSampleMode
from raytracer_tpu_torch.parallel.scene_shard import ShardedScenePacker, pad_blas, split_mesh
from raytracer_tpu_torch.scene import meshgen
from raytracer_tpu_torch.scene.device import ScenePacker, quantised_fields
from test_torch_parallel import seeded_target, spawn_group, stat_dict

CFG = RenderConfig(width=48, height=32, num_bounces=1,
                   texture_sample_mode=TextureSampleMode.BILINEAR)
QUANTISED = ("wq_rec", "wtq_rec")
PORT_ONLY = (*QUANTISED, "stack_bound")  # packed by the port alone


def mesh_scene(desc_mod, meshgen_mod, blas_mod):
    """``tests/test_scene_shard.py:_mesh_scene`` from the given package's modules:
    an icosphere and a reflective torus over a plane, one point light."""
    desc = desc_mod.SceneDescription(camera_fov_deg=90.0)
    desc.set_sky(np.full((16, 3), 0.35, np.float32), 4)
    p = desc.add_plane((0.0, -1.2, 0.0))
    desc.material(p).diffuse = np.array([0.5, 0.5, 0.5])
    ico = meshgen_mod.icosphere(1.0, 2)
    ico.materials[0].diffuse = np.array([0.7, 0.4, 0.2])
    desc.register_blas("ico", blas_mod.build_blas(ico))
    desc.mesh_sources["ico"] = ico
    torus = meshgen_mod.torus(1.0, 0.35, 24, 12)
    torus.materials[0].diffuse = np.array([0.2, 0.5, 0.7])
    torus.materials[0].reflection = np.array([0.25, 0.25, 0.25])
    desc.register_blas("torus", blas_mod.build_blas(torus))
    desc.mesh_sources["torus"] = torus
    desc.add_instance("ico", (-1.4, 0.3, 5.0))
    desc.add_instance("torus", (1.5, 0.2, 5.5))
    desc.point_lights.append(
        desc_mod.PointLight(np.array([30.0, 28.0, 25.0]), np.array([2.0, 6.0, 1.0])))
    desc.camera.position = np.array([0.0, 0.8, 0.0])
    return desc


def port_scene():
    from raytracer_tpu_torch.accel import blas
    from raytracer_tpu_torch.scene import description

    return mesh_scene(description, meshgen, blas)


@pytest.fixture(scope="module")
def packed():
    """(the whole scene, the two shard scenes), packed by the port."""
    from torch_parity import private_bvh_cache

    with private_bvh_cache():
        desc = port_scene()
        whole = ScenePacker(desc, CFG.width, CFG.height).frame()
        shards = ShardedScenePacker(desc, CFG, 2).frame()
    return whole, shards


# --------------------------------------------------------------- the ranks


def _trace_counts(renderer):
    """Wrap the renderer's two traces and K6's compaction: count the traces and
    keep each generation's queue (its pixels), in calls order."""
    seen = {"closest": 0, "any": 0, "queues": []}
    trace_scene, intersect_scene, compact = (renderer.trace_scene, renderer.intersect_scene,
                                             renderer._compact)

    def closest(*a, **kw):
        seen["closest"] += 1
        return trace_scene(*a, **kw)

    def any_hit(*a, **kw):
        seen["any"] += 1
        return intersect_scene(*a, **kw)

    def queue(cand):
        gen = compact(cand)
        seen["queues"].append(gen.pixel.numpy().copy())
        return gen

    def combine(*a, **kw):
        hits, incomplete = combine_hits(*a, **kw)
        # the CUDA kernels that read the combined record index flat memory
        seen["contiguous"] &= all(x.is_contiguous() for x in hits)
        return hits, incomplete

    combine_hits = renderer._combine_hits_over_shards
    seen["contiguous"] = True
    renderer.trace_scene, renderer.intersect_scene, renderer._compact = closest, any_hit, queue
    renderer._combine_hits_over_shards = combine
    return seen


def _shard_rank(rank, whole_fields, shard_fields, cfg_fields):
    from raytracer_tpu_torch.diff import train
    from raytracer_tpu_torch.parallel import collectives
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.scene_shard import make_primitive_sharded_renderer
    from raytracer_tpu_torch.render import renderer
    from raytracer_tpu_torch.scene.tensors import scene_from_numpy

    cfg = RenderConfig(**cfg_fields)
    mesh = make_mesh((1, 2), device_type="cpu")
    sp_rank = mesh.get_local_rank("sp")
    scene = scene_from_numpy(shard_fields[sp_rank], device="cpu")
    whole = scene_from_numpy(whole_fields, device="cpu")
    out = {"sp_rank": sp_rank}

    seen = _trace_counts(renderer)
    for walk in ("wide", "threaded"):
        wcfg = cfg.replace(traversal_kernel=walk)
        collectives.reset()
        seen.update(closest=0, any=0, queues=[])
        img, stats = make_primitive_sharded_renderer(wcfg, mesh)(scene)
        out[walk] = dict(image=img.numpy(), stats=stat_dict(stats),
                         counts=dict(collectives.counts), closest=seen["closest"],
                         any=seen["any"], queues=list(seen["queues"]),
                         contiguous=seen["contiguous"])
        with torch.no_grad():
            single, sstats = renderer.render_with_stats(whole, wcfg)
        out[walk].update(single=single.numpy(), single_stats=stat_dict(sstats))

    # one tensor-parallel step against make_train_step's on the whole scene
    target = torch.from_numpy(seeded_target(cfg))
    init, step = train.make_tensor_parallel_train_step(cfg, mesh)
    params, opt = init(scene)
    collectives.reset()
    seen.update(closest=0, any=0, queues=[])
    _, _, loss = step(params, opt, scene, target)
    out["step"] = dict(loss=float(loss), grads={k: p.grad.numpy().copy()
                                                 for k, p in params.items()},
                       counts=dict(collectives.counts), closest=seen["closest"],
                       any=seen["any"])
    init1, step1 = train.make_train_step(cfg)
    params1, opt1 = init1(whole)
    _, _, loss1 = step1(params1, opt1, whole, target)
    out["single_step"] = (float(loss1), {
        k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
        for k, p in params1.items()})
    return out


@pytest.fixture(scope="module")
def shard_group(packed, tmp_path_factory):
    whole, shards = packed
    return spawn_group(_shard_rank, 2, tmp_path_factory.mktemp("shard_group"),
                       whole._asdict(), [s._asdict() for s in shards],
                       {f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


# ------------------------------------------------------------------- tests


def test_split_mesh_partitions():
    ico = meshgen.icosphere(1.0, 2)
    parts = split_mesh(ico, 4)
    assert sum(p.triangle_count for p in parts) == ico.triangle_count
    sizes = [p.triangle_count for p in parts]
    assert max(sizes) - min(sizes) <= 1

    def vol(m):
        pts = np.concatenate([m.p0, m.p1, m.p2])
        d = pts.max(0) - pts.min(0)
        return float(np.prod(np.maximum(d, 1e-6)))

    assert sum(vol(p) for p in parts) < 2.5 * vol(ico)


def test_shard_scenes_match_jax_packer(packed):
    """Each port shard scene equals the JAX ``ShardedScenePacker``'s shard,
    field for field; the quantised records are those derived from it."""
    from raytracer_tpu.accel import blas as jax_blas
    from raytracer_tpu.config import RenderConfig as JaxConfig
    from raytracer_tpu.parallel.scene_shard import ShardedScenePacker as JaxSharded
    from raytracer_tpu.scene import description as jax_desc
    from raytracer_tpu.scene import meshgen as jax_meshgen
    from torch_parity import private_bvh_cache

    with private_bvh_cache():
        desc = mesh_scene(jax_desc, jax_meshgen, jax_blas)
        stack = JaxSharded(desc, JaxConfig(width=CFG.width, height=CFG.height), 2).frame()
    ref = {k: np.asarray(v) for k, v in stack._asdict().items()}
    _, shards = packed
    for s, shard in enumerate(shards):
        ours = shard._asdict()
        assert [k for k in ours if k not in PORT_ONLY] == list(ref)
        for k, v in ref.items():
            got = np.asarray(ours[k])
            assert got.dtype == v.dtype and np.array_equal(got, v[s]), (s, k)
        derived = quantised_fields({k: v[s] for k, v in ref.items()})
        for k in QUANTISED:
            assert np.array_equal(ours[k], derived[k]), (s, k)
        assert ours["stack_bound"] == wide.records_stack_bound(ref["wd_rec"][s],
                                                               ref["wt_rec"][s]), s
    # congruent: every field has one shape across the shards
    for k in shards[0]._fields:
        assert np.shape(getattr(shards[0], k)) == np.shape(getattr(shards[1], k)), k


def test_padded_rows_quantise_to_empty_nodes():
    """``pad_blas``'s zero rows decode as nodes with no live child
    (``quantised_records`` byte 15, the live mask); the rows before them are
    unchanged."""
    b = build_blas(meshgen.icosphere(1.0, 2), cache_dir=None)
    n_wide = b.wide_child_min.shape[0]
    p = pad_blas(b, b.node_min.shape[0] + 5, n_wide + 3, b.triangle_count + 8)

    def quantised(x):
        live = wide.leaf_live_counts(x.tri_p0, x.tri_e1, x.tri_e2)
        q = wide.quantised_records(wide.octant_records(x.wide), live)
        return q.view(np.uint8).reshape(8, -1, 128)

    qb, qp = quantised(b), quantised(p)
    assert qp.shape[1] == n_wide + 3
    assert np.array_equal(qp[:, :n_wide], qb)
    assert not qp[:, n_wide:, 15].any()
    # and the padded TLAS rows of the shard packer (zero wt_rec rows)
    zero = wide.quantised_records(np.zeros((8, 2, 72), np.float32))
    assert not zero.view(np.uint8).reshape(8, 2, 128)[..., 15].any()


@pytest.mark.parametrize("walk", ["wide", "threaded"])
def test_scene_sharded_render_matches_single(shard_group, walk):
    """Mismatch fraction < 1e-3 at 1e-5 (hits are min-t combined from identical
    triangle tests), no incomplete ray, primary and shadow counts equal."""
    for r in shard_group:
        got = r[walk]
        mism = np.abs(got["image"] - got["single"]) > 1e-5
        assert mism.mean() < 1e-3, mism.mean()
        assert got["stats"]["num_incomplete"] == 0
        assert got["contiguous"]  # every field of every combined record
        for k in ("num_primary", "num_shadow", "num_reflection", "num_refraction"):
            assert got["stats"][k] == got["single_stats"][k], k
    assert np.array_equal(shard_group[0][walk]["image"], shard_group[1][walk]["image"])


def test_sp_members_compact_to_the_same_queues(shard_group):
    """Shading after the combine is the same on every sp member, so K6 gives
    every member the same queue, lane for lane, in every generation."""
    a, b = shard_group
    assert a["sp_rank"] != b["sp_rank"]
    for walk in ("wide", "threaded"):
        qa, qb = a[walk]["queues"], b[walk]["queues"]
        assert len(qa) == len(qb) >= 1
        for x, y in zip(qa, qb):
            assert np.array_equal(x, y)
        assert a[walk]["stats"] == b[walk]["stats"]


def test_tensor_parallel_step_matches_single(shard_group):
    """Loss within 1e-5, gradients within rtol 2e-4 / atol 2e-6 of
    ``make_train_step``'s on the whole scene (``tests/test_scene_shard.py``'s
    bounds)."""
    for r in shard_group:
        loss1, grads1 = r["single_step"]
        np.testing.assert_allclose(r["step"]["loss"], loss1, rtol=1e-5)
        for k, want in grads1.items():
            np.testing.assert_allclose(r["step"]["grads"][k], want, rtol=2e-4, atol=2e-6,
                                       err_msg=f"grad mismatch for {k}")


def test_collectives_per_generation_only(shard_group):
    """The scene-sharded frame gathers once a closest-hit trace (the hit-record
    combine) plus the image, and all-reduces once an any-hit trace plus the
    counters; the tensor-parallel step adds, in its backward, one
    reduce-scatter a gather (the gather's transpose) and one all-reduce for
    the loss and gradients.  Nothing else communicates."""
    for r in shard_group:
        for walk in ("wide", "threaded"):
            got = r[walk]
            assert got["closest"] == 2 and got["any"] == 2  # two generations
            assert got["counts"] == {"all_gather": got["closest"] + 1,
                                     "all_reduce": got["any"] + 1, "reduce_scatter": 0}
        step = r["step"]
        assert step["counts"] == {"all_gather": step["closest"],
                                  "all_reduce": step["any"] + 1,
                                  "reduce_scatter": step["closest"]}
