"""K1/K2: the port's wide-BVH walks against the JAX package's trace_closest and
trace_any, on identical numpy rays: config3-tiny primaries and their shadow rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import traversal_wide as jax_tw
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu_torch.ops import traversal_wide
from torch_parity import jax_scene, jit, torch_config, torch_scene


@pytest.fixture(scope="module")
def setup():
    scene, cfg = jax_scene("config3")
    cfg = cfg.replace(visualize_heatmap=True)  # the JAX walk then tracks steps
    rays = jax_renderer.generate_primary_rays(scene, cfg)
    o, d = np.array(rays.origin), np.array(rays.direction)
    n = o.shape[0]
    t_max = np.full(n, np.inf, np.float32)
    active = np.ones(n, bool)
    jbvh = jax_tw.build_scene_bvh(scene)
    ref = jit(lambda *a: jax_tw.trace_closest(jbvh, *a, cfg))(o, d, t_max, active)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}

    # shadow rays of every light from the primary hit points (origins ON the
    # surfaces, as the renderer casts them)
    hit = ref["tri"] >= 0
    point = o + np.where(hit, ref["t"], 0.0)[:, None] * d
    dirs, dists = [], []
    for pos in np.concatenate([np.asarray(scene.pl_pos), np.asarray(scene.sl_pos)]):
        to_l = pos[None, :] - point
        dist = np.linalg.norm(to_l, axis=1)
        dirs.append(to_l / dist[:, None])
        dists.append(dist)
    for neg_dir in np.asarray(scene.dl_neg_dir):
        dirs.append(np.broadcast_to(neg_dir, point.shape))
        dists.append(np.full(n, np.inf))
    shadow = (
        np.tile(point, (len(dirs), 1)).astype(np.float32),
        np.concatenate(dirs).astype(np.float32),
        np.concatenate(dists).astype(np.float32),
        np.tile(hit, len(dirs)),
    )
    ref_found, ref_inc = jit(lambda *a: jax_tw.trace_any(jbvh, *a, cfg))(*shadow)
    return dict(
        bvh=traversal_wide.build_scene_bvh(torch_scene(scene)), cfg=torch_config(cfg),
        primary=(o, d, t_max, active), ref=ref, shadow=shadow,
        ref_found=np.asarray(ref_found), ref_any_incomplete=int(ref_inc),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_table_matches_jax(setup):
    scene, _cfg = jax_scene("config3")
    jbvh = jax_tw.build_scene_bvh(scene)
    bvh = setup["bvh"]
    assert (bvh.root, bvh.node_rows) == (jbvh.root, jbvh.node_rows)
    assert np.array_equal(bvh.table.numpy(), np.asarray(jbvh.table))
    assert np.array_equal(bvh.inst_mat.numpy(), np.asarray(jbvh.inst_mat))


def test_closest_matches_jax(setup):
    ref = setup["ref"]
    res = traversal_wide.trace_closest(setup["bvh"], *map(_t, setup["primary"]),
                                       setup["cfg"])
    tri, inst = res.tri.numpy(), res.inst.numpy()
    # XLA:CPU contracts multiply-adds into FMAs; the port (plain and CUDA) rounds
    # each operation.  A ray through the shared edge of two triangles can then
    # take the neighbour at the same t: measured 1 of 2304 lanes (t equal to
    # 5.1e-7 relative).  Such ties are allowed on <= 0.1% of lanes; steps,
    # misses and t must agree everywhere.
    differ = (tri != ref["tri"]) | (inst != ref["inst"])
    assert differ.mean() <= 1e-3, differ.sum()
    assert np.array_equal(tri >= 0, ref["tri"] >= 0)
    np.testing.assert_array_equal(res.steps.numpy(), ref["steps"])
    hit = ref["tri"] >= 0
    t = res.t.numpy()
    np.testing.assert_allclose(t[hit], ref["t"][hit], rtol=1e-6)
    assert int(res.incomplete) == 0 and int(ref["incomplete"]) == 0


def test_any_matches_jax(setup):
    found, incomplete = traversal_wide.trace_any(setup["bvh"], *map(_t, setup["shadow"]),
                                                 setup["cfg"])
    np.testing.assert_array_equal(found.numpy(), setup["ref_found"])
    assert int(incomplete) == 0 and setup["ref_any_incomplete"] == 0
    assert setup["shadow"][3].sum() > 1000  # a real shadow wavefront
