"""K1/K2 and K10: the port's wide-BVH walks and its threaded binary walks (ORDERED
and NAIVE) against the JAX package's trace_closest and trace_any of the same
kind, on identical numpy rays: config3-tiny primaries and their shadow rays."""

import numpy as np
import pytest
import torch

from raytracer_tpu.config import TraversalStrategy
from raytracer_tpu.ops import traversal as jax_threaded
from raytracer_tpu.ops import traversal_wide as jax_tw
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu_torch.ops import traversal, traversal_wide
from torch_parity import jax_scene, jit, torch_config, torch_scene

# The JAX threaded walk runs a straggler ladder; one round of 1,024 steps covers
# every ray here (asserted: its incomplete count is 0) and compiles in a third
# of the default four rounds' time.  The rounds do not change what a walk finds.
THREADED_ROUNDS = ((1.0, 1024),)


def _setup(jax_module, port_module, any_hit=True, **changes):
    """Reference walks of ``jax_module`` on config3-tiny's primaries and (with
    ``any_hit``) their shadow rays, and the inputs for the port's ``port_module``."""
    scene, cfg = jax_scene("config3")
    # the JAX walk tracks steps under the heatmap
    cfg = cfg.replace(visualize_heatmap=True, **changes)
    rays = jax_renderer.generate_primary_rays(scene, cfg)
    o, d = np.array(rays.origin), np.array(rays.direction)
    n = o.shape[0]
    t_max = np.full(n, np.inf, np.float32)
    active = np.ones(n, bool)
    jbvh = jax_module.build_scene_bvh(scene)
    ref = jit(lambda *a: jax_module.trace_closest(jbvh, *a, cfg))(o, d, t_max, active)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    out = dict(module=port_module, bvh=port_module.build_scene_bvh(torch_scene(scene)),
               cfg=torch_config(cfg), primary=(o, d, t_max, active), ref=ref)
    if not any_hit:
        return out

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
    ref_found, ref_inc = jit(lambda *a: jax_module.trace_any(jbvh, *a, cfg))(*shadow)
    return dict(out, shadow=shadow, ref_found=np.asarray(ref_found),
                ref_any_incomplete=int(ref_inc))


@pytest.fixture(scope="module")
def setup():
    return _setup(jax_tw, traversal_wide)


def _threaded(strategy, any_hit=True):
    return _setup(jax_threaded, traversal, any_hit, traversal_kernel="threaded",
                  traversal_rounds=THREADED_ROUNDS, traversal_strategy=strategy)


@pytest.fixture(scope="module")
def threaded():
    return _threaded(TraversalStrategy.ORDERED)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_table_matches_jax(setup):
    scene, _cfg = jax_scene("config3")
    jbvh = jax_tw.build_scene_bvh(scene)
    bvh = setup["bvh"]
    assert (bvh.root, bvh.node_rows) == (jbvh.root, jbvh.node_rows)
    assert np.array_equal(bvh.table.numpy(), np.asarray(jbvh.table))
    assert np.array_equal(bvh.inst_mat.numpy(), np.asarray(jbvh.inst_mat))


def _closest_matches_jax(setup):
    ref = setup["ref"]
    res = setup["module"].trace_closest(setup["bvh"], *map(_t, setup["primary"]),
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


def _any_matches_jax(setup):
    found, incomplete = setup["module"].trace_any(setup["bvh"], *map(_t, setup["shadow"]),
                                                  setup["cfg"])
    np.testing.assert_array_equal(found.numpy(), setup["ref_found"])
    assert int(incomplete) == 0 and setup["ref_any_incomplete"] == 0
    assert setup["shadow"][3].sum() > 1000  # a real shadow wavefront


def test_closest_matches_jax(setup):
    _closest_matches_jax(setup)


def test_any_matches_jax(setup):
    _any_matches_jax(setup)


def test_threaded_closest_matches_jax(threaded):
    """K10 closest hit: the checks of the wide walk (measured: ids, steps and
    misses equal on every lane)."""
    _closest_matches_jax(threaded)


def test_threaded_any_matches_jax(threaded):
    _any_matches_jax(threaded)


def test_threaded_naive_closest_matches_jax():
    """K10 closest hit under NAIVE (octant 0's links for every ray): the same
    hits, another visit order; steps against JAX's NAIVE walk."""
    _closest_matches_jax(_threaded(TraversalStrategy.NAIVE, any_hit=False))


def test_threaded_table_matches_jax():
    """The threaded arrays hold JAX's fused records' fields: per octant, each
    node's box, left, kind | count << 2 and links; the instance matrices and
    roots; the triangle pairs."""
    scene, _cfg = jax_scene("config3")
    j = jax_threaded.build_scene_bvh(scene)
    b = traversal.build_scene_bvh(torch_scene(scene))
    u = b.n_nodes
    rec = np.asarray(j.oct_rec).reshape(8, u, 12)
    np.testing.assert_array_equal(rec[0, :, :6], b.box.numpy())
    node = b.node.numpy()
    np.testing.assert_array_equal(rec[0, :, 6], node[:, 0])
    np.testing.assert_array_equal(rec[0, :, 7], node[:, 1] | (node[:, 2] << 2))
    np.testing.assert_array_equal(rec[:, :, 8:10], b.links.numpy())
    np.testing.assert_array_equal(np.asarray(j.inst_mat), b.inst_mat.numpy())
    np.testing.assert_array_equal(np.asarray(j.inst_root), b.inst_root.numpy())
    np.testing.assert_array_equal(np.asarray(j.tri_rec).reshape(-1, 9), b.tri.numpy())
