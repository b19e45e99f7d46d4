"""Made-up rays at the edges of the quantised child test (csrc/traverse.cu,
quant_kernel; ``ops/traversal_wide.py:node_bits_quantised_plain``): rays with 0
direction components, origins on child planes, rays through box corners and
edges, and rays whose t_max is a child's entry t.  Numpy only, so that the
tests of the card (which run without JAX) share them with the CPU tests."""

import numpy as np

from raytracer_tpu_torch import config

RAY_EPSILON = np.float32(config.RAY_EPSILON)


def child_boxes(rows):
    """(lo, hi) [R,8,3] of exact node rows [R,72] (component-major)."""
    rows = np.asarray(rows, np.float32)
    return (rows[:, 0:24].reshape(-1, 3, 8).transpose(0, 2, 1),
            rows[:, 24:48].reshape(-1, 3, 8).transpose(0, 2, 1))


def live_children(rows):
    """[R,8] bool: children that are not empty (kind 7) and not flat."""
    lo, hi = child_boxes(rows)
    kind = np.asarray(rows, np.float32)[:, 48:56].astype(np.int64) >> 20
    return (kind != 7) & (lo < hi).all(axis=2)


def entry_t(lo, hi, o, d):
    """[N] today's t_near of boxes (lo, hi) [N,3] for rays o, d [N,3], in float32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
        t0 = ((lo - o) * inv).astype(np.float32)
        t1 = ((hi - o) * inv).astype(np.float32)
    return np.maximum(RAY_EPSILON, np.minimum(t0, t1).max(axis=1)).astype(np.float32)


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def made_up_rays(rows, n, seed=0):
    """{set name: (row [N] int, o [N,3], d [N,3], t_max [N])}: rays aimed at live
    children of the node rows ``rows`` [R,72], in the rows' own space.

    - ``zero``: one or two direction components +0 or -0, from a child's
      planes or from inside its box;
    - ``on_plane``: origins exactly on a child's plane, towards a point of it;
    - ``corner`` / ``edge``: from outside the box through one of its corners,
      or a point of one of its edges;
    - ``t_max_entry``: t_max equal to the child's entry t (and one ulp above)."""
    rng = np.random.default_rng(seed)
    live = live_children(rows)
    r_idx, c_idx = np.nonzero(live)
    pick = rng.integers(0, r_idx.shape[0], n)
    row, child = r_idx[pick], c_idx[pick]
    lo, hi = child_boxes(rows)
    lo, hi = lo[row, child], hi[row, child]  # [N,3]
    size = (hi - lo).astype(np.float32)
    inside = (lo + rng.random((n, 3), np.float32) * size).astype(np.float32)
    corner_bits = rng.integers(0, 2, (n, 3)).astype(bool)
    corner = np.where(corner_bits, hi, lo)
    far = (np.linalg.norm(size, axis=1, keepdims=True) * 4 + 1).astype(np.float32)
    outside = (inside + _unit(rng.normal(size=(n, 3))) * far).astype(np.float32)
    axis = rng.integers(0, 3, n)
    lanes = np.arange(n)
    out = {}

    # 0 direction components: +0 or -0 on one or two axes; origins on a plane of
    # the zeroed axis (0 * inf = NaN) or inside the box
    d = _unit(rng.normal(size=(n, 3)))
    zero = np.zeros((n, 3), bool)
    zero[lanes, axis] = True
    zero[lanes, (axis + 1) % 3] |= rng.random(n) < 0.3
    d = np.where(zero, np.where(rng.random((n, 3)) < 0.5, np.float32(0.0), np.float32(-0.0)), d)
    o = outside.copy()
    plane = np.where(rng.random(n) < 0.5, lo[lanes, axis], hi[lanes, axis])
    o[lanes, axis] = np.where(rng.random(n) < 0.7, plane, inside[lanes, axis])
    out["zero"] = (row, o, d.astype(np.float32), np.full(n, np.inf, np.float32))

    # origins on a plane of the child, towards a point of the box or away
    o = inside.copy()
    o[lanes, axis] = plane
    target = np.where(rng.random((n, 1)) < 0.5, corner, outside)
    out["on_plane"] = (row, o, _unit(target - o), np.full(n, np.inf, np.float32))

    # through a corner, or a point of an edge (two coordinates on planes)
    out["corner"] = (row, outside, _unit(corner - outside), np.full(n, np.inf, np.float32))
    edge = corner.copy()
    edge[lanes, axis] = inside[lanes, axis]
    out["edge"] = (row, outside, _unit(edge - outside), np.full(n, np.inf, np.float32))

    # t_max at the child's entry t (the test t_near < min(t_max, ...) at equality)
    d = _unit(inside - outside)
    t_in = entry_t(lo, hi, outside, d)
    up = np.nextafter(t_in, np.float32(np.inf)).astype(np.float32)
    out["t_max_entry"] = (row, outside, d, np.where(rng.random(n) < 0.5, t_in, up))
    return out
