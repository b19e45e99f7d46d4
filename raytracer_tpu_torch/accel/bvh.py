"""Host-side SAH BVH builder (vectorized numpy).

Reproduces the reference's full-sweep SAH construction: per node, sweep every split
position along all three (pre-sorted) axes accumulating prefix/suffix bounds, take the
cheapest, terminate on ``split_cost >= surface_area(parent) * count`` or count < 3, and
re-partition the other two sorted index arrays stably (BVHBuilders.h:8-46,
BVHPartitions.h:76-114, BVHPartitions.h:27-73).  The per-object inner loops become
``np.minimum.accumulate`` sweeps; the reference's equal-coordinate tie-break scan
(BVHPartitions.h:38-56) is realized exactly by a membership lookup table over primitive
ids of the split-dimension partition.

Node layout (BVHNode.h:10-17 re-laid-out as SoA):
  - node 0 is the root, node 1 is padding (children always allocated in pairs starting
    at index 2, matching ``node_count = 2`` in BottomLevelBVH.cpp:94)
  - internal: ``left`` = index of left child (right = left + 1), ``count`` = 0,
    ``axis`` in {0,1,2} (the reference packs axis into count's top bits)
  - leaf: ``first``/``count`` reference a contiguous range of the leaf-ordered
    primitive permutation (the ``flatten()`` post-pass, BottomLevelBVH.cpp:196-212)
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _surface_area(mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    d = maxs - mins
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


@dataclasses.dataclass
class BVH:
    """Built BVH in SoA form, ready for device upload."""

    node_min: np.ndarray  # [M,3] float32
    node_max: np.ndarray  # [M,3] float32
    node_left: np.ndarray  # [M] int32: left child (internal) / first prim (leaf)
    node_count: np.ndarray  # [M] int32: 0 for internal, prim count for leaf
    node_axis: np.ndarray  # [M] int32: split axis for ordered traversal
    prim_order: np.ndarray  # [P] int32: leaf-ordered primitive permutation

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]

    def sah_cost(self) -> float:
        """Total SAH cost (for builder regression tests)."""
        root_sa = _surface_area(self.node_min[0], self.node_max[0])
        sa = _surface_area(self.node_min, self.node_max)
        is_leaf = self.node_count > 0
        c_t, c_i = 1.2, 1.0
        internal = np.sum(sa[2:][~is_leaf[2:]]) * c_t
        leaves = np.sum((sa * self.node_count)[is_leaf]) * c_i
        return float((internal + leaves) / max(root_sa, 1e-30) + c_t)


def build_bvh(
    prim_mins: np.ndarray,
    prim_maxs: np.ndarray,
    centroids: np.ndarray | None = None,
    force_split: bool = False,
    fix_epsilon: float = 0.001,
) -> BVH:
    """Build a SAH BVH over primitive AABBs.

    force_split=True builds down to single-primitive leaves regardless of the SAH
    termination test — used for the top-level BVH so instance leaves are singletons.
    """
    prim_mins = np.asarray(prim_mins, dtype=np.float64)
    prim_maxs = np.asarray(prim_maxs, dtype=np.float64)
    n = prim_mins.shape[0]
    assert n > 0
    if centroids is None:
        centroids = 0.5 * (prim_mins + prim_maxs)
    centroids = np.asarray(centroids, dtype=np.float64)

    # Three axis-sorted index arrays (BottomLevelBVH.cpp:82-88), partitioned in place.
    orders = np.stack(
        [np.argsort(centroids[:, d], kind="stable").astype(np.int64) for d in range(3)]
    )

    max_nodes = max(2 * n, 4)
    node_min = np.zeros((max_nodes, 3), np.float64)
    node_max = np.zeros((max_nodes, 3), np.float64)
    node_left = np.zeros((max_nodes,), np.int64)
    node_count = np.zeros((max_nodes,), np.int64)
    node_axis = np.zeros((max_nodes,), np.int64)

    node_counter = [2]
    in_left = np.zeros((n,), bool)  # reusable membership scratch (replaces temp[])

    stack = [(0, 0, n)]
    while stack:
        node, first, count = stack.pop()
        ids = orders[0, first : first + count]
        bmin = prim_mins[ids].min(axis=0)
        bmax = prim_maxs[ids].max(axis=0)
        # fix_if_needed: inflate degenerate axes (AABB.h:26-32)
        degen = bmax - bmin < fix_epsilon
        bmin = np.where(degen, bmin - 0.5 * fix_epsilon, bmin)
        bmax = np.where(degen, bmax + 0.5 * fix_epsilon, bmax)
        node_min[node] = bmin
        node_max[node] = bmax

        def make_leaf():
            node_left[node] = first
            node_count[node] = count

        if count < 3 and not force_split:
            make_leaf()
            continue
        if count == 1:
            make_leaf()
            continue

        # Full-sweep SAH across all three axes (BVHPartitions.h:76-114).
        best_cost = np.inf
        best_axis = -1
        best_k = -1
        for d in range(3):
            ids_d = orders[d, first : first + count]
            bmins = prim_mins[ids_d]
            bmaxs = prim_maxs[ids_d]
            lmin = np.minimum.accumulate(bmins, axis=0)
            lmax = np.maximum.accumulate(bmaxs, axis=0)
            rmin = np.minimum.accumulate(bmins[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmaxs[::-1], axis=0)[::-1]
            k = np.arange(1, count)
            cost = _surface_area(lmin[:-1], lmax[:-1]) * k + _surface_area(
                rmin[1:], rmax[1:]
            ) * (count - k)
            # middle-biased tie-break: co-located clusters tie every split cost;
            # a balanced choice keeps the tree O(log n) deep instead of an n-chain
            cmin = float(np.min(cost))
            ties = np.nonzero(cost == cmin)[0]
            i = int(ties[np.argmin(np.abs(2 * (ties + 1) - count))])
            if cmin < best_cost or (
                cmin == best_cost
                and abs(2 * (i + 1) - count) < abs(2 * best_k - count)
            ):
                best_cost = cmin
                best_axis = d
                best_k = i + 1  # prims in the left child

        # SAH termination: leaf when splitting is not cheaper than the parent
        # (BVHBuilders.h:27-34) — capped so giant co-located leaves can't serialize
        # the wavefront leaf cursor.
        parent_cost = _surface_area(bmin, bmax) * count
        if best_cost >= parent_cost and count <= 8 and not force_split:
            make_leaf()
            continue

        left = node_counter[0]
        node_counter[0] += 2
        node_left[node] = left
        node_count[node] = 0
        node_axis[node] = best_axis

        #

        # Stable 3-axis re-partition via membership of the split-dimension left block
        # (BVHPartitions.h:27-73 incl. the equal-coordinate tie-break).
        left_ids = orders[best_axis, first : first + best_k]
        in_left[left_ids] = True
        for d in range(3):
            if d == best_axis:
                continue
            arr = orders[d, first : first + count]
            m = in_left[arr]
            orders[d, first : first + count] = np.concatenate([arr[m], arr[~m]])
        in_left[left_ids] = False

        # Push right first so left is processed next (DFS order, BVHBuilders.h:44-45).
        stack.append((left + 1, first + best_k, count - best_k))
        stack.append((left, first, best_k))

    m = node_counter[0]
    return BVH(
        node_min=node_min[:m].astype(np.float32),
        node_max=node_max[:m].astype(np.float32),
        node_left=node_left[:m].astype(np.int32),
        node_count=node_count[:m].astype(np.int32),
        node_axis=node_axis[:m].astype(np.int32),
        prim_order=orders[0].astype(np.int32),
    )


def triangle_bounds(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray):
    """Per-triangle AABBs and centroids (Triangle.h:10-27: centroid = mean of
    vertices)."""
    mins = np.minimum(np.minimum(p0, p1), p2)
    maxs = np.maximum(np.maximum(p0, p1), p2)
    centroids = (p0 + p1 + p2) / 3.0
    return mins, maxs, centroids
