"""Bottom-level acceleration structure: build + flatten + disk cache.

The reference builds a per-mesh SBVH once, serializes it beside the asset as
``<mesh>.obj.bvh`` (BottomLevelBVH.cpp:149-192), keeps a filename-keyed in-memory cache
for instancing (BottomLevelBVH.cpp:16-22), and flattens triangles into leaf order to
drop the index indirection (BottomLevelBVH.cpp:196-212).  We do the same with a
content-hash-keyed npz cache: triangles are stored SoA as vertex-0 + edge vectors (hot)
and normal/texcoord edges + local material id (cold), exactly the layout of
TriangleHot/TriangleCold (BottomLevelBVH.h:6-22).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from ..config import MeshAccelerator
from ..scene.meshgen import MeshData
from .bvh import BVH, build_bvh, triangle_bounds

_BUILDER_VERSION = 8  # v8: SAH-DP wide collapse  # bump to invalidate cached BVHs


@dataclasses.dataclass
class Blas:
    """Flattened per-mesh accelerator, ready for concatenation into the device scene."""

    node_min: np.ndarray  # [M,3]
    node_max: np.ndarray
    node_left: np.ndarray  # [M] left child (internal) / first triangle (leaf)
    node_count: np.ndarray  # [M] 0 internal / triangle count leaf
    node_axis: np.ndarray  # [M]
    # leaf-ordered triangle SoA (hot: BottomLevelBVH.h:6-10)
    tri_p0: np.ndarray  # [T,3]
    tri_e1: np.ndarray  # [T,3] p1 - p0
    tri_e2: np.ndarray  # [T,3] p2 - p0
    # cold attributes (BottomLevelBVH.h:12-22)
    tri_n0: np.ndarray
    tri_ne1: np.ndarray
    tri_ne2: np.ndarray
    tri_t0: np.ndarray  # [T,2]
    tri_te1: np.ndarray
    tri_te2: np.ndarray
    tri_material: np.ndarray  # [T] local material id
    # threaded-traversal links [8, M, 2] (accel/links.py), BLAS_EXIT sentinels,
    # BLAS-local node indices
    links: np.ndarray = None
    # 8-wide collapse (accel/wide.py), BLAS-local payloads
    wide_child_min: np.ndarray = None  # [W,8,3]
    wide_child_max: np.ndarray = None
    wide_child_kind: np.ndarray = None  # [W,8]
    wide_child_payload: np.ndarray = None  # [W,8]
    wide_child_fb: np.ndarray = None  # [W,8]
    wide_order: np.ndarray = None  # [8,W,8]
    wide_depth: np.ndarray = None  # [] int
    wide_stack_bound: np.ndarray = None  # [] int: the walk's stack bound (wide.stack_bound)
    materials: list = None  # local material table (not cached; reattached by caller)
    source_triangle_count: int = 0

    @property
    def wide(self):
        from .wide import WideBVH

        return WideBVH(
            child_min=self.wide_child_min,
            child_max=self.wide_child_max,
            child_kind=self.wide_child_kind,
            child_payload=self.wide_child_payload,
            child_fb=self.wide_child_fb,
            order=self.wide_order,
            depth=int(self.wide_depth),
        )

    @property
    def stack_bound(self) -> int:
        return int(self.wide_stack_bound)

    @property
    def triangle_count(self) -> int:
        return self.tri_p0.shape[0]

    @property
    def root_aabb(self) -> np.ndarray:
        return np.stack([self.node_min[0], self.node_max[0]]).astype(np.float64)


_blas_memory_cache: dict = {}


def clear_cache() -> None:
    _blas_memory_cache.clear()


def _builder(accelerator: MeshAccelerator) -> str:
    """Which builder makes this accelerator here: the SBVH is the native
    spatial-split builder's where it loads, else the numpy object-split one's."""
    from . import native

    if accelerator == MeshAccelerator.SBVH and native.available():
        return "native"
    return "numpy"


def _mesh_hash(mesh: MeshData, accelerator: MeshAccelerator) -> str:
    """Cache key: the mesh, the accelerator and the builder that makes it, so a
    file one builder wrote is never read where the other's is expected."""
    h = hashlib.sha256()
    h.update(f"v{_BUILDER_VERSION}/{int(accelerator)}/{_builder(accelerator)}".encode())
    for f in ("p0", "p1", "p2"):
        h.update(np.ascontiguousarray(getattr(mesh, f)).tobytes())
    h.update(np.ascontiguousarray(mesh.material_id).tobytes())
    return h.hexdigest()[:24]


def build_blas(
    mesh: MeshData,
    accelerator: MeshAccelerator = MeshAccelerator.SBVH,
    cache_dir: str | None = ".cache/bvh_torch",
) -> Blas:
    """Build (or load from cache) the accelerator for a triangle mesh."""
    key = _mesh_hash(mesh, accelerator)
    if key in _blas_memory_cache:
        blas = _blas_memory_cache[key]
        return dataclasses.replace(blas, materials=mesh.materials)

    cache_path = os.path.join(cache_dir, key + ".npz") if cache_dir else None
    if cache_path and os.path.exists(cache_path):
        data = np.load(cache_path)
        blas = Blas(**{k: data[k] for k in data.files if k != "source_triangle_count"},
                    materials=mesh.materials,
                    source_triangle_count=int(data["source_triangle_count"]))
        if blas.wide_stack_bound is None:  # a file written before the bound was kept
            blas.wide_stack_bound = _stack_bound(blas.wide)
        _blas_memory_cache[key] = blas
        return blas

    if accelerator == MeshAccelerator.SBVH:
        bvh, order = _build_sbvh(mesh)
    else:
        bvh = _build_plain(mesh)
        order = bvh.prim_order

    # Merge small sibling subtrees into single <= 8-triangle leaves (dedupes SBVH
    # straddler copies; one fat-gather record per merged leaf — PERF.md lever #5).
    node_min, node_max, node_left, node_count, node_axis, order = merge_small_leaves(
        bvh.node_min, bvh.node_max, bvh.node_left, bvh.node_count, bvh.node_axis,
        order,
    )

    from .links import BLAS_EXIT, compute_links

    links = compute_links(node_left, node_count, node_axis, exit_sentinel=BLAS_EXIT)

    # 8-pad leaf ranges: every leaf's triangle range starts 8-aligned with length a
    # multiple of 8 (short leaves duplicate their last triangle — harmless for
    # closest- and any-hit).  The wide kernel then retires a whole leaf with ONE
    # [T/8,72] record gather; the binary kernel's pair cursor still works (8-aligned
    # implies pair-aligned).
    node_left, node_count, order = _pad_leaf_multiple(
        node_left.copy(), node_count.copy(), order, 8
    )

    from .wide import collapse_blas

    wideb = collapse_blas(node_min, node_max, node_left, node_count)
    wide_stack_bound = _stack_bound(wideb)

    # flatten(): copy triangles into leaf order, dropping the index indirection
    # (BottomLevelBVH.cpp:196-212); SBVH reference duplication falls out naturally.
    p0 = mesh.p0[order]
    blas = Blas(
        node_min=node_min,
        node_max=node_max,
        node_left=node_left,
        node_count=node_count,
        node_axis=node_axis,
        tri_p0=p0,
        tri_e1=mesh.p1[order] - p0,
        tri_e2=mesh.p2[order] - p0,
        tri_n0=mesh.n0[order],
        tri_ne1=mesh.n1[order] - mesh.n0[order],
        tri_ne2=mesh.n2[order] - mesh.n0[order],
        tri_t0=mesh.t0[order],
        tri_te1=mesh.t1[order] - mesh.t0[order],
        tri_te2=mesh.t2[order] - mesh.t0[order],
        tri_material=mesh.material_id[order].astype(np.int32),
        links=links,
        wide_child_min=wideb.child_min,
        wide_child_max=wideb.child_max,
        wide_child_kind=wideb.child_kind,
        wide_child_payload=wideb.child_payload,
        wide_child_fb=wideb.child_fb,
        wide_order=wideb.order,
        wide_depth=np.int64(wideb.depth),
        wide_stack_bound=wide_stack_bound,
        materials=mesh.materials,
        source_triangle_count=mesh.triangle_count,
    )
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(
            cache_path,
            **{
                f.name: getattr(blas, f.name)
                for f in dataclasses.fields(Blas)
                if f.name != "materials"
            },
        )
    _blas_memory_cache[key] = blas
    return blas


def _stack_bound(wideb) -> np.ndarray:
    """The BLAS walk's stack bound (span ``rt.stack_bound``), kept as ``wide_depth`` is."""
    from ..utils import trace
    from .wide import stack_bound

    with trace.span("rt.stack_bound"):
        return np.int64(stack_bound(wideb))


def merge_small_leaves(
    node_min, node_max, node_left, node_count, node_axis, order, max_leaf: int = 8
):
    """Collapse whole subtrees holding <= ``max_leaf`` unique triangle refs into
    single leaves, deduplicating SBVH straddler copies.

    The reference's flatten pass (BottomLevelBVH.cpp:196-212) drops the index
    indirection; on this TPU the traversal unit is "one fat gather" retiring one
    8-triangle record OR one 8-child node (PERF.md), so a subtree with <= 8 unique
    triangles costs >= 3 gather-iterations as a subtree but exactly 1 as a merged
    leaf — strictly fewer iterations for the same triangle tests (triangle tests
    inside a record are free relative to the gather).  SBVH spatial splits
    duplicate straddling refs into sibling leaves; merging reunites them, so the
    8-padded record count drops ~3x on Sponza-class meshes (the "4.2x padded-ref
    inflation" lever, PERF.md #5).

    Returns (node_min, node_max, node_left, node_count, node_axis, order) of the
    compacted tree, same pairs layout (root 0, pad 1, children in pairs from 2).
    """
    n_nodes = node_left.shape[0]
    if n_nodes <= 2:
        return node_min, node_max, node_left, node_count, node_axis, order
    is_leaf = node_count > 0

    # Bottom-up unique-ref sets, capped: refs[n] is the subtree's unique triangle
    # set when it fits in max_leaf, else None.  Post-order via explicit DFS stack
    # (no assumption that child index > parent index).
    refs: list = [None] * n_nodes
    stack = [(0, False)]
    while stack:
        node, expanded = stack.pop()
        if is_leaf[node]:
            first, cnt = int(node_left[node]), int(node_count[node])
            s = set(order[first : first + cnt].tolist())
            refs[node] = s if len(s) <= max_leaf else None
            continue
        left = int(node_left[node])
        if not expanded:
            stack.append((node, True))
            stack.append((left, False))
            stack.append((left + 1, False))
            continue
        a, b = refs[left], refs[left + 1]
        if a is not None and b is not None:
            u = a | b
            if len(u) <= max_leaf:
                refs[node] = u

    # Top-down rebuild: a node with a resolved ref set becomes a leaf.
    out_min, out_max = [node_min[0], node_min[0]], [node_max[0], node_max[0]]
    out_left, out_count, out_axis = [0, 0], [0, 0], [0, 0]
    new_order: list = []
    walk = [(0, 0)]  # (old node, new node)
    while walk:
        old, new = walk.pop()
        out_min[new] = node_min[old]
        out_max[new] = node_max[old]
        out_axis[new] = int(node_axis[old])
        if refs[old] is not None or is_leaf[old]:
            if refs[old] is not None:
                tris = sorted(refs[old])
            else:  # unmergeable big leaf (> max_leaf unique refs): keep verbatim
                first, cnt = int(node_left[old]), int(node_count[old])
                tris = order[first : first + cnt].tolist()
            out_left[new] = len(new_order)
            out_count[new] = len(tris)
            new_order.extend(tris)
            continue
        child = len(out_min)
        for _ in range(2):
            out_min.append(node_min[old])
            out_max.append(node_max[old])
            out_left.append(0)
            out_count.append(0)
            out_axis.append(0)
        out_left[new] = child
        out_count[new] = 0
        walk.append((int(node_left[old]), child))
        walk.append((int(node_left[old]) + 1, child + 1))

    return (
        np.asarray(out_min, node_min.dtype),
        np.asarray(out_max, node_max.dtype),
        np.asarray(out_left, np.int32),
        np.asarray(out_count, np.int32),
        np.asarray(out_axis, np.int32),
        np.asarray(new_order, np.int32),
    )


def _pad_leaf_multiple(node_left, node_count, order, mult):
    """Rewrite leaf ranges so each starts at a multiple of ``mult`` with length a
    multiple of ``mult`` (vectorized); short leaves repeat their last triangle."""
    is_leaf = node_count > 0
    leaf_ids = np.where(is_leaf)[0]
    # leaves partition [0, len(order)) contiguously; process in range order
    leaf_ids = leaf_ids[np.argsort(node_left[leaf_ids], kind="stable")]
    counts = node_count[leaf_ids].astype(np.int64)
    firsts = node_left[leaf_ids].astype(np.int64)
    new_counts = (counts + mult - 1) // mult * mult
    new_firsts = np.concatenate([[0], np.cumsum(new_counts)[:-1]])

    total = int(new_counts.sum())
    seg_start = np.repeat(new_firsts, new_counts)
    within = np.arange(total) - seg_start
    src = np.repeat(firsts, new_counts) + np.minimum(
        within, np.repeat(counts, new_counts) - 1
    )
    new_order = np.asarray(order)[src]

    node_left[leaf_ids] = new_firsts.astype(node_left.dtype)
    node_count[leaf_ids] = new_counts.astype(node_count.dtype)
    return node_left, node_count, new_order.astype(np.int32)


def _build_plain(mesh: MeshData) -> BVH:
    mins, maxs, cents = triangle_bounds(
        mesh.p0.astype(np.float64), mesh.p1.astype(np.float64), mesh.p2.astype(np.float64)
    )
    return build_bvh(mins, maxs, cents)


def _build_sbvh(mesh: MeshData):
    """Spatial-split BVH (sbvh.py); falls back to plain SAH via build_bvh on failure."""
    from .sbvh import build_sbvh

    bvh = build_sbvh(
        mesh.p0.astype(np.float64), mesh.p1.astype(np.float64), mesh.p2.astype(np.float64)
    )
    return bvh, bvh.prim_order
