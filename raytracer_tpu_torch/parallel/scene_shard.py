"""Tensor-parallel scene sharding: triangle geometry split over a mesh axis
(counterpart of ``raytracer_tpu/parallel/scene_shard.py``).

The reference keeps its whole scene in shared memory (BottomLevelBVH.cpp:16-22);
scenes bigger than one device's memory have no analog there.  SURVEY.md 2.3
marks "tensor/model parallel (scene sharded)" as the mode the accelerator build
introduces.  The design, as in the JAX package:

  * every registered mesh's triangle soup is split into `sp` spatially-coherent
    chunks (recursive centroid-median splits along the longest axis — each chunk
    is a compact spatial region, so per-shard BVHs stay tight);
  * each shard builds a COMPLETE sub-scene with the existing builders/packer:
    its own SBVHs, wide collapse, TLAS, instance table — analytic primitives,
    materials, textures, lights and camera are replicated (they are small);
  * per-shard `Blas` arrays are padded to common shapes BEFORE packing, so every
    packer-derived offset (node/wide/tri bases, the TLAS block start) is
    identical across shards and the per-shard scenes are congruent;
  * each rank along `sp` traverses the FULL ray wavefront against its own
    sub-scene; closest hits are min-t combined and any-hit masks OR-combined
    across `sp` (renderer._combine_hits_over_shards / intersect_scene), shading
    then proceeds replicated.

The host parts (``split_mesh`` to ``split_description``) are the JAX package's,
copied.  ``ShardedScenePacker.frame`` returns the per-shard scenes as a list,
one for each rank along `sp`, where the JAX package stacks them; the port's
quantised TLAS records (``wtq_rec``) are derived from the padded ``wt_rec``, so
a padded row is an empty node there too.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..accel import wide as wide_mod
from ..accel.blas import Blas, build_blas
from ..config import MeshAccelerator, RenderConfig
from ..render import renderer
from ..scene.device import ScenePacker
from ..scene.meshgen import MeshData
from . import collectives
from .shard import PixelShards

_MESH_FIELDS = ("p0", "p1", "p2", "n0", "n1", "n2", "t0", "t1", "t2",
                "material_id")


def split_mesh(mesh: MeshData, k: int) -> list[MeshData]:
    """Split a triangle soup into k spatially-coherent, size-balanced chunks.

    Recursive median split along the longest axis of the chunk's centroid bounds
    (the classic BVH build heuristic) with proportional allocation, so any k is
    supported and chunk sizes differ by at most one triangle."""
    assert mesh.triangle_count >= k, (mesh.triangle_count, k)
    cent = (mesh.p0 + mesh.p1 + mesh.p2) / 3.0

    def rec(idx: np.ndarray, parts: int) -> list[np.ndarray]:
        if parts == 1:
            return [idx]
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        left_parts = parts // 2
        cut = int(round(len(order) * left_parts / parts))
        cut = min(max(cut, left_parts), len(order) - (parts - left_parts))
        return rec(order[:cut], left_parts) + rec(order[cut:], parts - left_parts)

    chunks = rec(np.arange(mesh.triangle_count), k)
    return [
        MeshData(
            **{f: getattr(mesh, f)[c] for f in _MESH_FIELDS},
            materials=mesh.materials,
        )
        for c in chunks
    ]


def mesh_from_blas(b: Blas) -> MeshData:
    """Reconstruct a triangle soup from a built BLAS's leaf-ordered arrays.

    Fallback for descriptions that registered a BLAS without retaining the source
    soup (desc.mesh_sources).  SBVH spatial splits duplicate straddling refs
    (BVHBuilders.h:212-253) and the flatten pads leaves; duplicates re-split
    harmlessly (identical hits) and degenerate padding rows are dropped here."""
    e1, e2 = b.tri_e1, b.tri_e2
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    keep = area2 > 0.0
    f = lambda a: a[keep]  # noqa: E731
    return MeshData(
        p0=f(b.tri_p0), p1=f(b.tri_p0 + e1), p2=f(b.tri_p0 + e2),
        n0=f(b.tri_n0), n1=f(b.tri_n0 + b.tri_ne1), n2=f(b.tri_n0 + b.tri_ne2),
        t0=f(b.tri_t0), t1=f(b.tri_t0 + b.tri_te1), t2=f(b.tri_t0 + b.tri_te2),
        material_id=f(b.tri_material), materials=b.materials,
    )


def _pad_rows(a: np.ndarray, to: int, axis: int = 0) -> np.ndarray:
    if a.shape[axis] == to:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, to - a.shape[axis])
    return np.pad(a, widths)


def pad_blas(b: Blas, node_to: int, wide_to: int, tri_to: int) -> Blas:
    """Append inert rows so shard BLASes have congruent shapes.

    Every child/payload index in these tables points at pre-existing rows, so
    appended rows are unreachable; they only exist to make the packer's offsets
    (node_base/wide_node_base/tri_off, device.py:139-175) shard-invariant."""
    assert tri_to % 8 == 0, "triangle blocks must stay 8-aligned"
    kw = dict(
        node_min=_pad_rows(b.node_min, node_to),
        node_max=_pad_rows(b.node_max, node_to),
        node_left=_pad_rows(b.node_left, node_to),
        node_count=_pad_rows(b.node_count, node_to),
        node_axis=_pad_rows(b.node_axis, node_to),
        links=_pad_rows(b.links, node_to, axis=1),
        wide_child_min=_pad_rows(b.wide_child_min, wide_to),
        wide_child_max=_pad_rows(b.wide_child_max, wide_to),
        wide_child_kind=_pad_rows(b.wide_child_kind, wide_to),
        wide_child_payload=_pad_rows(b.wide_child_payload, wide_to),
        wide_child_fb=_pad_rows(b.wide_child_fb, wide_to),
        wide_order=_pad_rows(b.wide_order, wide_to, axis=1),
    )
    for f in ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_ne1", "tri_ne2",
              "tri_t0", "tri_te1", "tri_te2", "tri_material"):
        kw[f] = _pad_rows(getattr(b, f), tri_to)
    return dataclasses.replace(b, **kw)


def split_description(desc, sp: int,
                      accelerator: MeshAccelerator = MeshAccelerator.SBVH):
    """Produce `sp` shard descriptions sharing everything but triangle geometry.

    Material offsets are copied from the original description so a shard's
    tri_material + offset yields the SAME global material id the unsharded scene
    uses — shading is shard-invariant by construction."""
    shards = []
    split_meshes = {}
    for key in sorted(desc.blas_registry.keys()):
        src = desc.mesh_sources.get(key)
        if src is None:
            src = mesh_from_blas(desc.blas_registry[key])
        split_meshes[key] = split_mesh(src, sp)
    for s in range(sp):
        nd = copy.copy(desc)  # shares camera/lights/sky/prims/material_buffer
        nd.blas_registry = {}
        nd.blas_material_offsets = dict(desc.blas_material_offsets)
        nd.mesh_sources = {}
        for key, parts in split_meshes.items():
            nd.blas_registry[key] = build_blas(parts[s], accelerator)
        shards.append(nd)
    # pad per-key BLASes to common shapes so packer offsets are shard-invariant
    for key in split_meshes:
        blases = [d.blas_registry[key] for d in shards]
        node_to = max(b.node_min.shape[0] for b in blases)
        wide_to = max(b.wide_child_min.shape[0] for b in blases)
        tri_to = max(b.triangle_count for b in blases)
        tri_to = (tri_to + 7) // 8 * 8
        for d, b in zip(shards, blases):
            d.blas_registry[key] = pad_blas(b, node_to, wide_to, tri_to)
    return shards


class ShardedScenePacker:
    """Packs `sp` congruent sub-scenes of one description."""

    def __init__(self, desc, cfg: RenderConfig, sp: int):
        self.descs = split_description(desc, sp, cfg.mesh_accelerator)
        self.packers = [ScenePacker(d, cfg.width, cfg.height) for d in self.descs]
        self.sp = sp

    def frame(self) -> list:
        """The current frame's `sp` per-shard scenes (``DeviceScene`` of numpy
        arrays); rank k along `sp` uploads entry k."""
        frames = [p.frame() for p in self.packers]
        # per-frame TLAS arrays can differ in node count across shards (the
        # binary/wide TLAS shape depends on the sub-scene's instance AABBs);
        # pad to common capacity — appended rows are unreachable, exactly as in
        # pad_blas.
        pads = {
            "wt_rec": 1, "tl_links": 1,
            "tl_min": 0, "tl_max": 0, "tl_left": 0, "tl_count": 0, "tl_axis": 0,
        }
        out = []
        for f in frames:
            d = f._asdict()
            for name, axis in pads.items():
                to = max(getattr(g, name).shape[axis] for g in frames)
                d[name] = _pad_rows(np.asarray(d[name]), to, axis=axis)
            # zero wt_rec rows quantise to nodes with no live child
            d["wtq_rec"] = wide_mod.quantised_records(d["wt_rec"])
            out.append(type(f)(**d))
        return out


def make_primitive_sharded_renderer(cfg: RenderConfig, mesh,
                                    dp_axis: str = "dp", sp_axis: str = "sp"):
    """Returns run(scene) -> ([H,W,3] image, RenderStats): pixels sharded over
    `dp_axis`, triangle geometry over `sp_axis`.  Every rank calls it with its
    own shard's scene (entry ``mesh.get_local_rank(sp_axis)`` of
    ``ShardedScenePacker.frame()``, uploaded) and gets the whole image."""
    dp = mesh.size(tuple(mesh.mesh_dim_names).index(dp_axis))
    cfg_sp = cfg.replace(scene_shard_axis=sp_axis)
    px = PixelShards(cfg, mesh.get_group(dp_axis), dp)

    def run(scene):
        with torch.no_grad(), collectives.mesh_axes(mesh):
            rgb, stats = renderer.render_pixels(scene, cfg_sp, px.pixels(scene.cam_pos.device))
            # ray counters are identical across sp (shading is post-combine and
            # replicated), so summing over dp alone gives the global counts
            return px.image(rgb), px.sum_stats(stats)

    return run
