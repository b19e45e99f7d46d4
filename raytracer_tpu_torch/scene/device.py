"""Flattening the host scene graph into the flat arrays the renderer reads.

Everything the render kernels touch is a flat structure-of-arrays pytree: the TPU
counterpart of the reference's SoA triangle storage + global material buffer
(BottomLevelBVH.h:6-22, Material.h:28-61).  Static geometry (BLAS nodes, triangles,
materials, textures, sky) is packed once; per-frame state (TLAS, instance matrices,
camera, lights, analytic primitives) is cheap to re-pack every step — mirroring the
reference's per-frame top-level rebuild (Scene.cpp:139-171).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..accel.bvh import build_bvh
from ..core import matrix as mat4
from ..utils import trace
from . import textures as tex_mod
from .description import SceneDescription


class DeviceScene(NamedTuple):
    """Complete flattened scene: numpy arrays from ``ScenePacker.frame``, torch
    tensors after ``scene.tensors.scene_from_numpy``."""

    # analytic primitives (PrimitiveList.h)
    sph_center: object  # [S,3]
    sph_radius: object  # [S]
    sph_material: object  # [S] int32
    pln_normal: object  # [P,3]
    pln_distance: object  # [P]
    pln_u: object  # [P,3]
    pln_v: object  # [P,3]
    pln_material: object  # [P] int32
    # top-level BVH over instances (TopLevelBVH.h; leaves are single instances)
    tl_min: object  # [Mt,3]
    tl_max: object
    tl_left: object  # [Mt] int32: internal -> left child; leaf -> instance id
    tl_count: object  # [Mt] int32
    tl_axis: object  # [Mt] int32
    tl_links: object  # [8,Mt,2] int32 threaded near/skip links (accel/links.py)
    # mesh instances (Mesh.h)
    inst_world: object  # [I,3,4]
    inst_inv: object  # [I,3,4]
    inst_root: object  # [I] int32 global root-node index of the instance's BLAS
    # 8-wide BVH records (accel/wide.py): static BLAS block + per-frame wide TLAS
    wd_rec: object  # [8,Wb,72] f32 octant-major fused wide records (global payloads)
    wt_rec: object  # [8,Wt,72] f32 per-frame wide TLAS (root = local 0 -> global Wb)
    # their quantised copies (accel/wide.py:quantised_records), read by the walk
    wq_rec: object  # [8,Wb,32] int32 quantised BLAS block (packed once)
    wtq_rec: object  # [8,Wt,32] int32 quantised per-frame TLAS
    # concatenated bottom-level BVHs (BottomLevelBVH.h)
    nd_min: object  # [M,3]
    nd_max: object
    nd_left: object  # [M] int32 (globalized; leaf -> first global triangle)
    nd_count: object  # [M] int32
    nd_axis: object  # [M] int32
    nd_links: object  # [8,M,2] int32 threaded links (BLAS-concat local + offsets)
    # flattened leaf-ordered triangles (TriangleHot/TriangleCold)
    tr_p0: object
    tr_e1: object
    tr_e2: object
    tr_n0: object
    tr_ne1: object
    tr_ne2: object
    tr_t0: object  # [T,2]
    tr_te1: object
    tr_te2: object
    tr_material: object  # [T] int32 global material id (offset baked in)
    # global material buffer (Material.h:28-61)
    mat_diffuse: object  # [M,3]
    mat_reflection: object  # [M,3]
    mat_transmittance: object  # [M,3]
    mat_ior: object  # [M]
    mat_texture: object  # [M] int32 atlas texture id (0 = none)
    # texture atlas (scene/textures.py)
    tex_data: object  # [X,3]
    tex_width: object  # [K] int32
    tex_height: object  # [K] int32
    tex_levels: object  # [K] int32
    tex_offsets: object  # [K,16] int32
    tex_quad: object  # [X,4] int32 bilinear-footprint rows (textures.quad_idx)
    # lights
    pl_pos: object  # [Lp,3]
    pl_colour: object  # [Lp,3]
    sl_pos: object  # [Ls,3]
    sl_colour: object
    sl_neg_dir: object
    sl_inner: object  # [Ls]
    sl_outer: object  # [Ls]
    dl_neg_dir: object  # [Ld,3]
    dl_colour: object
    # sky (Sky.h)
    sky_data: object  # [S2,3]
    sky_size: object  # [] int32
    # camera view pyramid (Camera.h)
    cam_pos: object  # [3]
    cam_top_left: object
    cam_x: object
    cam_y: object
    ambient: object  # [] float32
    # the wide walk's stack bound (accel/wide.py:stack_bound), a Python int
    stack_bound: object

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_planes(self) -> int:
        return self.pln_normal.shape[0]

    @property
    def n_instances(self) -> int:
        return self.inst_root.shape[0]

    @property
    def n_point_lights(self) -> int:
        return self.pl_pos.shape[0]

    @property
    def n_spot_lights(self) -> int:
        return self.sl_pos.shape[0]

    @property
    def n_directional_lights(self) -> int:
        return self.dl_neg_dir.shape[0]


def _canonical(x) -> np.ndarray:
    """numpy array with 32-bit dtypes: float64 -> float32 and int64 -> int32,
    the same narrowing the JAX package's ``jnp.asarray`` applies, so both
    packers hand out arrays of identical dtype."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


class ScenePacker:
    """Packs a SceneDescription; static geometry uploaded once, dynamic state per
    frame."""

    def __init__(self, desc: SceneDescription, width: int, height: int):
        self.desc = desc
        desc.camera.resize(width, height)
        self._static = self._pack_static()
        self._static_dev = {k: _canonical(v) for k, v in self._static.items()}

    # -- static geometry -----------------------------------------------------

    def _pack_static(self) -> dict:
        from ..accel import wide as wide_mod

        desc = self.desc
        keys = sorted(desc.blas_registry.keys())
        self.node_base: dict = {}
        self.wide_node_base: dict = {}
        self.blas_stack_bound: dict = {}
        nd, tr, links, wrecs = [], [], [], []
        node_off = 0
        wide_off = 0
        tri_off = 0
        for k in keys:
            b = desc.blas_registry[k]
            self.node_base[k] = node_off
            self.wide_node_base[k] = wide_off
            self.blas_stack_bound[k] = b.stack_bound
            is_leaf = b.node_count > 0
            left = np.where(is_leaf, b.node_left + tri_off, b.node_left + node_off)
            nd.append(
                (b.node_min, b.node_max, left.astype(np.int32), b.node_count, b.node_axis)
            )
            # threaded links: offset in-BLAS node targets; keep sentinels (<0)
            lk = np.where(b.links >= 0, b.links + node_off, b.links).astype(np.int32)
            links.append(lk)
            assert tri_off % 8 == 0, "BLAS triangle blocks must stay 8-aligned"
            wrecs.append(
                wide_mod.octant_records(
                    b.wide, internal_offset=wide_off, leaf_offset=tri_off // 8
                )
            )
            mat_off = desc.blas_material_offsets[k]
            tr.append((b, (b.tri_material + mat_off).astype(np.int32)))
            node_off += b.node_min.shape[0]
            wide_off += b.wide_child_min.shape[0]
            tri_off += b.triangle_count
        # wide-kernel id encodings: tri ids ride best = tri<<8|inst (< 2^31)
        assert tri_off < (1 << 22), "triangle count exceeds 2^22"
        self.wide_node_count = wide_off

        def cat(idx, dtype, dim=None):
            if not nd:
                shape = (0,) if dim is None else (0, dim)
                return np.zeros(shape, dtype)
            return np.concatenate([x[idx] for x in nd], axis=0).astype(dtype)

        def cat_tr(field, dtype, dim=None):
            if not tr:
                shape = (0,) if dim is None else (0, dim)
                return np.zeros(shape, dtype)
            return np.concatenate(
                [getattr(b, field) if field else m for b, m in tr], axis=0
            ).astype(dtype)

        out = {
            "wd_rec": (
                np.concatenate(wrecs, axis=1)
                if wrecs
                else np.zeros((8, 0, 72), np.float32)
            ),
            "nd_min": cat(0, np.float32, 3),
            "nd_max": cat(1, np.float32, 3),
            "nd_left": cat(2, np.int32),
            "nd_count": cat(3, np.int32),
            "nd_axis": cat(4, np.int32),
            "nd_links": (
                np.concatenate(links, axis=1).astype(np.int32)
                if links
                else np.zeros((8, 0, 2), np.int32)
            ),
        }
        for f in ("tr_p0", "tr_e1", "tr_e2", "tr_n0", "tr_ne1", "tr_ne2"):
            out[f] = cat_tr(f[3:] if False else "tri_" + f[3:], np.float32, 3)
        for f in ("tr_t0", "tr_te1", "tr_te2"):
            out[f] = cat_tr("tri_" + f[3:], np.float32, 2)
        out["wq_rec"] = wide_mod.quantised_records(
            out["wd_rec"], wide_mod.leaf_live_counts(out["tr_p0"], out["tr_e1"], out["tr_e2"]))
        out["tr_material"] = (
            np.concatenate([m for _, m in tr], axis=0)
            if tr
            else np.zeros((0,), np.int32)
        )

        # materials + texture atlas
        mats = desc.material_buffer.materials
        textures = []
        tex_ids = np.zeros((len(mats),), np.int32)
        for i, m in enumerate(mats):
            t = None
            if m.texture_array is not None:
                t = tex_mod.from_array(m.texture_array, srgb=False)
            elif m.texture_path is not None:
                try:
                    t = tex_mod.load(m.texture_path)
                except (FileNotFoundError, OSError):
                    t = None
            if t is not None:
                textures.append(t)
                tex_ids[i] = len(textures)  # atlas id 0 is "none"
        atlas = tex_mod.build_atlas(textures)
        out.update(
            mat_diffuse=np.stack([m.diffuse for m in mats]).astype(np.float32),
            mat_reflection=np.stack([m.reflection for m in mats]).astype(np.float32),
            mat_transmittance=np.stack([m.transmittance for m in mats]).astype(
                np.float32
            ),
            mat_ior=np.array(
                [m.index_of_refraction for m in mats], np.float32
            ),
            mat_texture=tex_ids,
            tex_data=atlas.data,
            tex_width=atlas.width,
            tex_height=atlas.height,
            tex_levels=atlas.mip_levels,
            tex_offsets=atlas.mip_offsets,
            tex_quad=atlas.quad_idx,
            sky_data=desc.sky_data.astype(np.float32),
            sky_size=np.int32(desc.sky_size),
        )
        return out

    # -- per-frame dynamic state --------------------------------------------

    def frame(self) -> DeviceScene:
        """Build the DeviceScene for the current host scene state (span
        ``rt.app.pack``).

        Re-derives world matrices, rebuilds the TLAS (TopLevelBVH::build_bvh every
        frame, Scene.cpp:170), and refreshes camera/lights — all host-side numpy,
        then flat numpy arrays.
        """
        with trace.span("rt.app.pack"):
            return self._frame()

    def _frame(self) -> DeviceScene:
        desc = self.desc
        keys_order = sorted(desc.blas_registry.keys())  # noqa: F841

        # instances + TLAS
        n_inst = len(desc.instances)
        inst_world = np.zeros((n_inst, 3, 4), np.float32)
        inst_inv = np.zeros((n_inst, 3, 4), np.float32)
        inst_root = np.zeros((n_inst,), np.int32)
        inst_wide_root = np.zeros((n_inst,), np.int32)
        inst_bound = np.zeros((n_inst,), np.int64)
        stack_bound = 0
        wt_rec = np.zeros((8, 0, 72), np.float32)
        wtq_rec = np.zeros((8, 0, 32), np.int32)
        if n_inst:
            mins = np.zeros((n_inst, 3))
            maxs = np.zeros((n_inst, 3))
            for i, inst in enumerate(desc.instances):
                m = inst.transform.world_matrix()
                inst_world[i] = mat4.to_rows34(m)
                inst_inv[i] = mat4.to_rows34(mat4.invert(m))
                inst_root[i] = self.node_base[inst.blas_key]
                inst_wide_root[i] = self.wide_node_base[inst.blas_key]
                inst_bound[i] = self.blas_stack_bound[inst.blas_key]
                box = inst.world_aabb(desc.blas_registry[inst.blas_key].root_aabb)
                mins[i], maxs[i] = box[0], box[1]
            from ..accel import wide as wide_mod

            wtlas = wide_mod.build_wide_tlas(
                mins.astype(np.float32), maxs.astype(np.float32), inst_wide_root
            )
            # TLAS block appended after the static BLAS block; its root is local 0
            wt_rec = wide_mod.octant_records(
                wtlas, internal_offset=self.wide_node_count
            )
            wtq_rec = wide_mod.quantised_records(wt_rec)  # instance entries: no leaf
            with trace.span("rt.stack_bound"):
                stack_bound = wide_mod.stack_bound(wtlas, inst_bound)
            if stack_bound > wide_mod.STACK_CAPACITY:
                raise ValueError(
                    f"the scene's wide walk can push {stack_bound} stack entries; the walk "
                    f"holds at most {wide_mod.STACK_CAPACITY}")
            tlas = build_bvh(mins, maxs, force_split=True)
            # bake leaf 'first' -> instance id (single-instance leaves)
            is_leaf = tlas.node_count > 0
            tl_left = np.where(
                is_leaf, tlas.prim_order[np.minimum(tlas.node_left, n_inst - 1)],
                tlas.node_left,
            ).astype(np.int32)
            from ..accel.links import DONE, compute_links

            tl_links = compute_links(
                tlas.node_left, tlas.node_count, tlas.node_axis, exit_sentinel=DONE
            )
            tl = (
                tlas.node_min, tlas.node_max, tl_left, tlas.node_count,
                tlas.node_axis, tl_links,
            )
        else:
            tl = (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.int32),
                np.zeros((8, 0, 2), np.int32),
            )

        # analytic primitives
        n_s = len(desc.spheres)
        sph_center = np.zeros((n_s, 3), np.float32)
        sph_radius = np.zeros((n_s,), np.float32)
        sph_material = np.zeros((n_s,), np.int32)
        for i, s in enumerate(desc.spheres):
            sph_center[i] = s.transform.position
            sph_radius[i] = s.radius
            sph_material[i] = s.material_id

        n_p = len(desc.planes)
        pln_normal = np.zeros((n_p, 3), np.float32)
        pln_distance = np.zeros((n_p,), np.float32)
        pln_u = np.zeros((n_p, 3), np.float32)
        pln_v = np.zeros((n_p, 3), np.float32)
        pln_material = np.zeros((n_p,), np.int32)
        for i, p in enumerate(desc.planes):
            n, d, u, v = p.world_arrays()
            pln_normal[i], pln_distance[i] = n, d
            pln_u[i], pln_v[i] = u, v
            pln_material[i] = p.material_id

        # lights
        pl = desc.point_lights
        sl = desc.spot_lights
        dl = desc.directional_lights

        def norm(v):
            v = np.asarray(v, np.float64)
            return v / np.linalg.norm(v)

        cam = desc.camera.device_arrays()
        s = self._static_dev
        return DeviceScene(
            sph_center=_canonical(sph_center),
            sph_radius=_canonical(sph_radius),
            sph_material=_canonical(sph_material),
            pln_normal=_canonical(pln_normal),
            pln_distance=_canonical(pln_distance),
            pln_u=_canonical(pln_u),
            pln_v=_canonical(pln_v),
            pln_material=_canonical(pln_material),
            tl_min=_canonical(tl[0]),
            tl_max=_canonical(tl[1]),
            tl_left=_canonical(tl[2]),
            tl_count=_canonical(tl[3]),
            tl_axis=_canonical(tl[4]),
            tl_links=_canonical(tl[5]),
            inst_world=_canonical(inst_world),
            inst_inv=_canonical(inst_inv),
            inst_root=_canonical(inst_root),
            wd_rec=s["wd_rec"],
            wt_rec=_canonical(wt_rec),
            wq_rec=s["wq_rec"],
            wtq_rec=wtq_rec,
            nd_min=s["nd_min"],
            nd_max=s["nd_max"],
            nd_left=s["nd_left"],
            nd_count=s["nd_count"],
            nd_axis=s["nd_axis"],
            nd_links=s["nd_links"],
            tr_p0=s["tr_p0"],
            tr_e1=s["tr_e1"],
            tr_e2=s["tr_e2"],
            tr_n0=s["tr_n0"],
            tr_ne1=s["tr_ne1"],
            tr_ne2=s["tr_ne2"],
            tr_t0=s["tr_t0"],
            tr_te1=s["tr_te1"],
            tr_te2=s["tr_te2"],
            tr_material=s["tr_material"],
            mat_diffuse=s["mat_diffuse"],
            mat_reflection=s["mat_reflection"],
            mat_transmittance=s["mat_transmittance"],
            mat_ior=s["mat_ior"],
            mat_texture=s["mat_texture"],
            tex_data=s["tex_data"],
            tex_width=s["tex_width"],
            tex_height=s["tex_height"],
            tex_levels=s["tex_levels"],
            tex_offsets=s["tex_offsets"],
            tex_quad=s["tex_quad"],
            pl_pos=_canonical(
                np.stack([li.position for li in pl]).astype(np.float32)
                if pl
                else np.zeros((0, 3), np.float32)
            ),
            pl_colour=_canonical(
                np.stack([li.colour for li in pl]).astype(np.float32)
                if pl
                else np.zeros((0, 3), np.float32)
            ),
            sl_pos=_canonical(
                np.stack([li.position for li in sl]).astype(np.float32)
                if sl
                else np.zeros((0, 3), np.float32)
            ),
            sl_colour=_canonical(
                np.stack([li.colour for li in sl]).astype(np.float32)
                if sl
                else np.zeros((0, 3), np.float32)
            ),
            sl_neg_dir=_canonical(
                np.stack([-norm(li.direction) for li in sl]).astype(np.float32)
                if sl
                else np.zeros((0, 3), np.float32)
            ),
            sl_inner=_canonical(
                np.array([li.inner_cutoff for li in sl], np.float32)
            ),
            sl_outer=_canonical(
                np.array([li.outer_cutoff for li in sl], np.float32)
            ),
            dl_neg_dir=_canonical(
                np.stack([-norm(li.direction) for li in dl]).astype(np.float32)
                if dl
                else np.zeros((0, 3), np.float32)
            ),
            dl_colour=_canonical(
                np.stack([li.colour for li in dl]).astype(np.float32)
                if dl
                else np.zeros((0, 3), np.float32)
            ),
            sky_data=s["sky_data"],
            sky_size=s["sky_size"],
            cam_pos=_canonical(cam["cam_position"]),
            cam_top_left=_canonical(cam["cam_top_left"]),
            cam_x=_canonical(cam["cam_x_axis"]),
            cam_y=_canonical(cam["cam_y_axis"]),
            ambient=_canonical(np.float32(desc.ambient)),
            stack_bound=stack_bound,
        )


def quantised_fields(fields) -> dict:
    """``wq_rec`` and ``wtq_rec`` of a scene's other fields (a mapping of
    arrays): for scenes packed without them, such as the JAX package's."""
    from ..accel import wide as wide_mod

    live = wide_mod.leaf_live_counts(*(np.asarray(fields[k]) for k in ("tr_p0", "tr_e1",
                                                                         "tr_e2")))
    return {"wq_rec": wide_mod.quantised_records(np.asarray(fields["wd_rec"]), live),
            "wtq_rec": wide_mod.quantised_records(np.asarray(fields["wt_rec"]), live)}


def pack_scene(desc: SceneDescription, width: int, height: int) -> DeviceScene:
    """One-shot convenience: pack a scene for a given render size."""
    return ScenePacker(desc, width, height).frame()
