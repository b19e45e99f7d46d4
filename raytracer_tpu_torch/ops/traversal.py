"""Stackless threaded binary BVH traversal (counterpart of ``raytracer_tpu/ops/traversal.py``),
kernel K10 (closest hit and any hit), selected by ``RenderConfig.traversal_kernel``
other than ``"wide"``.

Each BVH is threaded: per ray-direction octant every node has a ``near`` link
(the child visited first) and a ``skip`` link (where to go on a miss or when
its subtree is done; ``accel/links.py``).  A ray's state is one node pointer,
one ``resume`` register for the TLAS -> BLAS entry (the BLAS exits through the
``BLAS_EXIT`` sentinel), and a cursor over the triangle pairs of the leaf it
is in.  One iteration is the JAX package's ``_step`` (``:230-318``): a BLAS
exit is resolved first; the ray is moved into the current instance's space;
then either one pair of Moller-Trumbore tests (hit1 against the t that hit0
may have lowered, strict ``<``) or one node visit (slab test against the best
t; an internal node goes ``near``, a miss or a BLAS leaf ``skip``, a TLAS leaf
enters its instance's BLAS root).  ``steps`` counts node visits.  NAIVE takes
octant 0's links.  The walk runs until done: it has no iteration budget, so
``incomplete`` is 0 (the kernel still reports rays that hit its guard).

``trace_closest`` / ``trace_any`` launch ``csrc/traverse_threaded.cu`` for CUDA
tensors and run ``trace_plain`` for CPU tensors.  The kernel reads one 32-byte
record a node visit (``octant_records``, packed on the device by
``build_scene_bvh`` every frame) and an 80-byte row a triangle pair
(``pair_rows``), each with 16-byte loads; ``trace_any`` walks only the active
lanes, which K6 lists on the device first.  The first version's split tables
stay, read by ``trace_form("split", ...)``, the yardstick, and by
``trace_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..accel.links import BLAS_EXIT
from ..config import RAY_EPSILON, RenderConfig, TraversalStrategy
from ..utils import trace
from . import compaction
from .traversal_wide import TraceResult

# rt_trace_threaded's form argument: "octant" (the renderer's) reads one 32-byte
# record a node visit and 80-byte pair rows with 16-byte loads, "split" the
# first version's tables (box, node, links, tri) with 32-bit loads
FORMS = {"split": 0, "octant": 1}
REC_WORDS = 8  # a node record: 32 bytes
PAIR_FLOATS = 20  # a pair row: its two triangles' 18 floats and 2 of padding, 80 bytes
# the octant layout's leaf payload in the near word (csrc/traverse_threaded.cu):
# bit 31 set (never a node, never DONE or BLAS_EXIT), bit 30 a TLAS leaf;
# BLAS leaf: count / 2 << 21 | left / 2; TLAS leaf: count << 8 | instance
LEAF_BIT, TLAS_BIT = -(1 << 31), 1 << 30
BLAS_PAIR_BITS, BLAS_COUNT_BITS, TLAS_INST_BITS, TLAS_COUNT_BITS = 21, 9, 8, 21

# node kinds
INTERNAL, TLAS_LEAF, BLAS_LEAF = 0, 1, 2


class SceneBVH(NamedTuple):
    """The frame's [TLAS | concatenated BLASes] node arrays, global indices."""

    box: torch.Tensor  # [U,6] f32 min | max
    node: torch.Tensor  # [U,3] i32 left (internal: left child; TLAS leaf: instance;
    #                     BLAS leaf: first triangle) | kind | triangle count
    links: torch.Tensor  # [8,U,2] i32 near | skip per octant (DONE, BLAS_EXIT sentinels)
    inst_mat: torch.Tensor  # [I+1,12] f32 inverse instance matrices (slot 0 identity)
    inst_root: torch.Tensor  # [I+1] i32 global BLAS root per instance (slot 0 unused)
    tri: torch.Tensor  # [T,9] f32 p0 | e1 | e2 (leaf ranges pair-aligned)
    rec: torch.Tensor  # [8U,8] i32 octant records (octant_records)
    pairs: torch.Tensor  # [T/2,20] f32 triangle-pair rows (pair_rows)

    @property
    def n_nodes(self) -> int:
        return self.box.shape[0]


def build_scene_bvh(scene) -> SceneBVH:
    """Assemble the frame's threaded traversal arrays (``traversal.py:88-153`` of
    the JAX package) from the packed ``tl_*``, ``nd_*``, ``inst_*`` and ``tr_*``
    fields.  JAX's fused octant records and triangle-pair rows were a TPU gather
    trick; here the node's box, its integer fields and the links are three
    arrays, and the integers stay int32.  The walk is discrete, so the tables
    carry no gradient, whatever ``scene``'s fields do."""
    scene = scene._replace(**{k: getattr(scene, k).detach()
                              for k in ("tl_min", "tl_max", "nd_min", "nd_max", "inst_inv",
                                        "tr_p0", "tr_e1", "tr_e2")})
    n_tlas = scene.tl_min.shape[0]
    n_inst = scene.inst_root.shape[0]
    # JAX's bounds (traversal.py:96-98), kept so both walk the same scenes
    if n_tlas + scene.nd_min.shape[0] >= 1 << 22:
        raise ValueError("threaded traversal: node count exceeds 2^22")
    if scene.tr_p0.shape[0] >= 1 << 22:
        raise ValueError("threaded traversal: triangle count exceeds 2^22")
    if n_inst >= 255:
        raise ValueError("threaded traversal: instance count exceeds 255")
    dev = scene.tl_min.device
    i32 = torch.int32
    tl_internal = scene.tl_count == 0
    bl_internal = scene.nd_count == 0
    kind = torch.cat([torch.where(tl_internal, INTERNAL, TLAS_LEAF),
                      torch.where(bl_internal, INTERNAL, BLAS_LEAF)]).to(i32)
    # BLAS internal children move past the TLAS block
    bl_left = torch.where(bl_internal, scene.nd_left + n_tlas, scene.nd_left)
    left = torch.cat([scene.tl_left, bl_left]).to(i32)
    count = torch.cat([scene.tl_count, scene.nd_count]).to(i32)
    bl_links = torch.where(scene.nd_links >= 0, scene.nd_links + n_tlas, scene.nd_links)
    identity = torch.cat([torch.eye(3, dtype=torch.float32, device=dev),
                          torch.zeros((3, 1), dtype=torch.float32, device=dev)], dim=1)
    box = torch.cat([torch.cat([scene.tl_min, scene.tl_max], dim=1),
                     torch.cat([scene.nd_min, scene.nd_max], dim=1)]).contiguous()
    node = torch.stack([left, kind, count], dim=1).contiguous()
    links = torch.cat([scene.tl_links, bl_links], dim=1).to(i32).contiguous()
    tri = torch.cat([scene.tr_p0, scene.tr_e1, scene.tr_e2], dim=1).contiguous()
    return SceneBVH(
        box=box, node=node, links=links,
        inst_mat=torch.cat([identity[None], scene.inst_inv]).reshape(-1, 12).contiguous(),
        inst_root=torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                             (scene.inst_root + n_tlas).to(i32)]).contiguous(),
        tri=tri, rec=octant_records(box, node, links), pairs=pair_rows(tri),
    )


def octant_records(box: torch.Tensor, node: torch.Tensor, links: torch.Tensor) -> torch.Tensor:
    """K10's node records: [8U,8] i32, octant-major, a node's box (its bits)
    with the octant's near and skip, 32 bytes, so that a node visit is one
    sector read by two 16-byte loads.  A leaf's near, which no walk follows, holds
    its payload (``LEAF_BIT`` set): a BLAS leaf's left / 2 and count / 2, a
    TLAS leaf's instance and count.  Raises ``ValueError`` where a value
    exceeds its bits or an internal node's near is not a node."""
    u = box.shape[0]
    if u >= 1 << 22:
        raise ValueError("octant_records: node count exceeds 2^22")
    left, kind, count = node.unbind(1)
    near, skip = links.unbind(2)  # [8,U]
    internal, tlas, blas = kind == INTERNAL, kind == TLAS_LEAF, kind == BLAS_LEAF
    faults = torch.stack([  # one read back a frame for all four checks
        (~(internal | tlas | blas)).any(),
        (blas & ((left < 0) | (left >> 1 >= 1 << BLAS_PAIR_BITS) | (count < 0)
                 | (count >> 1 >= 1 << BLAS_COUNT_BITS))).any(),
        (tlas & ((left < 0) | (left >= 1 << TLAS_INST_BITS) | (count < 0)
                 | (count >= 1 << TLAS_COUNT_BITS))).any(),
        (internal[None] & (near < 0)).any()])
    with trace.span("rt.host_read"):
        faults = faults.tolist()
    for fault, msg in zip(faults, (
            "node kinds are 0, 1 and 2",
            f"a BLAS leaf's left / 2 must lie in [0, 2^{BLAS_PAIR_BITS}) and its count / 2 "
            f"in [0, 2^{BLAS_COUNT_BITS})",
            f"a TLAS leaf's instance must lie in [0, 2^{TLAS_INST_BITS}) and its count in "
            f"[0, 2^{TLAS_COUNT_BITS})",
            "an internal node's near link must be a node")):
        if fault:
            raise ValueError(f"octant_records: {msg}")
    payload = torch.where(tlas, TLAS_BIT | (count << 8) | left,
                          ((count >> 1) << BLAS_PAIR_BITS) | (left >> 1)) | LEAF_BIT
    near = torch.where(internal[None], near, payload.to(torch.int32)[None])
    bits = box.contiguous().view(torch.int32)[None].expand(8, u, 6)
    return torch.cat([bits, near[..., None], skip[..., None]], dim=2).reshape(8 * u, REC_WORDS)


def pair_rows(tri: torch.Tensor) -> torch.Tensor:
    """[T/2,20] f32: rows 2p and 2p + 1 of ``tri`` and two zeros, 80 bytes a pair,
    so that a pair is five 16-byte loads."""
    if tri.shape[0] % 2:
        raise ValueError("pair_rows: an even number of triangle rows expected")
    p = tri.reshape(-1, 18)
    return torch.cat([p, torch.zeros((p.shape[0], 2), dtype=p.dtype, device=p.device)],
                     dim=1).contiguous()


class Walk(NamedTuple):
    """Everything ``trace_plain`` computes per lane."""

    t: torch.Tensor  # [N] f32 best t (t_max = no hit)
    best: torch.Tensor  # [N] i32 tri << 8 | inst1, -1 = no hit
    steps: torch.Tensor  # [N] i32 node visits
    pairs: torch.Tensor  # [N] i32 triangle-pair visits
    entries: torch.Tensor  # [N] i32 TLAS-leaf entries (instance transforms)
    found: torch.Tensor  # [N] bool (any hit)
    incomplete: torch.Tensor  # [] i32, 0: the walk has no budget
    node_hist: torch.Tensor | None = None  # [U] i64 visits of each node (``visits``)
    pair_hist: torch.Tensor | None = None  # [T/2] i64 visits of each triangle pair


def _triangle_hit(ox, oy, oz, dx, dy, dz, r, t_max):
    """intersect.triangle_hit of the JAX package on [k] lanes against rows r [k,9]:
    (hit, t), with the |a| < 1e-20 guard of ``_nonzero``."""
    e1x, e1y, e1z, e2x, e2y, e2z = (r[:, c] for c in range(3, 9))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    tiny = torch.where(a < 0, -1e-20, 1e-20).to(a.dtype)
    f = 1.0 / torch.where(torch.abs(a) < 1e-20, tiny, a)
    sx, sy, sz = ox - r[:, 0], oy - r[:, 1], oz - r[:, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) & (t > RAY_EPSILON) & (t < t_max)
    return hit, t


def trace_plain(bvh: SceneBVH, o, d, t_max, active, ordered: bool, any_hit: bool,
                visits: bool = False) -> Walk:
    """Plain walk: one ``_step`` per iteration over the lanes still alive, until
    none is.  Besides the kernel's outputs it counts each lane's pair visits,
    and its TLAS-leaf entries, from which a caller can compute the work of a
    walk; with ``visits`` also the visits of each node and each pair (which
    rows the walk reads)."""
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    t_out = t_max.clone()
    best_out = torch.full((n,), -1, dtype=i32, device=dev)
    steps_out = torch.zeros((n,), dtype=i32, device=dev)
    pairs_out = torch.zeros((n,), dtype=i32, device=dev)
    entries_out = torch.zeros((n,), dtype=i32, device=dev)
    found_out = torch.zeros((n,), dtype=torch.bool, device=dev)

    lane = torch.nonzero(active).flatten()  # the alive lanes' indices
    k = lane.shape[0]
    cur = torch.zeros((k,), dtype=i32, device=dev)
    resume = torch.full((k,), -1, dtype=i32, device=dev)
    inst = torch.full((k,), -1, dtype=i32, device=dev)
    pi = torch.zeros((k,), dtype=i32, device=dev)  # pair cursor
    rem = torch.zeros((k,), dtype=i32, device=dev)  # pairs left in the leaf
    tb = t_max[lane]
    best = torch.full((k,), -1, dtype=i32, device=dev)
    steps = torch.zeros((k,), dtype=i32, device=dev)
    pairs = torch.zeros((k,), dtype=i32, device=dev)
    entries = torch.zeros((k,), dtype=i32, device=dev)
    found = torch.zeros((k,), dtype=torch.bool, device=dev)
    ow, dw = o[lane], d[lane]
    node_hist = pair_hist = None
    if visits:
        node_hist = torch.zeros((bvh.n_nodes,), dtype=torch.int64, device=dev)
        pair_hist = torch.zeros((bvh.tri.shape[0] // 2,), dtype=torch.int64, device=dev)

    while lane.shape[0]:
        # ---- resolve a BLAS exit before the transform: the ray is back in world space
        has_tri = rem > 0
        exiting = (cur == BLAS_EXIT) & ~has_tri
        cur = torch.where(exiting, resume, cur)
        resume = torch.where(exiting, -1, resume)
        inst = torch.where(exiting, -1, inst)

        m = bvh.inst_mat[(inst + 1).long()]
        owx, owy, owz = ow[:, 0], ow[:, 1], ow[:, 2]
        dwx, dwy, dwz = dw[:, 0], dw[:, 1], dw[:, 2]
        ox = m[:, 0] * owx + m[:, 1] * owy + m[:, 2] * owz + m[:, 3]
        oy = m[:, 4] * owx + m[:, 5] * owy + m[:, 6] * owz + m[:, 7]
        oz = m[:, 8] * owx + m[:, 9] * owy + m[:, 10] * owz + m[:, 11]
        dx = m[:, 0] * dwx + m[:, 1] * dwy + m[:, 2] * dwz
        dy = m[:, 4] * dwx + m[:, 5] * dwy + m[:, 6] * dwz
        dz = m[:, 8] * dwx + m[:, 9] * dwy + m[:, 10] * dwz

        # ---- triangle phase: one pair, hit1 against the t hit0 may have lowered
        p = torch.where(has_tri, pi, 0).long()
        t_fixed = tb
        hit0, t0 = _triangle_hit(ox, oy, oz, dx, dy, dz, bvh.tri[2 * p], t_fixed)
        hit0 = hit0 & has_tri
        if not any_hit:
            tb = torch.where(hit0, t0, tb)
        hit1, t1 = _triangle_hit(ox, oy, oz, dx, dy, dz, bvh.tri[2 * p + 1],
                                 t_fixed if any_hit else tb)
        hit1 = hit1 & has_tri
        if any_hit:
            found = found | hit0 | hit1
        else:
            tb = torch.where(hit1, t1, tb)
            tri_id = torch.where(hit1, 2 * pi + 1, 2 * pi)
            best = torch.where(hit0 | hit1, (tri_id << 8) | (inst + 1), best)
        pi = torch.where(has_tri, pi + 1, pi)
        rem = torch.where(has_tri, rem - 1, rem)
        pairs = pairs + has_tri.to(i32)
        if visits:
            pair_hist.index_add_(0, p[has_tri], torch.ones_like(p[has_tri]))

        # ---- node phase: follow the threaded links
        do_node = ~has_tri & (cur >= 0) & ~found
        nidx = torch.where(do_node, cur, 0).long()
        if ordered:
            oct_ = ((dx > 0).to(i32) | ((dy > 0).to(i32) << 1)
                    | ((dz > 0).to(i32) << 2)).long()
        else:
            oct_ = torch.zeros_like(nidx)
        box = bvh.box[nidx]
        nrec = bvh.node[nidx]
        lk = bvh.links[oct_, nidx]
        left, kind, count = nrec[:, 0], nrec[:, 1], nrec[:, 2]
        near, skip = lk[:, 0], lk[:, 1]
        ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
        t0x, t1x = (box[:, 0] - ox) * ix, (box[:, 3] - ox) * ix
        t0y, t1y = (box[:, 1] - oy) * iy, (box[:, 4] - oy) * iy
        t0z, t1z = (box[:, 2] - oz) * iz, (box[:, 5] - oz) * iz
        t_near = torch.maximum(
            torch.clamp_min(torch.minimum(t0x, t1x), RAY_EPSILON),
            torch.maximum(torch.minimum(t0y, t1y), torch.minimum(t0z, t1z)),
        )
        t_far = torch.minimum(
            torch.minimum(tb, torch.maximum(t0x, t1x)),
            torch.minimum(torch.maximum(t0y, t1y), torch.maximum(t0z, t1z)),
        )
        box_hit = (t_near < t_far) & do_node
        is_bl = box_hit & (kind == BLAS_LEAF)
        is_tl = box_hit & (kind == TLAS_LEAF)
        nxt = torch.where(box_hit & (kind == INTERNAL), near, skip)
        # a BLAS leaf arms the pair cursor; a TLAS leaf enters its instance
        pi = torch.where(is_bl, left >> 1, pi)
        rem = torch.where(is_bl, count >> 1, rem)
        nxt = torch.where(is_tl, bvh.inst_root[torch.where(is_tl, left + 1, 0).long()], nxt)
        resume = torch.where(is_tl, skip, resume)
        inst = torch.where(is_tl, left, inst)
        cur = torch.where(do_node, nxt, cur)
        steps = steps + do_node.to(i32)
        entries = entries + is_tl.to(i32)
        if visits:
            node_hist.index_add_(0, nidx[do_node], torch.ones_like(nidx[do_node]))

        # ---- retire the lanes that are done
        alive = (cur >= 0) | (cur == BLAS_EXIT) | (rem > 0)
        if any_hit:
            alive = alive & ~found
        with trace.span("rt.host_read"):
            all_alive = bool(alive.all())
        if all_alive:
            continue
        dead = ~alive
        done = lane[dead]
        t_out[done] = tb[dead]
        best_out[done] = best[dead]
        steps_out[done] = steps[dead]
        pairs_out[done] = pairs[dead]
        entries_out[done] = entries[dead]
        found_out[done] = found[dead]
        keep = torch.nonzero(alive).flatten()
        lane, ow, dw = lane[keep], ow[keep], dw[keep]
        cur, resume, inst, pi, rem = cur[keep], resume[keep], inst[keep], pi[keep], rem[keep]
        tb, best, steps, pairs, entries, found = (tb[keep], best[keep], steps[keep],
                                                  pairs[keep], entries[keep], found[keep])

    zero = torch.zeros((), dtype=i32, device=dev)
    return Walk(t_out, best_out, steps_out, pairs_out, entries_out, found_out, zero, node_hist,
                pair_hist)


def _check_rays(what, bvh, o, d, t_max, active):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,) or active.shape != (n,):
        raise ValueError(f"{what}: o, d [N,3], t_max, active [N] expected")
    if any(x.dtype != torch.float32
           for x in (o, d, t_max, bvh.box, bvh.inst_mat, bvh.tri, bvh.pairs)):
        raise TypeError(f"{what}: float32 rays and tables expected")
    if any(x.dtype != torch.int32 for x in (bvh.node, bvh.links, bvh.inst_root, bvh.rec)):
        raise TypeError(f"{what}: int32 node, record, link and root tables expected")
    if active.dtype != torch.bool:
        raise TypeError(f"{what}: active must be bool")
    if any(x.device != o.device for x in (d, t_max, active, *bvh)):
        raise ValueError(f"{what}: inputs on different devices")
    kernels.require_contiguous(what, o, d, t_max, active, *bvh)
    kernels.require_no_grad(what, o, d, t_max, bvh.box, bvh.inst_mat, bvh.tri, bvh.pairs)


def _check_records(what: str, bvh: SceneBVH) -> None:
    """The octant form's tables: the records' and pair rows' shapes, and the
    16-byte aligned bases its vector loads need."""
    if tuple(bvh.rec.shape) != (8 * bvh.n_nodes, REC_WORDS):
        raise ValueError(f"{what}: rec [8U, {REC_WORDS}] expected")
    if tuple(bvh.pairs.shape) != (bvh.tri.shape[0] // 2, PAIR_FLOATS):
        raise ValueError(f"{what}: pairs [T/2, {PAIR_FLOATS}] expected")
    if any(x.data_ptr() % 16 for x in (bvh.rec, bvh.pairs, bvh.inst_mat)):
        raise ValueError(f"{what}: rec, pairs and inst_mat must be 16-byte aligned")


def _launch(any_hit: bool, bvh: SceneBVH, o, d, t_max, active, cfg: RenderConfig,
            form: str = "octant"):
    """One rt_trace_threaded launch of ``form``; the octant form's any hit over
    the active lanes listed by K6 (``compact_launch``, nothing read back).
    Returns (t, best, steps, found, incomplete)."""
    what = "threaded trace_any" if any_hit else "threaded trace_closest"
    _check_rays(what, bvh, o, d, t_max, active)
    if form == "octant":
        _check_records(what, bvh)
    n = o.shape[0]
    dev = o.device
    incomplete = torch.zeros((1,), dtype=torch.int32, device=dev)
    compact = any_hit and form == "octant"
    if any_hit:
        t = best = steps = None
        found = (torch.zeros if compact else torch.empty)((n,), dtype=torch.bool, device=dev)
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        best = torch.empty((n,), dtype=torch.int32, device=dev)
        steps = torch.empty((n,), dtype=torch.int32, device=dev)
        found = None
    if n == 0:
        return t, best, steps, found, incomplete[0]
    lane_list = lane_count = None
    if compact:
        lane_list, lane_count = compaction.compact_launch(active)
    P, I = kernels.P, kernels.I
    fn = kernels.entry("traverse_threaded", "rt_trace_threaded",
                       [I, I, P, P, P, P, P, I, P, P, P, I, P, P, P, P, I, P, P, P, P, P, P, P,
                        P])

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = fn(int(any_hit), FORMS[form], bvh.box.data_ptr(), bvh.node.data_ptr(),
             bvh.links.data_ptr(), bvh.rec.data_ptr(), bvh.pairs.data_ptr(), bvh.n_nodes,
             bvh.inst_mat.data_ptr(), bvh.inst_root.data_ptr(), bvh.tri.data_ptr(),
             int(_ordered(cfg)), o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
             active.data_ptr(), n, ptr(lane_list), ptr(lane_count), ptr(t), ptr(best),
             ptr(steps), ptr(found), incomplete.data_ptr(), kernels.stream_ptr(dev))
    trace.count("launch.k10." + ("split." if form == "split" else "")
                + ("any" if any_hit else "closest"))
    kernels.check(err, what)
    return t, best, steps, found, incomplete[0]


def trace_form(form: str, any_hit: bool, bvh: SceneBVH, o, d, t_max, active,
               cfg: RenderConfig):
    """One K10 launch in ``form`` (``FORMS``: ``"octant"`` is the renderer's,
    ``"split"`` the first version, the yardstick); returns (t, best, steps,
    found, incomplete) as the kernel writes them (t, best and steps None for
    any hit, found None for closest).  CUDA tensors only; the split form's
    launches count in ``trace.counters["launch.k10.split.closest"]`` and
    ``"launch.k10.split.any"``."""
    if form not in FORMS:
        raise ValueError(f"trace_form: form must be one of {tuple(FORMS)}")
    if o.device.type != "cuda":
        raise ValueError("trace_form: CUDA tensors expected")
    return _launch(any_hit, bvh, o, d, t_max, active, cfg, form)


def _ordered(cfg: RenderConfig) -> bool:
    return cfg.traversal_strategy == TraversalStrategy.ORDERED


def trace_closest(bvh: SceneBVH, o, d, t_max, active, cfg: RenderConfig) -> TraceResult:
    """K10: closest hit for a wavefront of world-space rays.  CPU tensors take
    ``trace_plain``; CUDA tensors launch ``rt_trace_threaded`` (counted in
    ``trace.counters["launch.k10.closest"]``)."""
    if o.device.type == "cpu":
        w = trace_plain(bvh, o, d, t_max, active, _ordered(cfg), any_hit=False)
        t, best, steps, incomplete = w.t, w.best, w.steps, w.incomplete
    else:
        t, best, steps, _found, incomplete = _launch(False, bvh, o, d, t_max, active, cfg)
    tri = torch.where(best >= 0, best >> 8, -1)
    inst = torch.where(best >= 0, (best & 255) - 1, -1)
    return TraceResult(t=t, tri=tri, inst=inst, steps=steps, incomplete=incomplete)


def trace_any(bvh: SceneBVH, o, d, t_max, active, cfg: RenderConfig):
    """K10: any-hit (shadow) traversal; a ray retires at its first hit against
    ``t_max``.  Returns (found [N] bool, incomplete [] i32).  CPU tensors take
    ``trace_plain``; CUDA tensors launch ``rt_trace_threaded`` (counted in
    ``trace.counters["launch.k10.any"]``) over the active lanes, listed on the
    device by K6 (``compaction.compact_launch``, counted in ``"launch.k6"``)."""
    if o.device.type == "cpu":
        w = trace_plain(bvh, o, d, t_max, active, _ordered(cfg), any_hit=True)
        return w.found, w.incomplete
    _t, _best, _steps, found, incomplete = _launch(True, bvh, o, d, t_max, active, cfg)
    return found, incomplete
