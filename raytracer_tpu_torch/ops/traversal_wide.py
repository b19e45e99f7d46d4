"""Wavefront 8-wide BVH traversal (counterpart of ``raytracer_tpu/ops/traversal_wide.py``),
kernels K1 (closest hit) and K2 (any hit).

The TLAS and every BLAS share one unified record table; entering an instance is
following a child entry whose instance bits switch the ray into object space, and
every stack entry carries its instance id (see ``accel/wide.py``).  A ray walks
until it is done: there is no iteration ladder.  The stack holds the scene's
proven bound (``accel/wide.py:stack_bound``, ``WideSceneBVH.stack_bound``)
unless ``RenderConfig.wide_stack_size`` sets a size, and ``incomplete`` counts
only rays whose stack overflowed a size so set.

``trace_closest`` / ``trace_any`` launch ``csrc/traverse.cu`` for CUDA tensors and
run ``trace_plain`` for CPU tensors.  ``trace_plain`` is the JAX package's ``_step``
as a vectorised loop over all lanes until none is alive, with the same float32
arithmetic, so ids and step counts agree lane for lane.

The kernel decides most children from the quantised node records
(``accel/wide.py:quantised_records``) and takes the exact test only where they
cannot decide; ``node_bits_quantised_plain`` is that decision in PyTorch, and
``trace_plain(..., quantised=True)`` holds it to the exact test at every node
visit.  ``trace_form`` launches the kernel's exact-record form (the first walk, the
yardstick) and ``walk_stats`` its counters; the renderer uses neither.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..accel.wide import (
    KIND_EMPTY, KIND_INTERNAL, KIND_LEAF, PAYLOAD_BITS, Q_INWARD, Q_PLANES, QREC_WORDS,
    STACK_CAPACITY,
)
from ..config import RAY_EPSILON, RenderConfig, TraversalStrategy
from ..utils import trace

POP = -1  # take the next deferred entry off the stack
EXIT = -2  # traversal finished

_PAYLOAD_MASK = (1 << PAYLOAD_BITS) - 1

FORMS = {"exact": 0, "quantised": 1}  # rt_trace's form argument
_COUNTING = 2  # rt_trace's form: quantised, adding its counters (walk_stats)
# walk_stats' counters, in csrc/traverse.cu's order
STATS = ("quantised_node_visits", "exact_lane_node_visits", "undecided_children",
         "inner_hits", "leaf_visits", "wide_leaf_visits", "live_tests", "exact_lanes",
         "enters")


class WideSceneBVH(NamedTuple):
    """Unified per-frame traversal structure: [BLAS block | per-frame TLAS | tris]."""

    table: torch.Tensor  # [8*W + T/8, 72] f32 unified records
    qrec: torch.Tensor  # [8*W, 32] int32 quantised node records (accel/wide.py)
    inst_mat: torch.Tensor  # [I+1,12] f32 inverse instance matrices (slot 0 identity)
    root: int  # global index of the TLAS wide root
    node_rows: int  # 8*W (first triangle-record row)
    stack_bound: int  # the most stack entries any ray's walk can push

    @property
    def n_nodes(self) -> int:
        return self.node_rows // 8


def build_scene_bvh(scene) -> WideSceneBVH:
    """Assemble the frame's unified wide traversal table (traversal_wide.py:71-103
    of the JAX package): static BLAS records, the per-frame TLAS after them, then
    the component-major 8-triangle leaf records (col c*8 + j).  The walk is
    discrete, so the table carries no gradient, whatever ``scene``'s fields do."""
    scene = scene._replace(**{k: getattr(scene, k).detach()
                              for k in ("wd_rec", "wt_rec", "wq_rec", "wtq_rec", "inst_inv",
                                        "tr_p0", "tr_e1", "tr_e2")})
    n_tri = scene.tr_p0.shape[0]
    n_inst = scene.inst_inv.shape[0]
    # id encodings: best = tri << 8 | inst1 (scene/device.py), inst1 in 8 bits
    if n_tri >= 1 << 22:
        raise ValueError(f"{n_tri} triangles: the traversal encodes fewer than 2^22")
    if n_inst >= 255:
        raise ValueError(f"{n_inst} instances: the traversal encodes fewer than 255")
    wb = scene.wd_rec.shape[1]
    rec = torch.cat([scene.wd_rec, scene.wt_rec], dim=1).reshape(-1, 72)
    dev = rec.device
    identity = torch.cat(
        [torch.eye(3, dtype=torch.float32, device=dev),
         torch.zeros((3, 1), dtype=torch.float32, device=dev)], dim=1
    )
    inst_mat = torch.cat([identity[None], scene.inst_inv], dim=0).reshape(-1, 12)
    tri = torch.cat([scene.tr_p0, scene.tr_e1, scene.tr_e2], dim=1)
    tri_rec = tri.reshape(-1, 8, 9).transpose(1, 2).reshape(-1, 72)
    return WideSceneBVH(
        table=torch.cat([rec, tri_rec], dim=0).contiguous(),
        qrec=torch.cat([scene.wq_rec, scene.wtq_rec], dim=1).reshape(-1, QREC_WORDS)
        .contiguous(),
        inst_mat=inst_mat.contiguous(),
        root=wb,
        node_rows=rec.shape[0],
        stack_bound=int(scene.stack_bound),
    )


class Walk(NamedTuple):
    """Everything ``trace_plain`` computes per lane."""

    t: torch.Tensor  # [N] f32 best t (t_max = no hit)
    best: torch.Tensor  # [N] i32 tri << 8 | inst1, -1 = no hit
    steps: torch.Tensor  # [N] i32 node visits
    leaves: torch.Tensor  # [N] i32 leaf-record visits
    found: torch.Tensor  # [N] bool (any hit)
    incomplete: torch.Tensor  # [] i32 lanes whose stack overflowed
    quant: dict | None = None  # trace_plain(quantised=True): STATS, and bits_differ


class TraceResult(NamedTuple):
    t: torch.Tensor  # [N] closest hit distance (t_max = miss)
    tri: torch.Tensor  # [N] i32 global triangle id (-1 = miss)
    inst: torch.Tensor  # [N] i32 instance id (-1 = miss)
    steps: torch.Tensor  # [N] i32 node visits
    incomplete: torch.Tensor  # [] i32 rays whose stack overflowed


def _exact_child_bits(rec, o, inv, tb):
    """[N,8] today's slab test of the 8 children of exact rows ``rec`` [N,72]
    (``trace_plain``'s, NaN-propagating; the kind test not applied)."""
    t0 = (rec[:, 0:24].reshape(-1, 3, 8) - o[:, :, None]) * inv[:, :, None]
    t1 = (rec[:, 24:48].reshape(-1, 3, 8) - o[:, :, None]) * inv[:, :, None]
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t_near = torch.maximum(torch.clamp_min(lo[:, 0], RAY_EPSILON),
                           torch.maximum(lo[:, 1], lo[:, 2]))
    t_far = torch.minimum(torch.minimum(tb[:, None], hi[:, 0]),
                          torch.minimum(hi[:, 1], hi[:, 2]))
    return t_near < t_far


def node_bits_quantised_plain(qrec, rec, o, d, tb):
    """The quantised kernel's child test (``csrc/traverse.cu``, quant_kernel) on rows
    ``qrec`` [N,32] int32 and their exact rows ``rec`` [N,72], for rays ``o``,
    ``d`` [N,3] in the node's space and best t ``tb`` [N].

    Returns (bits [N,8], undecided [N,8], inner [N,8], exact_lane [N]): the bits
    the kernel sets; the children neither box decides (the kernel reads their
    exact floats); those the inner box decides hit; and the lanes that take the
    exact test for every child (an inverse direction component not finite or
    0, or an origin not finite: there the slab test can see NaN, which the
    quantised planes would not reproduce)."""
    n = qrec.shape[0]
    inv = 1.0 / d
    exact_lane = ~((torch.isfinite(inv) & (inv != 0)).all(dim=1) & torch.isfinite(o).all(dim=1))
    by = qrec.contiguous().view(torch.uint8).reshape(n, 4 * QREC_WORDS)
    bias = qrec[:, 0:3].contiguous().view(torch.float32)[:, :, None]  # [N,3,1]
    exp = by[:, 12:15].contiguous().view(torch.int8).to(torch.int32)[:, :, None]
    alive = ((by[:, 15:16].to(torch.int32) >> torch.arange(8, device=qrec.device)) & 1) > 0
    planes = by[:, Q_PLANES:Q_PLANES + 48].to(torch.int32).reshape(n, 6, 8)
    inward = by[:, Q_INWARD:Q_INWARD + 8].to(torch.int32)[:, None, :]  # [N,1,8]
    axis = torch.arange(3, dtype=torch.int32, device=qrec.device)[None, :, None]
    in_lo, in_hi = (inward >> axis) & 1, (inward >> (axis + 3)) & 1  # [N,3,8]
    q_lo, q_hi = planes[:, 0:3], planes[:, 3:6]

    pos = (inv > 0)[:, :, None]
    q_near, q_far = torch.where(pos, q_lo, q_hi), torch.where(pos, q_hi, q_lo)
    step = torch.where(pos, 1, -1)
    qn_in = q_near + step * torch.where(pos, in_lo, in_hi)
    qf_in = q_far - step * torch.where(pos, in_hi, in_lo)
    oE, iE = o[:, :, None], inv[:, :, None]

    def plane_t(q):  # ((X(q) + bias) - o) * inv, X(q) = 2^(23+e) + q * 2^e from its bits
        x = (((exp + 150) << 23) + q).to(torch.int32).view(torch.float32)
        return ((x + bias) - oE) * iE

    def hits(q_n, q_f):
        t_near = torch.clamp_min(plane_t(q_n).amax(dim=1), RAY_EPSILON)
        t_far = torch.minimum(plane_t(q_f).amin(dim=1), tb[:, None])
        return t_near < t_far

    outer, inner = hits(q_near, q_far) & alive, hits(qn_in, qf_in) & alive
    nonempty = (qrec[:, 16:24] >> 28) != KIND_EMPTY
    exact = _exact_child_bits(rec, o, inv, tb) & nonempty
    undecided = outer & ~inner & nonempty & ~exact_lane[:, None]
    inner = inner & nonempty & ~exact_lane[:, None]
    bits = torch.where(exact_lane[:, None], exact, inner | (undecided & exact))
    return bits, undecided, inner, exact_lane


def leaf_live_plain(rec):
    """[N] the live slots of 8-triangle rows ``rec`` [N,72] (component-major):
    the least k >= 1 such that slots k..7 equal slot k-1 bit for bit
    (``accel/wide.py:leaf_live_counts``)."""
    bits = rec.contiguous().view(torch.int32).reshape(-1, 9, 8)
    differs = (bits[:, :, 1:] != bits[:, :, :-1]).any(dim=1)  # [N,7]
    j = torch.arange(1, 8, device=rec.device)
    return torch.where(differs, j, 0).amax(dim=1) + 1


def walk_stack(bvh: WideSceneBVH, size: int | None) -> int:
    """The walk's stack: ``size`` where it is set (``RenderConfig.wide_stack_size``),
    else the scene's bound (at least 1)."""
    return max(bvh.stack_bound, 1) if size is None else size


def trace_plain(bvh: WideSceneBVH, o, d, t_max, active, stack_size: int | None,
                ordered: bool, any_hit: bool, quantised: bool = False) -> Walk:
    """Plain walk of all lanes, one ``_step`` per iteration, until none is alive,
    with a stack of ``stack_size`` entries (None: the scene's bound).  Besides
    the kernel's outputs it counts each lane's leaf visits, from which a caller
    can compute the work of a walk.  With ``quantised``, every node visit
    also runs ``node_bits_quantised_plain`` beside the exact test, which still
    drives the walk: ``Walk.quant`` counts the visits where the two differ
    (``bits_differ``) and the quantised kernel's counters (``STATS``)."""
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    s = walk_stack(bvh, stack_size)
    lanes = torch.arange(n, device=dev)
    root_entry = (KIND_INTERNAL << PAYLOAD_BITS | bvh.root) << 8
    cur = torch.where(active, root_entry, EXIT).to(i32)
    sp = torch.zeros((n,), dtype=i32, device=dev)
    ovf = torch.zeros((n,), dtype=torch.bool, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    tb = t_max.clone()
    best = torch.full((n,), -1, dtype=i32, device=dev)
    steps = torch.zeros((n,), dtype=i32, device=dev)
    leaves = torch.zeros((n,), dtype=i32, device=dev)
    # column s is a scratch slot that masked-off pushes write into
    stack = torch.zeros((n, s + 1), dtype=i32, device=dev)
    owx, owy, owz = o[:, 0], o[:, 1], o[:, 2]
    dwx, dwy, dwz = d[:, 0], d[:, 1], d[:, 2]
    inf = torch.tensor(float("inf"), device=dev)
    quant = dict.fromkeys(("bits_differ", *STATS), 0) if quantised else None
    exact_lanes = torch.zeros((n,), dtype=torch.bool, device=dev)
    space = torch.full((n,), -1, dtype=i32, device=dev)  # the kernel's cached instance

    while True:
        # ---- pop: resolve POP sentinels from the stack (or retire the ray) ----
        need = cur == POP
        has = sp > 0
        top = stack[lanes, torch.clamp_min(sp - 1, 0).long()]
        cur = torch.where(need, torch.where(has, top, EXIT), cur)
        sp = sp - (need & has).to(i32)
        live = cur >= 0
        if any_hit:
            live = live & ~found
        with trace.span("rt.host_read"):
            any_live = bool(live.any())
        if not any_live:
            break

        # ---- decode + ray into current instance space ----
        kind = torch.where(live, cur >> (PAYLOAD_BITS + 8), 0)
        payload = torch.where(live, (cur >> 8) & _PAYLOAD_MASK, 0)
        inst1 = torch.where(live, cur & 255, 0)
        m = bvh.inst_mat[inst1.long()]
        ox = m[:, 0] * owx + m[:, 1] * owy + m[:, 2] * owz + m[:, 3]
        oy = m[:, 4] * owx + m[:, 5] * owy + m[:, 6] * owz + m[:, 7]
        oz = m[:, 8] * owx + m[:, 9] * owy + m[:, 10] * owz + m[:, 11]
        dx = m[:, 0] * dwx + m[:, 1] * dwy + m[:, 2] * dwz
        dy = m[:, 4] * dwx + m[:, 5] * dwy + m[:, 6] * dwz
        dz = m[:, 8] * dwx + m[:, 9] * dwy + m[:, 10] * dwz
        if ordered:
            oct_ = (dx > 0).to(i32) | ((dy > 0).to(i32) << 1) | ((dz > 0).to(i32) << 2)
        else:
            oct_ = torch.zeros_like(payload)

        is_leaf = live & (kind == KIND_LEAF)
        is_node = live & (kind == KIND_INTERNAL)
        row = torch.where(
            is_leaf, bvh.node_rows + payload,
            torch.where(is_node, oct_ * bvh.n_nodes + payload, 0),
        )
        rec = bvh.table[row.long()]  # [N,72]

        def comp(c):
            return rec[:, c * 8:(c + 1) * 8]

        oxE, oyE, ozE = ox[:, None], oy[:, None], oz[:, None]
        dxE, dyE, dzE = dx[:, None], dy[:, None], dz[:, None]
        tbE = tb[:, None]

        # ---- leaf: eight Moller-Trumbore tests (BottomLevelBVH.cpp:214-258) ----
        e1x, e1y, e1z = comp(3), comp(4), comp(5)
        e2x, e2y, e2z = comp(6), comp(7), comp(8)
        hx = dyE * e2z - dzE * e2y
        hy = dzE * e2x - dxE * e2z
        hz = dxE * e2y - dyE * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / torch.where(torch.abs(a) < 1e-30, 1e-30, a)
        sx = oxE - comp(0)
        sy = oyE - comp(1)
        sz = ozE - comp(2)
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (dxE * qx + dyE * qy + dzE * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        hit = (
            (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0)
            & (t > RAY_EPSILON) & (t < tbE) & is_leaf[:, None]
        )
        if any_hit:
            found = found | hit.any(dim=1)
        else:
            # smallest t wins, the earliest j on ties
            t_cand = torch.where(hit, t, inf)
            jmin = torch.argmin(t_cand, dim=1, keepdim=True)
            tmin = torch.gather(t_cand, 1, jmin)[:, 0]
            new_hit = tmin < tb
            tb = torch.where(new_hit, tmin, tb)
            best = torch.where(
                new_hit, ((payload * 8 + jmin[:, 0].to(i32)) << 8) | inst1, best
            )

        # ---- node: slab-test all 8 children (NaN-propagating min/max) ----
        ix, iy, iz = (1.0 / dx)[:, None], (1.0 / dy)[:, None], (1.0 / dz)[:, None]
        t0x, t1x = (comp(0) - oxE) * ix, (comp(3) - oxE) * ix
        t0y, t1y = (comp(1) - oyE) * iy, (comp(4) - oyE) * iy
        t0z, t1z = (comp(2) - ozE) * iz, (comp(5) - ozE) * iz
        t_near = torch.maximum(
            torch.clamp_min(torch.minimum(t0x, t1x), RAY_EPSILON),
            torch.maximum(torch.minimum(t0y, t1y), torch.minimum(t0z, t1z)),
        )
        t_far = torch.minimum(
            torch.minimum(tbE, torch.maximum(t0x, t1x)),
            torch.minimum(torch.maximum(t0y, t1y), torch.maximum(t0z, t1z)),
        )
        fa = comp(6).to(i32)  # exact float values: convert, never bitcast
        fbv = comp(7).to(i32)
        entries = (fa << 8) | torch.where(fbv > 0, fbv, inst1[:, None])
        bits = (t_near < t_far) & is_node[:, None] & ((fa >> PAYLOAD_BITS) != KIND_EMPTY)
        if quantised:
            _count_quantised(quant, exact_lanes, bvh, row, rec, is_node, is_leaf, bits,
                             torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1), tb)
            enter = (is_node | is_leaf) & (inst1 != space)
            quant["enters"] += int(enter.sum())
            space = torch.where(enter, inst1, space)

        # nearest set child is taken now; the rest are pushed far to near
        ibits = bits.to(i32)
        incl = torch.cumsum(ibits, dim=1)
        is_first = bits & (incl == 1)
        first_entry = torch.where(is_first, entries, 0).sum(dim=1, dtype=i32)
        has_any = incl[:, 7] > 0
        rest = bits & ~is_first
        ir = rest.to(i32)
        n_push = ir.sum(dim=1, dtype=i32)
        rc = n_push[:, None] - (torch.cumsum(ir, dim=1) - ir)  # suffix-inclusive
        ovf = ovf | (is_node & (sp + n_push > s))
        pos = sp[:, None] + rc - 1  # entries past the stack (the nearest) are dropped
        ok = rest & (pos < s)
        stack.scatter_(1, torch.where(ok, pos, s).long(), entries)
        sp = torch.where(is_node, torch.clamp_max(sp + n_push, s), sp)

        # ---- advance ----
        nxt = torch.where(is_node & has_any, first_entry, POP).to(i32)
        cur = torch.where(is_node | is_leaf, nxt, cur)
        steps = steps + is_node.to(i32)
        leaves = leaves + is_leaf.to(i32)

    lost = (ovf & ~found) if any_hit else ovf
    if quantised:
        quant["exact_lanes"] = int(exact_lanes.sum())
    return Walk(tb, best, steps, leaves, found, lost.sum(dtype=i32), quant)


def _count_quantised(quant, exact_lanes, bvh, row, rec, is_node, is_leaf, bits, o, d, tb):
    """One iteration of ``trace_plain(quantised=True)``: the quantised test at
    its node visits against the exact ``bits``, and the kernel's counters."""
    node = torch.nonzero(is_node)[:, 0]
    qbits, undecided, inner, exact_lane = node_bits_quantised_plain(
        bvh.qrec[row[node].long()], rec[node], o[node], d[node], tb[node])
    quant["bits_differ"] += int((qbits != bits[node]).any(dim=1).sum())
    quant["quantised_node_visits"] += int((~exact_lane).sum())
    quant["exact_lane_node_visits"] += int(exact_lane.sum())
    quant["undecided_children"] += int(undecided.sum())
    quant["inner_hits"] += int(inner.sum())
    exact_lanes[node[exact_lane]] = True
    live = leaf_live_plain(rec[is_leaf])
    quant["leaf_visits"] += int(live.shape[0])
    quant["wide_leaf_visits"] += int((live > 4).sum())
    quant["live_tests"] += int(live.sum())


def _check_rays(what, bvh, o, d, t_max, active, stack_size):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,) or active.shape != (n,):
        raise ValueError(f"{what}: o, d [N,3], t_max, active [N] expected")
    if any(x.dtype != torch.float32 for x in (o, d, t_max, bvh.table, bvh.inst_mat)):
        raise TypeError(f"{what}: float32 rays and table expected")
    if active.dtype != torch.bool:
        raise TypeError(f"{what}: active must be bool")
    if any(x.device != o.device for x in (d, t_max, active, bvh.table, bvh.inst_mat)):
        raise ValueError(f"{what}: inputs on different devices")
    if not 1 <= stack_size <= STACK_CAPACITY:
        raise ValueError(f"{what}: a stack of {stack_size} entries; the walk holds 1.."
                         f"{STACK_CAPACITY}")
    kernels.require_contiguous(what, o, d, t_max, active, bvh.table, bvh.inst_mat)
    kernels.require_no_grad(what, o, d, t_max, bvh.table, bvh.inst_mat)


def _launch(any_hit: bool, bvh: WideSceneBVH, o, d, t_max, active, cfg: RenderConfig,
            form: int = FORMS["quantised"], stats=None):
    """One rt_trace launch of ``form`` (``FORMS``, or ``_COUNTING``, which adds
    the counters to ``stats``); returns (t, best, steps, found, incomplete)."""
    what = "trace_any" if any_hit else "trace_closest"
    size = walk_stack(bvh, cfg.wide_stack_size)
    _check_rays(what, bvh, o, d, t_max, active, size)
    if form != FORMS["exact"]:
        if (bvh.qrec.dtype != torch.int32 or bvh.qrec.shape != (bvh.node_rows, QREC_WORDS)
                or bvh.qrec.device != o.device or bvh.qrec.data_ptr() % 16):
            raise ValueError(f"{what}: qrec [node_rows, 32] int32, 16-byte aligned, "
                             "on the rays' device expected")
        kernels.require_contiguous(what, bvh.qrec)
    n = o.shape[0]
    dev = o.device
    incomplete = torch.zeros((1,), dtype=torch.int32, device=dev)
    if any_hit:
        t = best = steps = None
        found = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        best = torch.empty((n,), dtype=torch.int32, device=dev)
        steps = torch.empty((n,), dtype=torch.int32, device=dev)
        found = None
    if n == 0:
        return t, best, steps, found, incomplete[0]
    P, I = kernels.P, kernels.I
    fn = kernels.entry("traverse", "rt_trace",
                       [I, I, P, P, I, I, P, I, I, P, P, P, P, I, P, P, P, P, P, P, P])

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = fn(int(any_hit), form, bvh.table.data_ptr(), bvh.qrec.data_ptr(), bvh.node_rows,
             bvh.root, bvh.inst_mat.data_ptr(), size,
             int(cfg.traversal_strategy == TraversalStrategy.ORDERED),
             o.data_ptr(), d.data_ptr(), t_max.data_ptr(), active.data_ptr(), n,
             ptr(t), ptr(best), ptr(steps), ptr(found), incomplete.data_ptr(), ptr(stats),
             kernels.stream_ptr(dev))
    trace.count(("launch.k2" if any_hit else "launch.k1")
                + (".exact" if form == FORMS["exact"] else ""))
    kernels.check(err, what)
    return t, best, steps, found, incomplete[0]


def trace_form(form: str, any_hit: bool, bvh: WideSceneBVH, o, d, t_max, active,
               cfg: RenderConfig) -> tuple:
    """(t, best, steps, found, incomplete) of one walk by the kernel's ``form``
    (``FORMS``: "quantised" is the renderer's K1 / K2, "exact" the first walk of the
    exact records, kept to time and hold the quantised one against; t, best
    and steps are None for any hit, found for closest).  CPU tensors take
    ``trace_plain``; CUDA tensors launch ``rt_trace`` (the exact form counted in
    ``trace.counters["launch.k1.exact"]`` and ``"launch.k2.exact"``)."""
    if form not in FORMS:
        raise ValueError(f"trace_form: form must be one of {tuple(FORMS)}")
    if o.device.type != "cpu":
        return _launch(any_hit, bvh, o, d, t_max, active, cfg, FORMS[form])
    w = trace_plain(bvh, o, d, t_max, active, cfg.wide_stack_size,
                    cfg.traversal_strategy == TraversalStrategy.ORDERED, any_hit)
    if any_hit:
        return None, None, None, w.found, w.incomplete
    return w.t, w.best, w.steps, None, w.incomplete


def walk_stats(any_hit: bool, bvh: WideSceneBVH, o, d, t_max, active,
               cfg: RenderConfig) -> dict:
    """The quantised walk's counters (``STATS``): on CUDA tensors from one
    launch of the kernel's counting instance (counted as a quantised launch),
    on CPU tensors from ``trace_plain(quantised=True)``, which adds
    ``bits_differ``."""
    if o.device.type == "cpu":
        return trace_plain(bvh, o, d, t_max, active, cfg.wide_stack_size,
                           cfg.traversal_strategy == TraversalStrategy.ORDERED, any_hit,
                           quantised=True).quant
    stats = torch.zeros((len(STATS),), dtype=torch.int64, device=o.device)
    _launch(any_hit, bvh, o, d, t_max, active, cfg, _COUNTING, stats)
    return dict(zip(STATS, (int(v) for v in stats.cpu())))


def trace_closest(bvh: WideSceneBVH, o, d, t_max, active, cfg: RenderConfig) -> TraceResult:
    """K1: closest hit for a wavefront of world-space rays.  CPU tensors take
    ``trace_plain``; CUDA tensors launch ``rt_trace`` (counted in
    ``trace.counters["launch.k1"]``)."""
    if o.device.type == "cpu":
        w = trace_plain(bvh, o, d, t_max, active, cfg.wide_stack_size,
                        cfg.traversal_strategy == TraversalStrategy.ORDERED, any_hit=False)
        t, best, steps, incomplete = w.t, w.best, w.steps, w.incomplete
    else:
        t, best, steps, _found, incomplete = _launch(False, bvh, o, d, t_max, active, cfg)
    tri = torch.where(best >= 0, best >> 8, -1)
    inst = torch.where(best >= 0, (best & 255) - 1, -1)
    return TraceResult(t=t, tri=tri, inst=inst, steps=steps, incomplete=incomplete)


def trace_any(bvh: WideSceneBVH, o, d, t_max, active, cfg: RenderConfig):
    """K2: any-hit (shadow) traversal; a ray retires at its first hit
    (BottomLevelBVH.cpp:398-437).  Returns (found [N] bool, incomplete [] i32).
    CPU tensors take ``trace_plain``; CUDA tensors launch ``rt_trace``
    (counted in ``trace.counters["launch.k2"]``)."""
    if o.device.type == "cpu":
        w = trace_plain(bvh, o, d, t_max, active, cfg.wide_stack_size,
                        cfg.traversal_strategy == TraversalStrategy.ORDERED, any_hit=True)
        found, incomplete = w.found, w.incomplete
    else:
        _t, _best, _steps, found, incomplete = _launch(True, bvh, o, d, t_max, active, cfg)
    return found, incomplete

