"""Wavefront 8-wide BVH traversal (counterpart of ``raytracer_tpu/ops/traversal_wide.py``),
kernels K1 (closest hit) and K2 (any hit).

The TLAS and every BLAS share one unified record table; entering an instance is
following a child entry whose instance bits switch the ray into object space, and
every stack entry carries its instance id (see ``accel/wide.py``).  A ray walks
until it is done: there is no iteration ladder, and ``incomplete`` counts only
rays whose short stack overflowed.

``trace_closest`` / ``trace_any`` launch ``csrc/traverse.cu`` for CUDA tensors and
run ``trace_plain`` for CPU tensors.  ``trace_plain`` is the JAX package's ``_step``
as a vectorised loop over all lanes until none is alive, with the same float32
arithmetic, so ids and step counts agree lane for lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..accel.wide import KIND_EMPTY, KIND_INTERNAL, KIND_LEAF, PAYLOAD_BITS
from ..config import RAY_EPSILON, RenderConfig, TraversalStrategy

POP = -1  # take the next deferred entry off the stack
EXIT = -2  # traversal finished

_PAYLOAD_MASK = (1 << PAYLOAD_BITS) - 1
_MAX_STACK = 64  # csrc/traverse.cu kMaxStack

# rt_trace launches, closest and any hit (reset and read by chip_smoke.py)
closest_launches = 0
any_launches = 0


class WideSceneBVH(NamedTuple):
    """Unified per-frame traversal structure: [BLAS block | per-frame TLAS | tris]."""

    table: torch.Tensor  # [8*W + T/8, 72] f32 unified records
    inst_mat: torch.Tensor  # [I+1,12] f32 inverse instance matrices (slot 0 identity)
    root: int  # global index of the TLAS wide root
    node_rows: int  # 8*W (first triangle-record row)

    @property
    def n_nodes(self) -> int:
        return self.node_rows // 8


def build_scene_bvh(scene) -> WideSceneBVH:
    """Assemble the frame's unified wide traversal table (traversal_wide.py:71-103
    of the JAX package): static BLAS records, the per-frame TLAS after them, then
    the component-major 8-triangle leaf records (col c*8 + j)."""
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
        inst_mat=inst_mat.contiguous(),
        root=wb,
        node_rows=rec.shape[0],
    )


class Walk(NamedTuple):
    """Everything ``trace_plain`` computes per lane."""

    t: torch.Tensor  # [N] f32 best t (t_max = no hit)
    best: torch.Tensor  # [N] i32 tri << 8 | inst1, -1 = no hit
    steps: torch.Tensor  # [N] i32 node visits
    leaves: torch.Tensor  # [N] i32 leaf-record visits
    found: torch.Tensor  # [N] bool (any hit)
    incomplete: torch.Tensor  # [] i32 lanes whose stack overflowed


class TraceResult(NamedTuple):
    t: torch.Tensor  # [N] closest hit distance (t_max = miss)
    tri: torch.Tensor  # [N] i32 global triangle id (-1 = miss)
    inst: torch.Tensor  # [N] i32 instance id (-1 = miss)
    steps: torch.Tensor  # [N] i32 node visits
    incomplete: torch.Tensor  # [] i32 rays whose stack overflowed


def trace_plain(bvh: WideSceneBVH, o, d, t_max, active, stack_size: int,
                ordered: bool, any_hit: bool) -> Walk:
    """Plain walk of all lanes, one ``_step`` per iteration, until none is alive.
    Besides the kernel's outputs it counts each lane's leaf visits, from which a
    caller can compute the work of a walk."""
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    s = stack_size
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
        if not bool(live.any()):
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
    return Walk(tb, best, steps, leaves, found, lost.sum(dtype=i32))


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
    if not 1 <= stack_size <= _MAX_STACK:
        raise ValueError(f"{what}: wide_stack_size must be in 1..{_MAX_STACK}")
    kernels.require_cuda_input(what, o, d, t_max, active, bvh.table, bvh.inst_mat)


def _launch(any_hit: bool, bvh: WideSceneBVH, o, d, t_max, active, cfg: RenderConfig):
    """One rt_trace launch; returns (t, best, steps, found, incomplete)."""
    global closest_launches, any_launches
    what = "trace_any" if any_hit else "trace_closest"
    _check_rays(what, bvh, o, d, t_max, active, cfg.wide_stack_size)
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
                       [I, P, I, I, P, I, I, P, P, P, P, I, P, P, P, P, P, P])

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = fn(int(any_hit), bvh.table.data_ptr(), bvh.node_rows, bvh.root,
             bvh.inst_mat.data_ptr(), cfg.wide_stack_size,
             int(cfg.traversal_strategy == TraversalStrategy.ORDERED),
             o.data_ptr(), d.data_ptr(), t_max.data_ptr(), active.data_ptr(), n,
             ptr(t), ptr(best), ptr(steps), ptr(found), incomplete.data_ptr(),
             kernels.stream_ptr(dev))
    if any_hit:
        any_launches += 1
    else:
        closest_launches += 1
    kernels.check(err, what)
    return t, best, steps, found, incomplete[0]


def trace_closest(bvh: WideSceneBVH, o, d, t_max, active, cfg: RenderConfig) -> TraceResult:
    """K1: closest hit for a wavefront of world-space rays.  CPU tensors take
    ``trace_plain``; CUDA tensors launch ``rt_trace`` (counted in ``closest_launches``)."""
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
    (counted in ``any_launches``)."""
    if o.device.type == "cpu":
        w = trace_plain(bvh, o, d, t_max, active, cfg.wide_stack_size,
                        cfg.traversal_strategy == TraversalStrategy.ORDERED, any_hit=True)
        found, incomplete = w.found, w.incomplete
    else:
        _t, _best, _steps, found, incomplete = _launch(True, bvh, o, d, t_max, active, cfg)
    return found, incomplete

