"""The roofline bound of the wide walks K1/K2 (``quant_kernel<``,
``raytracer_tpu_torch/csrc/traverse.cu``), counted the same way whatever
implements them: never from the kernel's own counters or form.

The profiled poses are rendered again through the loop's renderer with
``traversal_wide.trace_closest`` / ``trace_any`` wrapped, which keeps a seeded
sample of each launch's active lanes.  A frozen copy of the ordered walk's visit
rule (the program's ``ops/traversal_wide.py:trace_plain``: the nearest hit child
taken, the rest pushed far to near, a closest hit's best t pruning, an any hit
retiring at its first hit) walks the sample over the exact records, and its
visits are priced by constants counted from the kernel's arithmetic
(``chip_smoke.py``'s ``OPS_*``): each transform of the ray into an instance's
space, a slab test for each live (non-empty) child of a node visited, a
Moller-Trumbore test for each live triangle of a leaf visited.  Operations scale
by active lanes over sampled ones.  Bytes are each distinct table row the sample
touches, read once, and each lane's rays and results.  A launch's bound is
max(operations / 67e12 per s, bytes / 3.35e12 per s) on an H100 SXM.
"""

from __future__ import annotations

import torch

PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# float32 operations, counted from csrc/traverse.cu: the ray's transform into an
# instance's space (33) and its inverse direction (3); one child's slab test;
# one triangle's Moller-Trumbore test
OPS_ENTER, OPS_CHILD, OPS_TRIANGLE = 33 + 3, 25, 54
ROW_BYTES = 72 * 4  # a row of the exact table
# a lane's rays (o, d, t_max, active) and results (closest: t, best, steps;
# any: found)
LANE_BYTES = {False: 29 + 12, True: 29 + 1}
SAMPLE = 65_536  # lanes walked a launch
STACK = 256  # entries: more than any scene the program packs can push
RAY_EPSILON = 0.005
PAYLOAD_BITS, KIND_INTERNAL, KIND_LEAF, KIND_EMPTY = 20, 0, 1, 7
POP, EXIT = -1, -2


def capture(loop, frames) -> list:
    """Render ``frames`` (window frame indices) again through ``loop``'s renderer
    and return a sample of every K1/K2 launch's lanes: (any_hit, bvh, ordered,
    lanes, active lanes, o, d, t_max) of the sampled lanes."""
    from raytracer_tpu_torch.ops import traversal_wide as tw

    saved = tw.trace_closest, tw.trace_any
    launches = []

    def keep(any_hit, bvh, o, d, t_max, active, cfg):
        idx = torch.nonzero(active)[:, 0]
        n_active = int(idx.shape[0])
        if n_active > SAMPLE:
            g = torch.Generator().manual_seed(len(launches))
            idx = idx[torch.randperm(n_active, generator=g)[:SAMPLE].to(idx.device)]
        ordered = getattr(cfg.traversal_strategy, "name", "") == "ORDERED"
        launches.append((any_hit, bvh, ordered, int(o.shape[0]), n_active,
                         o[idx].clone(), d[idx].clone(), t_max[idx].clone()))

    def closest(bvh, o, d, t_max, active, cfg):
        keep(False, bvh, o, d, t_max, active, cfg)
        return saved[0](bvh, o, d, t_max, active, cfg)

    def any_hit(bvh, o, d, t_max, active, cfg):
        keep(True, bvh, o, d, t_max, active, cfg)
        return saved[1](bvh, o, d, t_max, active, cfg)

    try:
        tw.trace_closest, tw.trace_any = closest, any_hit
        for i in frames:
            k = (loop.start + i) % len(loop.poses)
            image, _ = loop.rend(loop.scene._replace(**{f: v[k] for f, v in loop.cams.items()}))
            float(image.sum())
    finally:
        tw.trace_closest, tw.trace_any = saved
    return launches


def _live(table, node_rows):
    """(live children of each node row, live triangles of each leaf row): a
    child is live unless empty; a leaf's slots k..7 that repeat slot k-1 bit for
    bit are padding."""
    kind = table[:node_rows, 48:56].to(torch.int32) >> PAYLOAD_BITS
    children = (kind != KIND_EMPTY).sum(dim=1).to(torch.int64)
    bits = table[node_rows:].contiguous().view(torch.int32).reshape(-1, 9, 8)
    differs = (bits[:, :, 1:] != bits[:, :, :-1]).any(dim=1)  # slot j+1 vs slot j
    j = torch.arange(1, 8, device=table.device)
    triangles = (torch.where(differs, j, 0).amax(dim=1) + 1).to(torch.int64)
    return children, triangles


def count(any_hit, bvh, ordered, o, d, t_max) -> dict:
    """The frozen walk of lanes ``o``, ``d``, ``t_max`` (all active) over ``bvh``'s
    exact table: transforms, live children tested, live triangles tested, the
    distinct table rows touched, node and leaf visits."""
    table, inst_mat, node_rows = bvh.table, bvh.inst_mat, int(bvh.node_rows)
    n_nodes = node_rows // 8
    children, triangles = _live(table, node_rows)
    n, dev, i32 = o.shape[0], o.device, torch.int32
    lanes = torch.arange(n, device=dev)
    cur = torch.full((n,), (KIND_INTERNAL << PAYLOAD_BITS | int(bvh.root)) << 8, dtype=i32,
                     device=dev)
    sp = torch.zeros((n,), dtype=i32, device=dev)
    stack = torch.zeros((n, STACK + 1), dtype=i32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    tb = t_max.clone()
    space = torch.full((n,), -1, dtype=i32, device=dev)
    touched = torch.zeros((table.shape[0],), dtype=torch.bool, device=dev)
    enters = tested = tris = nodes = leaves = torch.zeros((), dtype=torch.int64, device=dev)
    owx, owy, owz = o[:, 0], o[:, 1], o[:, 2]
    dwx, dwy, dwz = d[:, 0], d[:, 1], d[:, 2]
    inf = torch.tensor(float("inf"), device=dev)
    while True:
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
        kind = torch.where(live, cur >> (PAYLOAD_BITS + 8), 0)
        payload = torch.where(live, (cur >> 8) & ((1 << PAYLOAD_BITS) - 1), 0)
        inst1 = torch.where(live, cur & 255, 0)
        m = inst_mat[inst1.long()]
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
        row = torch.where(is_leaf, node_rows + payload,
                          torch.where(is_node, oct_ * n_nodes + payload, 0))
        touched[row[is_leaf | is_node].long()] = True
        visit = is_leaf | is_node
        nodes, leaves = nodes + is_node.sum(), leaves + is_leaf.sum()
        enters = enters + (visit & (inst1 != space)).sum()
        space = torch.where(visit, inst1, space)
        tested = tested + children[torch.where(is_node, payload, 0).long()][is_node].sum()
        tris = tris + triangles[torch.where(is_leaf, payload, 0).long()][is_leaf].sum()
        rec = table[row.long()]

        def comp(c):
            return rec[:, c * 8:(c + 1) * 8]

        oxE, oyE, ozE = ox[:, None], oy[:, None], oz[:, None]
        dxE, dyE, dzE = dx[:, None], dy[:, None], dz[:, None]
        tbE = tb[:, None]
        # leaf: eight Moller-Trumbore tests
        e1x, e1y, e1z = comp(3), comp(4), comp(5)
        e2x, e2y, e2z = comp(6), comp(7), comp(8)
        hx = dyE * e2z - dzE * e2y
        hy = dzE * e2x - dxE * e2z
        hz = dxE * e2y - dyE * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / torch.where(torch.abs(a) < 1e-30, 1e-30, a)
        sx, sy, sz = oxE - comp(0), oyE - comp(1), ozE - comp(2)
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (dxE * qx + dyE * qy + dzE * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        hit = ((u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) & (t > RAY_EPSILON)
               & (t < tbE) & is_leaf[:, None])
        if any_hit:
            found = found | hit.any(dim=1)
        else:
            tmin = torch.where(hit, t, inf).amin(dim=1)
            tb = torch.where(tmin < tb, tmin, tb)
        # node: the slab test of the 8 children (NaN-propagating min / max)
        ix, iy, iz = (1.0 / dx)[:, None], (1.0 / dy)[:, None], (1.0 / dz)[:, None]
        t0x, t1x = (comp(0) - oxE) * ix, (comp(3) - oxE) * ix
        t0y, t1y = (comp(1) - oyE) * iy, (comp(4) - oyE) * iy
        t0z, t1z = (comp(2) - ozE) * iz, (comp(5) - ozE) * iz
        t_near = torch.maximum(torch.clamp_min(torch.minimum(t0x, t1x), RAY_EPSILON),
                               torch.maximum(torch.minimum(t0y, t1y), torch.minimum(t0z, t1z)))
        t_far = torch.minimum(torch.minimum(tbE, torch.maximum(t0x, t1x)),
                              torch.minimum(torch.maximum(t0y, t1y), torch.maximum(t0z, t1z)))
        fa = comp(6).to(i32)
        fbv = comp(7).to(i32)
        entries = (fa << 8) | torch.where(fbv > 0, fbv, inst1[:, None])
        bits = (t_near < t_far) & is_node[:, None] & ((fa >> PAYLOAD_BITS) != KIND_EMPTY)
        # the nearest set child now, the rest pushed far to near
        incl = torch.cumsum(bits.to(i32), dim=1)
        is_first = bits & (incl == 1)
        first_entry = torch.where(is_first, entries, 0).sum(dim=1, dtype=i32)
        rest = bits & ~is_first
        ir = rest.to(i32)
        n_push = ir.sum(dim=1, dtype=i32)
        rc = n_push[:, None] - (torch.cumsum(ir, dim=1) - ir)
        pos = sp[:, None] + rc - 1
        ok = rest & (pos < STACK)
        stack.scatter_(1, torch.where(ok, pos, STACK).long(), entries)
        sp = torch.where(is_node, torch.clamp_max(sp + n_push, STACK), sp)
        nxt = torch.where(is_node & (incl[:, 7] > 0), first_entry, POP).to(i32)
        cur = torch.where(is_node | is_leaf, nxt, cur)
    return {"enters": int(enters), "children": int(tested), "triangles": int(tris),
            "rows": int(touched.sum()), "nodes": int(nodes), "leaves": int(leaves)}


def bound_ms(launches) -> float:
    """The summed roofline bound of ``launches`` (``capture``'s), in ms."""
    total = 0.0
    for any_hit, bvh, ordered, n_lanes, n_active, o, d, t_max in launches:
        if n_active == 0:
            continue
        c = count(any_hit, bvh, ordered, o, d, t_max)
        ops = (c["enters"] * OPS_ENTER + c["children"] * OPS_CHILD
               + c["triangles"] * OPS_TRIANGLE) * n_active / o.shape[0]
        n_bytes = c["rows"] * ROW_BYTES + n_lanes * LANE_BYTES[any_hit]
        total += max(ops / PEAK_F32_PER_S, n_bytes / PEAK_BYTES_PER_S) * 1e3
    return total


def walk_ms(ctx):
    """Device time a profiled frame of K1/K2's events (``quant_kernel<``), or None."""
    p = ctx.profile
    if p is None or not p.frames:
        return None
    ms = p.device_ms("quant_kernel<")
    return ms / p.frames if ms > 0 else None
