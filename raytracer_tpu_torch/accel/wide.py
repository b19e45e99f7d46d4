"""8-wide BVH ("BVH8") collapse for gather-bound TPU traversal.

The reference traverses a binary BVH one node per stack pop (BottomLevelBVH.cpp:
355-396) because on CPU the win comes from packet SIMD within a node.  On this TPU
the traversal cost model is *row gathers*: a [N] gather from a [U, K] table costs
the same ~6 ns/lane for any K up to 80 floats (measured, PERF.md), so the
TPU-native accelerator fetches EIGHT child AABBs + links in ONE gather.  Collapsing
the binary SBVH into an 8-wide tree divides the per-ray iteration count by ~3 at
identical per-iteration cost.

Collapse is the standard greedy surface-area pull-up (Ylitie et al. 2017 without
compression): starting from a node's two binary children, repeatedly replace the
internal child with the largest surface area by its own two children until 8 slots
are filled.  Binary leaves (<= 8 triangles by builder construction, 8-padded by the
BLAS flatten) become single-gather leaf children referencing one 8-triangle record.

Traversal order: children are pre-sorted per ray-direction octant by the projection
of their AABB centroid onto the octant diagonal — the 8-wide generalization of the
reference's ordered descent (BVHNode.h:30-40).  Records are stored octant-major so
the traversal's "nearest remaining child" is simply the lowest set bit of its hit
mask.

Child-slot encoding (carried through the traversal stack as one int32, and stored
in the record as two exact-value floats since int bit patterns do not survive f32
canonicalization on this TPU — PERF.md):

    f_a = kind << 20 | payload        (< 2^23, exact in float32)
    f_b = instance override            (0 = inherit, i+1 = enter instance i)
    stack entry = int(f_a) << 8 | inst1

kinds: 0 = internal (payload = wide node index; f_b > 0 means "enter instance
f_b-1 at BLAS root `payload`"), 1 = leaf (payload = 8-triangle record index),
7 = empty slot (box is inverted so the slab test always misses).
"""

from __future__ import annotations

import dataclasses

import numpy as np

KIND_INTERNAL = 0
KIND_LEAF = 1
KIND_EMPTY = 7

# kind(3) | payload(20) fits 23 bits => exact float32; payload bound asserted
PAYLOAD_BITS = 20
PAYLOAD_MAX = 1 << PAYLOAD_BITS

# Empty slots use a degenerate far-away POINT box: the slab test min/maxes the two
# planes per axis, so an inverted box (min > max) would behave like a huge valid box
# and always HIT; a point at 1e30 instead yields t_near >= t_far for every ray.
# (Finite, because inf * 0 in the slab test would produce NaN.)
_EMPTY_MIN = 1.0e30
_EMPTY_MAX = 1.0e30


@dataclasses.dataclass
class WideBVH:
    """Collapsed 8-wide BVH, children in slot order (unsorted)."""

    child_min: np.ndarray  # [W,8,3] f32
    child_max: np.ndarray  # [W,8,3] f32
    child_kind: np.ndarray  # [W,8] i32
    child_payload: np.ndarray  # [W,8] i32 (LOCAL: wide node / leaf record index)
    child_fb: np.ndarray  # [W,8] i32 instance override (0 = inherit)
    order: np.ndarray  # [8,W,8] i8: per-octant visit order (slot permutation)
    depth: int  # max wide-tree depth (stack sizing diagnostic)

    @property
    def n_nodes(self) -> int:
        return self.child_min.shape[0]


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def _dp_slot_partition(node_left, node_count, sa):
    """SAH-cost-optimal 8-wide collapse partition (Ylitie et al. 2017 §4.1,
    specialized to this hardware's cost model).

    On this TPU every slot — wide-node record or 8-triangle leaf record —
    costs exactly ONE fat gather when a ray hits its box (PERF.md: fixed
    ~13 ns/lane per gather op, any row width), so the expected traversal cost
    of a collapse is simply  sum over slots of SA(slot) / SA(root).  The DP
    minimizes that directly:

      cost[i][j] = min cost of representing binary subtree i using j child
                   slots of its parent's wide node
      leaf:      cost[i][j] = SA(i)                      (indivisible record)
      internal:  cost[i][1] = SA(i) + cost[i][8]         (create a wide node)
                 cost[i][j] = min( cost[i][1],
                                   min_{a+b=j} cost[l][a] + cost[r][b] )

    Returns (slots_of, node_cost): ``slots_of(i)`` yields the binary-node ids
    occupying the 8 slots of the wide node created at binary node i."""
    n = node_left.shape[0]
    is_leaf = node_count > 0
    INF = np.float64(np.inf)
    cost = np.full((n, 9), INF)
    # split[i][j]: 0 = subtree i occupies ONE slot; a in 1..j-1 = distribute
    # (a, j-a) over i's two children.  dsplit[i] = the pure-distribution argmin
    # for j=8, used when a wide node is MATERIALIZED at i (its own contents
    # must be distributed, never re-noded).
    split = np.zeros((n, 9), np.int8)
    dsplit = np.zeros((n,), np.int8)
    for i in range(n - 1, -1, -1):  # DFS pre-order: children after parent
        if is_leaf[i]:
            cost[i, 1:] = sa[i]
            continue
        l = int(node_left[i])
        r = l + 1
        d = np.full(9, INF)
        for j in range(2, 9):
            best, arg = INF, 1
            for a in range(1, j):
                c = cost[l, a] + cost[r, j - a]
                if c < best:
                    best, arg = c, a
            d[j] = best
            split[i, j] = arg
        dsplit[i] = split[i, 8]
        one = sa[i] + d[8]
        cost[i, 1] = one
        for j in range(2, 9):
            if one < d[j]:
                cost[i, j] = one
                split[i, j] = 0
            else:
                cost[i, j] = d[j]

    def slots_of(i):
        """Binary-node ids filling the 8 slots of the wide node created at i."""
        out = []

        def resolve(b, j):
            if j == 1 or is_leaf[b] or split[b, j] == 0:
                out.append(b)
                return
            a = int(split[b, j])
            l = int(node_left[b])
            resolve(l, a)
            resolve(l + 1, j - a)

        a = int(dsplit[i])
        l = int(node_left[i])
        resolve(l, a)
        resolve(l + 1, 8 - a)
        return out

    return slots_of, cost


def collapse8(
    node_min: np.ndarray,
    node_max: np.ndarray,
    node_left: np.ndarray,
    node_count: np.ndarray,
    leaf_kind: np.ndarray,
    leaf_payload: np.ndarray,
    leaf_fb: np.ndarray,
    strategy: str = "sah",
) -> WideBVH:
    """Collapse a binary BVH (bvh.py layout: root 0, children in pairs) to 8-wide.

    ``leaf_kind/payload/fb`` give, per binary node index, the child-slot encoding to
    emit when that binary node is a leaf — the caller decides what a leaf means
    (triangle record for a BLAS, instance entry for the TLAS).
    ``strategy``: "sah" = cost-optimal DP partition (_dp_slot_partition);
    "greedy" = largest-surface-area pull-up (kept for ablation).
    """
    is_leaf = node_count > 0
    sa = _surface_area(node_min, node_max)
    n_bin = node_left.shape[0]
    slots_dp = None
    if strategy == "sah" and not is_leaf[0]:
        slots_dp, _cost = _dp_slot_partition(node_left, node_count, sa)

    def leaf_slot(b):
        return (
            int(leaf_kind[b]),
            int(leaf_payload[b]),
            int(leaf_fb[b]),
            node_min[b],
            node_max[b],
        )

    # --- greedy pull-up, DFS over wide nodes -------------------------------
    slots_per_node: list = []  # list of lists of slot tuples / ("W", wide_child_ref)
    # Each wide node is created with its slot list; internal slots reference a
    # pending binary subtree that becomes its own wide node.
    wide_children: list = []  # [W] list of (kind, payload, fb, bmin, bmax)

    if is_leaf[0]:
        wide_children.append([leaf_slot(0)])
        depth = 1
    else:
        # stack of (binary_node, wide_index); wide ids assigned in DFS pre-order
        wide_children.append(None)
        stack = [(0, 0, 1)]
        depth = 1
        while stack:
            b, w, dep = stack.pop()
            depth = max(depth, dep)
            if slots_dp is not None:
                group = slots_dp(b)
            else:
                group = [int(node_left[b]), int(node_left[b]) + 1]
                while len(group) < 8:
                    # expand the internal child with the largest surface area
                    best_i, best_sa = -1, -1.0
                    for i, c in enumerate(group):
                        if not is_leaf[c] and sa[c] > best_sa:
                            best_i, best_sa = i, sa[c]
                    if best_i < 0:
                        break
                    c = group.pop(best_i)
                    group.extend([int(node_left[c]), int(node_left[c]) + 1])
            slots = []
            for c in group:
                if is_leaf[c]:
                    slots.append(leaf_slot(c))
                else:
                    cw = len(wide_children)
                    wide_children.append(None)
                    stack.append((c, cw, dep + 1))
                    slots.append(
                        (KIND_INTERNAL, cw, 0, node_min[c], node_max[c])
                    )
            wide_children[w] = slots

    w_count = len(wide_children)
    assert w_count < PAYLOAD_MAX, "wide node count exceeds payload field"
    child_min = np.full((w_count, 8, 3), _EMPTY_MIN, np.float32)
    child_max = np.full((w_count, 8, 3), _EMPTY_MAX, np.float32)
    child_kind = np.full((w_count, 8), KIND_EMPTY, np.int32)
    child_payload = np.zeros((w_count, 8), np.int32)
    child_fb = np.zeros((w_count, 8), np.int32)
    for w, slots in enumerate(wide_children):
        for j, (k, p, fb, bmin, bmax) in enumerate(slots):
            child_kind[w, j] = k
            child_payload[w, j] = p
            child_fb[w, j] = fb
            child_min[w, j] = bmin
            child_max[w, j] = bmax

    order = _octant_orders(child_min, child_max, child_kind)
    del n_bin
    return WideBVH(
        child_min=child_min,
        child_max=child_max,
        child_kind=child_kind,
        child_payload=child_payload,
        child_fb=child_fb,
        order=order,
        depth=depth,
    )


def _octant_orders(child_min, child_max, child_kind) -> np.ndarray:
    """[8,W,8] visit order per octant: ascending centroid projection onto the
    octant diagonal (empty slots last)."""
    centroid = 0.5 * (child_min + child_max)  # [W,8,3]
    empty = child_kind == KIND_EMPTY
    w = child_min.shape[0]
    order = np.zeros((8, w, 8), np.int8)
    for o in range(8):
        sign = np.array(
            [1.0 if (o >> a) & 1 else -1.0 for a in range(3)], np.float32
        )
        key = (centroid * sign).sum(-1)
        key = np.where(empty, np.inf, key)
        order[o] = np.argsort(key, axis=1, kind="stable").astype(np.int8)
    return order


def collapse_blas(node_min, node_max, node_left, node_count) -> WideBVH:
    """Collapse a BLAS binary BVH whose leaves are 8-aligned triangle ranges of
    at most 8 triangles (guaranteed by the builder leaf cap + 8-padded flatten)."""
    is_leaf = node_count > 0
    assert np.all(node_count[is_leaf] <= 8), "leaf exceeds one 8-triangle record"
    assert np.all(node_left[is_leaf] % 8 == 0), "leaf range not 8-aligned"
    leaf_kind = np.full(node_left.shape, KIND_LEAF, np.int32)
    leaf_payload = (node_left // 8).astype(np.int32)
    leaf_fb = np.zeros_like(leaf_payload)
    return collapse8(
        node_min, node_max, node_left, node_count, leaf_kind, leaf_payload, leaf_fb
    )


def build_wide_tlas(
    inst_min: np.ndarray,
    inst_max: np.ndarray,
    inst_wide_root: np.ndarray,
) -> WideBVH:
    """Per-frame wide TLAS over instance world AABBs (TopLevelBVH.cpp:32-45
    rebuilt every frame).  Instance children are INTERNAL entries carrying an
    instance override: payload = the instance's (GLOBAL) BLAS wide root, f_b =
    instance id + 1; the traversal switches ray space when it enters them."""
    n = inst_min.shape[0]
    assert n >= 1
    if n <= 8:
        # single wide root: no binary build needed
        child_min = np.full((1, 8, 3), _EMPTY_MIN, np.float32)
        child_max = np.full((1, 8, 3), _EMPTY_MAX, np.float32)
        child_kind = np.full((1, 8), KIND_EMPTY, np.int32)
        child_payload = np.zeros((1, 8), np.int32)
        child_fb = np.zeros((1, 8), np.int32)
        child_min[0, :n] = inst_min
        child_max[0, :n] = inst_max
        child_kind[0, :n] = KIND_INTERNAL
        child_payload[0, :n] = inst_wide_root
        child_fb[0, :n] = np.arange(1, n + 1)
        order = _octant_orders(child_min, child_max, child_kind)
        return WideBVH(
            child_min=child_min,
            child_max=child_max,
            child_kind=child_kind,
            child_payload=child_payload,
            child_fb=child_fb,
            order=order,
            depth=1,
        )

    from .bvh import build_bvh

    tlas = build_bvh(inst_min, inst_max, force_split=True)
    is_leaf = tlas.node_count > 0
    # singleton leaves: leaf 'first' indexes prim_order -> instance id
    inst_of_leaf = np.where(
        is_leaf, tlas.prim_order[np.minimum(tlas.node_left, n - 1)], 0
    )
    leaf_kind = np.full(tlas.node_left.shape, KIND_INTERNAL, np.int32)
    leaf_payload = inst_wide_root[inst_of_leaf].astype(np.int32)
    leaf_fb = (inst_of_leaf + 1).astype(np.int32)
    return collapse8(
        tlas.node_min,
        tlas.node_max,
        tlas.node_left,
        tlas.node_count,
        leaf_kind,
        leaf_payload,
        leaf_fb,
    )


def octant_records(
    wide: WideBVH, internal_offset: int = 0, leaf_offset: int = 0
) -> np.ndarray:
    """Assemble the fused octant-major traversal records [8, W, 72] float32.

    Layout per row: 48 box floats stored COMPONENT-major — col c*8 + j holds
    component c of child j, components ordered (min_x, min_y, min_z, max_x,
    max_y, max_z) — then 8 x f_a, 8 x f_b, then 8 zero floats of padding.
    Children are permuted into that octant's visit order so traversal takes set
    bits lowest-first.  Component-major packing lets the traversal's gathered
    [B,72,128] record be viewed as [B,6,8,128] with contiguous [B,8,128]
    per-component slabs: the slab test vectorizes over the 8-child axis in ONE
    set of VPU ops (8x fewer HLO ops than per-child slicing, which cut the
    1080p program's compile time — PERF.md round 3).  ``internal_offset``/
    ``leaf_offset`` globalize LOCAL payloads (instance entries, f_b > 0, are
    already global and take no offset).

    Rows are 72 wide (not 64) so node records and 72-float 8-triangle leaf
    records can live in ONE unified table: the traversal then issues a single
    fat gather per iteration regardless of whether a lane sits at a node or a
    leaf (a [N] row gather costs the same for any row width up to 80 floats —
    PERF.md), instead of one node gather + one triangle gather.
    """
    payload = wide.child_payload.astype(np.int64)
    payload = payload + np.where(
        (wide.child_kind == KIND_INTERNAL) & (wide.child_fb == 0),
        internal_offset,
        np.where(wide.child_kind == KIND_LEAF, leaf_offset, 0),
    )
    assert payload.max(initial=0) < PAYLOAD_MAX, "global payload exceeds 2^20"
    f_a = (wide.child_kind.astype(np.int64) << PAYLOAD_BITS) | payload

    w = wide.n_nodes
    rec = np.zeros((8, w, 72), np.float32)
    rows = np.arange(w)[:, None]
    for o in range(8):
        perm = wide.order[o].astype(np.int64)  # [W,8]
        bmin = wide.child_min[rows, perm]  # [W,8,3]
        bmax = wide.child_max[rows, perm]
        boxes = np.concatenate([bmin, bmax], axis=2)  # [W,8,6] child-major
        rec[o, :, :48] = boxes.transpose(0, 2, 1).reshape(w, 48)  # comp-major
        rec[o, :, 48:56] = f_a[rows, perm].astype(np.float32)
        rec[o, :, 56:64] = wide.child_fb[rows, perm].astype(np.float32)
    return rec


# ---------------------------------------------------------------------------
# Quantised node records (Ylitie, Karras and Laine, HPG 2017, kept exact).
#
# One 128-byte row a row of ``octant_records``, stored as 32 int32 words:
#
#   words 0-2    a float32 bias an axis (see the decode below)
#   word 3       bytes 0-2: a power-of-two step exponent e an axis (int8);
#                byte 3: the live children's mask (bit j: child j neither
#                empty nor flat)
#   words 4-15   48 uint8 planes, component-major: byte 16 + c*8 + j is plane c
#                of child j, c ordered (lo_x, lo_y, lo_z, hi_x, hi_y, hi_z)
#   words 16-23  8 child entries (f_a << 8) | f_b (f_b = 0 inherits the instance)
#   words 24-25  8 meta bytes: bits 0-2 = a leaf child's live triangles - 1
#   words 26-27  8 inward bytes: bit c set when plane c of the child's inner box
#                lies one step inside its outer plane (the plane does not decode
#                exactly)
#   words 28-31  zero
#
# A plane q decodes as float32(X(q) + bias), X(q) = 2^(23+e) + q * 2^e: the
# float whose exponent is 23 + e and whose low mantissa byte is q, built
# without arithmetic (the kernel: one byte permute).  The decode is monotone in
# q, and the packer fits the planes with it: q_lo is the largest q whose
# decode is <= lo and q_hi the smallest whose decode is >= hi, so the outer
# box (q_lo, q_hi) holds the exact box, and the inner box (q_lo + in_lo,
# q_hi - in_hi) lies inside it.  With the slab test's monotone float32
# operations on the decoded planes (((plane - o) * inv), as today's test does
# on the exact ones), a ray that misses the outer box misses the exact box and
# a ray that hits the inner box hits it; the rest take the exact test.
#
# "Dead" children, empty ones and boxes flat on some axis (lo == hi), are left
# out of the live mask and encoded inverted (q_lo = 255, q_hi = 0, no inward
# bits): on a lane whose inverse direction and origin are finite, the exact
# slab test never sets their bit (on the flat axis t0 == t1, so t_near >= t0 >=
# t_far).  Lanes with a non-finite inverse direction take the exact test for
# every child.
# ---------------------------------------------------------------------------

QREC_WORDS = 32
Q_PLANES, Q_ENTRIES, Q_META, Q_INWARD = 16, 64, 96, 104  # byte offsets in a row
Q_EXP_MIN, Q_EXP_MAX = -100, 100  # 2^(23+e) and 255 * 2^e stay normal float32


def decode_planes(bias, exp, q):
    """The kernel's decode ``float32(X(q) + bias)``, X(q) = 2^(23+exp) + q *
    2^exp built from its bits, broadcast over numpy arrays (q in 0..256)."""
    e = np.asarray(exp, np.int64)
    x = (((e + 150) << 23) + np.asarray(q, np.int64)).astype(np.uint32).view(np.float32)
    return (x + np.asarray(bias, np.float32)).astype(np.float32)


def leaf_live_counts(tr_p0, tr_e1, tr_e2) -> np.ndarray:
    """[T/8] int32: for each 8-triangle leaf record, the least k >= 1 such that
    slots k..7 equal slot k-1 bit for bit (the leaf padding repeats a leaf's
    last triangle, ``accel/blas.py:_pad_leaf_multiple``).  A repeated slot gives
    the same t as the one before it, so it never wins a closest hit (the
    earliest slot wins a tie) and never changes an any hit."""
    tri = np.concatenate([tr_p0, tr_e1, tr_e2], axis=1).astype(np.float32)
    if tri.shape[0] % 8:
        raise ValueError("leaf records hold 8 triangle slots")
    bits = np.ascontiguousarray(tri).view(np.uint32).reshape(-1, 8, 9)
    differs = (bits[:, 1:] != bits[:, :-1]).any(axis=2)  # [L,7]: slot j+1 vs slot j
    last = 7 - np.argmax(differs[:, ::-1], axis=1)  # the last slot j >= 1 that differs
    return np.where(differs.any(axis=1), last + 1, 1).astype(np.int32)


def _fit_planes(bias, exp, lo, hi):
    """(q_lo, q_hi) by binary search on the (monotone) decode: the largest q
    with decode <= lo, the smallest with decode >= hi.  The frame guarantees
    decode(0) <= lo and decode(255) >= hi."""
    q_lo = np.zeros(lo.shape, np.int64)
    q_hi = np.full(hi.shape, 255, np.int64)
    for step in (128, 64, 32, 16, 8, 4, 2, 1):
        up = q_lo + step
        q_lo = np.where((up <= 255) & (decode_planes(bias, exp, np.minimum(up, 255)) <= lo),
                        up, q_lo)
        down = q_hi - step
        q_hi = np.where((down >= 0) & (decode_planes(bias, exp, np.maximum(down, 0)) >= hi),
                        down, q_hi)
    return q_lo, q_hi


def quantised_records(rec: np.ndarray, live: np.ndarray | None = None) -> np.ndarray:
    """[8, W, 32] int32 quantised rows of ``octant_records``' [8, W, 72] rows
    (layout above).  ``live`` ([leaf records] int, ``leaf_live_counts``) gives
    the leaf children's live triangles; it may be None when no child is a
    leaf (a TLAS)."""
    rec = np.asarray(rec, np.float32)
    lead = rec.shape[:-1]
    rows = rec.reshape(-1, 72)
    r = rows.shape[0]
    lo = rows[:, 0:24].reshape(r, 3, 8)  # [R, axis, child]
    hi = rows[:, 24:48].reshape(r, 3, 8)
    f_a = rows[:, 48:56].astype(np.int64)  # exact float values
    f_b = rows[:, 56:64].astype(np.int64)
    kind = f_a >> PAYLOAD_BITS
    dead = (kind == KIND_EMPTY) | (lo == hi).any(axis=1)  # [R, child]
    live_box = ~dead[:, None, :]
    if not (np.isfinite(lo) & np.isfinite(hi) | ~live_box).all():
        raise ValueError("quantised_records: a live child's box is not finite")

    # the frame of each axis: the smallest power-of-two step 2^e whose 255
    # steps span the live children's boxes, and the bias that puts plane 0 at
    # or below their least corner
    has = live_box.any(axis=2)  # [R, axis]
    least = np.where(has, np.where(live_box, lo, np.inf).min(axis=2), 0.0).astype(np.float32)
    top = np.where(has, np.where(live_box, hi, -np.inf).max(axis=2), 0.0).astype(np.float32)
    extent = top.astype(np.float64) - least
    with np.errstate(divide="ignore"):
        exp = np.ceil(np.log2(np.where(extent > 0, extent / 255.0, 1.0)))
    exp = np.clip(exp, Q_EXP_MIN, Q_EXP_MAX).astype(np.int64)
    for _ in range(8):
        base = (((exp + 150) << 23).astype(np.uint32)).view(np.float32)  # 2^(23+e)
        bias = (least - base).astype(np.float32)
        for _ in range(4):  # decode(0) <= least, whatever the subtraction rounded
            bias = np.where(decode_planes(bias, exp, 0) > least,
                            np.nextafter(bias, np.float32(-np.inf)), bias).astype(np.float32)
        short = decode_planes(bias, exp, 255) < top
        if not short.any():
            break
        exp = np.where(short, exp + 1, exp)
    if (decode_planes(bias, exp, 0) > least).any() or (decode_planes(bias, exp, 255) < top).any() \
            or (exp > Q_EXP_MAX).any():
        raise ValueError("quantised_records: a node's frame does not cover its children")

    # planes of the live children; the dead ones inverted
    b3, e3 = bias[:, :, None], exp[:, :, None]
    safe_lo = np.where(live_box, lo, least[:, :, None])
    safe_hi = np.where(live_box, hi, least[:, :, None])
    q_lo, q_hi = _fit_planes(b3, e3, safe_lo, safe_hi)
    in_lo = live_box & (decode_planes(b3, e3, q_lo) != lo)
    in_hi = live_box & (decode_planes(b3, e3, q_hi) != hi)
    q_lo = np.where(live_box, q_lo, 255)
    q_hi = np.where(live_box, q_hi, 0)

    meta = np.zeros((r, 8), np.int64)
    is_leaf = kind == KIND_LEAF
    if is_leaf.any():
        if live is None:
            raise ValueError("quantised_records: leaf children need their live counts")
        meta = np.where(is_leaf, np.asarray(live)[np.where(is_leaf, f_a & (PAYLOAD_MAX - 1), 0)]
                        - 1, 0)
    inward = np.zeros((r, 8), np.int64)
    for a in range(3):
        inward |= in_lo[:, a].astype(np.int64) << a
        inward |= in_hi[:, a].astype(np.int64) << (a + 3)
    alive = (~dead).astype(np.int64) << np.arange(8)

    out = np.zeros((r, 4 * QREC_WORDS), np.uint8)
    out[:, 0:12] = bias.view(np.uint8).reshape(r, 12)
    out[:, 12:15] = exp.astype(np.int8).view(np.uint8)
    out[:, 15] = alive.sum(axis=1)
    out[:, Q_PLANES:Q_PLANES + 48] = np.concatenate([q_lo, q_hi], axis=1).reshape(r, 48)
    entries = ((f_a << 8) | f_b).astype(np.int32)
    out[:, Q_ENTRIES:Q_ENTRIES + 32] = entries.view(np.uint8).reshape(r, 32)
    out[:, Q_META:Q_META + 8] = meta
    out[:, Q_INWARD:Q_INWARD + 8] = inward
    return out.view(np.int32).reshape(*lead, QREC_WORDS)
