"""The quantised wide-node records of K1/K2 (``accel/wide.py:quantised_records``)
and their three-way child test (``ops/traversal_wide.py:node_bits_quantised_plain``,
the plain version of ``csrc/traverse.cu``'s quant_kernel): the decode holds the
exact boxes, leaves' live slots are exact, and the test gives the exact test's
bits on config3-tiny's walks, on made-up rays at its edges and on random boxes.
The kernels themselves are held to the plain walk on the card
(``test_torch_kernels_gpu.py``)."""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raytracer_tpu_torch.accel import wide
from raytracer_tpu_torch.ops import traversal_wide
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.scene import scenes
from raytracer_tpu_torch.scene.device import ScenePacker, quantised_fields
from raytracer_tpu_torch.scene.tensors import scene_from_numpy
from torch_parity import fields, jax_scene, private_bvh_cache, torch_config, torch_scene
from torch_quant_rays import made_up_rays

CONFIG4_TINY = (48, 32)


@functools.lru_cache(maxsize=None)
def _config4():
    with private_bvh_cache():
        desc, cfg = scenes.make_scene("config4")
        return ScenePacker(desc, *CONFIG4_TINY).frame(), cfg


def _tables():
    """{name: (exact rows [R,72], quantised rows [R,32], live [leaf records])} of
    config3-tiny (the JAX package's packing) and config4-tiny (the port's)."""
    f3 = fields(jax_scene("config3")[0])
    q3 = quantised_fields(f3)
    p4 = _config4()[0]
    out = {}
    for name, f, q in (("config3", f3, q3), ("config4", p4._asdict(), p4._asdict())):
        live = wide.leaf_live_counts(f["tr_p0"], f["tr_e1"], f["tr_e2"])
        rows = np.concatenate([f["wd_rec"], f["wt_rec"]], axis=1).reshape(-1, 72)
        qrows = np.concatenate([q["wq_rec"], q["wtq_rec"]], axis=1).reshape(-1, 32)
        out[name] = (rows, qrows, live)
    return out


def _unpack(qrows):
    by = np.ascontiguousarray(qrows).view(np.uint8).reshape(-1, 128)
    bias = np.ascontiguousarray(qrows[:, 0:3]).view(np.float32)  # [R,3]
    exp = by[:, 12:15].view(np.int8).astype(np.int32)
    alive = ((by[:, 15:16].astype(np.int64) >> np.arange(8)) & 1).astype(bool)  # [R,8]
    planes = by[:, wide.Q_PLANES:wide.Q_PLANES + 48].astype(np.int32).reshape(-1, 6, 8)
    meta = by[:, wide.Q_META:wide.Q_META + 8].astype(np.int64)
    inward = by[:, wide.Q_INWARD:wide.Q_INWARD + 8].astype(np.int64)
    return bias, exp, alive, planes, meta, inward


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_decode_holds_exact_boxes(name):
    """(a) With the kernel's float32 decode, on every child of both tables: q_lo
    is the largest plane at or below lo and q_hi the smallest at or above hi;
    an inward bit is set exactly where the plane does not decode to the exact
    value; dead children (empty or flat) are inverted; entries and meta as the
    layout says."""
    rows, qrows, live = _tables()[name]
    bias, exp, alive_mask, planes, meta, inward = _unpack(qrows)
    assert (np.abs(exp) <= 100).all() and np.isfinite(bias).all()
    lo = rows[:, 0:24].reshape(-1, 3, 8)
    hi = rows[:, 24:48].reshape(-1, 3, 8)
    f_a = rows[:, 48:56].astype(np.int64)
    kind = f_a >> wide.PAYLOAD_BITS
    dead = (kind == wide.KIND_EMPTY) | (lo == hi).any(axis=1)
    q_lo, q_hi = planes[:, 0:3], planes[:, 3:6]

    def dec(q):
        return wide.decode_planes(bias[:, :, None], exp[:, :, None], q)

    alive = ~dead[:, None, :]
    assert np.array_equal(alive_mask, ~dead)
    # the decode is monotone in q (the fits below rely on it)
    grid = dec(np.arange(256)[None, None, :].repeat(3, 1))
    assert (np.diff(grid, axis=2) >= 0).all()
    in_lo = np.stack([(inward >> a) & 1 for a in range(3)], axis=1).astype(bool)
    in_hi = np.stack([(inward >> (a + 3)) & 1 for a in range(3)], axis=1).astype(bool)
    ok_lo = (dec(q_lo) <= lo) & ((q_lo == 255) | (dec(q_lo + 1) > lo))
    ok_hi = (dec(q_hi) >= hi) & ((q_hi == 0) | (dec(q_hi - 1) < hi))
    assert (ok_lo | ~alive).all() and (ok_hi | ~alive).all()
    assert (in_lo == alive & (dec(q_lo) != lo)).all()
    assert (in_hi == alive & (dec(q_hi) != hi)).all()
    # the inner planes stay inside the exact box (an inverted inner box fails)
    assert ((dec(q_lo + in_lo) >= lo) | ~alive).all()
    assert ((dec(q_hi - in_hi) <= hi) | ~alive).all()
    assert ((q_lo == 255) & (q_hi == 0) | alive).all()
    assert (dead.sum() > 0) and (alive.sum() > 0)

    entries = qrows[:, 16:24]
    assert np.array_equal(entries, ((f_a << 8) | rows[:, 56:64].astype(np.int64)).astype(np.int32))
    is_leaf = kind == wide.KIND_LEAF
    want = np.where(is_leaf, live[np.where(is_leaf, f_a & (wide.PAYLOAD_MAX - 1), 0)] - 1, 0)
    assert np.array_equal(meta, want)
    assert not qrows[:, 28:32].any()


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_leaf_live_slots(name):
    """(b) For every leaf record, slots >= k equal slot k-1 bit for bit, and k is
    the least such (slot k-1 differs from slot k-2); the torch copy agrees."""
    f = fields(jax_scene("config3")[0]) if name == "config3" else _config4()[0]._asdict()
    tri = np.concatenate([f["tr_p0"], f["tr_e1"], f["tr_e2"]], axis=1).astype(np.float32)
    bits = tri.view(np.uint32).reshape(-1, 8, 9)
    live = wide.leaf_live_counts(f["tr_p0"], f["tr_e1"], f["tr_e2"])
    assert live.min() >= 1 and live.max() <= 8 and (live < 8).any()
    for k in range(1, 9):
        sel = bits[live == k]
        assert (sel[:, k:] == sel[:, k - 1:k]).all()
        if k > 1:
            assert (sel[:, k - 1] != sel[:, k - 2]).any(axis=1).all()
    rec = torch.from_numpy(np.ascontiguousarray(bits.view(np.float32).transpose(0, 2, 1))
                           .reshape(-1, 72))
    assert np.array_equal(traversal_wide.leaf_live_plain(rec).numpy(), live)


@functools.lru_cache(maxsize=None)
def _config3_walks():
    """config3-tiny's primaries and every light's shadow rays from their hits,
    each walked by trace_plain with and without the quantised check."""
    scene, cfg = jax_scene("config3")
    tscene, tcfg = torch_scene(scene), torch_config(cfg)
    bvh = traversal_wide.build_scene_bvh(tscene)
    rays = renderer.generate_primary_rays(tscene, tcfg)
    n = rays.count
    prim = (rays.origin, rays.direction, torch.full((n,), float("inf")),
            torch.ones((n,), dtype=torch.bool))
    # NAIVE: every ray reads octant 0's rows, whatever its signs
    walks = {name: [traversal_wide.trace_plain(bvh, *prim, tcfg.wide_stack_size, ordered,
                                               False, quantised=q) for q in (False, True)]
             for name, ordered in (("primary", True), ("primary_naive", False))}
    w = walks["primary"][0]
    hit = w.best >= 0
    point = prim[0] + torch.where(hit, w.t, 0.0)[:, None] * prim[1]
    lights = torch.cat([tscene.pl_pos, tscene.sl_pos])
    to_l = lights[:, None, :] - point[None]
    dist = torch.linalg.norm(to_l, dim=2)
    shadow = (point.repeat(lights.shape[0], 1), (to_l / dist[..., None]).reshape(-1, 3),
              dist.reshape(-1), hit.repeat(lights.shape[0]))
    walks["shadow"] = [traversal_wide.trace_plain(bvh, *shadow, tcfg.wide_stack_size, True,
                                                  True, quantised=q) for q in (False, True)]
    return walks


@pytest.mark.parametrize("rays", ["primary", "shadow", "primary_naive"])
def test_quantised_bits_on_config3_walks(rays):
    """(c) At every (lane, node) trace_plain visits on config3-tiny, the
    three-way test sets the exact test's bits; the check leaves the walk as it
    was.  The walk does exercise the undecided and exact-lane paths."""
    plain, checked = _config3_walks()[rays]
    for a, b in zip(plain[:6], checked[:6]):
        assert torch.equal(a, b)
    q = checked.quant
    assert q["bits_differ"] == 0, q
    assert q["quantised_node_visits"] + q["exact_lane_node_visits"] == int(plain.steps.sum())
    assert q["leaf_visits"] == int(plain.leaves.sum())
    assert q["undecided_children"] > 0 and q["inner_hits"] > 0
    assert q["live_tests"] < 8 * q["leaf_visits"]
    if rays != "shadow":  # the centre row and column have a 0 component
        assert q["exact_lanes"] > 0 and q["exact_lane_node_visits"] > 0


def _rows_bits(rows, qrows, row, o, d, tb):
    """(quantised bits, exact bits, undecided, exact_lane) of rays on rows."""
    rec = torch.from_numpy(np.ascontiguousarray(rows[row]))
    q = torch.from_numpy(np.ascontiguousarray(qrows[row]))
    o, d, tb = (torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)) for x in (o, d, tb))
    bits, undecided, _inner, exact_lane = traversal_wide.node_bits_quantised_plain(q, rec, o, d, tb)
    nonempty = (q[:, 16:24] >> 28) != wide.KIND_EMPTY
    exact = traversal_wide._exact_child_bits(rec, o, 1.0 / d, tb) & nonempty
    return bits, exact, undecided, exact_lane


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_quantised_bits_on_made_up_rays(name):
    """(d) Rays with +-0 direction components, origins on child planes, through
    corners and edges, and with t_max at a child's entry t: the three-way test
    gives the exact test's bits on every child of the row they aim at."""
    rows, qrows, _ = _tables()[name]
    sets = made_up_rays(rows, 4000, seed=1 if name == "config3" else 2)
    for label, (row, o, d, tb) in sets.items():
        bits, exact, undecided, exact_lane = _rows_bits(rows, qrows, row, o, d, tb)
        assert torch.equal(bits, exact), label
        if label == "zero":
            assert bool(exact_lane.all())
        else:
            # (a ray on a plane towards a corner of that plane has a 0 component)
            assert not bool(exact_lane.all()) and int(undecided.sum()) > 0, label
    # the entry-t set sits on the boundary: both outcomes occur
    row, o, d, tb = sets["t_max_entry"]
    bits = _rows_bits(rows, qrows, row, o, d, tb)[1]
    hit_aimed = bits.any(dim=1)
    assert bool(hit_aimed.any()) and not bool(hit_aimed.all())


_coord = st.floats(-8.0, 8.0, width=32)


@st.composite
def _node_and_ray(draw):
    """A node of 8 random children (some flat, some sharing planes, some empty)
    and a ray whose components may be +-0, with a random t_max."""
    grid = draw(st.sampled_from([None, 0.25, 1.0 / 3.0]))
    boxes = []
    for _ in range(8):
        a = np.array(draw(st.lists(_coord, min_size=3, max_size=3)), np.float32)
        b = np.array(draw(st.lists(_coord, min_size=3, max_size=3)), np.float32)
        if grid is not None:  # planes that often decode exactly, or coincide
            a, b = (np.round(a / grid) * grid).astype(np.float32), \
                (np.round(b / grid) * grid).astype(np.float32)
        flat = draw(st.sampled_from([None, 0, 1, 2, None, None]))
        if flat is not None:
            b[flat] = a[flat]
        boxes.append((np.minimum(a, b), np.maximum(a, b)))
    kinds = draw(st.lists(st.sampled_from([0, 1, 7, 0, 1]), min_size=8, max_size=8))
    o = np.array(draw(st.lists(_coord, min_size=3, max_size=3)), np.float32)
    if draw(st.booleans()):  # origin on a child's plane
        j, ax = draw(st.integers(0, 7)), draw(st.integers(0, 2))
        o[ax] = boxes[j][draw(st.integers(0, 1))][ax]
    d = np.array(draw(st.lists(st.floats(-1.0, 1.0, width=32), min_size=3, max_size=3)),
                 np.float32)
    for ax in range(3):
        if draw(st.integers(0, 4)) == 0:
            d[ax] = np.float32(draw(st.sampled_from([0.0, -0.0])))
    tb = np.float32(draw(st.sampled_from([np.inf, 1.0, 4.0, 20.0])))
    return boxes, kinds, o, d, tb


@settings(max_examples=300, deadline=None)
@given(_node_and_ray())
def test_quantised_bits_hypothesis(case):
    """(d) Random nodes and rays: the three-way test equals the exact test."""
    boxes, kinds, o, d, tb = case
    row = np.zeros((1, 72), np.float32)
    for j, (lo, hi) in enumerate(boxes):
        row[0, [j, 8 + j, 16 + j]] = lo
        row[0, [24 + j, 32 + j, 40 + j]] = hi
        row[0, 48 + j] = float((kinds[j] << wide.PAYLOAD_BITS) | j)
    live = np.full(8, 8, np.int32)
    qrow = wide.quantised_records(row[None], live)[0]
    bits, exact, _, _ = _rows_bits(row, qrow, np.zeros(1, np.int64), o[None], d[None],
                                   np.array([tb], np.float32))
    assert torch.equal(bits, exact)


def test_quantised_fields_round_trip():
    """(e) The packer's quantised fields reach the tensors unchanged, and a
    scene packed without them (the JAX package's) gets the same ones derived."""
    packed = _config4()[0]
    scene = scene_from_numpy(packed._asdict(), device="cpu")
    for k in ("wq_rec", "wtq_rec"):
        got = getattr(scene, k)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), getattr(packed, k))
    bare = {k: v for k, v in packed._asdict().items() if k not in ("wq_rec", "wtq_rec")}
    derived = scene_from_numpy(bare, device="cpu")
    for k in ("wq_rec", "wtq_rec"):
        assert torch.equal(getattr(derived, k), getattr(scene, k))
    bvh = traversal_wide.build_scene_bvh(scene)
    assert bvh.qrec.shape == (bvh.node_rows, wide.QREC_WORDS)
    assert bvh.qrec.dtype == torch.int32 and bvh.qrec.is_contiguous()
