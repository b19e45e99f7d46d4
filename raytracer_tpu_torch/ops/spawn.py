"""The children of a generation on the card, forward only: the reflection and
refraction rays and their compaction into the next queue, as two hand-written
CUDA launches around K6 (``csrc/spawn.cu``).

``flags`` runs after the lights' sum: each parent lane's reflection and
refraction flags in the [2n] candidate order that K6 compacts (the
reflections, then the refractions), and each block's count of either.
``children`` runs K6 over those flags and reads its count on the host (the
one read that sizes the next queue), then ``write`` computes each slot's child
from its parent's state into one allocation, and adds the generation's
reflections and refractions to the frame's counts.  Launches count in
``trace.counters["launch.spawn.flags"]`` and ``"launch.spawn.write"``.

The renderer takes this path where it takes ``ops/shade``'s: on CUDA tensors,
when no input of the generation asks for a gradient.  Its plain versions are
``render/renderer.py``'s ``_spawn`` and ``_compact``, the torch ops that the
CPU and a render under autograd run; on the card the two give the same queue
bit for bit, in the same order, and the same counts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..utils import trace
from . import compaction
from .intersect import Hits, Rays

BLOCK = 256  # csrc/spawn.cu kBlock: the flags write two counts a block
# a parent lane's state that the kernels read, in csrc/spawn.cu's Parent order
PARENT_FIELDS = ("hit", "refl_c", "trans_c", "ior", "direction", "normal", "w", "dD_dx",
                 "dD_dy", "dN_dx", "dN_dy", "point", "dO_dx", "dO_dy", "pixel")
_DTYPES = {"hit": torch.bool, "pixel": torch.int32}  # float32 otherwise
_LANE_SCALARS = ("hit", "ior", "pixel")  # [n]; the rest [n, 3]
# the next queue's eight [n, 3] fields, one slab each, in this order: the rays'
# six, the throughput, the absorption
QUEUE_FIELDS = 8
# bytes a slot of the next queue takes: the eight fields, the pixel, the flag
QUEUE_SLOT_BYTES = QUEUE_FIELDS * 12 + 4 + 1


class Parents(NamedTuple):
    """A spawning generation as ``write`` takes it."""

    state: tuple  # the tensors of PARENT_FIELDS, [n] or [n, 3]
    flags: torch.Tensor  # [2n] bool: the reflection of lane i at i, its refraction at n + i
    counts: torch.Tensor  # [2 * blocks] int32: each block's reflections, then refractions


class Queue(NamedTuple):
    """The next generation's queue, [n_active, ...] views of one allocation,
    and the frame's counts with this generation's children, 0-dim int32."""

    rays: Rays
    weight: torch.Tensor  # [n_active, 3]
    sigma: torch.Tensor  # [n_active, 3]
    pixel: torch.Tensor  # [n_active] int32
    active: torch.Tensor  # [n_active] bool, all set
    num_reflection: torch.Tensor
    num_refraction: torch.Tensor


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def flags(rays: Rays, pixel, hits: Hits, w, refl_c, trans_c, ior) -> Parents:
    """One ``rt_spawn_flags`` launch (``"launch.spawn.flags"``; none for an
    empty generation) over a generation's ``rays`` and ``pixel``, its ``hits``,
    its throughput ``w`` through this segment and the hits' material rows
    ``refl_c``, ``trans_c``, ``ior`` (``_spawn``'s inputs)."""
    state = (hits.hit, refl_c, trans_c, ior, rays.direction, hits.normal, w, rays.dD_dx,
             rays.dD_dy, hits.dN_dx, hits.dN_dy, hits.point, hits.dO_dx, hits.dO_dy, pixel)
    n = hits.hit.shape[0]
    dev = hits.hit.device
    kernels.require_lanes("rt_spawn_flags", n, {
        f: (x, _DTYPES.get(f, torch.float32)) for f, x in zip(PARENT_FIELDS, state)}, {}, dev)
    if any(x.shape != ((n,) if f in _LANE_SCALARS else (n, 3))
           for f, x in zip(PARENT_FIELDS, state)):
        raise ValueError("rt_spawn_flags: hit, ior and pixel [N], the rest [N, 3] expected")
    # one allocation: the flags, then from a 16-byte boundary the block counts
    blocks = -(-n // BLOCK)
    head = _round_up(2 * n, 16)
    raw = torch.empty((head + 8 * blocks,), dtype=torch.uint8, device=dev)
    parents = Parents(state, raw[:2 * n].view(torch.bool), raw[head:].view(torch.int32))
    if n == 0:
        return parents
    arr = kernels.pointers(state)
    P, I = kernels.P, kernels.I
    fn = kernels.entry("spawn", "rt_spawn_flags", [P, I, P, P, P])
    err = fn(ctypes.addressof(arr), n, parents.flags.data_ptr(), parents.counts.data_ptr(),
             kernels.stream_ptr(dev))
    trace.count("launch.spawn.flags")
    kernels.check(err, "rt_spawn_flags")
    return parents


def write(parents: Parents, sel, num_reflection, num_refraction) -> Queue:
    """One ``rt_spawn_write`` launch (``"launch.spawn.write"``): the children of
    the candidates ``sel`` ([n_active] int32 indices into ``parents.flags``, in
    queue order) and the counts given plus the flags' (0-dim int32)."""
    n = parents.flags.shape[0] // 2
    n_active = sel.shape[0]
    dev = sel.device
    i32 = torch.int32
    kernels.require_lanes("rt_spawn_write", n_active, {"sel": (sel, i32)}, {
        "counts": (parents.counts, i32), "num_reflection": (num_reflection, i32),
        "num_refraction": (num_refraction, i32)}, dev)
    # one allocation: eight slabs of [m, 3] floats, m a multiple of 4 so that
    # every slab and what follows starts on a 16-byte boundary; the pixels;
    # the flags
    m = _round_up(n_active, 4)
    raw = torch.empty((QUEUE_SLOT_BYTES * m,), dtype=torch.uint8, device=dev)
    floats = 3 * QUEUE_FIELDS * m
    fields = raw[:4 * floats].view(torch.float32).view(QUEUE_FIELDS, m, 3)[:, :n_active]
    pixel = raw[4 * floats:4 * floats + 4 * m].view(i32)[:n_active]
    active = raw[4 * floats + 4 * m:].view(torch.bool)[:n_active]
    counts = torch.empty((2,), dtype=i32, device=dev)
    arr = kernels.pointers(parents.state)
    P, I = kernels.P, kernels.I
    fn = kernels.entry("spawn", "rt_spawn_write",
                       [P, I, P, I, P, ctypes.c_longlong, P, P, P, I, P, P, P, P, P])
    err = fn(ctypes.addressof(arr), n, sel.data_ptr(), n_active, fields.data_ptr(), 3 * m,
             pixel.data_ptr(), active.data_ptr(), parents.counts.data_ptr(),
             parents.counts.shape[0] // 2, num_reflection.data_ptr(), num_refraction.data_ptr(),
             counts.data_ptr(), counts.data_ptr() + 4, kernels.stream_ptr(dev))
    trace.count("launch.spawn.write")
    kernels.check(err, "rt_spawn_write")
    return Queue(rays=Rays(*fields[:6]), weight=fields[6], sigma=fields[7], pixel=pixel,
                 active=active, num_reflection=counts[0], num_refraction=counts[1])


def children(parents: Parents, num_reflection, num_refraction) -> Queue:
    """The next queue of a spawning generation: K6 over its flags with one read
    of the count on the host, then ``write``."""
    sel, _ = compaction.compact(parents.flags)
    return write(parents, sel, num_reflection, num_refraction)
