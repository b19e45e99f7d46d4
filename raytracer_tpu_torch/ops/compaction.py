"""Stable boolean stream compaction (counterpart of ``raytracer_tpu/ops/compaction.py``),
kernel K6.

The JAX package compacts into a fixed capacity and pads with a fallback lane,
because XLA's shapes are static.  Here the queue is exact: ``compact`` returns the
indices of the flagged lanes, in lane order, and their count.  Stability matters:
the queue's order sets the order of the framebuffer sums.

``compact_launch`` launches the kernel and leaves the count on the device;
``compact`` reads it back, which sizes the next queue.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import trace

TILE = 8192  # flags a block of rt_compact takes (csrc/compact.cu kTile)
# rt_compact's scratch, one for each (device, stream): the kernel leaves it zero
_scratch: dict = {}


def compact_plain(flags: torch.Tensor) -> tuple:
    """(int32 [n_active] indices of the set flags in lane order, n_active)."""
    pos = torch.cumsum(flags.to(torch.int32), dim=0, dtype=torch.int32) - 1
    n_active = 0
    if flags.shape[0]:
        with trace.span("rt.host_read"):
            n_active = int(pos[-1].item()) + 1
    # unflagged lanes all write one spare slot past the end, which is cut off
    dest = torch.where(flags, pos, n_active).long()
    out = torch.empty((n_active + 1,), dtype=torch.int32, device=flags.device)
    out[dest] = torch.arange(flags.shape[0], dtype=torch.int32, device=flags.device)
    return out[:n_active], n_active


def _launch(flags: torch.Tensor) -> torch.Tensor:
    """One ``rt_compact`` launch on CUDA flags: [n + 1] int32, the indices and
    then the count (one allocation: a wrapper's host time is part of the call)."""
    kernels.require_contiguous("compact", flags)
    dev = flags.device
    n = flags.shape[0]
    buf = torch.empty((n + 1,), dtype=torch.int32, device=dev)
    if n == 0:
        return buf.zero_()
    if n >= 2**31 - TILE:
        raise ValueError("compact: too many lanes for int32 indices")
    # the kernel's tiles start at the 16-byte boundary at or below flags[0]
    tiles = (flags.data_ptr() % 16 + n + TILE - 1) // TILE
    stream = kernels.stream_ptr(dev)
    scratch = _scratch.get((dev, stream))
    if scratch is None or scratch.shape[0] < 1 + tiles:
        scratch = _scratch[(dev, stream)] = torch.zeros(
            (1 + 2 * tiles,), dtype=torch.int64, device=dev)
    P, I = kernels.P, kernels.I
    fn = kernels.entry("compact", "rt_compact", [P, I, I, P, P, P, P])
    ptr = buf.data_ptr()
    err = fn(flags.data_ptr(), n, tiles, scratch.data_ptr(), ptr, ptr + 4 * n, stream)
    trace.count("launch.k6")
    kernels.check(err, "rt_compact")
    return buf


def _check(flags: torch.Tensor) -> None:
    if flags.dtype != torch.bool or flags.dim() != 1:
        raise TypeError("compact: flags must be a 1-D bool tensor")


def compact_launch(flags: torch.Tensor) -> tuple:
    """K6 without a read-back: (int32 [n] indices, int32 [1] count), both on the
    flags' device; the first ``count`` indices are the set flags in lane order
    and the rest are unspecified.  CUDA tensors launch ``rt_compact`` (counted in
    ``trace.counters["launch.k6"]``); CPU tensors take ``compact_plain``,
    the rest of the indices zero."""
    _check(flags)
    n = flags.shape[0]
    if flags.device.type == "cpu":
        idx, n_active = compact_plain(flags)
        out = torch.zeros((n,), dtype=torch.int32)
        out[:n_active] = idx
        return out, torch.tensor([n_active], dtype=torch.int32)
    buf = _launch(flags)
    return buf[:n], buf[n:]


def compact(flags: torch.Tensor) -> tuple:
    """K6: (int32 [n_active] indices of the set flags in lane order, n_active).
    CPU tensors take ``compact_plain``; CUDA tensors launch as
    ``compact_launch`` does and read its count back with one ``.item()``: the
    one host synchronisation of a generation, which sizes the next queue."""
    if flags.device.type == "cpu":
        return compact_plain(flags)
    _check(flags)
    buf = _launch(flags)  # compact_launch's launch, without its two views
    with trace.span("rt.host_read"):
        n_active = int(buf[flags.shape[0]].item())
    return buf[:n_active], n_active
