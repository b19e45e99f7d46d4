"""Stable boolean stream compaction (counterpart of ``raytracer_tpu/ops/compaction.py``),
kernel K6.

The JAX package compacts into a fixed capacity and pads with a fallback lane,
because XLA's shapes are static.  Here the queue is exact: ``compact`` returns the
indices of the flagged lanes, in lane order, and their count.  Stability matters:
the queue's order sets the order of the framebuffer sums.
"""

from __future__ import annotations

import torch

from .. import kernels

launches = 0  # rt_compact launches (reset and read by chip_smoke.py)


def compact_plain(flags: torch.Tensor) -> tuple:
    """(int32 [n_active] indices of the set flags in lane order, n_active)."""
    pos = torch.cumsum(flags.to(torch.int32), dim=0, dtype=torch.int32) - 1
    n_active = int(pos[-1].item()) + 1 if flags.shape[0] else 0
    # unflagged lanes all write one spare slot past the end, which is cut off
    dest = torch.where(flags, pos, n_active).long()
    out = torch.empty((n_active + 1,), dtype=torch.int32, device=flags.device)
    out[dest] = torch.arange(flags.shape[0], dtype=torch.int32, device=flags.device)
    return out[:n_active], n_active


def compact(flags: torch.Tensor) -> tuple:
    """K6.  CPU tensors take ``compact_plain``; CUDA tensors launch ``rt_compact``
    (module attribute ``launches`` counts them).  Reading the count back is the
    one host synchronisation of a generation: it sizes the next queue."""
    global launches
    if flags.device.type == "cpu":
        return compact_plain(flags)
    if flags.dtype != torch.bool or flags.dim() != 1:
        raise TypeError("compact: flags must be a 1-D bool tensor")
    kernels.require_contiguous("compact", flags)
    n = flags.shape[0]
    if n == 0:
        return torch.empty((0,), dtype=torch.int32, device=flags.device), 0
    if n >= 2**31 - 1024:
        raise ValueError("compact: too many lanes for int32 indices")
    nb = (n + 1023) // 1024
    offsets = torch.empty((nb + 1,), dtype=torch.int32, device=flags.device)
    out = torch.empty((n,), dtype=torch.int32, device=flags.device)
    fn = kernels.entry("compact", "rt_compact",
                       [kernels.P, kernels.I, kernels.P, kernels.P, kernels.P])
    err = fn(flags.data_ptr(), n, offsets.data_ptr(), out.data_ptr(),
             kernels.stream_ptr(flags.device))
    launches += 1
    kernels.check(err, "rt_compact")
    n_active = int(offsets[nb].item())
    return out[:n_active], n_active

