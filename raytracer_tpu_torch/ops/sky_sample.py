"""Sky sampling: Debevec angular-map light probe (counterpart of
``raytracer_tpu/ops/sky_sample.py``), kernel K5.

Reference (clayne/CPU-Raytracer): Sky.cpp:28-67 — direction -> (u,v) via
``r = acos(z) / (2*pi*sqrt(x^2+y^2))``, nearest-texel gather, scaled by 1/pi.
``sample_sky`` launches ``csrc/sky.cu`` for CUDA tensors and runs
``sample_sky_plain`` for CPU tensors.  Its gradient on the card is the
``rt_sky_sample_bwd`` kernel (``SkySample``); on the CPU, autograd of
``sample_sky_plain`` (``sample_backward_plain`` computes the same sums from
the texel indices).
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..core import vecmath as vm
from ..utils import trace


def probe_size(sky_data: torch.Tensor) -> int:
    """Side of the square probe held as [size*size, 3] rows."""
    size = math.isqrt(sky_data.shape[0])
    if size * size != sky_data.shape[0]:
        raise ValueError(f"sky probe has {sky_data.shape[0]} rows, not a square")
    return size


def texel_index(size: int, direction: torch.Tensor) -> torch.Tensor:
    """[N] int64 row of the probe texel each direction [N,3] (normalized) reads."""
    x, y, z = direction[:, 0], direction[:, 1], direction[:, 2]
    denom = vm.safe_sqrt(x * x + y * y)
    r = 0.5 * vm.ONE_OVER_PI * vm.safe_arccos(z) / torch.clamp_min(denom, 1e-12)
    size_f = float(size)
    u = x * r + 0.5
    v = y * r + 0.5
    # Util::float_to_int rounds to NEAREST (Sky.cpp:40-41)
    px = torch.floor(u * size_f + 0.5).to(torch.int32)
    py = torch.floor(v * size_f + 0.5).to(torch.int32)
    return torch.clamp(py * size + px, 0, size * size - 1).long()


def sample_sky_plain(sky_data: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """direction: [N,3] (normalized). Returns [N,3] radiance."""
    return vm.ONE_OVER_PI * sky_data[texel_index(probe_size(sky_data), direction)]


def _check(sky_data: torch.Tensor, direction: torch.Tensor) -> None:
    if sky_data.device != direction.device:
        raise ValueError("sample_sky: sky_data and direction on different devices")
    if sky_data.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError("sample_sky: float32 inputs expected")
    if direction.dim() != 2 or direction.shape[1] != 3 or sky_data.shape[1:] != (3,):
        raise ValueError("sample_sky: direction [N,3] and sky_data [S*S,3] expected")
    kernels.require_contiguous("sample_sky", sky_data, direction)


def sample_forward(sky_data: torch.Tensor, direction: torch.Tensor, want_index: bool):
    """One ``rt_sky_sample`` launch: ([N,3] radiance, [N] int32 texel index or None).
    The index is written only when ``want_index`` (a gradient is needed); counted
    in ``trace.counters["launch.k5"]``."""
    _check(sky_data, direction)
    size = probe_size(sky_data)
    n = direction.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=direction.device)
    index = (torch.empty((n,), dtype=torch.int32, device=direction.device)
             if want_index else None)
    if n == 0:
        return out, index
    P, I = kernels.P, kernels.I
    fn = kernels.entry("sky", "rt_sky_sample", [P, I, P, I, P, P, P])
    err = fn(direction.data_ptr(), n, sky_data.data_ptr(), size, out.data_ptr(),
             None if index is None else index.data_ptr(), kernels.stream_ptr(direction.device))
    trace.count("launch.k5")
    kernels.check(err, "rt_sky_sample")
    return out, index


def sample_backward_plain(index: torch.Tensor, cot: torch.Tensor, rows: int) -> torch.Tensor:
    """The [rows,3] gradient of sky_data: cot / pi summed onto ``index``, as
    autograd of ``sample_sky_plain`` computes it (each lane's product, then the
    sums), in the cotangent's dtype."""
    grad = torch.zeros((rows, 3), dtype=cot.dtype, device=cot.device)
    return grad.index_add_(0, index.long(), cot * vm.ONE_OVER_PI)


def sample_backward(index: torch.Tensor, cot: torch.Tensor, rows: int) -> torch.Tensor:
    """K5 backward: the [rows,3] gradient of sky_data, cot / pi scattered to
    ``index``.  CPU tensors take ``sample_backward_plain``; CUDA tensors launch
    ``rt_sky_sample_bwd`` once (counted in ``trace.counters["launch.k5.bwd"]``),
    which sums into float64 rows, rounded to float32 once."""
    n = index.shape[0]
    if (cot.shape != (n, 3) or cot.dtype != torch.float32 or index.dtype != torch.int32
            or index.device != cot.device):
        raise ValueError("sample_sky backward: cot [N,3] float32 and index [N] int32 "
                         "on one device expected")
    if cot.device.type == "cpu":
        return sample_backward_plain(index, cot, rows)
    kernels.require_contiguous("sample_sky backward", index, cot)
    grad = torch.zeros((rows, 3), dtype=torch.float64, device=cot.device)
    if n == 0:
        return grad.float()
    P, I = kernels.P, kernels.I
    fn = kernels.entry("sky", "rt_sky_sample_bwd", [P, P, I, P, P])
    err = fn(index.data_ptr(), cot.data_ptr(), n, grad.data_ptr(),
             kernels.stream_ptr(cot.device))
    trace.count("launch.k5.bwd")
    kernels.check(err, "rt_sky_sample_bwd")
    return grad.float()


class SkySample(torch.autograd.Function):
    """K5 on the card: the forward launches ``rt_sky_sample``, the backward
    ``rt_sky_sample_bwd``.  The direction gets no gradient (JAX's floor to a
    texel gives it zero)."""

    @staticmethod
    def forward(ctx, sky_data, direction, want_index):
        out, index = sample_forward(sky_data, direction, want_index)
        ctx.rows = sky_data.shape[0]
        if index is not None:
            ctx.save_for_backward(index)
        return out

    @staticmethod
    def backward(ctx, cot):
        grad_sky = None
        if ctx.needs_input_grad[0]:
            (index,) = ctx.saved_tensors
            grad_sky = sample_backward(index, cot.contiguous(), ctx.rows)
        return grad_sky, None, None


def sample_sky(sky_data: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """K5.  CPU tensors take ``sample_sky_plain`` (differentiated by autograd);
    CUDA tensors go through ``SkySample``, whose forward launches
    ``rt_sky_sample`` (counted in ``trace.counters["launch.k5"]``) and whose
    backward launches ``rt_sky_sample_bwd`` (counted in ``"launch.k5.bwd"``)."""
    if direction.device.type == "cpu":
        return sample_sky_plain(sky_data, direction)
    want_index = torch.is_grad_enabled() and sky_data.requires_grad
    return SkySample.apply(sky_data, direction, want_index)
