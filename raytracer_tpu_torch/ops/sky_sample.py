"""Sky sampling: Debevec angular-map light probe (counterpart of
``raytracer_tpu/ops/sky_sample.py``), kernel K5.

Reference (clayne/CPU-Raytracer): Sky.cpp:28-67 — direction -> (u,v) via
``r = acos(z) / (2*pi*sqrt(x^2+y^2))``, nearest-texel gather, scaled by 1/pi.
``sample_sky`` launches ``csrc/sky.cu`` for CUDA tensors and runs
``sample_sky_plain`` for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..core import vecmath as vm

launches = 0  # rt_sky_sample launches (reset and read by chip_smoke.py)


def probe_size(sky_data: torch.Tensor) -> int:
    """Side of the square probe held as [size*size, 3] rows."""
    size = math.isqrt(sky_data.shape[0])
    if size * size != sky_data.shape[0]:
        raise ValueError(f"sky probe has {sky_data.shape[0]} rows, not a square")
    return size


def sample_sky_plain(sky_data: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """direction: [N,3] (normalized). Returns [N,3] radiance."""
    size = probe_size(sky_data)
    x, y, z = direction[:, 0], direction[:, 1], direction[:, 2]
    denom = vm.safe_sqrt(x * x + y * y)
    r = 0.5 * vm.ONE_OVER_PI * vm.safe_arccos(z) / torch.clamp_min(denom, 1e-12)
    size_f = float(size)
    u = x * r + 0.5
    v = y * r + 0.5
    # Util::float_to_int rounds to NEAREST (Sky.cpp:40-41)
    px = torch.floor(u * size_f + 0.5).to(torch.int32)
    py = torch.floor(v * size_f + 0.5).to(torch.int32)
    index = torch.clamp(py * size + px, 0, size * size - 1)
    return vm.ONE_OVER_PI * sky_data[index.long()]


def sample_sky(sky_data: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """K5 forward.  CPU tensors take ``sample_sky_plain``; CUDA tensors launch
    ``rt_sky_sample`` (module attribute ``launches`` counts them)."""
    global launches
    if direction.device.type == "cpu":
        return sample_sky_plain(sky_data, direction)
    if sky_data.device != direction.device:
        raise ValueError("sample_sky: sky_data and direction on different devices")
    if sky_data.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError("sample_sky: float32 inputs expected")
    if direction.dim() != 2 or direction.shape[1] != 3 or sky_data.shape[1:] != (3,):
        raise ValueError("sample_sky: direction [N,3] and sky_data [S*S,3] expected")
    kernels.require_cuda_input("sample_sky", sky_data, direction)
    size = probe_size(sky_data)
    n = direction.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=direction.device)
    if n == 0:
        return out
    fn = kernels.entry("sky", "rt_sky_sample", [kernels.P, kernels.I, kernels.P,
                                                kernels.I, kernels.P, kernels.P])
    err = fn(direction.data_ptr(), n, sky_data.data_ptr(), size, out.data_ptr(),
             kernels.stream_ptr(direction.device))
    launches += 1
    kernels.check(err, "rt_sky_sample")
    return out

