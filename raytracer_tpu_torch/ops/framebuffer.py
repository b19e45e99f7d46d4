"""Framebuffer accumulation of a generation: each lane's contribution added to
its pixel (counterpart of ``fb.at[gen.pixel].add(contribution)``,
``raytracer_tpu/render/renderer.py:439``), part of kernel K6's generation step.

``accumulate`` adds in place: CPU tensors take ``accumulate_plain``
(``index_add_``); CUDA tensors launch ``rt_scatter_add3`` (``csrc/framebuffer.cu``
over ``csrc/scatter.cuh``, counted in ``trace.counters["launch.fb_scatter"]``),
through ``FramebufferAdd`` when a gradient is wanted, whose backward gathers the
frame's gradient at each lane's pixel.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import trace


def accumulate_plain(fb: torch.Tensor, pixel: torch.Tensor,
                     contribution: torch.Tensor) -> torch.Tensor:
    """fb [P,3] with contribution [n,3] added at the rows pixel [n] names, in place."""
    return fb.index_add_(0, pixel, contribution)


def scatter_add(fb: torch.Tensor, pixel: torch.Tensor, contribution: torch.Tensor) -> None:
    """One ``rt_scatter_add3`` launch: ``accumulate_plain`` on the card, in place."""
    n = pixel.shape[0]
    if (fb.dim() != 2 or fb.shape[1] != 3 or contribution.shape != (n, 3)
            or fb.dtype != torch.float32 or contribution.dtype != torch.float32
            or pixel.dtype != torch.int32
            or not fb.device == pixel.device == contribution.device):
        raise ValueError("accumulate: fb [P,3] and contribution [n,3] float32, pixel [n] "
                         "int32, on one device expected")
    kernels.require_contiguous("accumulate", fb, pixel, contribution)
    if n == 0:
        return
    P, I = kernels.P, kernels.I
    fn = kernels.entry("framebuffer", "rt_scatter_add3", [P, P, I, P, P])
    err = fn(pixel.data_ptr(), contribution.data_ptr(), n, fb.data_ptr(),
             kernels.stream_ptr(fb.device))
    trace.count("launch.fb_scatter")
    kernels.check(err, "rt_scatter_add3")


class FramebufferAdd(torch.autograd.Function):
    """``scatter_add`` in place on the frame; the frame's gradient passes
    through, and each lane's contribution gets the frame's gradient at its
    pixel, as autograd of ``index_add_`` gives them."""

    @staticmethod
    def forward(ctx, fb, pixel, contribution):
        scatter_add(fb, pixel, contribution)
        ctx.mark_dirty(fb)
        ctx.save_for_backward(pixel)
        return fb

    @staticmethod
    def backward(ctx, grad):
        (pixel,) = ctx.saved_tensors
        grad_c = grad.index_select(0, pixel) if ctx.needs_input_grad[2] else None
        return grad, None, grad_c


def accumulate(fb: torch.Tensor, pixel: torch.Tensor, contribution: torch.Tensor) -> torch.Tensor:
    """fb [P,3] with contribution [n,3] added at pixel [n] (int32), in place."""
    if fb.device.type == "cpu":
        return accumulate_plain(fb, pixel, contribution)
    if torch.is_grad_enabled() and (fb.requires_grad or contribution.requires_grad):
        return FramebufferAdd.apply(fb, pixel, contribution.contiguous())
    scatter_add(fb, pixel, contribution.contiguous())  # no graph: spare autograd's host time
    return fb
