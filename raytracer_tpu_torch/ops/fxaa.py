"""FXAA post pass (counterpart of ``raytracer_tpu/ops/fxaa.py``), kernel K8.

Reference: fragment_fxaa.glsl:21-70 — X-pattern luma taps, gradient blur
direction with span clamp, and a 2-vs-4 sample fallback by luma range.  Gamma
1/2.2 is applied to the linear framebuffer as it is sampled
(fragment_fxaa.glsl:16-18); the output is the gamma-space image.  Taps at
fractional offsets are bilinear gathers on the image grid, clamped to the edge.

``fxaa`` launches ``csrc/fxaa.cu`` for a CUDA image and runs ``fxaa_plain`` for
a CPU image.
"""

from __future__ import annotations

import torch

from .. import kernels

FXAA_REDUCE_MIN = 1.0 / 128.0
FXAA_REDUCE_MUL = 1.0 / 8.0
FXAA_SPAN_MAX = 8.0
LUMA = (0.299, 0.587, 0.114)

launches = 0  # rt_fxaa launches (reset and read by chip_smoke.py)


def _luma(c):
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def _bilinear_tap(img, x, y):
    """Gamma-space image at fractional pixel coordinates (clamped), bilinear."""
    h, w = img.shape[:2]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def fxaa_plain(linear_image: torch.Tensor) -> torch.Tensor:
    """[H,W,3] linear -> [H,W,3] gamma-space anti-aliased image."""
    img = torch.clamp(linear_image, 0.0, 1.0) ** (1.0 / 2.2)
    h, w = img.shape[:2]
    dev = img.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)

    def shift(dy, dx):
        # clamp-to-edge neighbour fetch, as the GLSL sampler clamps
        ys = torch.clamp(rows + dy, 0, h - 1)
        xs = torch.clamp(cols + dx, 0, w - 1)
        return img[ys[:, None], xs[None, :]]

    # X-pattern: the GLSL offsets are +-1 texel diagonals
    l_tl, l_tr, l_bl, l_br, l_m = map(
        _luma, (shift(-1, -1), shift(-1, 1), shift(1, -1), shift(1, 1), img))

    l_min = torch.minimum(torch.minimum(torch.minimum(l_tl, l_tr),
                                        torch.minimum(l_bl, l_br)), l_m)
    l_max = torch.maximum(torch.maximum(torch.maximum(l_tl, l_tr),
                                        torch.maximum(l_bl, l_br)), l_m)

    dir_x = (l_bl + l_br) - (l_tl + l_tr)
    dir_y = (l_tl + l_bl) - (l_tr + l_br)

    reduce = torch.clamp_min((l_tl + l_tr + l_bl + l_br) * 0.25 * FXAA_REDUCE_MUL,
                             FXAA_REDUCE_MIN)
    adjust = 1.0 / (torch.minimum(torch.abs(dir_x), torch.abs(dir_y)) + reduce)
    dir_x = torch.clamp(dir_x * adjust, -FXAA_SPAN_MAX, FXAA_SPAN_MAX)
    dir_y = torch.clamp(dir_y * adjust, -FXAA_SPAN_MAX, FXAA_SPAN_MAX)

    ys, xs = torch.meshgrid(rows.to(torch.float32), cols.to(torch.float32), indexing="ij")

    def tap(k):
        return _bilinear_tap(img, xs + dir_x * k, ys + dir_y * k)

    result_a = 0.5 * (tap(1.0 / 3.0 - 0.5) + tap(2.0 / 3.0 - 0.5))
    result_b = 0.5 * (tap(0.0 - 0.5) + tap(1.0 - 0.5))
    result = 0.5 * (result_a + result_b)

    l_res = _luma(result)
    bad = (l_res < l_min) | (l_res > l_max)
    return torch.where(bad[..., None], result_a, result)


def fxaa(linear_image: torch.Tensor) -> torch.Tensor:
    """K8.  CPU images take ``fxaa_plain``; CUDA images launch ``rt_fxaa`` once
    (counted in ``launches``)."""
    global launches
    if linear_image.device.type == "cpu":
        return fxaa_plain(linear_image)
    if linear_image.dim() != 3 or linear_image.shape[2] != 3:
        raise ValueError("fxaa: [H,W,3] image expected")
    if linear_image.dtype != torch.float32:
        raise TypeError("fxaa: float32 image expected")
    kernels.require_contiguous("fxaa", linear_image)
    h, w = linear_image.shape[:2]
    out = torch.empty_like(linear_image)
    if h * w == 0:
        return out
    fn = kernels.entry("fxaa", "rt_fxaa", [kernels.P, kernels.I, kernels.I, kernels.P,
                                           kernels.P])
    err = fn(linear_image.data_ptr(), h, w, out.data_ptr(),
             kernels.stream_ptr(linear_image.device))
    launches += 1
    kernels.check(err, "rt_fxaa")
    return out
