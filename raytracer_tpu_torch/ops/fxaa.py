"""FXAA post pass (counterpart of ``raytracer_tpu/ops/fxaa.py``), kernel K8.

Reference: fragment_fxaa.glsl:21-70 — X-pattern luma taps, gradient blur
direction with span clamp, and a 2-vs-4 sample fallback by luma range.  Gamma
1/2.2 is applied to the linear framebuffer as it is sampled
(fragment_fxaa.glsl:16-18); the output is the gamma-space image.  Taps at
fractional offsets are bilinear gathers on the image grid, clamped to the edge.

``fxaa`` launches ``csrc/fxaa.cu`` for a CUDA image and runs ``fxaa_plain`` for
a CPU image.  The kernel's tile form reads every tap from a block's tile of the
image and ``HALO`` texels around it (``fxaa_halo`` says why that holds them all).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import trace

FXAA_REDUCE_MIN = 1.0 / 128.0
FXAA_REDUCE_MUL = 1.0 / 8.0
FXAA_SPAN_MAX = 8.0
LUMA = (0.299, 0.587, 0.114)

# rt_fxaa's forms, in the order of fxaa.cu's ``enum Form``: "tile" (the
# renderer's: each texel's gamma once a block, in shared memory) and "first",
# the first design, kept as the yardstick of chip_smoke.py's K8 row and never
# picked by a render path; both give the same bits
FORMS = ("tile", "first")
# the tile form's halo, in texels before and after a pixel on each axis: a
# finite direction is clamped to +-FXAA_SPAN_MAX and the taps sit at k in
# [-1/2, 1/2] along it, so a tap starts at most 4 texels away, and its
# bilinear's second texel is one further (fxaa.cu: kHaloLo, kHaloHi)
HALO = (4, 5)


def _luma(c):
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def _tap_texels(h: int, w: int, x, y):
    """The texels a bilinear tap at fractional pixel coordinates (x, y) reads:
    (x, y clamped to the image, x0, y0, x1, y1)."""
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    return x, y, x0, y0, x1, y1


def _bilinear_tap(img, x, y):
    """Gamma-space image at fractional pixel coordinates (clamped), bilinear."""
    x, y, x0, y0, x1, y1 = _tap_texels(img.shape[0], img.shape[1], x, y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


# the taps' offsets along the blur direction (fragment_fxaa.glsl:51-58):
# result_a's two, then result_b's two
TAP_K = (1.0 / 3.0 - 0.5, 2.0 / 3.0 - 0.5, 0.0 - 0.5, 1.0 - 0.5)


def _gamma(linear_image):
    return torch.clamp(linear_image, 0.0, 1.0) ** (1.0 / 2.2)


def fxaa_direction(img):
    """The blur direction of each pixel of the gamma-space image ``img``
    (fragment_fxaa.glsl:21-49): (dir_x, dir_y, l_min, l_max), each [H,W];
    the direction is clamped to +-FXAA_SPAN_MAX, or NaN."""
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
    return dir_x, dir_y, l_min, l_max


def _tap_positions(h: int, w: int, dir_x, dir_y):
    """Each tap's fractional pixel coordinates (x, y), in TAP_K's order."""
    dev = dir_x.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    return [(xs + dir_x * k, ys + dir_y * k) for k in TAP_K]


def fxaa_halo(linear_image: torch.Tensor):
    """How far ``fxaa_plain``'s taps reach from their pixel, each [H,W]: the
    least and the greatest texel offset a pixel's taps read, on x and on y
    (x0 - x and x1 - x over the four taps, likewise y), and whether the pixel's
    direction is finite.  Where it is, the offsets lie within HALO."""
    img = _gamma(linear_image)
    h, w = img.shape[:2]
    dir_x, dir_y, _, _ = fxaa_direction(img)
    dev = img.device
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[:, None]
    lo_x = lo_y = hi_x = hi_y = None
    for x, y in _tap_positions(h, w, dir_x, dir_y):
        _, _, x0, y0, x1, y1 = _tap_texels(h, w, x, y)
        pairs = ((x0 - xs, x1 - xs), (y0 - ys, y1 - ys))
        if lo_x is None:
            (lo_x, hi_x), (lo_y, hi_y) = pairs
        else:
            lo_x, hi_x = torch.minimum(lo_x, pairs[0][0]), torch.maximum(hi_x, pairs[0][1])
            lo_y, hi_y = torch.minimum(lo_y, pairs[1][0]), torch.maximum(hi_y, pairs[1][1])
    return lo_x, hi_x, lo_y, hi_y, torch.isfinite(dir_x) & torch.isfinite(dir_y)


def fxaa_plain(linear_image: torch.Tensor) -> torch.Tensor:
    """[H,W,3] linear -> [H,W,3] gamma-space anti-aliased image."""
    img = _gamma(linear_image)
    h, w = img.shape[:2]
    dir_x, dir_y, l_min, l_max = fxaa_direction(img)
    taps = [_bilinear_tap(img, x, y) for x, y in _tap_positions(h, w, dir_x, dir_y)]
    result_a = 0.5 * (taps[0] + taps[1])
    result_b = 0.5 * (taps[2] + taps[3])
    result = 0.5 * (result_a + result_b)

    l_res = _luma(result)
    bad = (l_res < l_min) | (l_res > l_max)
    return torch.where(bad[..., None], result_a, result)


def fxaa(linear_image: torch.Tensor) -> torch.Tensor:
    """K8.  CPU images take ``fxaa_plain``; CUDA images launch ``rt_fxaa``'s tile
    form once (counted in ``trace.counters["launch.k8"]``)."""
    if linear_image.device.type == "cpu":
        return fxaa_plain(linear_image)
    return fxaa_form("tile", linear_image)


def fxaa_form(form: str, linear_image: torch.Tensor) -> torch.Tensor:
    """One ``rt_fxaa`` launch in ``form`` (one of ``FORMS``; the tile form counted
    in ``trace.counters["launch.k8"]``, the first in ``"launch.k8.first"``) on a
    CUDA image."""
    if form not in FORMS:
        raise ValueError(f"fxaa: form must be one of {FORMS}")
    if linear_image.device.type != "cuda":
        raise ValueError("fxaa: the kernel takes a CUDA image")
    if linear_image.dim() != 3 or linear_image.shape[2] != 3:
        raise ValueError("fxaa: [H,W,3] image expected")
    if linear_image.dtype != torch.float32:
        raise TypeError("fxaa: float32 image expected")
    kernels.require_contiguous("fxaa", linear_image)
    h, w = linear_image.shape[:2]
    out = torch.empty_like(linear_image)
    if h * w == 0:
        return out
    P, I = kernels.P, kernels.I
    fn = kernels.entry("fxaa", "rt_fxaa", [P, I, I, I, I, I, P, P])
    # the kernel refuses a halo other than its own
    err = fn(linear_image.data_ptr(), h, w, FORMS.index(form), *HALO, out.data_ptr(),
             kernels.stream_ptr(linear_image.device))
    trace.count("launch.k8" if form == "tile" else "launch.k8.first")
    kernels.check(err, f"rt_fxaa ({form})")
    return out
