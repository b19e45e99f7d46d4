"""The comparisons that decide ``correct``, and the seeded draws they judge.

Each check is ``(name, value, limit)`` and passes when ``value <= limit``.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_pixels(rng: np.random.Generator, n_pixels: int, k: int) -> torch.Tensor:
    """``k`` distinct row-major pixel indices drawn from the seed (all of them when
    the frame has fewer)."""
    k = min(k, n_pixels)
    return torch.as_tensor(np.sort(rng.choice(n_pixels, size=k, replace=False)),
                           dtype=torch.long)


def pixel_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """[N] the largest channel's error of each pixel, |got - want| / (1 + |want|):
    absolute in the dark, relative where a light's falloff makes radiance large."""
    got, want = got.double(), want.double().to(got.device)
    err = (got - want).abs() / (1.0 + want.abs())
    return torch.nan_to_num(err, nan=float("inf")).amax(dim=1)


def share_off(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Share of the pixels whose error exceeds ``tol``."""
    return float((pixel_error(got, want) > tol).double().mean())


def max_abs(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return float(torch.nan_to_num((got - want).abs(), nan=float("inf")).max())


def ulps32(got, want) -> float:
    """The largest gap between ``got`` and the exact ``want`` in units of float32's
    spacing at ``max(|want|, 1)``: a float32 result rounded from exact float64
    arithmetic reads at most 0.5."""
    want = np.asarray(want, np.float64)
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32)).astype(np.float64)
    gap = np.abs(np.asarray(got).astype(np.float64) - want) / scale
    return float(np.nan_to_num(gap, nan=np.inf).max())


def lost_rays(stats: list, n_pixels: int) -> tuple:
    """Over frames' ``RenderStats``: (rays lost, ``num_dropped`` + ``num_incomplete``
    summed; the largest gap between ``num_primary`` and the frame's pixels).  The
    renderer is lossless: both are 0 on every frame."""
    if not stats:
        return 0, 0
    lost = torch.stack([s.num_dropped.long() + s.num_incomplete.long() for s in stats])
    primary = torch.stack([s.num_primary.long() for s in stats])
    return int(lost.sum()), int((primary - n_pixels).abs().max())


def report(checks: list) -> dict:
    """{name: {"value", "limit"}} of the checks, in order."""
    return {name: {"value": value, "limit": limit} for name, value, limit in checks}
