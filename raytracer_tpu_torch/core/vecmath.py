"""Batched 3-vector math on tensors (counterpart of ``raytracer_tpu/core/vecmath.py``).

Every function operates on ``[..., 3]`` float32 tensors.  Dot and cross products are
written as explicit component sums, in the order XLA's size-3 reductions take them.
Each operation rounds on its own; XLA:CPU may fuse a multiply-add (ROADMAP.md C1).

Reference (clayne/CPU-Raytracer): Math.h, SIMD_Vector3.h
"""

from __future__ import annotations

import torch

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
ONE_OVER_PI = 1.0 / PI
ONE_OVER_TWO_PI = 1.0 / TWO_PI


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of [..., 3] tensors -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize rows; matches SIMD_Vector3::normalize (rsqrt of squared length)."""
    return a * torch.rsqrt(length_squared(a) + eps)[..., None]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt that is 0 for x <= 0 (the double-where form of the JAX package)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_arccos(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """arccos with inputs pulled off +-1 so the gradient stays finite at the poles."""
    return torch.arccos(torch.clamp(x, -1.0 + eps, 1.0 - eps))


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection; sign of n irrelevant (Math.h:28-30)."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(v, n, eta, cos_theta, k) -> torch.Tensor:
    """Snell refraction given precomputed eta, cos_theta and k = 1 - eta^2 (1 - cos^2).

    ``k`` is clamped at zero, so lanes in total internal reflection produce finite
    garbage that callers mask out (Math.h:34-36).
    """
    return eta[..., None] * v + (eta * cos_theta - safe_sqrt(k))[..., None] * n


def pow2_128(x: torch.Tensor) -> torch.Tensor:
    """x**128 by 7 repeated squarings (Math.h:80-96, Light.h:23)."""
    for _ in range(7):
        x = x * x
    return x
