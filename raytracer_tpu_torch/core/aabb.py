"""Axis-aligned bounding boxes (host-side numpy, used by the BVH builders).

The device-side slab test lives in ``ops/traversal_wide.py``; this module is the
scalar builder vocabulary (expand / overlap / surface_area / transform / validity).

Reference (clayne/CPU-Raytracer): AABB.h, AABB.cpp
"""

from __future__ import annotations

import numpy as np

INF = np.float64(np.inf)


def empty() -> np.ndarray:
    """[2,3] box: row 0 = min (+inf), row 1 = max (-inf) (AABB.cpp:3-9)."""
    return np.array([[INF] * 3, [-INF] * 3])


def from_points(points: np.ndarray) -> np.ndarray:
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    box = np.stack([points.min(axis=0), points.max(axis=0)])
    return fix_if_needed(box)


def is_valid(box: np.ndarray) -> bool:
    """max > min on every axis (AABB.h:18-20)."""
    return bool(np.all(box[1] > box[0]))


def is_empty(box: np.ndarray) -> bool:
    return bool(np.all(box[0] == INF) and np.all(box[1] == -INF))


def fix_if_needed(box: np.ndarray, epsilon: float = 0.001) -> np.ndarray:
    """Inflate degenerate (zero-thickness) axes by epsilon (AABB.h:26-32)."""
    box = np.array(box, dtype=np.float64)
    degenerate = box[1] - box[0] < epsilon
    box[0] = np.where(degenerate, box[0] - 0.5 * epsilon, box[0])
    box[1] = np.where(degenerate, box[1] + 0.5 * epsilon, box[1])
    return box


def expand(box: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Union of two boxes (AABB.h:42-48)."""
    return np.stack([np.minimum(box[0], other[0]), np.maximum(box[1], other[1])])


def expand_point(box: np.ndarray, p: np.ndarray) -> np.ndarray:
    return np.stack([np.minimum(box[0], p), np.maximum(box[1], p)])


def overlap(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Intersection; empty box when disjoint (AABB.cpp:24-35)."""
    box = np.stack([np.maximum(b1[0], b2[0]), np.minimum(b1[1], b2[1])])
    if not np.all(box[1] > box[0]):
        return empty()
    return box


def surface_area(box: np.ndarray) -> float:
    """2(dx·dy + dy·dz + dz·dx) (AABB.h:34-40)."""
    d = box[1] - box[0]
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def surface_area_batch(mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    """Vectorized surface area for [N,3] min/max arrays."""
    d = maxs - mins
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])


def transform(box: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Tight AABB of an OBB via the component-wise-abs trick (AABB.cpp:55-73)."""
    m = np.asarray(m, dtype=np.float64)
    center = 0.5 * (box[0] + box[1])
    extent = 0.5 * (box[1] - box[0])
    new_center = m[:3, :3] @ center + m[:3, 3]
    new_extent = np.abs(m[:3, :3]) @ extent
    return np.stack([new_center - new_extent, new_center + new_extent])
