"""4x4 affine transforms (host-side numpy) + batched device-side application.

Convention: standard column-vector 4x4, ``p' = M[:3,:3] @ p + M[:3,3]``.  The reference
stores the same transforms in row-vector layout (Matrix4.h:8-28); results are identical.

Reference (clayne/CPU-Raytracer): Matrix4.h, Transform.h
"""

from __future__ import annotations

import numpy as np

from . import quaternion as quat


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def compose(position, rotation_q, scale=None) -> np.ndarray:
    """World matrix from position + quaternion (Transform.h:13-43).

    The reference has no scale channel; we add an optional uniform/per-axis scale as a
    generalization (identity by default).
    """
    m = np.eye(4, dtype=np.float64)
    r = quat.to_matrix3(rotation_q)
    if scale is not None:
        r = r @ np.diag(np.broadcast_to(np.asarray(scale, dtype=np.float64), (3,)))
    m[:3, :3] = r
    m[:3, 3] = np.asarray(position, dtype=np.float64)
    return m


def invert(m: np.ndarray) -> np.ndarray:
    """Full 4x4 inverse (Matrix4.h:88-138 uses the cofactor expansion; numpy's solve is
    numerically equivalent for our affine matrices)."""
    return np.linalg.inv(m)


def transform_position(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Transform points, w=1 (Matrix4.h:31-38). Works on [3] or [N,3] arrays."""
    p = np.asarray(p)
    return p @ np.asarray(m)[:3, :3].T + np.asarray(m)[:3, 3]


def transform_direction(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Transform directions, w=0 (Matrix4.h:62-69). Works on [3] or [N,3] arrays."""
    d = np.asarray(d)
    return d @ np.asarray(m)[:3, :3].T


def to_rows34(m: np.ndarray) -> np.ndarray:
    """Pack to the [3,4] float32 form shipped to the device (rotation | translation)."""
    return np.asarray(m, dtype=np.float32)[:3, :4]
