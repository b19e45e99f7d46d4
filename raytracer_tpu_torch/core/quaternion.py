"""Quaternions (host-side, numpy).

Scene graph rotations are host-side state updated per frame (animation, camera input),
exactly like the reference's Transform updates; only the resulting 3x4 world/inverse
matrices are shipped to the device.

Layout: (x, y, z, w), identity = (0, 0, 0, 1).

Reference (clayne/CPU-Raytracer): Quaternion.h
"""

from __future__ import annotations

import numpy as np

IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float64)


def normalize(q: np.ndarray) -> np.ndarray:
    return np.asarray(q, dtype=np.float64) / np.linalg.norm(q)


def conjugate(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([-x, -y, -z, w])


def axis_angle(axis, angle: float) -> np.ndarray:
    """Quaternion rotating by ``angle`` radians around (unit) ``axis``
    (Quaternion.h:26-36)."""
    axis = np.asarray(axis, dtype=np.float64)
    half = 0.5 * angle
    s = np.sin(half)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(half)])


def multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product a*b (Quaternion.h:119-126): applying b then a."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            ax * bw + aw * bx + ay * bz - az * by,
            ay * bw + aw * by + az * bx - ax * bz,
            az * bw + aw * bz + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def rotate(q: np.ndarray, v) -> np.ndarray:
    """Rotate vector v by quaternion q (Quaternion.h:128-134)."""
    v = np.asarray(v, dtype=np.float64)
    u = np.asarray(q[:3], dtype=np.float64)
    w = q[3]
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * np.cross(u, v)


def nlerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Normalized linear interpolation (Quaternion.h:105-115)."""
    return normalize((1.0 - t) * np.asarray(a) + t * np.asarray(b))


def to_matrix3(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix R with column-vector convention: v' = R @ v.

    Equivalent to the reference's Transform::calc_world_matrix rotation block
    (Transform.h:13-43), which stores the same rotation in row-vector form.
    """
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ]
    )


def look_rotation(forward, up) -> np.ndarray:
    """Quaternion looking along ``forward`` with ``up`` hint (Quaternion.h:39-103)."""
    forward = np.asarray(forward, dtype=np.float64)
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)

    # Rows of the row-vector-convention matrix (see reference).
    m00, m01, m02 = right
    m10, m11, m12 = up
    m20, m21, m22 = forward

    trace = m00 + m11 + m22
    if trace > 0.0:
        num = np.sqrt(trace + 1.0)
        w = num * 0.5
        num = 0.5 / num
        return np.array([(m12 - m21) * num, (m20 - m02) * num, (m01 - m10) * num, w])
    if m00 >= m11 and m00 >= m22:
        num7 = np.sqrt(1.0 + m00 - m11 - m22)
        num4 = 0.5 / num7
        return np.array(
            [0.5 * num7, (m01 + m10) * num4, (m02 + m20) * num4, (m12 - m21) * num4]
        )
    if m11 > m22:
        num6 = np.sqrt(1.0 + m11 - m00 - m22)
        num3 = 0.5 / num6
        return np.array(
            [(m10 + m01) * num3, 0.5 * num6, (m21 + m12) * num3, (m20 - m02) * num3]
        )
    num5 = np.sqrt(1.0 + m22 - m00 - m11)
    num2 = 0.5 / num5
    return np.array(
        [(m20 + m02) * num2, (m21 + m12) * num2, 0.5 * num5, (m01 - m10) * num2]
    )
