"""Frozen copies of the port's host geometry: quaternions
(``raytracer_tpu_torch/core/quaternion.py:16-119``), the Catmull-Rom camera spline
(``core/spline.py:11-53``), world matrices (``core/matrix.py:16-55``), the
camera's view pyramid (``scene/camera.py:26-34, 86-97``) and the reference's
Sponza fly-through keyframes (``scene/scenes.py:158-168``, Scene.cpp:95-126).

Part of the benchmark's yardstick, read by the scene builders and by the
reference.  Later changes add files beside this one and never edit it.
"""

from __future__ import annotations

import numpy as np

# -- quaternions (core/quaternion.py:16-119) -------------------------------

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


# -- Catmull-Rom spline (core/spline.py:11-53) -----------------------------

# minispline polynomial coefficients (Spline.h:18-23)
_COEFFS = np.array(
    [
        [-1.0, 2.0, -1.0, 0.0],
        [3.0, -5.0, 0.0, 2.0],
        [-3.0, 4.0, 1.0, 0.0],
        [1.0, -1.0, 0.0, 0.0],
    ]
)


class CatmullRomSpline:
    """Stateful looping spline sampler matching the reference's playback semantics."""

    def __init__(self, times, values):
        self.times = np.asarray(times, dtype=np.float64)
        self.values = np.asarray(values, dtype=np.float64)
        assert self.times.ndim == 1 and len(self.times) == len(self.values)
        self.time = 0.0
        self.current = 0

    def get_point(self, delta: float) -> np.ndarray:
        """Advance playback by ``delta`` seconds and return the spline position
        (Spline.h:26-51)."""
        self.time += delta
        n = len(self.times)
        if self.time >= self.times[n - 1]:
            self.time = 0.0
            self.current = 0
        while self.times[self.current] < self.time:
            self.current += 1

        t0 = self.times[self.current - 1]
        t1 = self.times[self.current]
        x = (self.time - t0) / (t1 - t0)

        result = np.zeros(self.values.shape[1:])
        for i in range(4):
            c = _COEFFS[i]
            k = int(np.clip(self.current + i - 2, 0, n - 1))
            basis = 0.5 * (((c[0] * x + c[1]) * x + c[2]) * x + c[3])
            result = result + basis * self.values[k]
        return result


# -- world matrices (core/matrix.py:16-55) ---------------------------------


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def compose(position, rotation_q, scale=None) -> np.ndarray:
    """World matrix from position + quaternion (Transform.h:13-43).

    The reference has no scale channel; we add an optional uniform/per-axis scale as a
    generalization (identity by default).
    """
    m = np.eye(4, dtype=np.float64)
    r = to_matrix3(rotation_q)
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

# -- camera (scene/camera.py:26-34, 86-97) -----------------------------------


def camera_pyramid(width: int, height: int, fov: float) -> tuple:
    """(top-left corner, x axis, y axis) of the unrotated view pyramid for a render
    size and a full horizontal field of view in radians (Camera.cpp:5-16)."""
    half_width = 0.5 * width
    half_height = 0.5 * height
    d = half_width / np.tan(0.5 * fov)
    return (np.array([-half_width, half_height, d]), np.array([1.0, 0.0, 0.0]),
            np.array([0.0, -1.0, 0.0]))


def camera_arrays(position, rotation, width: int, height: int, fov: float) -> dict:
    """The rotated pyramid as float32 arrays for the primary rays (Camera.cpp:45-48)."""
    top_left, x_axis, y_axis = camera_pyramid(width, height, fov)
    return {
        "cam_pos": np.asarray(position, np.float32),
        "cam_top_left": np.asarray(rotate(rotation, top_left), np.float32),
        "cam_x": np.asarray(rotate(rotation, x_axis), np.float32),
        "cam_y": np.asarray(rotate(rotation, y_axis), np.float32),
    }


# -- the reference's Sponza fly-through (Scene.cpp:95-126; scenes.py:158-168) ---

SPONZA_SPLINE_TIMES = [float(t) for t in range(0, 53, 2)]
SPONZA_SPLINE_POINTS = [
    (0.0, 2.0, 0.0), (-60.6, 17.2, 15.5), (-108.1, 17.2, -1.9),
    (-125.1, 17.2, -15.0), (-129.6, 17.2, -32.9), (-115.1, 17.2, -46.7),
    (-89.1, 17.2, -52.8), (-38.4, 17.2, -55.2), (2.4, 20.3, -46.7),
    (15.4, 29.4, -37.6), (22.8, 31.5, -27.5), (26.5, 43.1, -12.6),
    (37.4, 65.0, 17.3), (39.4, 65.4, 31.4), (39.4, 65.4, 31.4),
    (49.2, 68.8, 37.0), (49.2, 68.8, 37.0), (85.1, 70.0, 42.5),
    (106.1, 70.8, 27.4), (114.9, 72.3, -16.4), (93.1, 73.4, -50.5),
    (61.5, 65.1, -27.1), (44.9, 88.8, -6.7), (18.0, 99.1, -13.6),
    (17.6, 99.1, -13.6), (8.4, 83.9, -11.1), (12.6, 37.4, 1.4),
]


def sponza_spline_poses(n: int, phase: float) -> list:
    """``n`` camera poses spaced evenly over the whole fly-through, the first at
    ``phase`` (in [0, 1)) of the first interval: position from the Catmull-Rom
    spline mapped affinely into the procedural stand-in's atrium, rotation looking
    along the motion (``scenes.py:198-240``, ``sponza_spline_poses``, with its
    ``i + 0.5`` replaced by ``i + phase``)."""
    pts = np.array(SPONZA_SPLINE_POINTS, np.float64)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    tlo = np.array([-15.0, 1.5, -5.0])
    thi = np.array([15.0, 10.0, 5.0])
    pts = (pts - lo) / np.maximum(hi - lo, 1e-9) * (thi - tlo) + tlo
    t_end = SPONZA_SPLINE_TIMES[-1]
    poses = []
    rot = axis_angle([0.0, 1.0, 0.0], -np.pi / 2)  # fallback: the bench pose
    for i in range(n):
        t = (i + phase) / n * t_end
        pos = CatmullRomSpline(SPONZA_SPLINE_TIMES, pts).get_point(t)
        nxt = CatmullRomSpline(SPONZA_SPLINE_TIMES, pts).get_point(t + 0.05)
        forward = np.asarray(nxt, np.float64) - np.asarray(pos, np.float64)
        if np.linalg.norm(forward) > 1e-9:
            rot = look_rotation(forward, [0.0, 1.0, 0.0])
        poses.append((np.asarray(pos, np.float64).copy(), np.asarray(rot).copy()))
    return poses
