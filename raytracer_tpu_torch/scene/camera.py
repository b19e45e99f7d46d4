"""Pinhole camera (host-side state; the device receives the rotated view pyramid).

Reference (clayne/CPU-Raytracer): Camera.cpp — the view pyramid is three vectors:
``top_left_corner`` at distance ``d = half_width / tan(fov/2)``, plus per-pixel steps
``x_axis`` (1,0,0) and ``y_axis`` (0,-1,0), all rotated into world space each frame.
Primary rays are then ``normalize(x_axis*i + y_axis*j + corner)`` (Raytracer.cpp:45-59).
"""

from __future__ import annotations

import numpy as np

from ..core import quaternion as quat


class Camera:
    def __init__(self, fov: float):
        self.fov = float(fov)  # full horizontal FOV in radians (Scene.cpp:7)
        self.position = np.zeros(3)
        self.rotation = quat.IDENTITY.copy()
        self.top_left_corner = np.zeros(3)
        self.x_axis = np.array([1.0, 0.0, 0.0])
        self.y_axis = np.array([0.0, -1.0, 0.0])
        self._resized = False

    def resize(self, width: int, height: int) -> None:
        """Rebuild the view pyramid for a render size (Camera.cpp:5-16)."""
        half_width = 0.5 * width
        half_height = 0.5 * height
        d = half_width / np.tan(0.5 * self.fov)
        self.top_left_corner = np.array([-half_width, half_height, d])
        self.x_axis = np.array([1.0, 0.0, 0.0])
        self.y_axis = np.array([0.0, -1.0, 0.0])
        self._resized = True

    # -- fly controls (Camera.cpp:18-42); keys is a set of name strings -----
    MOVEMENT_SPEED = 10.0
    ROTATION_SPEED = 3.0

    def update(self, delta: float, keys=()) -> None:
        keys = set(keys)
        right = quat.rotate(self.rotation, [1.0, 0.0, 0.0])
        forward = quat.rotate(self.rotation, [0.0, 0.0, 1.0])
        if "w" in keys:
            self.position = self.position + forward * self.MOVEMENT_SPEED * delta
        if "a" in keys:
            self.position = self.position - right * self.MOVEMENT_SPEED * delta
        if "s" in keys:
            self.position = self.position - forward * self.MOVEMENT_SPEED * delta
        if "d" in keys:
            self.position = self.position + right * self.MOVEMENT_SPEED * delta
        if "shift" in keys:
            self.position = self.position - [0.0, self.MOVEMENT_SPEED * delta, 0.0]
        if "space" in keys:
            self.position = self.position + [0.0, self.MOVEMENT_SPEED * delta, 0.0]
        if "up" in keys:
            self.rotation = quat.multiply(
                quat.axis_angle(right, -self.ROTATION_SPEED * delta), self.rotation
            )
        if "down" in keys:
            self.rotation = quat.multiply(
                quat.axis_angle(right, +self.ROTATION_SPEED * delta), self.rotation
            )
        if "left" in keys:
            self.rotation = quat.multiply(
                quat.axis_angle([0.0, 1.0, 0.0], -self.ROTATION_SPEED * delta),
                self.rotation,
            )
        if "right" in keys:
            self.rotation = quat.multiply(
                quat.axis_angle([0.0, 1.0, 0.0], +self.ROTATION_SPEED * delta),
                self.rotation,
            )

    def dump_pose(self) -> str:
        """Paste-ready pose dump (the reference's F-key camera dump,
        Camera.cpp:39-42)."""
        p = self.position
        r = self.rotation
        return (
            f"camera.position = np.array([{p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f}])\n"
            f"camera.rotation = np.array([{r[0]:.6f}, {r[1]:.6f}, {r[2]:.6f}, "
            f"{r[3]:.6f}])"
        )

    def device_arrays(self) -> dict:
        """Rotated pyramid as float32 arrays for the primary-ray kernel
        (Camera.cpp:45-48)."""
        assert self._resized, "Camera.resize(width, height) must be called first"
        return {
            "cam_position": np.asarray(self.position, np.float32),
            "cam_top_left": np.asarray(
                quat.rotate(self.rotation, self.top_left_corner), np.float32
            ),
            "cam_x_axis": np.asarray(quat.rotate(self.rotation, self.x_axis), np.float32),
            "cam_y_axis": np.asarray(quat.rotate(self.rotation, self.y_axis), np.float32),
        }
