"""Catmull-Rom camera spline (host-side).

Reference (clayne/CPU-Raytracer): Spline.h:4-52 — iq's minispline basis, keyframes with
non-uniform times, looping playback, clamped end segments.
"""

from __future__ import annotations

import numpy as np

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
