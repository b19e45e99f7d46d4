"""Debug validators and geometry dumpers.

Reference: Debug.h — NaN/Inf lane validators (Debug.h:8-22), the Snell's-law
self-check asserted per refracted packet (Debug.h:32-54, invoked at
Raytracer.cpp:323), and .obj dumpers for triangles/AABBs (Debug.h:57-99).
The validators take torch tensors on any device; the dumpers take arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import vecmath as vm


def is_finite(x) -> bool:
    """All-lanes finite check (Debug::is_valid, Debug.h:8-22)."""
    return bool(torch.isfinite(x).all())


def check_refraction(n1, n2, direction, normal, refracted, mask, tol=1e-3):
    """Verify Snell's law n1*sin(theta1) == n2*sin(theta2) on masked lanes
    (Debug::test_refraction, Debug.h:32-54). Returns a boolean tensor."""
    cos1 = -vm.dot(direction, normal)
    cos2 = -vm.dot(refracted, normal)
    sin1 = torch.sqrt(torch.clamp_min(1.0 - cos1 * cos1, 0.0))
    sin2 = torch.sqrt(torch.clamp_min(1.0 - cos2 * cos2, 0.0))
    ok = torch.abs(n1 * sin1 - n2 * sin2) < tol
    # preconditions: normalized vectors, correctly-oriented hemisphere
    ok = ok & (torch.abs(torch.sqrt(vm.length_squared(direction)) - 1.0) < 1e-3)
    ok = ok & (torch.abs(torch.sqrt(vm.length_squared(refracted)) - 1.0) < 1e-2)
    ok = ok & (cos1 > -1e-4)
    return torch.where(mask, ok, True)


def obj_write_triangles(path: str, p0, p1, p2) -> None:
    """Dump triangles as a Wavefront .obj for external viewers
    (Debug::obj_write_triangle, Debug.h:57-79)."""
    p0, p1, p2 = (np.asarray(x).reshape(-1, 3) for x in (p0, p1, p2))
    with open(path, "w") as f:
        for a, b, c in zip(p0, p1, p2):
            for v in (a, b, c):
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(len(p0)):
            base = 3 * i + 1
            f.write(f"f {base} {base + 1} {base + 2}\n")


def obj_write_aabbs(path: str, mins, maxs) -> None:
    """Dump AABBs as .obj boxes (Debug::obj_write_aabb, Debug.h:81-99)."""
    mins = np.asarray(mins).reshape(-1, 3)
    maxs = np.asarray(maxs).reshape(-1, 3)
    faces = [
        (1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
        (1, 3, 7, 5), (2, 6, 8, 4),
    ]
    with open(path, "w") as f:
        for k, (lo, hi) in enumerate(zip(mins, maxs)):
            for x in (lo[0], hi[0]):
                for y in (lo[1], hi[1]):
                    for z in (lo[2], hi[2]):
                        f.write(f"v {x} {y} {z}\n")
            base = 8 * k
            for q in faces:
                f.write("f " + " ".join(str(base + i) for i in q) + "\n")
