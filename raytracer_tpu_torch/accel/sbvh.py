"""Spatial-split BVH (SBVH) builder — Stich et al. 2009, as implemented by the
reference (BVHBuilders.h:48-330, BVHPartitions.h:117-378).

The production path is the native C++ builder (native/sbvh_builder.cpp via
accel/native.py): 256-bin spatial splits with exact triangle clipping and per-
straddler reference unsplitting.  When the native library can't be built, falls back
to the vectorized-numpy object-split SAH builder (equivalent to
MESH_ACCELERATOR_BVH, Config.h:32-35) — correct, just without spatial splits.
"""

from __future__ import annotations

import numpy as np

from . import native
from .bvh import BVH, build_bvh, triangle_bounds


def build_sbvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> BVH:
    out = native.build_native(p0, p1, p2, spatial=True)
    if out is not None:
        return out
    mins, maxs, cents = triangle_bounds(p0, p1, p2)
    return build_bvh(mins, maxs, cents)


def build_sah_native_or_numpy(p0, p1, p2) -> BVH:
    """Plain object-split SAH via the native builder when available."""
    out = native.build_native(p0, p1, p2, spatial=False)
    if out is not None:
        return out
    mins, maxs, cents = triangle_bounds(p0, p1, p2)
    return build_bvh(mins, maxs, cents)
