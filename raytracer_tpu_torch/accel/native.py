"""ctypes bindings for the native C++ (S)BVH builder (raytracer_tpu_torch/native/sbvh_builder.cpp).

The builder is compiled on demand with g++ (cached in raytracer_tpu_torch/native/build/); if the
toolchain is unavailable the callers fall back to the vectorized numpy builder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_ROOT, "native", "sbvh_builder.cpp")
_SO = os.path.join(_PKG_ROOT, "native", "build", "libsbvh.so")

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                 _SRC, "-o", _SO],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
        lib.rt_build_bvh.restype = ctypes.c_int
        lib.rt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # p0
            ctypes.POINTER(ctypes.c_float),  # p1
            ctypes.POINTER(ctypes.c_float),  # p2
            ctypes.c_int,                    # n_tris
            ctypes.c_int,                    # spatial
            ctypes.POINTER(ctypes.c_float),  # node_min
            ctypes.POINTER(ctypes.c_float),  # node_max
            ctypes.POINTER(ctypes.c_int32),  # node_left
            ctypes.POINTER(ctypes.c_int32),  # node_count
            ctypes.POINTER(ctypes.c_int32),  # node_axis
            ctypes.POINTER(ctypes.c_int32),  # prim_order
            ctypes.POINTER(ctypes.c_int32),  # out_counts
        ]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build_native(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, spatial: bool):
    """Build a (S)BVH natively. Returns a bvh.BVH or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    from .bvh import BVH

    n = p0.shape[0]
    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    cap_refs = 2 * n if spatial else max(n, 1)
    cap_nodes = 2 * cap_refs
    node_min = np.zeros((cap_nodes, 3), np.float32)
    node_max = np.zeros((cap_nodes, 3), np.float32)
    node_left = np.zeros((cap_nodes,), np.int32)
    node_count = np.zeros((cap_nodes,), np.int32)
    node_axis = np.zeros((cap_nodes,), np.int32)
    prim_order = np.zeros((cap_refs,), np.int32)
    counts = np.zeros((2,), np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.rt_build_bvh(
        ptr(p0, ctypes.c_float), ptr(p1, ctypes.c_float), ptr(p2, ctypes.c_float),
        n, 1 if spatial else 0,
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(node_left, ctypes.c_int32), ptr(node_count, ctypes.c_int32),
        ptr(node_axis, ctypes.c_int32), ptr(prim_order, ctypes.c_int32),
        ptr(counts, ctypes.c_int32),
    )
    if rc != 0:
        return None
    m, refs = int(counts[0]), int(counts[1])
    return BVH(
        node_min=node_min[:m].copy(),
        node_max=node_max[:m].copy(),
        node_left=node_left[:m].copy(),
        node_count=node_count[:m].copy(),
        node_axis=node_axis[:m].copy(),
        prim_order=prim_order[:refs].copy(),
    )
