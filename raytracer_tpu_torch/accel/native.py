"""ctypes bindings for the native C++ (S)BVH builder (raytracer_tpu_torch/native/sbvh_builder.cpp).

The builder is compiled on demand with g++ (cached in raytracer_tpu_torch/native/build/).
Processes that load it at once are kept apart by an exclusive lock on a file
beside the library: one compiles to a temporary name and renames it into place,
the others wait and load the finished file, so no process opens a half-written
library.  A library that exists but does not load is rebuilt once.  Where g++
is on ``PATH`` a build or load that still fails raises; only without g++ (and
without a usable library) do the callers fall back to the vectorized numpy
builder, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_ROOT, "native", "sbvh_builder.cpp")
_SO = os.path.join(_PKG_ROOT, "native", "build", "libsbvh.so")

_lib = None
_lib_failed = False


@contextlib.contextmanager
def build_lock(so_path: str):
    """Hold an exclusive ``fcntl`` lock on ``<so_path>.lock`` (made if absent)."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    with open(so_path + ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(src: str, so_path: str) -> None:
    """g++ ``src`` to a temporary file beside ``so_path``, then rename it into
    place; raises RuntimeError with the compiler's output if it fails."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(so_path), prefix=".libsbvh.", suffix=".so")
    os.close(fd)
    try:
        out = subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp],
            capture_output=True, text=True,
        )
        if out.returncode != 0:
            raise RuntimeError(f"native SBVH builder: g++ failed on {src}:\n{out.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _intact(so_path: str) -> bool:
    """Whether ``so_path`` is a whole 64-bit ELF file: its segments and section
    headers lie inside it.  The loader maps a cut file and dies of SIGBUS on
    the missing pages instead of raising, so a file is checked before it is
    opened."""
    try:
        size = os.path.getsize(so_path)
        with open(so_path, "rb") as f:
            head = f.read(64)
            if len(head) < 64 or head[:5] != b"\x7fELF\x02":
                return False
            (phoff, shoff) = struct.unpack_from("<QQ", head, 32)
            (phentsize, phnum, shentsize, shnum) = struct.unpack_from("<HHHH", head, 54)
            if shoff + shnum * shentsize > size or phoff + phnum * phentsize > size:
                return False
            f.seek(phoff)
            table = f.read(phnum * phentsize)
        for i in range(phnum):
            offset, = struct.unpack_from("<Q", table, i * phentsize + 8)
            filesz, = struct.unpack_from("<Q", table, i * phentsize + 32)
            if offset + filesz > size:
                return False
        return True
    except OSError:
        return False


def _open(so_path: str):
    if not _intact(so_path):
        raise OSError(f"{so_path} is not a whole ELF library")
    lib = ctypes.CDLL(so_path)
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
    return lib


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    have_gxx = shutil.which("g++") is not None
    with build_lock(_SO):
        stale = not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        if stale and not have_gxx:
            _lib_failed = True  # no toolchain: the numpy builder, as the JAX package
            return None
        if stale:
            _compile(_SRC, _SO)
        try:
            _lib = _open(_SO)
        except OSError:
            if not have_gxx:
                _lib_failed = True
                return None
            _compile(_SRC, _SO)  # a file that does not load is rebuilt once
            try:
                _lib = _open(_SO)
            except OSError as e:
                raise RuntimeError(f"native SBVH builder: {_SO} does not load after "
                                   f"a rebuild: {e}") from e
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
