"""Build and load the hand-written CUDA kernels (``raytracer_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface under ``build/torch_kernels/`` at the repo root,
at first use; the compilers of all sources run side by side.  The libraries are
loaded with ``ctypes``: every pointer and the stream travel as ``c_void_p``, and
every C entry point returns ``cudaGetLastError()`` after its launches, which
``check`` turns into an exception.

``--fmad=false`` keeps each kernel's float32 arithmetic bit-comparable with its
plain PyTorch version (no multiply-add contraction), which the traversal's
marginal shadow decisions need (PERF.md, shadow-ray marginality).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("traverse", "traverse_threaded", "hits", "texture", "texture_bwd", "sky", "compact",
           "fxaa", "primitives")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not os.path.exists(so):
        return True
    src_time = max(
        os.path.getmtime(os.path.join(CSRC, f))
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )
    return os.path.getmtime(so) < src_time


def build(force: bool = False, verbose_ptxas: bool = False) -> dict:
    """Compile every stale kernel source, all ``nvcc`` processes at once.

    Returns {name: {"seconds": wall time of that build, "log": compiler output}}
    for the sources it built.  Raises ``RuntimeError`` with the compiler's output
    if any build fails.  Each library is written to a temporary name and renamed,
    so a concurrent reader never loads a half-written file.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = [n for n in SOURCES if force or _stale(n)]
    procs = {}
    for name in names:
        tmp = _so_path(name) + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose_ptxas:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, time.perf_counter())
    out, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, _so_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def ptxas_usage(log: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] parsed from ``-Xptxas -v``."""
    rows, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            rows.append({"kernel": kernel, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == kernel:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building the kernels at first use."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build()
        lib = ctypes.CDLL(_so_path(name))
        _libs[name] = lib
    return lib


def entry(name: str, fn: str, argtypes: list):
    """The C entry point ``fn`` of ``csrc/<name>.cu`` with its argument types set."""
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_contiguous(what: str, *tensors) -> None:
    """Checked by every wrapper before a launch: the kernels index flat memory."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def require_no_grad(what: str, *tensors) -> None:
    """Checked by the traversal and primitive-pick wrappers: a walk or a pick is
    discrete and has no gradient, so an input that asks for one is refused
    rather than silently detached."""
    for t in tensors:
        if t.requires_grad:
            raise ValueError(
                f"{what}: the walk or pick is discrete and has no gradient; the "
                "renderer detaches its inputs (trace_scene, intersect_scene)"
            )


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
