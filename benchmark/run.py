"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m benchmark.run`` works as well).  It
prints the result's JSON as the last line of standard output, and the numbers
compared with their limits as the last lines of standard error.  It exits with 3,
printing no result, without the CUDA devices the cell asks for, and with 4 if a
module of JAX or of the JAX package was loaded.

The run keeps its CPU thread pools to one thread each.  Every build and cache
stays in the checkout: the port's kernels in
``build/torch_kernels/``, its SBVH builder in ``raytracer_tpu_torch/native/build/``
and its BLAS cache in ``.cache/bvh_torch`` (the port fixes these), and the
directories set below for PyTorch's extensions, Triton and the CUDA JIT.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, this file's directory heads sys.path; the checkout's root
# takes its place, so that the benchmark's modules are found as ``benchmark.*``
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT


def main() -> int:
    os.chdir(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # one process with few threads: the host issues every launch, so threads that
    # spin beside it only add noise (numpy's and PyTorch's pools, on the CPU only)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    from benchmark import harness

    return harness.main(sys.argv[1:], t0=T0)


if __name__ == "__main__":
    sys.exit(main())
