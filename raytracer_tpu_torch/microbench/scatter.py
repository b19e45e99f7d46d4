"""K5 bwd (the sky-gradient scatter) and K6 (stable compaction) on made-up
inputs at the main path's sizes, each beside the one PyTorch call that
computes the same function.

K5 bwd scatters ``cot / pi`` of 2,073,600 lanes (one 1080p generation) onto a
256² probe's ``[65536, 3]`` gradient, under five texel patterns:

- ``random``: each lane a random texel;
- ``permutation``: a random permutation of the lanes, mod 65,536, so the lanes
  of a warp name different texels;
- ``one_texel``: every lane on one texel;
- ``tiles25``: the lanes as a 1920x1080 image, 25x25 pixels a texel, as
  config3's primary rays read the probe (a pixel spans ~0.057 deg, a texel
  ~1.4 deg);
- ``tiles25_zero90``: the same with 90% of the lanes' cotangent all zero,
  as the hit lanes of a generation give it.

K6 compacts 4,147,200 flags (a 1080p generation's two child candidates a
lane) at densities 0.017 (config3's generation 0), 0.3 and 1, and the view
``flags[1:]`` (not 16-byte aligned).

Each line: ``ms`` (CUDA events, mean of ``--reps`` calls), ``device_ms`` (the
calls queued behind a wait kernel), the library call's ``library_ms`` and,
where it reads nothing back, its ``library_device_ms``, and the check against
the plain version.  A last line gives the host's microseconds for the PyTorch
calls a wrapper makes around a launch (these calls are host-bound).  The library calls are
``torch.zeros(...).index_add_(0, index, cot, alpha=1/pi)`` on the int32 index
and ``torch.nonzero(flags)``; the port never calls either on the card.

    python -m raytracer_tpu_torch.microbench.scatter [--cpu] [--n N] [--reps 50]
"""

from __future__ import annotations

import math

import numpy as np

from . import device_ms, device_of, emit, ms, parser

N = 1920 * 1080  # lanes of one 1080p generation
ROWS = 256 * 256  # config3's sky probe
SKY_PATTERNS = ("random", "permutation", "one_texel", "tiles25", "tiles25_zero90")
DENSITIES = (71_409 / 4_147_200, 0.3, 1.0)


def sky_inputs(pattern: str, n: int = N, rows: int = ROWS, width: int = 1920, seed: int = 0):
    """(index [n] int32, cot [n,3] float32) as numpy arrays for one pattern."""
    rng = np.random.default_rng(seed)
    cot = rng.standard_normal((n, 3), dtype=np.float32)
    lane = np.arange(n)
    if pattern == "random":
        index = rng.integers(0, rows, n)
    elif pattern == "permutation":
        index = rng.permutation(n) % rows
    elif pattern == "one_texel":
        index = np.full(n, rows // 2 + math.isqrt(rows) // 2)
    elif pattern.startswith("tiles25"):
        tiles_x = -(-width // 25)
        index = ((lane // width // 25) * tiles_x + (lane % width) // 25) % rows
        if pattern.endswith("zero90"):
            cot[rng.random(n) < 0.9] = 0.0
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    return index.astype(np.int32), cot


def sky_bwd_measure(index, cot, rows: int, device, reps: int) -> dict:
    """K5 bwd against its plain version and the one-call ``index_add_`` on the
    same (index, cot): times, the share of all-zero lanes, and the l2-relative
    error of the kernel, of the plain version in float32 and of the library
    call against the plain version's sums taken in float64 (a float32 sum of
    2 M lanes on one texel is itself ~3e-5 off in any order), and the spread
    between two kernel runs."""
    import torch

    from ..ops import sky_sample

    def kernel():
        return sky_sample.sample_backward(index, cot, rows)

    def library():
        return torch.zeros((rows, 3), dtype=torch.float32, device=device).index_add_(
            0, index, cot, alpha=1.0 / math.pi)

    want = sky_sample.sample_backward_plain(index, cot.double(), rows)
    got, again = kernel(), kernel()
    scale = float(want.norm().clamp_min(1e-30))

    def l2rel(x):
        return float((x.double() - want).norm()) / scale

    return {
        "lanes": index.shape[0], "rows": rows,
        "zero_lane_share": float((cot == 0).all(dim=1).float().mean()),
        "ms": ms(kernel, reps, device), "device_ms": device_ms(kernel, device, reps),
        "library_ms": ms(library, reps, device),
        "library_device_ms": device_ms(library, device, reps),
        "l2_rel": l2rel(got), "max_abs_err": float((got.double() - want).abs().max()),
        "plain_f32_l2_rel": l2rel(sky_sample.sample_backward_plain(index, cot, rows)),
        "library_l2_rel": l2rel(library()),
        "run_to_run_l2_rel": float((again - got).norm()) / scale,
        "run_to_run_max_abs": float((again - got).abs().max()),
    }


def compact_measure(flags, device, reps: int) -> dict:
    """K6 against ``compact_plain`` and ``torch.nonzero`` on the same flags: the
    ``compact`` call (count read back), ``compact_launch`` alone and queued
    (``device_ms``), and whether indices and count are exact."""
    import torch

    from ..ops import compaction

    def launch():
        return compaction.compact_launch(flags)

    k_idx, k_n = compaction.compact(flags)
    p_idx, p_n = compaction.compact_plain(flags)
    l_idx, l_count = launch()
    exact = (k_n == p_n and bool(torch.equal(k_idx, p_idx)) and int(l_count.item()) == p_n
             and bool(torch.equal(l_idx[:p_n], p_idx)))
    return {
        "lanes": flags.shape[0], "active": int(p_n), "exact": exact,
        "ms": ms(lambda: compaction.compact(flags), reps, device),
        "launch_ms": ms(launch, reps, device), "device_ms": device_ms(launch, device, reps),
        "library_ms": ms(lambda: torch.nonzero(flags), reps, device),
        "library_device_ms": "not measured: torch.nonzero reads its count back",
    }


def host_costs(device, reps: int) -> dict:
    """Host microseconds of the PyTorch calls a wrapper makes around a small
    launch: an allocation, a slice, reading one int back, and the current
    stream (PyTorch's object, and the raw pointer the wrappers take)."""
    import time

    import torch

    from .. import kernels

    buf = torch.zeros((1 << 20,), dtype=torch.int32, device=device)
    device = buf.device  # with its index, as the wrappers see a tensor's device
    calls = {
        "torch.empty": lambda: torch.empty((1 << 20,), dtype=torch.int32, device=device),
        "slice": lambda: buf[1:],
        "item": lambda: buf[5].item(),
    }
    if device.type == "cuda":
        calls["kernels.stream_ptr"] = lambda: kernels.stream_ptr(device)
        calls["torch.cuda.current_stream"] = lambda: torch.cuda.current_stream(device).cuda_stream
    out = {}
    for name, fn in calls.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def main(argv=None) -> list:
    ap = parser("K5 bwd and K6 against index_add_ and nonzero on made-up patterns")
    ap.add_argument("--n", type=int, default=N, help="K5 bwd lanes (K6 takes twice as many)")
    args = ap.parse_args(argv)

    import torch

    dev = device_of(args)
    out = []
    for pattern in SKY_PATTERNS:
        index, cot = (torch.from_numpy(a).to(dev) for a in sky_inputs(pattern, args.n))
        emit(out, "sky_bwd", dev, name=f"K5 bwd {pattern}",
             replaces="raytracer_tpu/ops/sky_sample.py:16",
             **sky_bwd_measure(index, cot, ROWS, dev, args.reps))
    rng = np.random.default_rng(1)
    uniform = rng.random(2 * args.n + 1)
    for density in DENSITIES:
        flags = torch.from_numpy(uniform < density).to(dev)
        for label, view in (("", flags[:-1]), (" flags[1:]", flags[1:])):
            emit(out, "compact", dev, name=f"K6 density {density:.3g}{label}",
                 replaces="raytracer_tpu/ops/compaction.py:26",
                 **compact_measure(view, dev, args.reps))
    emit(out, "host", dev, name="host us a call", reps=20 * args.reps,
         **host_costs(dev, 20 * args.reps))
    return out


if __name__ == "__main__":
    main()
