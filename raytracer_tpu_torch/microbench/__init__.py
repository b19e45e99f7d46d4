"""Row-gather microbenchmarks: the port of the four Pallas harnesses of ``scratch/``.

One module a harness, each with ``main(argv=None)`` that builds the harness's
table and indices from ``numpy.random.default_rng(0)`` at its own shapes, times
its measurements on ``cuda`` (``--cpu`` runs the plain versions on the CPU),
prints one JSON line a measurement and returns them as a list:

- ``gather`` (``scratch/bench_pallas_gather.py``): K11 direct and staged
  against ``torch.index_select``;
- ``chained`` (``scratch/bench_pallas_chained.py``): the chained loop of 32
  dependent gathers, by ``index_select``, by K11 staged and as one K12 launch,
  and the ``indep`` baseline;
- ``table_gather`` (``scratch/bench_vmem_gather.py``): K11 direct from a
  2.40 MB table, and its chained loop (K12);
- ``table_rowsum`` (``scratch/bench_vmem_invreg.py``): K13 single and chained.

    python -m raytracer_tpu_torch.microbench.chained          # on the card
    python -m raytracer_tpu_torch.microbench.chained --cpu    # plain versions

Times on the card are the mean of ``--reps`` calls by CUDA events (``ms``, a
small kernel's launch cost in it), and the same with the calls queued behind a
wait kernel so that none waits on the host (``device_ms``); on the CPU the host
clock gives ``ms`` and ``device_ms`` is "not measured".
"""

from __future__ import annotations

import argparse
import json
import time

REPS = 50  # calls a CUDA-event mean takes: a small kernel's launch cost is in it
# device_ms's wait kernel: 2e8 cycles, >= 100 ms at the H100's top clock of 1.98 GHz
SLEEP_CYCLES, SLEEP_MS_LEAST = 200_000_000, 100.0


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU; default: cuda")
    ap.add_argument("--reps", type=int, default=REPS, help="calls a timing averages")
    return ap


def device_of(args):
    """``cuda`` unless ``--cpu``; raises without a card (``devices.resolve``)."""
    from .. import devices

    return devices.resolve("cpu" if args.cpu else None)


def ms(fn, reps: int, device) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up: CUDA events on
    the card, the host clock on the CPU."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def device_ms(fn, device, reps: int = REPS):
    """Device time of one call of ``fn``: CUDA events around ``reps`` calls queued
    behind a wait kernel (``torch.cuda._sleep``) that outlasts their enqueueing,
    so no launch waits on the host ("not measured" on the CPU)."""
    if device.type != "cuda":
        return "not measured"
    import torch

    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize(device)
    if enqueue_ms > SLEEP_MS_LEAST:
        raise RuntimeError(f"device_ms: enqueueing {reps} calls took {enqueue_ms:.1f} ms, "
                           "longer than the wait kernel")
    return start.elapsed_time(end) / reps


def emit(out: list, bench: str, device, **fields) -> dict:
    """Print one measurement as a JSON line and keep it in ``out``."""
    import torch

    line = {"bench": bench, **fields, "clock": "cuda_events" if device.type == "cuda" else "host",
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(line), flush=True)
    out.append(line)
    return line
