"""Runs one cell of ``BENCHMARK.json`` once and prints the result's line.

A cell (``workloads[i]``) names a configuration (``configs[j].file``, a JSON file
of sizes under ``benchmark/configs/``) and a traffic mix (``benchmark/mixes/
<traffic>.json``, whose ``loop`` names the loop in ``benchmark/loops/``).  A
per-layer metric is read by ``benchmark/metrics/<name>.py``.  Everything is
found by name: a new cell, configuration, mix or per-layer metric is new files
and new entries, never an edit of this file.

A run: set-up (scene, upload, warm-up; ``setup_s`` from process start to the
first timed frame), a window of ``--seconds`` of frames in a closed loop, then,
with ``--trace 1``, the per-layer readers, then the reference's check of what the
window produced.  ``<unit>_ms`` is the window's length over the units of work
(the mix's ``unit``: frames) completed in it, ``<unit>_ms_p95`` the 95th
percentile of every unit's time in the window (``FrameClock``).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

from . import tracing as trace_mod
from .reference import compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "raytracer_tpu")  # whole top-level names


class NoDevice(RuntimeError):
    pass


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def configuration(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _load(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str, root: str = ROOT) -> dict:
    return _load(os.path.join(root, "benchmark", "mixes", f"{traffic}.json"))


def loop_class(name: str):
    return importlib.import_module(f"benchmark.loops.{name}").Loop


def reader(name: str, root: str = ROOT):
    """The module of ``benchmark/metrics/<name>.py`` (loaded by path: names hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def blocked_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)


def tail_ms(times_ms: list) -> float:
    """The 95th percentile of every frame's time (``statistics.quantiles``, n=20)."""
    if len(times_ms) < 2:
        return float(times_ms[0]) if times_ms else float("nan")
    return statistics.quantiles(times_ms, n=20)[18]


class FrameClock:
    """Each frame's time in the window.  On the card, on the device's clock: a CUDA
    event recorded as the window opens and after each frame; a frame ends on a read
    on the host, so the stream is idle and the event is stamped at once, and the
    gaps between consecutive events are the frames' times.  On the CPU, the host's
    clock."""

    def __init__(self, cuda: bool):
        self.cuda, self.marks = cuda, []

    def mark(self) -> None:
        import torch

        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def times_ms(self) -> list:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def host_state(cpu_s: float, window_s: float) -> dict:
    """What the host gave the window, for reading noise between runs: this
    process's CPUs and its CPU seconds a second of the window (``cpu_s``, from
    ``time.process_time``; near 1 for a loop that waits on nothing but the host)."""
    cpus = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else None
    return {"cpus": cpus, "own_cpu": cpu_s / window_s}


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict | None = None, control: bool = False, t0: float | None = None,
        root: str = ROOT) -> dict:
    """One run of cell ``name``; returns the result's line as a dict."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    bench = benchmark(root)
    w = workload(bench, name)
    config = {**configuration(bench, w["config"], root), **(overrides or {})}
    m = mix(w["traffic"], root)
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]):
        raise NoDevice(f"{name} needs {w['chips']} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                       "available")
    tracer = trace_mod.Tracer(trace, device)
    loop = loop_class(m["loop"])(config, m, seed, device, tracer)
    loop.setup()
    # set-up's survivors (the scene, the meshes, the program's objects) leave the
    # collector's generations, so that a full collection in the window does not
    # scan them; the window's own garbage is collected as usual
    gc.collect()
    gc.freeze()
    tracer.sync()
    setup_s = time.perf_counter() - t0
    tracer.spans.clear()

    # the window: a closed loop of frames; with --trace 1 a profiler over
    # ``profile_frames`` frames from frame ``profile_after``
    p_first = int(m["profile_after"]) if trace else -1
    if trace and hasattr(loop, "profile_from"):  # a loop may align it to its cycle
        p_first = loop.profile_from(p_first)
    p_last = p_first + int(m["profile_frames"]) - 1 if trace else -1
    prof = None
    clock = FrameClock(cuda)
    cpu_before = time.process_time()
    i = 0
    start = time.perf_counter()
    clock.mark()
    while True:
        if i == p_first:
            prof = trace_mod.Profile(tracer).__enter__()
        if p_first <= i <= p_last:
            with prof.frame():
                loop.frame(i)
        else:
            loop.frame(i)
        clock.mark()
        if i == p_last:
            prof.__exit__(None, None, None)
        i += 1
        end = time.perf_counter()
        if end - start >= seconds and i > p_last:
            break
    window_s, units = end - start, i
    host = host_state(time.process_time() - cpu_before, window_s)
    gc.unfreeze()
    times_ms = clock.times_ms()
    del clock
    peak = max(torch.cuda.max_memory_allocated(k) for k in range(w["chips"])) if cuda else 0

    result = {"correct": False, "attempted": units, "failed": 0, "metrics": {}}
    if trace:
        profiled = list(range(p_first, p_last + 1))
        # what a reader reads: the spans (name -> [ms]), the profile and its frames,
        # the window
        ctx = SimpleNamespace(spans=dict(tracer.spans), profile=prof, profiled=profiled,
                              units=units, window_s=window_s, loop=loop, config=config, mix=m)
        for x in bench["per_layer"]:
            if applies(x, name):
                value = reader(x["name"], root).read(ctx)
                if value is not None:
                    result["metrics"][x["name"]] = {"value": value, "unit": x["unit"]}
        del ctx
    else:
        unit = m["unit"]
        values = {f"{unit}_ms": window_s * 1e3 / units, f"{unit}_ms_p95": tail_ms(times_ms),
                  "setup_s": setup_s}
        for x in bench["end_to_end"]:
            if applies(x, name) and x["name"] in values:
                result["metrics"][x["name"]] = {"value": values[x["name"]], "unit": x["unit"]}

    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": w["chips"] if cuda else 1,
        "memory_peak_bytes": int(peak),
    }
    if cuda:
        result["device"]["power_limit_w"] = _power_limit_w()
    if trace:
        result["device"].update(busy_s=prof.busy_s(), window_s=prof.wall_s)
        result["breakdown"] = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}

    # the check: after the window, once the peak is read and the program's state freed;
    # with ``control`` the control's outputs stand in the program's place
    loop.release()
    t_check = time.perf_counter()
    checks = loop.check(control)
    result["timing"] = {"window_s": window_s, "frames_timed": len(times_ms),
                        "check_s": time.perf_counter() - t_check}
    result["host"] = host
    ok = [value <= limit for _, value, limit in checks]
    result["correct"] = all(ok)
    result["failed"] = 0 if all(ok) else 1
    if control:
        result["control"] = True
    result["checks"] = compare.report(checks)
    return result


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control (the reference in the next precision down, "
                         "in the program's place) instead of the program's outputs: the "
                         "run must come out not correct; for setting limits, never in the "
                         "benchmark's own runs")
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     control=bool(args.control), t0=t0)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    found = blocked_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
