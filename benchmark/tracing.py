"""What a ``--trace 1`` run records: the benchmark's own spans around each call into
a layer of the program, and a profiler window over a few steady frames.

Spans: a ``torch.cuda.synchronize()`` at each boundary (in the traced run only),
the host clock between, and a ``torch.profiler.record_function`` of the same name,
so that the profiler's idle gaps can be named by the span the host was in.  With
tracing off a span is a no-op.

The profiler window (``Profile``) keeps only a summary: every device event's name,
start and duration, the host events' names and extents, and the window's wall
time on the host clock.  Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


class Tracer:
    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.spans = defaultdict(list)  # name -> [ms]
        self.names = {"frame"}  # every range this tracer records (never a device event)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        self.sync()
        self.names.add(name)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self.sync()
        self.spans[name].append((time.perf_counter() - t0) * 1e3)


class Profile:
    """A torch.profiler window over whole frames; after ``__exit__``: ``frames``,
    ``wall_s`` (host clock), ``device`` ([name, start_us, dur_us] of every event
    that ran on the card), ``host`` (numpy arrays of the host events' starts, ends
    and names), and ``t0_us``, ``t1_us`` (the window on the profiler's clock)."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.frames = 0
        self.wall_s = 0.0
        self.device, self.host = [], None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.tracer.cuda else [])
        self.tracer.sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def frame(self):
        self.frames += 1
        return torch.profiler.record_function("frame")

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        self.tracer.sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        starts, ends, names, frames = [], [], [], []
        for e in self.prof.events():
            r = e.time_range
            if e.device_type == DeviceType.CUDA:
                # a record_function range is shown on the device's timeline too
                if not (getattr(e, "is_user_annotation", False) or e.name in self.tracer.names):
                    self.device.append((e.name, float(r.start), float(r.elapsed_us())))
            else:
                if e.name == "frame":
                    frames.append((r.start, r.end))
                starts.append(r.start)
                ends.append(r.end)
                names.append(e.name)
        self.host = (np.asarray(starts, np.float64), np.asarray(ends, np.float64),
                     np.asarray(names, dtype=object))
        if frames:
            self.t0_us = float(min(a for a, _ in frames))
            self.t1_us = float(max(b for _, b in frames))
        else:
            self.t0_us = self.t1_us = 0.0
        del self.prof
        return False

    # ---- what the readers and the result take from it ----

    def busy_s(self) -> float:
        """Seconds in which at least one event ran on the card (the union of the
        device events' extents)."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        busy, end = 0.0, -np.inf
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy * 1e-6

    def launched_in(self, span: str) -> list:
        """The device events that started inside a host range named ``span``: a
        span synchronises at both ends in a traced run, so these are the events
        that the calls inside it launched, and none of another span's."""
        starts, ends, names = self.host
        sel = names == span
        a, b = starts[sel], ends[sel]
        return [e for e in self.device if np.any((a <= e[1]) & (e[1] <= b))]

    def device_ms(self, name_part: str) -> float:
        return sum(d for n, _, d in self.device if name_part in n) * 1e-3

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for n, _, d in self.device:
            by[n[:120]] += d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10, look: int = 400) -> list:
        """The card's idle time inside the frames, by what the host was doing: each
        of the ``look`` longest gaps between device events is named by the
        innermost host event (a span, an operator) running at its middle, and the
        gaps are summed by that name."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        gaps, end = [], self.t0_us
        for s, e in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1_us > end:
            gaps.append((end, self.t1_us))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:look]
        starts, ends, names = self.host
        dur = ends - starts
        by = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.nonzero((starts <= mid) & (ends >= mid) & (names != "frame"))[0]
            name = str(names[inside[np.argmin(dur[inside])]]) if inside.size else "(no host event)"
            by[name[:120]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
