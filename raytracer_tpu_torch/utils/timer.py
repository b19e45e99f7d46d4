"""Wall-clock instrumentation (ScopeTimer analog; ScopeTimer.h:5-27)."""

from __future__ import annotations

import time


class ScopeTimer:
    """RAII-style timer printing us/ms/s, as the reference does around BVH builds
    (BottomLevelBVH.cpp:38-48)."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if not self.quiet:
            us = self.elapsed * 1e6
            if us < 1000:
                msg = f"{us:.0f} us"
            elif us < 1e6:
                msg = f"{us / 1000:.2f} ms"
            else:
                msg = f"{self.elapsed:.2f} s"
            print(f"{self.name} took: {msg}")
        return False


class FrameTimer:
    """FPS + moving-average frame time over the last N frames (Main.cpp:62-85)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: list = []
        self.last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        delta = now - self.last
        self.last = now
        self.samples.append(delta)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return delta

    @property
    def average(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    @property
    def fps(self) -> float:
        return 1.0 / max(self.average, 1e-9)
