"""The port's spans and counters: the one place the program reports where its
work goes.

``span(name)`` names a stage of the program on the profiler's clock.
With no ``torch.profiler`` recording it is one read of the profiler's enabled
flag and returns a shared no-op context: nothing is allocated and no string is
formatted.  With a profiler recording it is ``torch.profiler.record_function``,
so its range sits beside the device events, on their clock, and an idle gap on
the card is named by the innermost stage the host was in.  A span never
synchronises the device.  Every span name starts with ``rt.``.

``counters`` is one ``collections.Counter``, always on: the launch count of each
kernel wrapper (``launch.<kernel>[.<variant>]``).  Readers take differences;
``counters.clear()`` resets all.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd import profiler as _profiler

counters: collections.Counter = collections.Counter()


def count(key: str, k: int = 1) -> None:
    counters[key] += k


class _Off:
    """The context a span returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager naming a stage: a no-op unless a profiler records, then
    ``record_function(name)``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
