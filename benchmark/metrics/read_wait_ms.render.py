"""Host time a frame blocked on the card inside the renderer: the summed
duration of the program's ``rt.host_read`` ranges (each a read of a value the
card computes, waiting for the queue to drain to it) over the profiled frames,
on the profiler's clock.  Nothing is read from a program without the
``rt.render`` span."""

import numpy as np

from benchmark.metrics._spans import profile

NAME, UNIT, LAYER, MOVES = "read_wait_ms.render", "ms", "render.renderer", "frame_ms"


def read(ctx):
    p = profile(ctx)
    if p is None:
        return None
    starts, ends, names = p.host
    sel = names == "rt.host_read"
    return float(np.sum(ends[sel] - starts[sel])) * 1e-3 / p.frames
