"""Reads a frame that block the host on the card inside the renderer: the
program's ``rt.host_read`` ranges (``raytracer_tpu_torch/utils/trace.py``: K10's
record check, K6's count once a spawning generation) over the profiled frames.
Nothing is read from a program without the ``rt.render`` span."""

import numpy as np

from benchmark.metrics._spans import profile

NAME, UNIT, LAYER, MOVES = "host_reads_per_frame.render", "reads/frame", \
    "render.renderer", "frame_ms"


def read(ctx):
    p = profile(ctx)
    if p is None:
        return None
    return float(np.count_nonzero(p.host[2] == "rt.host_read")) / p.frames
