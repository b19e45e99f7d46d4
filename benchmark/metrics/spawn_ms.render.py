"""Host time a frame issuing the children (the candidates' ``cat`` calls) and their
compaction (K6 and the per-field gathers): the self time of the program's
``rt.spawn`` and ``rt.compact`` ranges (each range's duration less the ``rt.*``
ranges inside it: K6's count read is ``read_wait_ms.render``'s), summed over the
generations, over the profiled frames, on the profiler's clock.  Nothing is read
from a program without the ``rt.render`` span."""

from benchmark.metrics._spans import profile, self_ms

NAME, UNIT, LAYER, MOVES = "spawn_ms.render", "ms", "render.renderer", "frame_ms"
TARGETS = ("rt.spawn", "rt.compact")


def read(ctx):
    p = profile(ctx)
    return None if p is None else self_ms(p, TARGETS) / p.frames
