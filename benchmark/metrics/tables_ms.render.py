"""Host time a frame building the tables ``render_wavefront`` builds every call
(K10's records and the quad atlas): the self time of the program's
``rt.tables`` range (its duration less the ``rt.*`` ranges inside it: the read
of K10's record check is ``read_wait_ms.render``'s), over the profiled frames,
on the profiler's clock.  Nothing is read from a program without the
``rt.render`` span."""

from benchmark.metrics._spans import profile, self_ms

NAME, UNIT, LAYER, MOVES = "tables_ms.render", "ms", "render.renderer", "frame_ms"
TARGETS = ("rt.tables",)


def read(ctx):
    p = profile(ctx)
    return None if p is None else self_ms(p, TARGETS) / p.frames
