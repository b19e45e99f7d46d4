"""Wall time of one ``Renderer.__call__`` (``render_wavefront``'s generations, to
the last launch's end): the mean of the ``render`` span over the window's frames,
on the host clock with a synchronise at each boundary."""

NAME, UNIT, LAYER, MOVES = "render_ms.render", "ms", "render.renderer", "frame_ms"


def read(ctx):
    ms = ctx.spans.get("render")
    return sum(ms) / len(ms) if ms else None
