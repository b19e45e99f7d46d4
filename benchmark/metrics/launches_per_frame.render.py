"""Device events a frame that the renderer launched: every kernel, copy and memset
that started inside the ``render`` span (``Renderer.__call__``; a span
synchronises at both ends in a traced run, ``tracing.Profile.launched_in``), over
the frames profiled.  The app loop's upload, FXAA and readback lie in spans of
their own and are not counted."""

NAME, UNIT, LAYER, MOVES = "launches_per_frame.render", "launches/frame", \
    "render.renderer", "frame_ms"


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames:
        return None
    n = len(p.launched_in("render"))
    return n / p.frames if n else None
