"""Host time a frame of the app loop spends before the render: the program's
animation (``SceneDescription.update``), ``ScenePacker.frame()`` (the TLAS
rebuilt on the host) and ``Renderer.upload`` (every field, host to device): the
mean of the ``app.host`` span over the window's frames, on the host clock with a
synchronise at each boundary (``tracing.Tracer.span``)."""

NAME, UNIT, LAYER, MOVES = "host_ms.app", "ms", "app", "frame_ms"


def read(ctx):
    ms = ctx.spans.get("app.host")
    return sum(ms) / len(ms) if ms else None
