"""Device events a frame of the app loop's host layer: the copies (and any
kernel) launched inside the ``app.host`` span, that is by ``Renderer.upload``
after ``SceneDescription.update`` and ``ScenePacker.frame()``, over the frames
profiled (``tracing.Profile.launched_in``)."""

NAME, UNIT, LAYER, MOVES = "launches_per_frame.app", "launches/frame", "app", "frame_ms"


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames:
        return None
    n = len(p.launched_in("app.host"))
    return n / p.frames if n else None
