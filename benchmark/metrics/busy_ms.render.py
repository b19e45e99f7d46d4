"""Device time a frame: the time in which at least one event ran on the card
(the union of the profiled frames' device events), over the frames profiled."""

NAME, UNIT, LAYER, MOVES = "busy_ms.render", "ms", "device", "frame_ms"


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames or not p.device:
        return None
    return p.busy_s() * 1e3 / p.frames
