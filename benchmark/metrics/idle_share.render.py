"""The card's idle share over the profiled frames: 1 - device busy / wall time,
both over the profiled frames (the wall time on the host clock, under the
profiler, whose own host cost it includes: chip_smoke.py:407-446)."""

NAME, UNIT, LAYER, MOVES = "idle_share.render", "fraction", "device", "frame_ms"


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames or not p.device or p.wall_s <= 0:
        return None
    return 1.0 - p.busy_s() / p.wall_s
