"""K1/K2's share of their roofline, in %: the bound of the profiled frames' walks
(``_wide_walk.py``: the profiled poses rendered again, a seeded sample of each
launch's lanes walked by a frozen copy of the walk's visit rule and priced by
operations and bytes counted the same way whatever implements K1/K2) over
their device time (``wide_walk_ms.kernels``), both a frame.  Nothing is read
where no ``quant_kernel<`` event ran."""

from benchmark.metrics._wide_walk import bound_ms, capture, walk_ms

NAME, UNIT, LAYER, MOVES = "wide_walk_roofline.kernels", "%", "kernels", "frame_ms"


def read(ctx):
    ms = walk_ms(ctx)
    if ms is None:
        return None
    launches = capture(ctx.loop, ctx.profiled)
    return 100.0 * bound_ms(launches) / len(ctx.profiled) / ms
