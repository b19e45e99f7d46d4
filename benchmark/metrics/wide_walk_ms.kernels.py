"""Device time a frame of the wide walks K1/K2: the events of ``quant_kernel<``
(``raytracer_tpu_torch/csrc/traverse.cu``), summed over the profiled frames and
divided by their number.  Nothing is read where no such event ran (a cell on
another walk)."""

from benchmark.metrics._wide_walk import walk_ms

NAME, UNIT, LAYER, MOVES = "wide_walk_ms.kernels", "ms", "kernels", "frame_ms"


def read(ctx):
    return walk_ms(ctx)
