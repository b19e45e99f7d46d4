"""Host time a frame issuing the shading glue (Beer's law, the sky, the material
gather and K3, the lights, the framebuffer add): the self time of the program's
``rt.shade`` ranges (each range's duration less the ``rt.*`` ranges inside it),
summed over the generations, over the profiled frames, on the profiler's clock.
Nothing is read from a program without the ``rt.render`` span."""

from benchmark.metrics._spans import profile, self_ms

NAME, UNIT, LAYER, MOVES = "shade_ms.render", "ms", "render.renderer", "frame_ms"
TARGETS = ("rt.shade",)


def read(ctx):
    p = profile(ctx)
    return None if p is None else self_ms(p, TARGETS) / p.frames
