"""Device time a frame of the mesh walks: the events of the wide walks K1/K2
(``quant_kernel<``, ``csrc/traverse.cu``) and of the threaded walks K10
(``rec_kernel<``, ``csrc/traverse_threaded.cu``), summed over the profiled
frames and divided by their number."""

NAME, UNIT, LAYER, MOVES = "walk_ms.kernels", "ms", "kernels", "frame_ms"
KERNELS = ("quant_kernel<", "rec_kernel<")


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames:
        return None
    ms = sum(p.device_ms(k) for k in KERNELS)
    return ms / p.frames if ms > 0 else None
