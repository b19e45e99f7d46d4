"""What the readers of the program's own spans (``rt.*``,
``raytracer_tpu_torch/utils/trace.py``) share: the profile they read, and a
range's self time."""

import numpy as np


def profile(ctx):
    """``ctx.profile``, or None where there is nothing to read: no profile, no
    profiled frame, or a program without the ``rt.render`` span."""
    p = ctx.profile
    if p is None or not p.frames or p.host is None or not np.any(p.host[2] == "rt.render"):
        return None
    return p


def self_ms(p, targets) -> float:
    """Summed over the ranges named in ``targets``: each range's duration less the
    union of the ``rt.*`` ranges inside it, in ms."""
    starts, ends, names = p.host
    rt = np.nonzero(np.char.startswith(names.astype(str), "rt."))[0]
    total = 0.0
    for i in np.nonzero(np.isin(names, targets))[0]:
        a, b = starts[i], ends[i]
        inner = rt[(starts[rt] >= a) & (ends[rt] <= b) & (rt != i)]
        covered, end = 0.0, a
        for s, e in sorted(zip(starts[inner], ends[inner])):
            covered += max(0.0, e - max(s, end))
            end = max(end, e)
        total += (b - a) - covered
    return total * 1e-3
