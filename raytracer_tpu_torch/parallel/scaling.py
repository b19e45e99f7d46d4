"""Scaling-efficiency harness: rays/s on 1 device vs n devices (counterpart of
``raytracer_tpu/parallel/scaling.py``; BASELINE.md target: >= 80% multi-host
scaling efficiency).

Each count the process group offers is timed: 1 renders on this rank alone,
the group's size renders pixel-sharded over every rank.  Counts above the
group's size are skipped (the JAX function skips counts above
``len(jax.devices())``), and so are counts between 1 and the group's size,
which would need a group of their own.  Times are wall times of whole frames,
the card synchronised before the clock is read.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..render import renderer
from .mesh import make_mesh
from .shard import make_sharded_renderer


def _sync(scene):
    if scene.cam_pos.is_cuda:
        torch.cuda.synchronize(scene.cam_pos.device)


def measure(scene, cfg: RenderConfig, device_counts=(1, 2, 4, 8), iters: int = 3):
    """{"rays_per_s": {n: rays/s}, "efficiency": {n: rays/s / (n * rays/s at 1)}}."""
    n_avail = dist.get_world_size() if dist.is_initialized() else 1
    results = {}

    def timed(fn):
        _sync(scene)
        fn()  # warm-up
        best = np.inf
        for _ in range(iters):
            _sync(scene)
            t0 = time.perf_counter()
            out = fn()
            _sync(scene)
            best = min(best, time.perf_counter() - t0)
        return best, out

    for n in device_counts:
        if n > n_avail or 1 < n < n_avail:
            continue
        if n == 1:
            def run():
                with torch.no_grad():
                    return renderer.render_with_stats(scene, cfg)
        else:
            run_sharded = make_sharded_renderer(
                cfg, make_mesh((n, 1), device_type=scene.cam_pos.device.type))

            def run():
                return run_sharded(scene)
        dt, (_img, stats) = timed(run)
        total = sum(int(getattr(stats, k)) for k in
                    ("num_primary", "num_shadow", "num_reflection", "num_refraction"))
        results[n] = total / dt

    base = results.get(1)
    return {"rays_per_s": results,
            "efficiency": {n: (r / (base * n)) if base else float("nan")
                           for n, r in results.items()}}
