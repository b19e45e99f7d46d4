"""Ray-throughput metrics: MRays/s per category (Main.cpp:87-95 definitions)."""

from __future__ import annotations


def mrays_per_second(stats, seconds: float) -> dict:
    """Convert RenderStats counters + wall time into the reference's ImGui metrics
    (counters x fps / 1e6; ours are per-lane so no lane-width scaling).  The keys
    are the JAX package's."""
    def f(x):
        return int(x) / seconds / 1e6

    total = (
        int(stats.num_primary)
        + int(stats.num_shadow)
        + int(stats.num_reflection)
        + int(stats.num_refraction)
    )
    return {
        "total_mrays_s": total / seconds / 1e6,
        "primary_mrays_s": f(stats.num_primary),
        "shadow_mrays_s": f(stats.num_shadow),
        "reflection_mrays_s": f(stats.num_reflection),
        "refraction_mrays_s": f(stats.num_refraction),
        "dropped_rays": int(stats.num_dropped),
    }
