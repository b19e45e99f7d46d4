"""Runtime configuration for the ray tracer (a copy of the JAX package's config).

The reference keeps every knob as a compile-time ``#define`` in Config.h:1-56.  Here the
knobs are one frozen (hashable) dataclass that the renderer reads on the host.

Reference (clayne/CPU-Raytracer): Config.h:1-56
"""

from __future__ import annotations

import dataclasses
import enum


class TextureSampleMode(enum.IntEnum):
    """Reference: Config.h:38-42 (TEXTURE_SAMPLE_MODE_*)."""

    NEAREST = 0
    BILINEAR = 1
    MIPMAP = 2


class MipmapFilter(enum.IntEnum):
    """Reference: Config.h:48-53 (MIPMAP_FILTER_*)."""

    TRILINEAR = 0
    ANISOTROPIC = 1
    EWA = 2


class TraversalStrategy(enum.IntEnum):
    """Reference: Config.h:27-30 (BVH_TRAVERSE_TREE_*)."""

    NAIVE = 0
    ORDERED = 1


class MeshAccelerator(enum.IntEnum):
    """Reference: Config.h:32-35 (MESH_ACCELERATOR_*)."""

    BVH = 0
    SBVH = 1


# The reference offsets every secondary/shadow ray by this epsilon and uses it as the
# near bound of every intersection test (Ray.h:5 ``EPSILON = 0.005f``).
RAY_EPSILON = 0.005

# Scene-wide constant ambient term (Scene.h:35 ``ambient_lighting = Vector3(0.2f)``).
AMBIENT_LIGHTING = 0.2

# Blinn-Phong specular exponent (Light.h:23 ``Math::pow2<128>(specular_factor)``).
SPECULAR_EXPONENT = 128

# Air IOR (Material.h:24 ``air_index_of_refraction = 1.0f``).
AIR_IOR = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (hashable).

    Mirrors Config.h knob-for-knob, plus the wavefront-specific knobs that replace the
    reference's packet/tile machinery (SIMD_LANE_SIZE, tile sizes).

    This renderer is lossless by construction: every ray walks its BVH until it is
    done and each generation's queue holds exactly its active candidates.  It
    therefore accepts and IGNORES the knobs that size the JAX package's static
    straggler ladders, queues and chunks: ``traversal_chunk``, ``chunk_strided``,
    ``traversal_rounds``, ``ladder_sort_octant``, ``traversal_unroll``,
    ``wide_rounds*``, ``queue_factor``, ``scan_bounces``, ``chunk_checkpoint`` and
    ``scene_shard_axis``.  ``traversal_kernel`` is honoured as in the JAX
    package (``"wide"`` walks the 8-wide BVH, any other value the threaded
    binary BVH, which runs until done), and so is ``wide_stack_size`` (the wide
    walk's stack overflow is what ``RenderStats.num_incomplete`` counts).
    """

    # Render settings (Config.h:8-12)
    width: int = 900
    height: int = 600
    num_bounces: int = 3  # bounces AFTER the primary ray (Config.h:12)

    # Texture pipeline (Config.h:38-56)
    texture_sample_mode: TextureSampleMode = TextureSampleMode.MIPMAP
    mipmap_filter: MipmapFilter = MipmapFilter.ANISOTROPIC
    max_anisotropy: float = 8.0
    # Bounded formulation of EWA's data-dependent ellipse scan (Texture.cpp:302-334):
    # the scan window is statically capped at ewa_max_span x ewa_max_span texels.
    ewa_max_span: int = 16

    # BVH settings (Config.h:22-35).  The reference's BVH_TRAVERSAL_STACK_SIZE
    # (Config.h:25) has no direct analog: the threaded kernel is stackless and the
    # wide kernel's short packed stack is sized by ``wide_stack_size`` below.
    visualize_heatmap: bool = False
    # NAIVE = direction-independent child visit order; ORDERED = near-child-first
    # by ray octant (BVH_TRAVERSE_TREE_* Config.h:27-30) — consumed by both
    # traversal kernels (ops/traversal.py, ops/traversal_wide.py).
    traversal_strategy: TraversalStrategy = TraversalStrategy.ORDERED
    # BVH vs SBVH builder selection (MESH_ACCELERATOR_* Config.h:32-35) — consumed
    # by the scene factories (scene/scenes.py passes it to build_blas).
    mesh_accelerator: MeshAccelerator = MeshAccelerator.SBVH

    # Rays per traversal chunk: bounds the stack memory of the wavefront traversal
    # (the analog of the reference's 32x32 tile decomposition, Window.h:32-33).
    traversal_chunk: int = 1 << 17
    # True: chunk c takes pixels c, c+n_chunks, ... (uniform frame sample per
    # chunk -> balanced queue load); False: contiguous row-blocks (spatial
    # locality for the traversal gathers; dense blocks may overflow the
    # scene-tuned queues -> num_dropped).  Measured per scene (PERF.md r4).
    chunk_strided: bool = True

    # Straggler ladder for the stackless traversal (ops/traversal.py): rounds of
    # (wavefront fraction, statically-bounded iterations).  Round 0 runs every ray;
    # each later round compacts unfinished rays into a smaller wavefront with a
    # larger step budget.  Rays exceeding the total budget are counted as
    # `incomplete` in the render stats.
    # Tuned to measured aliveness curves (sponza-class primaries: ~21% alive after
    # 64 steps, ~0.3% after 128, 0% after 256).
    traversal_rounds: tuple = (
        (1.0, 72),
        (0.25, 96),
        (1.0 / 32, 256),
        (1.0 / 256, 2048),
    )
    # A/B knob: sort compacted ladder sub-wavefronts by ray octant (gather
    # locality experiment — PERF.md bounds the win <2x; measured in round 4).
    ladder_sort_octant: bool = False
    # unroll factor of the inner fori_loop (amortizes loop overhead; measured
    # scratch/bench_stack_cost.py on Sponza-class closest: unroll=2 is -8%
    # ns/ray, unroll=4 regresses — the sweet spot is 2)
    traversal_unroll: int = 2

    # Traversal kernel: "wide" = 8-wide BVH, 8 child boxes per node visit + one
    # 8-triangle record per leaf (ops/traversal_wide.py, K1/K2); any other value
    # ("threaded") = stackless threaded binary BVH, one node or one triangle pair
    # per iteration (ops/traversal.py, K10).
    traversal_kernel: str = "wide"
    # Short per-ray stack of deferred wide children (packed int32 entries).  Wide
    # tree depth is ~log7(T); demand beyond the bound is counted as `incomplete`
    # (Sponza-class primaries: S=16 suffices, S=12 truncates ~0.005%).
    wide_stack_size: int = 16
    # Straggler ladder for the wide kernel, tuned to the measured Sponza-class
    # camera-primary aliveness curve AFTER leaf merging (scratch/aliveness.py:
    # 52% alive @12 wide iterations, 15% @16, 3.8% @20, 0.07% @32, 0 @48) —
    # effective cost ~18.8 full-wavefront iterations (was 24 pre-merge).
    wide_rounds: tuple = (
        (1.0, 12),
        (0.65, 8),
        (1.0 / 16, 12),
        (1.0 / 128, 48),
        (1.0 / 512, 224),
    )
    # Any-hit (shadow) rays retire at the FIRST hit, so their aliveness curve
    # drops much faster (measured post-merge: 45% alive @8, 12% @12, 0.74% @20,
    # 0.007% @32): compact earlier and more often; ~12.2 effective iterations.
    wide_rounds_any: tuple = (
        (1.0, 8),
        (0.55, 4),
        (0.15, 8),
        (1.0 / 64, 24),
        (1.0 / 256, 96),
    )
    # Ladder overrides for SECONDARY bounce generations (None = same as the
    # primary ladders above).  Secondary queues are sized to ~their expected
    # activity (queue_factor), so a scene-tuned primary ladder whose round 0
    # compacts below 100% (e.g. config3's shadow ladder assumes the ~39%
    # contribution-cull of CAMERA hits) can starve a tight secondary wavefront
    # whose active fraction is higher — starved lanes surface as
    # RenderStats.num_incomplete (light leaks).  Secondary generations
    # should therefore be given ladders whose round 0 runs every lane (the
    # None default inherits the primary ladders unchanged — scene configs that
    # tune a compacting primary round 0 must set these too, as config3 does).
    wide_rounds_secondary: "tuple | None" = None
    wide_rounds_any_secondary: "tuple | None" = None

    # Tensor-parallel scene sharding (SURVEY.md 2.3 "tensor/model parallel" row):
    # when set to a mesh axis name (e.g. "sp"), the renderer is being called inside
    # a shard_map where each device along that axis holds a DIFFERENT sub-scene
    # (parallel/scene_shard.py); closest-hit records are min-t combined and any-hit
    # masks OR-combined across the axis after each local traversal.  None (default)
    # = scene replicated, no collectives in the forward pass.
    scene_shard_axis: "str | None" = None

    # Shadow-ray origin offset along the surface normal, in world units.  0.0 keeps
    # the reference's exact scheme (origin ON the surface, RAY_EPSILON as t_min,
    # Ray.h:5), which leaves ~9% of Sponza shadow rays within f32 rounding of a
    # hit/miss decision across differently-shaped compiled programs (PERF.md).
    # A small positive value (~RAY_EPSILON) moves origins off the marginal
    # surfaces; contributing lanes are front-facing by construction (the
    # contribution cull), so +normal is always the shadow-ray side.
    shadow_normal_offset: float = 0.0

    # Mesh hit differential convention.  The reference computes dO/dN in OBJECT
    # space and never rotates them by the instance world matrix
    # (BottomLevelBVH.cpp:291-301; Mesh.cpp:23-28 transforms the incoming ray
    # only) — arguably a bug for rotated instances, but it is the reference
    # behavior.  False (default): rotate differentials to world space (correct
    # under rigid instancing).  True: reference-compatible object-space
    # differentials, letting the scalar oracle (render/oracle.py) and the
    # wavefront renderer be compared under NON-identity instance rotations.
    differentials_object_space: bool = False

    # Wavefront machinery (replaces SIMD_LANE_SIZE / tile scheduling; SURVEY.md 2.3).
    # Capacity of each secondary-ray generation as a fraction of the primary count.
    # A surface can spawn both a reflection and a refraction ray (Raytracer.cpp:249-316),
    # so 2.0 is lossless; smaller trades a bounded amount of energy for compute.
    # May be a tuple giving per-bounce-depth fractions (last entry repeats): scenes
    # that are mostly diffuse shrink deep generations aggressively.
    queue_factor: "float | tuple" = 2.0

    # Roll the secondary bounce generations into ONE lax.scan body (all secondary
    # queues share the bounce-1 capacity) instead of Python-unrolling a separate
    # pipeline per bounce.  The bounce pipeline (two traversal ladders + shading)
    # is then traced/compiled once for ALL secondary generations, roughly halving
    # the 1080p program's XLA compile time (PERF.md round 3).  Radiance is
    # identical whenever no queue overflows (capacities can only grow vs. a
    # decaying per-bounce queue_factor tuple, so drops can only decrease).
    scan_bounces: bool = True

    # Rematerialization policy of the per-chunk render body under reverse-mode
    # AD.  True (default): jax.checkpoint with the save-named policy — only
    # traversal outputs ("trace") and id-indexed gather results ("gather") are
    # kept as residuals, elementwise shading math is recomputed in bwd; bounds
    # activation memory to O(chunk).  False: no checkpoint — XLA saves every
    # differentiable-path intermediate (traversal internals are stop_gradient'd
    # and still dropped), trading HBM for zero bwd recompute.
    chunk_checkpoint: bool = True

    # Post-processing (Config.h:20)
    enable_fxaa: bool = False

    # Differentiability: carry ray differentials (mip LOD) only when mipmapping,
    # mirroring RAY_DIFFERENTIALS_ENABLED (Config.h:46).
    @property
    def ray_differentials_enabled(self) -> bool:
        return self.texture_sample_mode == TextureSampleMode.MIPMAP

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
