#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``raytracer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: torch / CUDA versions, the card, ``nvidia-smi`` name and power limit;
2. build: every ``raytracer_tpu_torch/csrc/*.cu`` with ``-Xptxas -v``: seconds,
   registers and spills of each kernel;
3. the main path: ``config3_sponza`` at 1920x1080 with the 260k-triangle
   procedural Sponza stand-in, built by the port's own host code, rendered
   forward through ``Renderer`` — the launch counts of every kernel in one frame
   (each must be > 0, the two children kernels one each a spawning
   generation), the six ray counters (dropped and incomplete must be 0),
   the median frame time of 3 frames after a warm-up, forward MRays/s, the time
   of each kernel inside a frame by CUDA events, peak device memory, and one
   frame under torch.profiler (device busy share, top operators by device time);
4. the training path: fwd+bwd of ``image_loss(render_with_stats(...))`` against
   a zero target over the 17 differentiable fields, one autograd graph over the
   whole 1080p frame — the launch counts of all nine kernels in one step (the
   backward kernels K7 bwd, K4 and K5 bwd among them), the counters, the loss, every
   field's gradient norm (finite, not all zero), the median step time of 3 after
   a warm-up split into forward and backward, fwd+bwd MRays/s, each kernel's time
   inside a step, an Adam update's time, peak device memory and one profiled
   step; then 3 steps of ``diff.train.make_train_step``, whose loss must fall;
   the filters: the same config3 1080p scene under ``mipmap_filter=TRILINEAR``,
   ``mipmap_filter=EWA``, ``texture_sample_mode=BILINEAR`` and
   ``texture_sample_mode=NEAREST``, each forward (median of 3 frames after a
   warm-up, MRays/s, the six counters, the mode's K3 launches) and as a
   fwd+bwd step over the 17 fields (step ms and its split, MRays/s, peak memory,
   every gradient norm, the mode's K4 launches; under TRILINEAR the camera's
   gradients must be finite and not zero);
5. the interactive frame loop: ``raytracer_tpu_torch.app.main`` renders config4
   (900x600, 3 bounces, animated, TLAS rebuilt on the host every frame) for 30
   frames with FXAA into PNGs — its own per-frame ms (median, p90), MRays/s,
   dropped rays (0 on every frame), the launches of every kernel in the run
   (K8 FXAA and K9 spheres/planes among them, each > 0), every PNG read back
   with the port's ``load_png``; then the pieces of one frame timed apart
   (animate + pack, upload, render, present, PNG write);
6. configs 0 (256², no bounce) and 2 (512², 8 bounces) forward: frame ms
   (median of 3 after a warm-up), MRays/s, the six counters (dropped and
   incomplete must be 0) and each kernel's launches in one frame;
6b. the threaded walk: config3 at 1080p under ``traversal_kernel="threaded"``
   (K10 in place of K1/K2), one frame with the counts at 0 (K10's inputs of
   every generation kept for its rows, as of one config4 frame under the
   threaded walk), the median of 3 timed frames, MRays/s, a profiled frame
   (its device time, K10's in it), the time of packing the frame's tables
   (``build_scene_bvh``, its device time by the profiler), the share of pixels
   more than 1e-3 from the wide walk's frame (ties only), then one fwd+bwd step
   with the counts at 0, the median of 3 timed steps and a profiled step's
   device time (both loss counters 0, finite gradients);
7. kernel vs plain: each kernel and its plain PyTorch version on the card, on
   the inputs the main path gave that kernel in generation 0 (the forward
   kernels on config3's frame and on config4's; K3 and K4 in every mode on
   that mode's config3 frame (K3 also on config4's lanes), K4 also on its
   generation with the most
   top-texel lanes; K8 on config4's presented frame and on config3's 1080p
   frame; K9 on every generation of config4, config0 and config2, the rays
   that start inside a dielectric sphere among them), with the stated
   tolerance (a backward kernel against autograd of the plain forward, with a
   seeded cotangent; K7 forward and backward on every generation of config3's
   and config4's frames, the triangle and instance tables' gradients on
   generation 0; K10 on every generation of the threaded frame; K5 bwd also
   on the training step's own generation-0 inputs and on the made-up texel
   patterns of ``microbench/scatter.py``, and K6 at three densities and on a
   view one byte off alignment, both against their plain versions in float64
   where a float32 sum's order matters; the framebuffer scatter on generation
   1's contributions); then each kernel's time, its plain version's time, the
   one PyTorch call that computes the same function where there is one, and
   the least time the card could take (bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger); K5 bwd, K6 and the
   framebuffer scatter also with their calls queued behind a wait kernel
   (``device_ms``) and their time inside the training step; K4 in every mode
   also against the float64 sums of the plain version's per-lane values, with
   its ``device_ms`` and the run structure of its rows within warps and the
   atomics it issues; under ANISOTROPIC also on the training
   step's own generations 0 and 1 and on the patterns of
   ``microbench/scatter.py`` (every lane on one row, a permutation, 90% zero
   cotangents); K11 with the device time of ``index_select`` beside it; K1
   and K2 held to the plain walk, with their device time and bytes as
   issued, and the walk's counters (undecided children, lanes with a 0
   direction component, live triangles a leaf visit) held to the plain
   walk's; K10 on every generation of config3's and config4's threaded
   frames, with its device time, bytes as issued and sectors touched on
   generation 0 (``microbench/threaded.py``), beside the tables' sizes and
   the walk's warp efficiency; K3 in every mode and K8 with their device
   time, K3 with its taps' spread a lane and a warp, and EWA's set-up share
   (the window cut to one texel); K5, K7 and K9 with their device time; the two shading kernels of
   the no-grad path (``csrc/shade.cu``, row ``shade``) on config3's
   generation 0 against the torch glue they replace (every output bit for
   bit, the frame's dense add within 1e-6 relative), with their device time
   behind a wait kernel, the stage's with K5 and K3, and the glue's; the two
   children kernels of the no-grad path (``csrc/spawn.cu``, row ``spawn``)
   on the same generation against ``_compact(_spawn(...))`` (the next
   queue's ten fields bit for bit, the counts equal), with the stage's ms
   (K6 and its read among it) beside the glue's, each launch's device time
   and the glue's;
7b. the gather microbenchmarks: the four row-gather harnesses of ``scratch/``
   through ``raytracer_tpu_torch.microbench`` (``gather``, ``chained``,
   ``table_gather``, ``table_rowsum``) at the harnesses' shapes, each with the
   counts at 0 (its measurements and the launches of K11-K13); then a row for
   each harness kernel (K11 direct and staged, K11 from the 2.40 MB table, K12
   at the harnesses' two loop shapes, K13 single and chained) against its
   plain version, exact, with its device time (the calls queued behind a wait
   kernel, so none waits on the host); then K12 on config3's wide table (10
   dependent 288-byte rows for each of the 2,073,600 lanes) beside K1's time
   in this run, its latency (one warp an SM, 1,000 steps a lane), and over
   the same rows cut to the quantised record's 128 bytes; then K12 over the
   threaded walk's box rows, 54 dependent rows a lane, as they are (24
   bytes, 32-bit loads, one thread a chain: the floor under K10's
   one-lane-one-record reads) and padded to 32 bytes (16-byte loads, a warp's
   rows fetched together: the floor a fetch shared across a warp could
   reach);
8. small-input checks, the card against the same render on the CPU through the
   plain versions: config3 at 64x36 (20k triangles; also under the threaded
   walk), config4 at 96x64 on animation frames 0 and 2, config2 at 64x64 and 8
   bounces, forward; config3 and config4 fwd+bwd; the gradients of a weighted
   image sum of config3 at 64x36 with respect to the triangle tables and the
   instance matrices;
8b. the oracle: the four scenes of ``tests/test_torch_oracle.py`` (the JAX
   package's ``tests/test_oracle.py`` scenes, built by the port) rendered on
   the card and held to the port's scalar oracle (``render/oracle.py``, numpy
   on the host) under ``tests/test_torch_oracle.py``'s bounds: those of
   ``tests/test_oracle.py`` and the CPU readings' tighter ones;
8c. pixel sharding: a process group of world size 1 over NCCL, config3 at
   1080p through ``parallel/shard.make_sharded_renderer`` (with the counts at
   0: every forward kernel launched) against the unsharded frame (max
   difference printed; identical bits expected), one
   ``diff/train.make_sharded_train_step`` step against ``make_train_step``'s
   (loss and every gradient within 1e-5 relative), frame and step ms in
   turns beside the unsharded ones, the collectives each made, and
   ``parallel/scaling.measure`` (only 1 device runs on one card);
8d. scene sharding: config3's geometry split in two
   (``parallel/scene_shard.ShardedScenePacker``), two spawned processes on the
   one card over gloo (NCCL refuses two ranks on one device), dp=1 x sp=2:
   the combined frame against the unsharded one (mismatch share at 1e-5 below
   1e-3, the six counters equal), each rank's kernel launches, the
   collectives a frame and their time and copies from the profile (gloo takes
   the CUDA tensors itself), then one ``make_tensor_parallel_train_step``
   step (loss within 1e-5 of the unsharded step's) and its profile, and which
   collectives gloo takes on CUDA tensors;
9. the kernels line, the ``nvidia-smi`` line, and last the device line.

``--log PATH`` also writes every JSON line, in full, to PATH.

It imports nothing of JAX.  Without a CUDA card, or run outside the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# shared memory's rate: 128 bytes a clock an SM, 132 SMs at the H100 SXM's top
# clock of 1.98 GHz (K13's floor as issued: its shared-memory reads)
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9
WIDTH, HEIGHT, TRIANGLES = 1920, 1080, 260_000

# float32 operations per unit of work, counted from the kernel sources
# (csrc/traverse.cu): every iteration transforms the ray into instance space
# (33), a node visit adds 3 reciprocals and 8 slab tests of 25, a leaf visit
# 8 Moller-Trumbore tests of 54.
OPS_ITER, OPS_NODE, OPS_LEAF = 33, 3 + 8 * 25, 8 * 54
OPS_SKY = 25  # per lane (csrc/sky.cu)
# per lane of K5 bwd and the framebuffer scatter (csrc/scatter.cuh): 3 zero
# tests, 3 products, 3 x 5 segmented-scan adds
OPS_SCATTER3 = 21
# K3 / K4, every mode (csrc/texture.cuh, texture.cu, texture_bwd.cu).  A
# bilinear tap: 30 forward; 99 backward (the forward set-up 20, the weight and
# position cotangents 49, 12 products and 12 atomic adds into the row, 6 to move
# and accumulate).  Per lane, the set-up: NEAREST the texel's position and wrap
# (15; 3 atomic adds backward), BILINEAR 2, TRILINEAR 4 abs, 4 max, log2, floor
# and the clamps (20) and its blend (10; backward 70 for the blend's cotangent
# through lam and the maxes to the derivatives), ANISOTROPIC 25 (backward 28 with
# the cotangent / n), EWA the axes, the eccentricity clamp, the level, the
# quadratic form, its inverse and the box (80; 83 backward).  EWA per texel of
# its window scanned: 11 for r2 and the test (twice backward: the weight sum,
# then the scatter); per texel inside the ellipse 27 more (the weight with its
# expf, the wrap, 7 to accumulate), backward 34 (the weight twice, the wrap, 3
# products and 3 atomic adds).
OPS_TAP, OPS_TAPBWD = 30, 99
OPS_MODE = {  # mode: (fwd per lane, fwd per filter tap, bwd per lane, bwd per filter tap)
    "nearest": (15, 0, 18, 0), "bilinear": (2, OPS_TAP, 5, OPS_TAPBWD),
    "trilinear": (30, OPS_TAP, 90, OPS_TAPBWD), "aniso": (25, OPS_TAP, 28, OPS_TAPBWD),
    "ewa": (80, 11, 83, 22),
}
OPS_EWA_TEXEL, OPS_EWABWD_TEXEL = 27, 34
# csrc/shade.cu, float32 operations a lane counted from the source: the
# surface's Beer's law, sky term, albedo, w * albedo and direction to the
# camera (37) and the lights' sum's ambient, product, sky and frame adds (12);
# per light its direction, distance and Blinn-Phong term (the seven
# squarings), its colour and falloff, its mask (~55), and its add (3)
OPS_SHADE_LANE, OPS_SHADE_LIGHT = 37 + 12, 55 + 3
# the shading kernels' launch counters, ``launch.shade.<suffix>``: the no-grad
# path's two a generation, and the texture ids K3 reads on a textured scene
SHADE_KERNELS = ("shade_surface", "shade_lights", "shade_tex_id")
# the children kernels' launch counters, ``launch.spawn.<suffix>``: the no-grad
# path's two a spawning generation
SPAWN_KERNELS = ("spawn_flags", "spawn_write")
# csrc/spawn.cu, float32 operations counted from the source: a flagged lane's
# two squared lengths and, refracting, its Snell terms (~20); a child's Snell
# terms, the two differentials' dot products and its own direction,
# throughput, differentials and absorption (~90, the reflection's Fresnel term
# where its parent refracts included)
OPS_SPAWN_LANE, OPS_SPAWN_CHILD = 20, 90
# the modes the filters phase drives, besides the main path's ANISOTROPIC
FILTER_MODES = ("trilinear", "ewa", "bilinear", "nearest")
# csrc/fxaa.cu, what a pixel needs (a powf counted as one operation): its
# texel's gamma (9) and luma (5) once, the result's luma (5), the min / max,
# direction, reduce and span clamp (31), 4 tap positions (16), 4 bilinear taps
# (43), the means and the range test (20)
OPS_FXAA = 9 + 2 * 5 + 31 + 16 + 4 * 43 + 20
# csrc/primitives.cu: per closest-hit lane the ray's a and 1/2a (7), each sphere
# 30, each plane 17; per any-hit test a sphere 27, a plane 17
OPS_PRIM_LANE, OPS_PRIM_SPHERE, OPS_PRIM_PLANE = 7, 30, 17
OPS_ANY_SPHERE, OPS_ANY_PLANE = 27, 17
# csrc/hits.cuh, per lane with a mesh hit: the forward 410 (Moller-Trumbore 48,
# the two transforms of the ray 33, the point 6, the normal 37, uv 8, the four
# differentials' transforms 60, k 18, the du / dv 54, dP 48, dN 83, ds / dt 12,
# the rest 3); the backward recomputes it and adds ~960 for the adjoint
OPS_HITS_FWD, OPS_HITS_BWD = 410, 410 + 960
# csrc/traverse_threaded.cu, what the walk needs: per active ray the ray's 3
# reciprocals in the TLAS's space (its identity transform is not counted); per
# TLAS-leaf entry the transform into the instance's space (33) and its 3
# reciprocals; per node visit one slab test (25); per pair visit two
# Moller-Trumbore tests (2 x 54)
OPS_TRAY, OPS_TENTRY, OPS_TNODE, OPS_TPAIR = 3, 36, 25, 108
# csrc/gather.cu, a chain's step (K12, K13) beside the R - 1 adds of its row's
# sum: the accumulation, the product, its truncation, the two integer adds and
# the modulus (the range test and the sign fix-up not counted)
OPS_CHAIN_STEP = 6
# K12 on config3's wide table: steps a lane, K1's node visits a primary ray
# (10.0 on config3's 1080p frame, the K1 row's node_visits over its lanes)
WIDE_CHAIN_ITERS = 10
LATENCY_STEPS = 1000  # K12's latency run on that table: steps a lane
QUANT_ROW_FLOATS = 32  # a quantised wide-node record (accel/wide.py): 128 bytes
# the share of pixels of the threaded walk's 1080p frame that may differ from
# the wide walk's by more than 1e-3: the walks may take different triangles at
# an exactly equal t (a shared edge), nothing else
THREADED_PIXEL_SHARE = 5e-3
# card against CPU on the vertex loss of config3 64x36: per-table l2-relative
# bound ("*" for the rest).  Measured on an H100 in four runs, equal to 3
# digits from run to run (the CPU and card forwards differ, not the sums):
# tr_p0 2.3e-4, tr_e1 1.3e-4, tr_e2 3.7e-4, inst_inv 8.1e-5; the normal tables
# tr_n0 1.1e-5, tr_ne1 7.7e-6, tr_ne2 2.7e-5; inst_world 2.0e-6; the uv tables
# tr_t0 3.9e-3, tr_te1 2.6e-3, tr_te2 5.6e-3 (they reach the image through the
# texture filter, whose mip level the card's log2 moves, as SMALL_GRAD_TOL's
# tex_data).  Each limit is 1.8x (the uv tables) to 5x its table's reading.
VERTEX_GRAD_TOL = {"*": 1e-3, "tr_n0": 1e-4, "tr_ne1": 1e-4, "tr_ne2": 1e-4,
                   "inst_world": 1e-5, "tr_t0": 1e-2, "tr_te1": 1e-2, "tr_te2": 1e-2}
INSTANCE_TABLES = ("inst_inv", "inst_world")
APP_FRAMES = 30  # config4 frames rendered through app.main
# card against CPU on config3 64x36 fwd+bwd: per-field l2-relative bound on the
# gradients ("*" for every other field).  Measured on an H100: <= 2.5e-5 (the
# camera fields), tex_data 8.8e-4 (the card's log2 moves a few lanes to another
# mip level); the bounds leave room for the shadow flips the forward check allows
SMALL_GRAD_TOL = {"*": 1e-3, "tex_data": 1e-2}
# the appearance fields the make_train_step check trains (a zero target pulls
# every one of them down, so the loss falls from the first step)
TRAIN_FIELDS = ("mat_diffuse", "mat_reflection", "mat_transmittance", "tex_data",
                "sky_data", "pl_colour", "sl_colour", "dl_colour", "ambient")


LOG = None  # --log PATH: every JSON line also goes there, in full


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    if LOG:
        with open(LOG, "a") as f:
            f.write(line + "\n")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    b, o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


# bytes a walk's loads ask for (csrc/traverse.cu): the matrix and the world ray
# (6 floats) at each transform into an instance's space, a node visit's 7 x 16
# bytes of its record, an exact lane's 3 of them and the 48 box floats of its
# exact row, 6 floats an undecided child, 9 x 16 bytes a leaf half
BYTES_ENTER, BYTES_QNODE, BYTES_XLANE, BYTES_UNDECIDED, BYTES_HALF = 72, 112, 48 + 192, 24, 144


def issued_bytes(stats, lane_bytes) -> float:
    """Bytes as issued by one K1 / K2 launch, from its counters ``stats``
    (``traversal_wide.walk_stats``)."""
    return (lane_bytes + stats["enters"] * BYTES_ENTER
            + stats["quantised_node_visits"] * BYTES_QNODE
            + stats["exact_lane_node_visits"] * BYTES_XLANE
            + stats["undecided_children"] * BYTES_UNDECIDED
            + (stats["leaf_visits"] + stats["wide_leaf_visits"]) * BYTES_HALF)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tap_spread(per_lane, filtered) -> dict:
    """A per-lane count (K3's taps or texels) over the lanes on the filter
    branch: mean, p50, p99 and max; and what a warp pays, the mean over warps of
    32 consecutive lanes (launch order) of their largest count, beside the mean
    a lane over all lanes."""
    import torch

    from raytracer_tpu_torch.microbench import threaded as mb_threaded

    x = per_lane[filtered].float()
    if not x.numel():
        return {"lanes": 0}
    q = torch.quantile(x, torch.tensor([0.5, 0.99], device=x.device))
    n = per_lane.shape[0]
    warps = torch.nn.functional.pad(per_lane.float(), (0, (-n) % 32)).view(-1, 32)
    return {"lanes": x.numel(), "mean": float(x.mean()), "p50": float(q[0]),
            "p99": float(q[1]), "max": float(x.max()),
            "lane_mean": float(per_lane.float().mean()),
            "warp_max_mean": float(warps.amax(dim=1).mean()),
            "warp_efficiency": mb_threaded.warp_efficiency(per_lane)}


def rays_of(counters: dict) -> int:
    """The rays a frame traced (bench.py:192-211's count)."""
    return (counters["num_primary"] + counters["num_shadow"] + counters["num_reflection"]
            + counters["num_refraction"])


class Recorder:
    """Wraps the kernels' wrapper functions where the renderer calls them:
    keeps a copy of the inputs of each wrapper's first call (of every call for
    the names in ``every_call``, in ``calls``), or times every call with CUDA
    events.  Launch counts stay with the wrappers themselves."""

    def __init__(self, targets, every_call=()):
        self.targets = targets  # [(module, attribute name, kernel name)]
        self.every_call = set(every_call)
        self.inputs, self.calls, self.events = {}, {}, {}
        self.capture = self.timing = False

    def __enter__(self):
        import torch

        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.targets]
        for (m, a, name), (_, _, orig) in zip(self.targets, self.saved):
            def wrapped(*args, _orig=orig, _name=name, **kw):
                if self.capture and (_name not in self.inputs
                                     or _name in self.every_call):
                    got = ([x.detach().clone() if torch.is_tensor(x) else x for x in args],
                           kw)
                    self.inputs.setdefault(_name, got)
                    self.calls.setdefault(_name, []).append(got)
                if not self.timing:
                    return _orig(*args, **kw)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _orig(*args, **kw)
                e1.record()
                self.events.setdefault(_name, []).append((e0, e1))
                return out
            setattr(m, a, wrapped)
        return self

    def __exit__(self, *exc):
        for m, a, orig in self.saved:
            setattr(m, a, orig)

    def kernel_ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}


def profile_frame(render) -> dict:
    """Device time of one frame (or training step) by torch.profiler: the kernels
    and copies that ran on the card (device-side events only; an operator's own
    row would count its kernel twice), their share of the wall time, the
    largest, the copies apart, and the host's events of the collectives
    (``c10d::``, ``gloo:``, ``nccl:``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_name, comm = {}, {}
    for e in prof.events():
        into = by_name if e.device_type == DeviceType.CUDA else \
            comm if e.name.startswith(("c10d::", "gloo:", "nccl:")) else None
        if into is not None:
            ms, n = into.get(e.name, (0.0, 0))
            into[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    collectives = [{"name": k, "ms": ms, "count": n} for k, (ms, n) in sorted(comm.items())]
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured",
                "collective_events": collectives}
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_events": sum(n for _, n in by_name.values()),
        "top_device_kernels": [{"name": k[:90], "ms": ms, "count": n}
                               for k, (ms, n) in top],
        "device_copies": [{"name": k, "ms": ms, "count": n}
                          for k, (ms, n) in sorted(by_name.items()) if k.startswith("Memcpy")],
        "collective_events": collectives,
    }


def kernel_counters() -> tuple:
    """(forward kernels, every kernel): {name: key}, where each kernel's
    wrapper counts its launches under ``key`` of ``trace.counters``."""
    fwd_counts = {
        "traverse_closest": "launch.k1",
        "traverse_any": "launch.k2",
        "hits": "launch.k7",
        "texture_aniso": "launch.k3.aniso",
        "sky": "launch.k5",
        "compact": "launch.k6",
        "fb_scatter": "launch.fb_scatter",
    }
    counts = {**fwd_counts,
              "hits_bwd": "launch.k7.bwd",
              "texture_aniso_bwd": "launch.k4.aniso",
              "sky_bwd": "launch.k5.bwd",
              "fxaa": "launch.k8",
              "prim_closest": "launch.k9.closest",
              "prim_any": "launch.k9.any",
              "threaded_closest": "launch.k10.closest",
              "threaded_any": "launch.k10.any",
              **{k: f"launch.shade.{k[6:]}" for k in SHADE_KERNELS},
              **{k: f"launch.spawn.{k[6:]}" for k in SPAWN_KERNELS}}
    for mode in FILTER_MODES:
        counts[f"texture_{mode}"] = f"launch.k3.{mode}"
        counts[f"texture_{mode}_bwd"] = f"launch.k4.{mode}"
    return fwd_counts, counts


def reset_kernel_counts(counts: dict) -> None:
    from raytracer_tpu_torch.utils import trace

    for key in counts.values():
        trace.counters.pop(key, None)


def read_kernel_counts(counts: dict) -> dict:
    from raytracer_tpu_torch.utils import trace

    return {name: trace.counters[key] for name, key in counts.items()}


def gather_phase(scene, record, launches: dict, report: list, walk_visits: dict,
                 smi: str) -> list:
    """Phase 7b: the four row-gather harnesses of scratch/ through the port's
    entry points, at the harnesses' shapes, each run with the counts at 0; then
    K11-K13 against their plain versions on the same inputs, one row a harness
    kernel (``record``, which also holds each row to its check); then K12 on
    config3's wide table beside K1's row.  Returns the problems found."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import microbench
    from raytracer_tpu_torch.microbench import chained as mb_chained
    from raytracer_tpu_torch.microbench import gather as mb_gather
    from raytracer_tpu_torch.microbench import table_gather as mb_table_gather
    from raytracer_tpu_torch.microbench import table_rowsum as mb_table_rowsum
    from raytracer_tpu_torch.microbench import threaded as mb_threaded
    from raytracer_tpu_torch.ops import gather, traversal, traversal_wide
    from raytracer_tpu_torch.utils import trace

    dev = scene.tr_p0.device
    t_gather = time.perf_counter()
    problems, runs = [], {}
    for label, bench in (("gather", mb_gather), ("chained", mb_chained),
                         ("table_gather", mb_table_gather), ("table_rowsum", mb_table_rowsum)):
        for key in gather.LAUNCH.values():
            trace.counters.pop(key, None)
        with contextlib.redirect_stdout(io.StringIO()):
            lines = bench.main([])
        runs[label] = {k: trace.counters[v] for k, v in gather.LAUNCH.items()}
        checks = {f"{line['name']}.{k}": v for line in lines for k, v in line.items()
                  if k in ("match", "exact", "j_equal", "per_call_equal")}
        emit("gather_bench", bench=label, module=f"raytracer_tpu_torch.microbench.{label}",
             launches=runs[label], measurements=lines, nvidia_smi=smi)
        if not all(checks.values()):
            return [f"microbench {label}: a check failed: {checks}"]

    def gather_err(got, want) -> tuple:
        """(every output equals its plain version bit for bit, NaNs included;
        the largest |difference| of the float outputs, inf if an int output
        differs)."""
        pairs = list(zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)))
        exact = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                    for a, b in pairs)
        errs = [float((a - b).nan_to_num(nan=float("inf")).abs().max())
                if a.is_floating_point() else (0.0 if bool(torch.equal(a, b)) else float("inf"))
                for a, b in pairs]
        return exact, 0.0 if exact else max(errs)

    def chain_rows(table, idx0, iters) -> int:
        """The distinct rows a K12 chain reads (its data picks them)."""
        t, j = table.shape[0], idx0
        seen = torch.zeros(t, dtype=torch.bool, device=table.device)
        for i in range(iters):
            seen[j.long()] = True
            j = gather.next_index(j, table[j.long(), 0] * t, i, t)
        return int(seen.sum())

    def gather_row(name, replaces, run, key, kernel, plain, bnd, library=None, reps=50,
                   issued=None, **extra):
        """One kernel row, its launches those of microbench.``run``."""
        launches[name] = runs[run][key]
        if launches[name] <= 0:
            problems.append(f"{name} launched {launches[name]} times in microbench.{run}")
        exact, err = gather_err(kernel(), plain())
        dev_ms = microbench.device_ms(kernel, dev)
        if issued is not None:
            extra["bytes_as_issued"] = issued
            extra["issued_per_s"] = issued / (dev_ms / 1e3)
        record(name, "raytracer_tpu_torch/csrc/gather.cu", replaces, err,
               cuda_ms(kernel, reps), cuda_ms(plain, 5), bnd,
               None if library is None else cuda_ms(library, reps), exact,
               device_ms=dev_ms, microbench=f"raytracer_tpu_torch.microbench.{run}", **extra)

    def k12_over(table, lanes, steps, reps=50) -> dict:
        """K12 over ``table``: {exact, ms, device_ms, bytes_as_issued,
        issued_per_s}."""
        def fn():
            return gather.chained_gather(table, lanes, steps)

        dev_ms = microbench.device_ms(fn, dev, reps)
        issued = lanes.shape[0] * steps * table.shape[1] * 4
        return {"exact": gather_err(fn(), gather.chained_gather_plain(table, lanes, steps))[0],
                "ms": cuda_ms(fn, reps), "device_ms": dev_ms, "bytes_as_issued": issued,
                "issued_per_s": issued / (dev_ms / 1e3)}

    _, padded, idx = mb_gather.inputs(dev)
    k11_bytes = (torch.unique(idx).numel() * padded.shape[1] * 4 + nbytes(idx)
                 + idx.shape[0] * padded.shape[1] * 4)
    for schedule, replaces in (("direct", "scratch/bench_pallas_gather.py:63 row_kernel"),
                               ("staged", "scratch/bench_pallas_gather.py:92 block_kernel")):
        gather_row(f"row_gather_{schedule}", replaces, "gather", schedule,
                   lambda schedule=schedule: gather.row_gather(padded, idx, schedule),
                   lambda: gather.row_gather_plain(padded, idx), bound_ms(k11_bytes, 0),
                   lambda: torch.index_select(padded, 0, idx), schedule=schedule,
                   shape={"table": list(padded.shape), "lanes": idx.shape[0]},
                   library_device_ms=microbench.device_ms(
                       lambda: torch.index_select(padded, 0, idx), dev),
                   tolerance="exact (a copy of bits)")
    del padded, idx

    table, idx = mb_table_gather.inputs(dev)
    gather_row("row_gather_table", "scratch/bench_vmem_gather.py:33 kernel_take, "
               ":37 kernel_tala", "table_gather", "direct",
               lambda: gather.row_gather(table, idx, "direct"),
               lambda: gather.row_gather_plain(table, idx),
               bound_ms(torch.unique(idx).numel() * table.shape[1] * 4 + nbytes(idx)
                        + idx.shape[0] * table.shape[1] * 4, 0),
               lambda: torch.index_select(table, 0, idx), schedule="direct",
               shape={"table": list(table.shape), "lanes": idx.shape[0]},
               tolerance="exact (a copy of bits)")
    n, iters, width = idx.shape[0], mb_table_gather.ITERS, table.shape[1]
    rows = chain_rows(table, idx, iters)
    gather_row("chained_gather_table", "scratch/bench_vmem_gather.py:61-75 bench_loop",
               "table_gather", "chained", lambda: gather.chained_gather(table, idx, iters),
               lambda: gather.chained_gather_plain(table, idx, iters),
               bound_ms(rows * width * 4 + nbytes(idx) + n * 8,
                        n * iters * (width - 1 + OPS_CHAIN_STEP)),
               issued=n * iters * width * 4,
               shape={"table": list(table.shape), "lanes": n, "iters": iters},
               rows_read=rows, tolerance="acc and j equal on every lane")
    del table, idx

    table, idx, idx_all = mb_chained.inputs(dev)
    n, iters, width = idx.shape[0], mb_chained.ITERS, table.shape[1]
    rows = chain_rows(table, idx, iters)
    issued = n * iters * width * 4
    def indep_fn():
        return gather.indep_gather(table, idx_all)

    i_exact, i_err = gather_err(indep_fn(), gather.indep_gather_plain(table, idx_all))
    indep = {"launches": runs["chained"]["indep"], "exact": i_exact, "max_abs_err": i_err,
             "ms": cuda_ms(indep_fn, 50), "device_ms": microbench.device_ms(indep_fn, dev)}
    if not i_exact:
        problems.append(f"K12 indep differs from its plain version by {i_err}")
    gather_row("chained_gather", "scratch/bench_pallas_chained.py:25 pallas_gather "
               "(in make_fn :67-84)", "chained", "chained",
               lambda: gather.chained_gather(table, idx, iters),
               lambda: gather.chained_gather_plain(table, idx, iters),
               bound_ms(rows * width * 4 + nbytes(idx) + n * 8,
                        n * iters * (width - 1 + OPS_CHAIN_STEP)),
               issued=issued, shape={"table": list(table.shape), "lanes": n, "iters": iters},
               rows_read=rows, bound_as_issued_ms=issued / PEAK_BYTES_PER_S * 1e3,
               indep=indep, tolerance="acc and j equal on every lane; indep's acc equal")
    del table, idx, idx_all

    tab, idx = mb_table_rowsum.inputs(dev)
    n, iters, comps = idx.shape[0], mb_table_rowsum.ITERS, tab.shape[0]
    gather_row("table_rowsum", "scratch/bench_vmem_invreg.py:63 gather_kernel", "table_rowsum",
               "rowsum", lambda: gather.table_rowsum(tab, idx),
               lambda: gather.table_rowsum_plain(tab, idx),
               bound_ms(nbytes(tab, idx) + n * 4, n * (comps - 1)),
               shape={"table": list(tab.shape), "lanes": n},
               smem_floor_as_issued_ms=n * comps * 4 / SMEM_BYTES_PER_S * 1e3,
               tolerance="equal on every lane (both sum left to right)")
    gather_row("table_rowsum_chain", "scratch/bench_vmem_invreg.py:39 in_kernel",
               "table_rowsum", "rowsum_chain", lambda: gather.table_rowsum_chain(tab, idx, iters),
               lambda: gather.table_rowsum_chain_plain(tab, idx, iters),
               bound_ms(nbytes(tab, idx) + n * 8, n * iters * (comps - 1 + OPS_CHAIN_STEP)),
               shape={"table": list(tab.shape), "lanes": n, "iters": iters},
               smem_floor_as_issued_ms=n * iters * comps * 4 / SMEM_BYTES_PER_S * 1e3,
               tolerance="acc and j equal on every lane (j follows the float sum)")
    del tab, idx

    # K12 on config3's own wide table: one dependent 288-byte row a step, 10
    # steps a lane (K1's node visits a primary ray) over the 1080p primaries
    wide = traversal_wide.build_scene_bvh(scene).table
    n, iters = WIDTH * HEIGHT, WIDE_CHAIN_ITERS
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, wide.shape[0], n).astype(np.int32)).to(dev)
    k12 = k12_over(wide, idx, iters)
    same = k12["exact"]
    w_ms = k12["ms"]
    rows = chain_rows(wide, idx, iters)
    # the latency of one dependent row: one warp an SM, so no row waits for bandwidth
    lat_n = torch.cuda.get_device_properties(dev).multi_processor_count * 32 \
        if dev.type == "cuda" else 32
    lat_ms = cuda_ms(lambda: gather.chained_gather(wide, idx[:lat_n], LATENCY_STEPS), 5)
    latency = {"lanes": lat_n, "steps": LATENCY_STEPS, "ms": lat_ms,
               "ns_per_step": lat_ms * 1e6 / LATENCY_STEPS}
    # the same chains over the rows cut to the quantised node record's width
    # (QUANT_ROW_FLOATS): the floor a narrower record could reach
    narrow = wide[:, :QUANT_ROW_FLOATS].contiguous()
    narrow_row = dict(k12_over(narrow, idx, iters), row_floats=narrow.shape[1])
    n_same = narrow_row["exact"]
    narrow_row["over_wide"] = narrow_row["device_ms"] / k12["device_ms"]
    del narrow
    k1 = next(r for r in report if r["name"] == "traverse_closest")
    k1_walk = walk_visits["traverse_closest"]
    emit("gather_wide_table", table=list(wide.shape), lanes=n, iters=iters, exact=same,
         ms=w_ms, device_ms=k12["device_ms"], bytes_as_issued=k12["bytes_as_issued"],
         issued_per_s=k12["issued_per_s"], ns_per_lane_iter=w_ms * 1e6 / (n * iters),
         rows_read=rows,
         bound_ms=bound_ms(rows * wide.shape[1] * 4 + nbytes(idx) + n * 8,
                           n * iters * (wide.shape[1] - 1 + OPS_CHAIN_STEP))[0],
         latency=latency, k1_ms=k1["ms"], k1_bound_ms=k1["bound_ms"], k1_walk=k1_walk,
         k1_visits_per_active_lane=(k1_walk["node_visits"] + k1_walk["leaf_visits"])
         / max(k1_walk["active"], 1),
         k1_over_chain=k1["ms"] / w_ms, narrow=narrow_row,
         nvidia_smi=smi)
    if not n_same:
        problems.append("K12 on config3's cut table differs from its plain version")
    if not same:
        problems.append("K12 on config3's wide table differs from its plain version")
    del wide, idx

    # K12 over the threaded walk's box rows (K10's table), 54 dependent rows a
    # lane (K10's node visits a primary ray): the rows as they are, 24 bytes
    # with 32-bit loads, and padded to 32 bytes with 16-byte loads
    floors = mb_threaded.chain_floor(traversal.build_scene_bvh(scene), WIDTH * HEIGHT,
                                     mb_threaded.CHAIN_ITERS, dev, 20)
    k10 = next(r for r in report if r["name"] == "threaded_closest")
    emit("gather_threaded_table", rows=floors, k10_ms=k10["ms"], nvidia_smi=smi)
    if not all(f["exact"] for f in floors):
        problems.append("K12 on the threaded walk's box rows differs from its plain version")
    emit("gather", seconds=time.perf_counter() - t_gather)
    return problems


# ------------------------------------------- the oracle and the parallel layer


def rel_l2(a, b) -> float:
    """l2-relative difference of two tensors in float64 (the norm of a when b is 0)."""
    a, b = a.double(), b.double()
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb > 0 else float(a.norm())


def oracle_phase(smi: str) -> list:
    """The four scenes of ``tests/test_torch_oracle.py`` rendered on the card and
    held to the port's oracle (``render/oracle.py``, numpy on the host) under that
    test's bounds; returns the problems found."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_oracle as cases
    from raytracer_tpu_torch.render.oracle import OracleRenderer
    from raytracer_tpu_torch.scene.device import pack_scene

    problems = []
    for name, (make, cfg, min_hit) in cases.CASES.items():
        packed = pack_scene(make(), cfg.width, cfg.height)
        t0 = time.perf_counter()
        img, counters = cases.render_port(packed, cfg, device="cuda")
        t1 = time.perf_counter()
        ref = OracleRenderer(packed, cfg).render()
        t2 = time.perf_counter()
        r = cases.compare(img, ref)
        checks = {**cases.within_bounds(r, min_hit),
                  "cpu_readings": cases.within_cpu_readings(r)}
        passed = all(checks.values()) and counters["num_dropped"] == 0 \
            and counters["num_incomplete"] == 0
        emit("oracle", scene=name, width=cfg.width, height=cfg.height,
             bounces=cfg.num_bounces, filter=cfg.mipmap_filter.name, counters=counters,
             **r, checks=checks, passed=passed,
             card_render_s=t1 - t0, oracle_s=t2 - t1,
             tolerance=cases.BOUNDS_TEXT, nvidia_smi=smi)
        if not passed:
            problems.append(f"oracle {name}: {r}")
    return problems


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_phase(scene, cfg, image, counters, train_kernels, smi: str) -> list:
    """World size 1 over NCCL on config3 at 1080p: the pixel-sharded frame (one
    shard, so the permutation is the identity) against the unsharded one, one
    sharded step against ``make_train_step``'s, both timed in turns beside the
    unsharded ones, and ``parallel/scaling.measure`` (only 1 device runs on one
    card); returns the problems found."""
    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch.diff import train
    from raytracer_tpu_torch.parallel import collectives, distributed, scaling, shard
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.render import renderer

    fwd_counts, counts = kernel_counters()
    distributed.initialize(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                           local_rank=0)
    try:
        backend = dist.get_backend()
        mesh = make_mesh((1, 1))
        run = shard.make_sharded_renderer(cfg, mesh)
        reset_kernel_counts(counts)
        collectives.reset()
        simg, sstats = run(scene)
        torch.cuda.synchronize()
        launches = {k: n for k, n in read_kernel_counts(counts).items() if k in fwd_counts}
        coll = dict(collectives.counts)
        scounters = {k: int(v) for k, v in sstats._asdict().items()}
        # the frame's later generations add into the framebuffer with atomics,
        # so two runs may differ in the last bits: identical bits expected,
        # the largest difference printed and held to 1e-5
        max_diff = float((simg - image).abs().max())
        identical = bool(torch.equal(simg, image))

        def unsharded():
            with torch.no_grad():
                renderer.render_with_stats(scene, cfg)

        def timed(fn) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        frame = {"unsharded": [], "sharded": []}
        for _ in range(3):  # in turns
            frame["unsharded"].append(timed(unsharded))
            frame["sharded"].append(timed(lambda: run(scene)))
        frame_profile = profile_frame(lambda: run(scene))

        # one step each from the same parameters and a zero target, under
        # PyTorch's deterministic algorithms: the gathers' backward
        # (``index_add_``) then adds in a fixed order; two of make_train_step's
        # give what order is left to the kernels' atomics (K4 into tex_data)
        target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device="cuda")
        init1, step1 = train.make_train_step(cfg)
        init, step = train.make_sharded_train_step(cfg, mesh)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            p1, o1 = init1(scene)
            _, _, loss1 = step1(p1, o1, scene, target)
            grads1 = {k: p.grad.detach().clone() for k, p in p1.items() if p.grad is not None}
            p2, o2 = init1(scene)
            step1(p2, o2, scene, target)
            spread = {k: rel_l2(p2[k].grad, g) for k, g in grads1.items()}
            del p2, o2
            p, o = init(scene)
            reset_kernel_counts(counts)
            collectives.reset()
            _, _, loss = step(p, o, scene, target)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        step_launches = {k: n for k, n in read_kernel_counts(counts).items()
                         if k in train_kernels}
        step_coll = dict(collectives.counts)
        grad_rel = {k: rel_l2(p[k].grad, g) for k, g in grads1.items()}
        others = [k for k in p.keys() if k not in grads1]
        grads_zero_elsewhere = all(not bool(p[k].grad.any()) for k in others)
        loss_rel = abs(float(loss) - float(loss1)) / abs(float(loss1))
        steps = {"unsharded": [], "sharded": []}
        for _ in range(2):  # in turns
            steps["unsharded"].append(timed(lambda: step1(p1, o1, scene, target)))
            steps["sharded"].append(timed(lambda: step(p, o, scene, target)))
        scale = scaling.measure(scene, cfg, device_counts=(1, 2, 4, 8), iters=3)
    finally:
        dist.destroy_process_group()

    med = {k: statistics.median(v) for k, v in frame.items()}
    smed = {k: statistics.median(v) for k, v in steps.items()}
    passed = max_diff <= 1e-5 and scounters == counters \
        and all(n > 0 for n in launches.values()) and all(n > 0 for n in step_launches.values()) \
        and all(v <= 1e-5 for v in grad_rel.values()) and grads_zero_elsewhere \
        and loss_rel <= 1e-5 and coll == {"all_gather": 1, "all_reduce": 1, "reduce_scatter": 0} \
        and step_coll == {"all_gather": 0, "all_reduce": 1, "reduce_scatter": 0}
    emit("sharded", config="config3_sponza", width=cfg.width, height=cfg.height, world_size=1,
         backend=str(backend), image_max_abs_diff=max_diff, image_identical=identical,
         counters=scounters, counters_equal_unsharded=scounters == counters,
         launches=launches, collectives_frame=coll,
         frame_ms={"unsharded": med["unsharded"], "sharded": med["sharded"],
                   "runs": frame}, profile=frame_profile,
         step_loss=float(loss), step_loss_unsharded=float(loss1), step_loss_rel=loss_rel,
         step_grad_l2_rel=grad_rel, unsharded_run_to_run_l2_rel=spread,
         deterministic_algorithms_for_the_comparison=True,
         step_launches=step_launches, collectives_step=step_coll,
         step_ms={"unsharded": smed["unsharded"], "sharded": smed["sharded"], "runs": steps},
         scaling=scale, passed=passed,
         tolerance="image within 1e-5 (identical bits expected: one shard's permutation is "
                   "the identity; the framebuffer's atomics may reorder sums); counters equal; "
                   "every gradient within 1e-5 l2-relative of make_train_step's and the loss "
                   "within 1e-5 (both steps under deterministic algorithms); one gather + one "
                   "all-reduce a frame, one all-reduce a step",
         nvidia_smi=smi)
    return [] if passed else [f"sharded: see the 'sharded' line (max diff {max_diff}, "
                              f"grads {grad_rel}, loss {loss_rel})"]


SHARD_RANK_TIMEOUT_S = 600


def gloo_cuda_probe() -> dict:
    """Which collectives the installed gloo takes on CUDA tensors ("ok", or
    the error it raised)."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device="cuda"), x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe reports what gloo refuses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def scene_shard_rank(rank: int, work: str) -> None:
    """One of the two ranks of the scene_sharded phase (a spawned process, both
    on the one card, over gloo): its shard's frame and one tensor-parallel step,
    results written to ``work``."""
    sys.path.insert(0, REPO)
    import pickle
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch.diff import train
    from raytracer_tpu_torch.parallel import collectives, distributed
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.scene_shard import make_primitive_sharded_renderer
    from raytracer_tpu_torch.render import renderer
    from raytracer_tpu_torch.scene.tensors import scene_from_numpy

    try:
        distributed.initialize(init_method="file://" + os.path.join(work, "store"),
                               world_size=2, rank=rank, local_rank=0, backend="gloo")
        mesh = make_mesh((1, 2))
        sp = mesh.get_local_rank("sp")
        with open(os.path.join(work, "cfg.pkl"), "rb") as f:
            cfg = pickle.load(f)
        scene = scene_from_numpy(dict(np.load(os.path.join(work, f"shard{sp}.npz"))),
                                 device="cuda")
        fwd_counts, counts = kernel_counters()
        train_kernels = (*fwd_counts, "hits_bwd", "texture_aniso_bwd", "sky_bwd")
        traces = {"closest": 0}
        trace_scene = renderer.trace_scene

        def counted(*a, **kw):
            traces["closest"] += 1
            return trace_scene(*a, **kw)

        renderer.trace_scene = counted
        # lanes where both shards hit at the same t (triangles of the two halves
        # meeting at an edge): the combine keeps shard 0's, the whole scene's
        # walk whichever it met first, so these lanes alone may shade differently
        ties = {"lanes": 0, "on": True, "bytes": 0}
        gather = collectives.all_gather

        def tie_counting(x, g):
            got = gather(x, g)
            if ties["on"] and x.dim() == 2 and x.shape[1] == 28:  # a hit-record combine
                t = got[:, :-1, 0]
                ties["lanes"] += int(((t[0] == t[1]) & torch.isfinite(t[0])).sum())
                ties["bytes"] += got.numel() * got.element_size()
            return got

        collectives.all_gather = tie_counting
        out = {"rank": rank, "sp": sp, "backend": str(dist.get_backend())}
        run = make_primitive_sharded_renderer(cfg, mesh)
        reset_kernel_counts(counts)
        collectives.reset()
        t0 = time.perf_counter()
        img, stats = run(scene)
        torch.cuda.synchronize()
        out.update(first_frame_ms=(time.perf_counter() - t0) * 1e3,
                   launches={k: n for k, n in read_kernel_counts(counts).items()
                             if k in fwd_counts},
                   collectives=dict(collectives.counts),
                   generations=traces["closest"], tie_lanes=ties["lanes"],
                   combine_gathered_bytes=ties["bytes"],
                   counters={k: int(v) for k, v in stats._asdict().items()})
        ties["on"] = False
        if sp == 0:
            np.save(os.path.join(work, "image.npy"), img.cpu().numpy())
        frame_ms = []
        for _ in range(2):
            collectives.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(scene)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        out.update(frame_ms=frame_ms, profile=profile_frame(lambda: run(scene)))

        # one tensor-parallel step over the 17 fields against a zero target
        init, step = train.make_tensor_parallel_train_step(cfg, mesh)
        params, opt = init(scene)
        target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device="cuda")
        reset_kernel_counts(counts)
        collectives.reset()
        traces["closest"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss = step(params, opt, scene, target)
        torch.cuda.synchronize()
        out["step"] = dict(
            loss=float(loss), ms=(time.perf_counter() - t0) * 1e3,
            launches={k: n for k, n in read_kernel_counts(counts).items()
                      if k in train_kernels},
            collectives=dict(collectives.counts), generations=traces["closest"],
            grads_finite=all(bool(torch.isfinite(p.grad).all()) for p in params.values()),
            profile=profile_frame(lambda: step(params, opt, scene, target)))
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        probe = gloo_cuda_probe()
        with open(os.path.join(work, f"probe{rank}.json"), "w") as f:
            json.dump(probe, f)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def scene_sharded_phase(desc, cfg, image, counters, train_loss, smi: str) -> list:
    """dp=1 x sp=2 on config3 at 1080p: the geometry split in two, each half's
    scene rendered by its own process on the one card (``nccl`` refuses two
    ranks on one device, so the group runs over gloo, which takes the CUDA
    tensors itself), the combined frame
    against the unsharded one and one tensor-parallel step's loss against the
    unsharded step's; returns the problems found."""
    import multiprocessing as mp
    import pickle

    import numpy as np

    from raytracer_tpu_torch.parallel.scene_shard import ShardedScenePacker

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    shards = ShardedScenePacker(desc, cfg, 2).frame()
    pack_s = time.perf_counter() - t0
    shard_triangles = [int(s.tr_p0.shape[0]) for s in shards]
    for k, s in enumerate(shards):
        np.savez(os.path.join(work, f"shard{k}.npz"), **s._asdict())
    with open(os.path.join(work, "cfg.pkl"), "wb") as f:
        pickle.dump(cfg, f)
    del shards

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=scene_shard_rank, args=(r, work)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, SHARD_RANK_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    wall_s = time.perf_counter() - t0
    errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
              if f.endswith(".err")]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        shutil.rmtree(work, ignore_errors=True)
        return [f"scene_sharded: {len(hung)} rank(s) hung, exit codes "
                f"{[p.exitcode for p in procs]}: " + "\n".join(errors)]
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(2)]
    probes = [json.load(open(os.path.join(work, f"probe{r}.json"))) for r in range(2)]
    img = np.load(os.path.join(work, "image.npy"))
    shutil.rmtree(work, ignore_errors=True)

    ref = image.cpu().numpy()
    mism_px = int((np.abs(img - ref) > 1e-5).any(axis=-1).sum())
    mism = float((np.abs(img - ref) > 1e-5).mean())
    ties = ranks[0]["tie_lanes"]
    got = ranks[0]["counters"]
    # a tie lane may take another triangle than the whole scene's walk: its
    # pixel, its 3 lights' shadow rays and its 2 children may differ
    slack = {"num_shadow": 3 * ties, "num_reflection": ties, "num_refraction": ties}
    counter_diff = {k: got[k] - counters[k] for k in counters}
    loss = ranks[0]["step"]["loss"]
    loss_rel = abs(loss - train_loss) / abs(train_loss)
    gens = ranks[0]["generations"]
    fwd_ok = all(all(n > 0 for n in r["launches"].values()) for r in ranks)
    step_ok = all(all(n > 0 for n in r["step"]["launches"].values()) for r in ranks)
    counters_equal = all(r["counters"] == counters for r in ranks)
    counters_ok = all(abs(v) <= slack.get(k, 0) for k, v in counter_diff.items())
    passed = (mism < 1e-3 and mism_px <= ties and counters_ok and fwd_ok and step_ok
              and loss_rel <= 1e-5
              and all(r["step"]["grads_finite"] for r in ranks)
              and ranks[0]["counters"] == ranks[1]["counters"])
    emit("scene_sharded", config="config3_sponza", width=cfg.width, height=cfg.height,
         dp=1, sp=2, backend=ranks[0]["backend"], shard_triangles=shard_triangles,
         pack_s=pack_s, ranks_wall_s=wall_s, mismatch_fraction=mism, mismatched_pixels=mism_px,
         tie_lanes=ties, counters=got, counters_equal_unsharded=counters_equal,
         counters_minus_unsharded=counter_diff,
         launches=[r["launches"] for r in ranks],
         step_launches=[r["step"]["launches"] for r in ranks],
         generations=gens, collectives_frame=ranks[0]["collectives"],
         combine_gathered_bytes_per_generation=ranks[0]["combine_gathered_bytes"] / max(gens, 1),
         first_frame_ms=[r["first_frame_ms"] for r in ranks],
         frame_ms=[r["frame_ms"] for r in ranks],
         profile=[r["profile"] for r in ranks],
         step_loss=loss, step_loss_unsharded=train_loss, step_loss_rel=loss_rel,
         step_ms=[r["step"]["ms"] for r in ranks], step_collectives=ranks[0]["step"]["collectives"],
         step_generations=ranks[0]["step"]["generations"],
         step_profile=[r["step"]["profile"] for r in ranks],
         gloo_on_cuda_tensors=probes[0], passed=passed,
         tolerance="mismatch fraction at 1e-5 < 1e-3 against the unsharded frame, and no "
                   "more mismatched pixels than tie lanes (both shards hit at one t); the "
                   "counters equal but for the tie lanes' (3 shadow rays and 2 children a "
                   "lane); the step's loss within 1e-5 of the unsharded step's",
         nvidia_smi=smi)
    return [] if passed else [f"scene_sharded: mismatch {mism} ({mism_px} px, {ties} tie lanes),"
                              f" counters {got} vs {counters}, loss rel {loss_rel}"]


def main(argv=None) -> int:
    global LOG
    ap = argparse.ArgumentParser(description="Drive the PyTorch + CUDA port on one CUDA card.")
    ap.add_argument("--log", help="also write every JSON line, in full, to this file")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs one CUDA card")
    import numpy as np
    if not os.path.isdir(os.path.join(REPO, "raytracer_tpu_torch")):
        return fail(f"{REPO} holds no raytracer_tpu_torch package: run from a checkout")
    sys.path.insert(0, REPO)
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        open(args.log, "w").close()
        LOG = args.log

    from raytracer_tpu_torch import app, kernels, microbench
    from raytracer_tpu_torch.accel import wide as wide_mod
    from raytracer_tpu_torch.config import MipmapFilter, TextureSampleMode, TraversalStrategy
    from raytracer_tpu_torch.diff import train
    from raytracer_tpu_torch.microbench import scatter
    from raytracer_tpu_torch.microbench import threaded as mb_threaded
    from raytracer_tpu_torch.ops import (
        compaction, framebuffer, fxaa, gather, hits, intersect, shade, sky_sample, spawn,
        texture_sample, traversal, traversal_wide,
    )
    from raytracer_tpu_torch.render import renderer
    from raytracer_tpu_torch.scene import scenes
    from raytracer_tpu_torch.scene.device import ScenePacker
    from raytracer_tpu_torch.utils import image as image_util

    # -------------------------------------------------------------- 1. environment
    smi = nvidia_smi_line()
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    # -------------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    built = kernels.build(force=True, verbose_ptxas=True)
    usage = {name: kernels.ptxas_usage(b["log"]) for name, b in built.items()}
    emit("build", seconds=time.perf_counter() - t0,
         per_source_seconds={k: v["seconds"] for k, v in built.items()}, ptxas=usage)
    for name in kernels.SOURCES:
        kernels.library(name)

    # ------------------------------------------------------------ 3. the main path
    t0 = time.perf_counter()
    desc, cfg = scenes.config3_sponza(WIDTH, HEIGHT, target_triangles=TRIANGLES)
    packed = ScenePacker(desc, WIDTH, HEIGHT).frame()
    rend = renderer.Renderer(cfg, device="cuda")
    scene = rend.upload(packed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the quantised node records' host cost: the BLAS block once a scene (its
    # leaves' live slots with it), the TLAS every frame (ScenePacker.frame)
    t0 = time.perf_counter()
    wide_mod.quantised_records(packed.wd_rec, wide_mod.leaf_live_counts(
        packed.tr_p0, packed.tr_e1, packed.tr_e2))
    t1 = time.perf_counter()
    wide_mod.quantised_records(packed.wt_rec)
    t2 = time.perf_counter()
    bvh3 = traversal_wide.build_scene_bvh(scene)
    emit("scene", name="config3_sponza", width=WIDTH, height=HEIGHT,
         triangles=int(packed.tr_p0.shape[0]), instances=int(packed.inst_inv.shape[0]),
         stack_bound=packed.stack_bound,
         wide_records=list(packed.wd_rec.shape), texels=int(packed.tex_data.shape[0]),
         seconds=seconds, quantise_blas_ms=(t1 - t0) * 1e3, quantise_tlas_ms=(t2 - t1) * 1e3,
         table_bytes=nbytes(bvh3.table), quantised_node_bytes=nbytes(bvh3.qrec),
         exact_node_bytes=bvh3.node_rows * 72 * 4)
    del bvh3

    fwd_counts, counts = kernel_counters()
    train_kernels = (*fwd_counts, "hits_bwd", "texture_aniso_bwd", "sky_bwd")
    # config4 through the app: every forward kernel, FXAA and the primitives
    app_kernels = (*fwd_counts, "fxaa", "prim_closest", "prim_any", *SHADE_KERNELS[:2],
                   *SPAWN_KERNELS)
    # the threaded walk: K10 in place of K1/K2
    threaded_kernels = ("threaded_closest", "threaded_any", "hits", "texture_aniso", "sky",
                        "compact", "fb_scatter", *SHADE_KERNELS, *SPAWN_KERNELS)
    targets = [(traversal_wide, "trace_closest", "traverse_closest"),
               (traversal_wide, "trace_any", "traverse_any"),
               (hits, "mesh_hits", "hits"),
               (texture_sample, "sample", "texture_aniso"),
               (sky_sample, "sample_sky", "sky"),
               (compaction, "compact", "compact"),
               (framebuffer, "accumulate", "fb_scatter"),
               (shade, "surface", "shade"),
               (spawn, "flags", "spawn")]
    bwd_targets = [(hits, "hits_backward", "hits_bwd"),
                   (texture_sample, "sample_backward", "texture_aniso_bwd"),
                   (sky_sample, "sample_backward", "sky_bwd")]

    def reset_counts():
        reset_kernel_counts(counts)

    def read_counts():
        return read_kernel_counts(counts)

    # one frame with the counts at 0: the forward path's run
    reset_counts()
    rec = Recorder(targets, every_call=("texture_aniso", "hits"))
    with rec:
        rec.capture = True
        image, stats = rend(scene)
        torch.cuda.synchronize()
        rec.capture = False
    launches = {k: n for k, n in read_counts().items()
                if k in (*fwd_counts, *SHADE_KERNELS, *SPAWN_KERNELS)}
    counters = {k: int(v) for k, v in stats._asdict().items()}
    img_mean = float(image.mean())
    finite = bool(torch.isfinite(image).all())

    # timed frames: one warm-up, then the median of 3
    torch.cuda.reset_peak_memory_stats()
    rend(scene)
    torch.cuda.synchronize()
    frame_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        rend(scene)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    peak_mem = torch.cuda.max_memory_allocated()
    with Recorder(targets) as timer:
        timer.timing = True
        rend(scene)
        frame_kernel_ms = timer.kernel_ms()
    profile = profile_frame(lambda: rend(scene))
    frame_ms = statistics.median(frame_s) * 1e3
    rays = rays_of(counters)
    emit("frame", config="config3_sponza", width=WIDTH, height=HEIGHT,
         frame_ms=frame_ms, frame_ms_all=[s * 1e3 for s in frame_s],
         fwd_mrays_per_s=rays / (frame_ms / 1e3) / 1e6, counters=counters,
         image_shape=list(image.shape), image_mean=img_mean, image_finite=finite,
         launches=launches, kernel_ms_in_frame=frame_kernel_ms, profile=profile,
         max_memory_allocated_bytes=peak_mem, nvidia_smi=smi)
    problems = [f"{k} launched {n} times in the main path" for k, n in launches.items()
                if n <= 0]
    problems += [f"{k} launched {launches[k]} times in a frame of {cfg.num_bounces} bounces"
                 for k in SPAWN_KERNELS if launches[k] != cfg.num_bounces]
    if counters["num_dropped"] or counters["num_incomplete"]:
        problems.append(f"loss counters not 0: {counters}")
    if not finite or tuple(image.shape) != (HEIGHT, WIDTH, 3):
        problems.append("image not finite or of the wrong shape")
    if problems:
        return fail("; ".join(problems))

    # ------------------------------------------------------- 4. the training path
    params = train.extract_params(scene)
    target = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device="cuda")

    def fwd_bwd(params, scfg, split=None):
        """One fwd+bwd step over the whole frame (one autograd graph); with
        ``split``, synchronise after the forward and append (fwd s, bwd s)."""
        for p in params.values():
            p.grad = None
        t0 = time.perf_counter()
        img, st = renderer.render_with_stats(train.apply_params(scene, params), scfg)
        loss = train.image_loss(img, target)
        if split is not None:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        loss.backward()
        if split is not None:
            torch.cuda.synchronize()
            split.append((t1 - t0, time.perf_counter() - t1))
        return loss.detach(), st

    # one step with the counts at 0: the training path's run (and the warm-up);
    # K4's and K5 bwd's inputs of every generation are kept for their rows
    reset_counts()
    with Recorder(bwd_targets[1:], every_call=("sky_bwd", "texture_aniso_bwd")) as step_rec:
        step_rec.capture = True
        loss, tstats = fwd_bwd(params, cfg)
        torch.cuda.synchronize()
    train_launches = read_counts()
    tcounters = {k: int(v) for k, v in tstats._asdict().items()}
    grad_norms = {k: None if p.grad is None else float(p.grad.norm())
                  for k, p in params.items()}
    train_loss = float(loss)

    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(3):
        fwd_bwd(params, cfg, splits)
    train_peak_mem = torch.cuda.max_memory_allocated()
    step_ms = statistics.median((a + b) * 1e3 for a, b in splits)
    with Recorder(targets + bwd_targets) as timer:
        timer.timing = True
        fwd_bwd(params, cfg)
        step_kernel_ms = timer.kernel_ms()
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    adam_ms = cuda_ms(opt.step, 3)  # on the last step's gradients
    train_profile = profile_frame(lambda: fwd_bwd(params, cfg))
    del opt, params

    init, step = train.make_train_step(cfg, fields=TRAIN_FIELDS)
    tparams, topt = init(scene)
    train_losses = []
    for _ in range(3):
        tparams, topt, tl = step(tparams, topt, scene, target)
        train_losses.append(float(tl))
    del tparams, topt
    trays = rays_of(tcounters)
    emit("train", config="config3_sponza", width=WIDTH, height=HEIGHT,
         loss="image_loss(render_with_stats(...), zeros), all 17 fields, one graph",
         step_ms=step_ms, step_ms_all=[(a + b) * 1e3 for a, b in splits],
         fwd_ms=statistics.median(a * 1e3 for a, _ in splits),
         bwd_ms=statistics.median(b * 1e3 for _, b in splits), adam_ms=adam_ms,
         fwd_bwd_mrays_per_s=trays / (step_ms / 1e3) / 1e6, counters=tcounters,
         loss_value=train_loss, grad_norms=grad_norms, launches=train_launches,
         kernel_ms_in_step=step_kernel_ms, profile=train_profile,
         max_memory_allocated_bytes=train_peak_mem,
         make_train_step_fields=list(TRAIN_FIELDS), make_train_step_losses=train_losses,
         nvidia_smi=smi)
    problems = [f"{k} launched {train_launches[k]} times in the training step"
                for k in train_kernels if train_launches[k] <= 0]
    if tcounters["num_dropped"] or tcounters["num_incomplete"]:
        problems.append(f"loss counters not 0 in the training step: {tcounters}")
    norms = [v for v in grad_norms.values() if v is not None]
    if not all(math.isfinite(v) for v in norms) or not any(v > 0 for v in norms):
        problems.append(f"gradients not finite or all zero: {grad_norms}")
    if not math.isfinite(train_loss) or not train_losses[-1] < train_losses[0]:
        problems.append(f"make_train_step's loss did not fall: {train_losses}")
    if problems:
        return fail("; ".join(problems))

    # ------------------------------------------------------ 4b. every texture filter
    # config3 at 1080p under each of the other modes: one frame with the counts
    # at 0 (K3's inputs of every generation kept for the kernel rows), timed
    # frames, then one fwd+bwd step with the counts at 0 and 3 timed steps
    mode_changes = {"trilinear": dict(mipmap_filter=MipmapFilter.TRILINEAR),
                    "ewa": dict(mipmap_filter=MipmapFilter.EWA),
                    "bilinear": dict(texture_sample_mode=TextureSampleMode.BILINEAR),
                    "nearest": dict(texture_sample_mode=TextureSampleMode.NEAREST)}
    filter_calls, filter_launches = {}, {}
    for mode in FILTER_MODES:
        k3_name, k4_name = f"texture_{mode}", f"texture_{mode}_bwd"
        mcfg = cfg.replace(**mode_changes[mode])
        mrend = renderer.Renderer(mcfg, device="cuda")
        reset_counts()
        with Recorder([(texture_sample, "sample", k3_name)], every_call=(k3_name,)) as mrec:
            mrec.capture = True
            mimg, mstats = mrend(scene)
            torch.cuda.synchronize()
        mlaunches = read_counts()
        filter_calls[mode] = mrec.calls[k3_name]
        mcounters = {k: int(v) for k, v in mstats._asdict().items()}
        mfinite = bool(torch.isfinite(mimg).all())
        mrend(scene)
        torch.cuda.synchronize()
        mframe_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            mrend(scene)
            torch.cuda.synchronize()
            mframe_s.append(time.perf_counter() - t0)

        mparams = train.extract_params(scene)
        reset_counts()
        _, mtstats = fwd_bwd(mparams, mcfg)
        torch.cuda.synchronize()
        mstep_launches = read_counts()
        mnorms = {k: None if p.grad is None else float(p.grad.norm())
                  for k, p in mparams.items()}
        torch.cuda.reset_peak_memory_stats()
        msplits = []
        for _ in range(3):
            fwd_bwd(mparams, mcfg, msplits)
        mpeak = torch.cuda.max_memory_allocated()
        with Recorder([(texture_sample, "sample", k3_name),
                       (texture_sample, "sample_backward", k4_name)]) as timer:
            timer.timing = True
            fwd_bwd(mparams, mcfg)
            mkernel_ms = timer.kernel_ms()
        mprofile = profile_frame(lambda: fwd_bwd(mparams, mcfg))
        del mparams
        mframe_ms = statistics.median(mframe_s) * 1e3
        mstep_ms = statistics.median((a + b) * 1e3 for a, b in msplits)
        mtcounters = {k: int(v) for k, v in mtstats._asdict().items()}
        filter_launches[k3_name] = mlaunches[k3_name]
        filter_launches[k4_name] = mstep_launches[k4_name]
        emit("filters", config="config3_sponza", width=WIDTH, height=HEIGHT, mode=mode,
             change={k: v.name for k, v in mode_changes[mode].items()},
             frame_ms=mframe_ms, frame_ms_all=[x * 1e3 for x in mframe_s],
             fwd_mrays_per_s=rays_of(mcounters) / (mframe_ms / 1e3) / 1e6,
             counters=mcounters, image_mean=float(mimg.mean()), image_finite=mfinite,
             launches={k: n for k, n in mlaunches.items() if n},
             step_ms=mstep_ms, step_ms_all=[(a + b) * 1e3 for a, b in msplits],
             fwd_ms=statistics.median(a * 1e3 for a, _ in msplits),
             bwd_ms=statistics.median(b * 1e3 for _, b in msplits),
             fwd_bwd_mrays_per_s=rays_of(mtcounters) / (mstep_ms / 1e3) / 1e6,
             step_counters=mtcounters, step_launches={k: n for k, n in
                                                      mstep_launches.items() if n},
             texture_ms_in_step=mkernel_ms, step_profile=mprofile, grad_norms=mnorms,
             max_memory_allocated_bytes=mpeak, nvidia_smi=smi)
        problems = []
        if mlaunches[k3_name] <= 0 or mstep_launches[k4_name] <= 0:
            problems.append(f"K3 launched {mlaunches[k3_name]}, K4 "
                            f"{mstep_launches[k4_name]} times")
        for c in (mcounters, mtcounters):
            if c["num_dropped"] or c["num_incomplete"]:
                problems.append(f"loss counters not 0: {c}")
        if not mfinite or tuple(mimg.shape) != (HEIGHT, WIDTH, 3):
            problems.append("image not finite or of the wrong shape")
        if not all(v is None or math.isfinite(v) for v in mnorms.values()):
            problems.append(f"gradients not finite: {mnorms}")
        if not mnorms["tex_data"]:
            problems.append("no gradient reached tex_data")
        cams = [mnorms[k] for k in ("cam_pos", "cam_top_left", "cam_x", "cam_y")]
        if mode == "trilinear" and not all(v is not None and v > 0 for v in cams):
            problems.append(f"camera gradients zero under TRILINEAR: {cams}")
        if problems:
            return fail(f"filters, {mode}: " + "; ".join(problems))
        del mrend, mimg

    # ------------------------------------------------ 5. the interactive frame loop
    app_out = os.path.join(REPO, "build", "chip_smoke_app")
    shutil.rmtree(app_out, ignore_errors=True)
    reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        app.main(["--scene", "config4", "--frames", str(APP_FRAMES), "--fxaa",
                  "--out", app_out])
    app_s = time.perf_counter() - t0
    app_launches = read_counts()
    frames = [json.loads(x) for x in printed.getvalue().splitlines() if x.startswith("{")]
    frame_ms_app = [f["ms"] for f in frames]
    pngs = sorted(os.listdir(app_out))
    png_shapes = {tuple(image_util.load_png(os.path.join(app_out, f)).shape) for f in pngs}
    shutil.rmtree(app_out)
    emit("app", command="raytracer_tpu_torch.app.main --scene config4 --frames "
         f"{APP_FRAMES} --fxaa", frames=len(frames), seconds=app_s,
         frame_ms_median=statistics.median(frame_ms_app),
         frame_ms_p90=statistics.quantiles(frame_ms_app, n=10, method="inclusive")[-1],
         frame_ms_all=frame_ms_app,
         total_mrays_s_median=statistics.median(f["total_mrays_s"] for f in frames),
         dropped_rays=[f["dropped_rays"] for f in frames], launches=app_launches,
         launches_per_frame={k: n / APP_FRAMES for k, n in app_launches.items()},
         pngs=len(pngs), png_shapes=[list(x) for x in png_shapes], nvidia_smi=smi)
    problems = [f"{k} launched {app_launches[k]} times in the app run"
                for k in app_kernels if app_launches[k] <= 0]
    if app_launches["fxaa"] != APP_FRAMES:
        problems.append(f"FXAA launched {app_launches['fxaa']} times in {APP_FRAMES} frames")
    if len(frames) != APP_FRAMES or any(f["dropped_rays"] for f in frames):
        problems.append("the app printed the wrong frames or dropped rays")
    if len(pngs) != APP_FRAMES + 1 or png_shapes != {(600, 900, 3)}:
        problems.append(f"the app wrote {len(pngs)} PNGs of shapes {png_shapes}")
    if problems:
        return fail("; ".join(problems))

    # the pieces of one config4 frame, apart: one warm-up frame, then the median
    # of 5 (the app's frame clock holds them all, the previous frame's PNG write
    # included)
    desc4, cfg4 = scenes.make_scene("config4")
    cfg4 = cfg4.replace(enable_fxaa=True)
    packer4 = ScenePacker(desc4, cfg4.width, cfg4.height)
    rend4 = renderer.Renderer(cfg4, device="cuda")
    png_path = os.path.join(REPO, "build", "chip_smoke_piece.png")
    piece_s = {k: [] for k in ("animate_and_pack", "upload", "render", "present",
                               "save_png")}
    for i in range(6):
        t0 = time.perf_counter()
        desc4.update(1.0 / 60.0)
        packed4 = packer4.frame()
        t1 = time.perf_counter()
        scene4 = rend4.upload(packed4)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        img4, stats4 = rend4(scene4)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        with torch.no_grad():
            renderer.present(img4, cfg4)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        image_util.save_png(png_path, img4.cpu().numpy())
        t5 = time.perf_counter()
        if i:
            for k, a, b in (("animate_and_pack", t0, t1), ("upload", t1, t2),
                            ("render", t2, t3), ("present", t3, t4), ("save_png", t4, t5)):
                piece_s[k].append(b - a)
    os.remove(png_path)
    pieces_ms = {k: statistics.median(v) * 1e3 for k, v in piece_s.items()}
    # the PNG write split: the copy to the host, the gamma in numpy, zlib + chunks
    t0 = time.perf_counter()
    host4 = img4.cpu().numpy()
    t1 = time.perf_counter()
    u8 = image_util.to_srgb_u8(host4)
    t2 = time.perf_counter()
    image_util.encode_png(u8)
    png_split_ms = {"to_host": (t1 - t0) * 1e3, "gamma_u8": (t2 - t1) * 1e3,
                    "encode": (time.perf_counter() - t2) * 1e3}
    counters4 = {k: int(v) for k, v in stats4._asdict().items()}
    tlas_q = []  # the frame's quantised TLAS records, inside animate_and_pack
    for _ in range(5):
        t0 = time.perf_counter()
        wide_mod.quantised_records(packed4.wt_rec)
        tlas_q.append(time.perf_counter() - t0)
    emit("frame_pieces", config="config4", width=cfg4.width, height=cfg4.height,
         ms_median_of_5=pieces_ms, sum_ms=sum(pieces_ms.values()),
         quantise_tlas_ms=statistics.median(tlas_q) * 1e3,
         tlas_nodes=int(packed4.wt_rec.shape[1]),
         save_png_split_ms=png_split_ms, render_profile=profile_frame(lambda: rend4(scene4)),
         host_share=(pieces_ms["animate_and_pack"] + pieces_ms["upload"]
                     + pieces_ms["save_png"]) / sum(pieces_ms.values()),
         scene_bytes=sum(int(np.asarray(v).nbytes) for v in packed4), counters=counters4,
         triangles=int(packed4.tr_p0.shape[0]), instances=int(packed4.inst_inv.shape[0]),
         spheres=int(packed4.sph_radius.shape[0]), planes=int(packed4.pln_distance.shape[0]),
         nvidia_smi=smi)
    if counters4["num_dropped"] or counters4["num_incomplete"]:
        return fail(f"config4 loss counters not 0: {counters4}")

    # the kernels' inputs of one more frame, for the kernel rows: the first call
    # of each forward kernel and of K8, every call of K9 (each generation's
    # closest hit and shadow rays)
    k9_targets = [(intersect, "pick_closest", "prim_closest"),
                  (intersect, "pick_any", "prim_any")]
    k9_every = ("prim_closest", "prim_any")
    rec4 = Recorder(targets + k9_targets + [(fxaa, "fxaa", "fxaa")],
                    every_call=k9_every + ("hits",))
    with rec4:
        rec4.capture = True
        img4, _ = rend4(scene4)
        with torch.no_grad():
            renderer.present(img4, cfg4)
        torch.cuda.synchronize()

    # config4's frame under the threaded walk: K10's inputs of every generation,
    # which its rows check beside config3's
    reset_counts()
    with Recorder([(traversal, "trace_closest", "threaded_closest"),
                   (traversal, "trace_any", "threaded_any")],
                  every_call=("threaded_closest", "threaded_any")) as th4_rec:
        th4_rec.capture = True
        _, th4_stats = renderer.Renderer(cfg4.replace(traversal_kernel="threaded"),
                                         device="cuda")(scene4)
        torch.cuda.synchronize()
    threaded4_calls = th4_rec.calls
    th4_counters = {k: int(v) for k, v in th4_stats._asdict().items()}
    if th4_counters["num_dropped"] or th4_counters["num_incomplete"]:
        return fail(f"config4 threaded loss counters not 0: {th4_counters}")

    # ------------------------------------------------------ 6. configs 0 and 2
    k9_calls = {"config4": rec4.calls}  # K9's inputs, every call of one frame
    for name in ("config0", "config2"):
        sdesc, scfg = scenes.make_scene(name)
        r = renderer.Renderer(scfg, device="cuda")
        sc = r.upload(ScenePacker(sdesc, scfg.width, scfg.height).frame())
        reset_counts()
        with Recorder(k9_targets, every_call=k9_every) as srec:
            srec.capture = True
            simg, sstats = r(sc)
            torch.cuda.synchronize()
        slaunches = read_counts()
        k9_calls[name] = srec.calls
        scount = {k: int(v) for k, v in sstats._asdict().items()}
        r(sc)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r(sc)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sms = statistics.median(times) * 1e3
        srays = rays_of(scount)
        sfinite = bool(torch.isfinite(simg).all())
        emit("scenes", config=name, width=scfg.width, height=scfg.height,
             bounces=scfg.num_bounces, frame_ms=sms, frame_ms_all=[t * 1e3 for t in times],
             fwd_mrays_per_s=srays / (sms / 1e3) / 1e6, counters=scount,
             launches={k: n for k, n in slaunches.items() if n}, image_mean=float(simg.mean()),
             image_finite=sfinite, nvidia_smi=smi)
        if (scount["num_dropped"] or scount["num_incomplete"] or not sfinite
                or slaunches["prim_closest"] <= 0 or slaunches["prim_any"] <= 0):
            return fail(f"{name}: counters {scount}, finite {sfinite}, launches {slaunches}")
        del r, sc, simg

    # ------------------------------------------------------ 6b. the threaded walk
    # config3 at 1080p under traversal_kernel="threaded": one frame with the
    # counts at 0 (K10's inputs of every generation kept for its rows), timed
    # frames, then one fwd+bwd step with the counts at 0 and 3 timed steps
    th_cfg = cfg.replace(traversal_kernel="threaded")
    th_rend = renderer.Renderer(th_cfg, device="cuda")
    reset_counts()
    with Recorder([(traversal, "trace_closest", "threaded_closest"),
                   (traversal, "trace_any", "threaded_any")],
                  every_call=("threaded_closest", "threaded_any")) as th_rec:
        th_rec.capture = True
        th_img, th_stats = th_rend(scene)
        torch.cuda.synchronize()
    threaded_launches = read_counts()
    threaded_calls = th_rec.calls
    th_counters = {k: int(v) for k, v in th_stats._asdict().items()}
    th_finite = bool(torch.isfinite(th_img).all())
    th_diff = (th_img - image).abs().amax(dim=-1)
    share_off = float((th_diff > 1e-3).float().mean())
    th_rend(scene)
    torch.cuda.synchronize()
    th_frame_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        th_rend(scene)
        torch.cuda.synchronize()
        th_frame_s.append(time.perf_counter() - t0)
    th_profile = profile_frame(lambda: th_rend(scene))

    # the records' packing, every frame in build_scene_bvh (one host read of
    # the packer's checks), beside the rest of the frame
    th_pack_ms = cuda_ms(lambda: traversal.build_scene_bvh(scene), 5)
    th_pack_device_ms = profile_frame(lambda: traversal.build_scene_bvh(scene))["device_busy_ms"]
    th_params = train.extract_params(scene)
    reset_counts()
    _, th_sstats = fwd_bwd(th_params, th_cfg)
    torch.cuda.synchronize()
    th_step_launches = read_counts()
    th_norms = {k: None if p.grad is None else float(p.grad.norm()) for k, p in th_params.items()}
    th_splits = []
    for _ in range(3):
        fwd_bwd(th_params, th_cfg, th_splits)
    th_step_profile = profile_frame(lambda: fwd_bwd(th_params, th_cfg))
    del th_params
    th_frame_ms = statistics.median(th_frame_s) * 1e3
    th_step_ms = statistics.median((a + b) * 1e3 for a, b in th_splits)
    th_scounters = {k: int(v) for k, v in th_sstats._asdict().items()}
    emit("threaded", config="config3_sponza", width=WIDTH, height=HEIGHT,
         change={"traversal_kernel": "threaded"}, frame_ms=th_frame_ms,
         frame_ms_all=[x * 1e3 for x in th_frame_s],
         fwd_mrays_per_s=rays_of(th_counters) / (th_frame_ms / 1e3) / 1e6, counters=th_counters,
         image_mean=float(th_img.mean()), image_finite=th_finite,
         pixels_off_wide_share=share_off, pixels_off_wide_bound=THREADED_PIXEL_SHARE,
         max_abs_off_wide=float(th_diff.max()),
         launches={k: n for k, n in threaded_launches.items() if n}, profile=th_profile,
         frame_device_ms=th_profile["device_busy_ms"],
         step_device_ms=th_step_profile["device_busy_ms"],
         k10_device_ms_in_frame={k["name"]: k["ms"]
                                 for k in th_profile.get("top_device_kernels", [])
                                 if "rec_kernel" in k["name"]},
         pack_ms=th_pack_ms, pack_device_ms=th_pack_device_ms, step_ms=th_step_ms,
         step_ms_all=[(a + b) * 1e3 for a, b in th_splits],
         fwd_ms=statistics.median(a * 1e3 for a, _ in th_splits),
         bwd_ms=statistics.median(b * 1e3 for _, b in th_splits),
         fwd_bwd_mrays_per_s=rays_of(th_scounters) / (th_step_ms / 1e3) / 1e6,
         step_counters=th_scounters, step_launches={k: n for k, n in th_step_launches.items() if n},
         step_profile=th_step_profile, grad_norms=th_norms, nvidia_smi=smi)
    problems = [f"{k} launched {threaded_launches[k]} times in the threaded frame"
                for k in threaded_kernels if threaded_launches[k] <= 0]
    problems += [f"{k} launched {threaded_launches[k]} times under the threaded walk"
                 for k in ("traverse_closest", "traverse_any") if threaded_launches[k]]
    if th_step_launches["threaded_closest"] <= 0 or th_step_launches["hits_bwd"] <= 0:
        problems.append(f"the threaded step launched {th_step_launches}")
    for c in (th_counters, th_scounters):
        if c["num_dropped"] or c["num_incomplete"]:
            problems.append(f"loss counters not 0 under the threaded walk: {c}")
    if not th_finite or tuple(th_img.shape) != (HEIGHT, WIDTH, 3):
        problems.append("threaded image not finite or of the wrong shape")
    if share_off > THREADED_PIXEL_SHARE:
        problems.append(f"{share_off} of pixels off the wide frame by > 1e-3")
    if not all(v is None or math.isfinite(v) for v in th_norms.values()):
        problems.append(f"threaded gradients not finite: {th_norms}")
    if problems:
        return fail("threaded: " + "; ".join(problems))
    del th_rend, th_img, th_diff

    # --------------------------------------------------------- 7. kernel vs plain
    inputs = rec.inputs
    hits_calls = {"config3": rec.calls["hits"], "config4": rec4.calls["hits"]}
    report = []
    ok = True
    launches.update({k: train_launches[k] for k in ("hits_bwd", "texture_aniso_bwd",
                                                     "sky_bwd")})
    launches.update({k: threaded_launches[k] for k in ("threaded_closest", "threaded_any")})
    launches.update({k: app_launches[k] for k in ("fxaa", "prim_closest", "prim_any")})
    launches.update(filter_launches)
    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = torch.device("cuda")

    def l2rel(a, b) -> float:
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def record(name, source, replaces, max_err, ms, plain_ms, bnd, library_ms, passed,
               **extra):
        nonlocal ok
        emit("kernel", name=name, passed=passed, max_abs_err=max_err, ms=ms,
             plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
             library_ms=library_ms, **extra)
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms})
        ok = ok and passed

    # The forward kernels' checks against their plain versions on one frame's
    # generation-0 inputs: each returns a dict with max_abs_err and passed.
    def check_sky(sky_data, direction):
        diff = (sky_sample.sample_sky(sky_data, direction)
                - sky_sample.sample_sky_plain(sky_data, direction)).abs().amax(dim=1)
        frac = float((diff > 0).float().mean())
        return diff, {"max_abs_err": float(diff.max()), "passed": frac <= 1e-3,
                      "lanes": direction.shape[0], "lanes_other_texel": frac}

    def check_texture(tex, lanes, tcfg, data4):
        """K3 against sample_plain."""
        got = texture_sample.sample(tex, *lanes, tcfg, data4=data4)
        err = (got - texture_sample.sample_plain(tex, *lanes, tcfg, data4)).abs().amax(dim=1)
        frac = float((err <= 1e-5).float().mean())
        return {"max_abs_err": float(err.max()), "passed": frac >= 0.999,
                "lanes": err.shape[0], "lanes_within_tolerance": frac}

    def check_compact(flags):
        k_idx, k_n = compaction.compact(flags)
        p_idx, p_n = compaction.compact_plain(flags)
        exact = k_n == p_n and bool(torch.equal(k_idx, p_idx))
        return {"max_abs_err": 0.0 if exact else float("inf"), "passed": exact,
                "lanes": flags.shape[0], "active": int(p_n)}

    def ordered(kcfg) -> bool:
        return kcfg.traversal_strategy == TraversalStrategy.ORDERED

    def check_traverse(any_hit, bvh, o, d, t_max, active, kcfg):
        """K1 / K2 (through trace_closest / trace_any) against the plain walk; the
        kernel's counters against the plain walk's (which also holds the
        quantised test to the exact one at every node visit).  Also returns the
        walk (its visits count the work)."""
        walk = traversal_wide.trace_plain(bvh, o, d, t_max, active, kcfg.wide_stack_size,
                                          ordered(kcfg), any_hit, quantised=True)
        if any_hit:
            kfound, kinc = traversal_wide.trace_any(bvh, o, d, t_max, active, kcfg)
            same = bool(torch.equal(kfound, walk.found))
            got = {"max_abs_err": 0.0 if same else float("inf"),
                   "found_differs": int((kfound != walk.found).sum())}
        else:
            res = traversal_wide.trace_closest(bvh, o, d, t_max, active, kcfg)
            kt, kinc, ksteps = res.t, res.incomplete, res.steps
            kbest = torch.where(res.tri >= 0, (res.tri << 8) | (res.inst + 1), -1)
            same = bool(torch.equal(kbest, walk.best) and torch.equal(ksteps, walk.steps))
            fin = torch.isfinite(walk.t)
            gap = (kt - walk.t)[fin].abs()
            rel = float((gap / walk.t[fin].abs()).max()) if bool(fin.any()) else 0.0
            same = same and rel <= 1e-6
            got = {"max_abs_err": float(gap.max()) if bool(fin.any()) else 0.0,
                   "ids_differ": int((kbest != walk.best).sum()),
                   "steps_differ": int((ksteps != walk.steps).sum()), "t_max_rel": rel}
        stats = traversal_wide.walk_stats(any_hit, bvh, o, d, t_max, active, kcfg)
        stats_equal = stats == {k: walk.quant[k] for k in traversal_wide.STATS}
        got.update(passed=same and int(kinc) == 0 and stats_equal
                   and walk.quant["bits_differ"] == 0 and int(walk.incomplete) == 0,
                   incomplete=int(kinc), lanes=o.shape[0], active=int(active.sum()),
                   stats=stats, stats_equal_plain=stats_equal,
                   bits_differ=walk.quant["bits_differ"])
        return got, walk

    def check_forward(inp):
        (tex, *lanes, tcfg), kw = inp["texture_aniso"]
        return {"sky": check_sky(*inp["sky"][0])[1],
                "texture_aniso": check_texture(tex, tuple(lanes), tcfg, kw["data4"]),
                "compact": check_compact(*inp["compact"][0]),
                "traverse_closest": check_traverse(False, *inp["traverse_closest"][0])[0],
                "traverse_any": check_traverse(True, *inp["traverse_any"][0])[0]}

    def inside_sphere(prims, o) -> int:
        """Lanes whose origin lies inside a sphere (where the sphere's t is t1)."""
        if not prims.sph_center.shape[0] or not o.shape[0]:
            return 0
        d2 = ((o[:, None, :] - prims.sph_center[None]) ** 2).sum(dim=-1)
        return int((d2 < prims.sph_radius[None] ** 2).any(dim=1).sum())

    def check_k9(calls) -> dict:
        """K9 closest and any hit against their plain versions on every call of
        one frame (one of each per generation): per kernel, per call, the lanes,
        those starting inside a sphere, and those whose result differs."""
        closest, anyhit = [], []
        for (prims, o, d), _ in calls.get("prim_closest", []):
            kw9, kt = intersect.pick_closest(prims, o, d)
            pw, pt = intersect.pick_closest_plain(prims, o, d)
            fin = torch.isfinite(pt) & torch.isfinite(kt)
            closest.append({
                "lanes": o.shape[0], "inside_sphere": inside_sphere(prims, o),
                "winners_differ": int((kw9 != pw).sum()), "t_differ": int((kt != pt).sum()),
                "max_abs_err": float((kt - pt)[fin].abs().max()) if bool(fin.any()) else 0.0})
        for (prims, o, d, tmax, act), _ in calls.get("prim_any", []):
            kb = intersect.pick_any(prims, o, d, tmax, act)
            pb = intersect.pick_any_plain(prims, o, d, tmax, act)
            anyhit.append({
                "lanes": o.shape[0], "active": int(act.sum()),
                "inside_sphere": inside_sphere(prims, o[act]), "blocked": int(pb.sum()),
                "blocked_differ": int((kb != pb).sum()),
                "max_abs_err": 0.0 if bool(torch.equal(kb, pb)) else float("inf")})
        out = {}
        for name, per_call, differ in (("prim_closest", closest, ("winners_differ", "t_differ")),
                                       ("prim_any", anyhit, ("blocked_differ",))):
            g = max(range(len(per_call)), key=lambda i: per_call[i]["inside_sphere"])
            out[name] = {"calls": len(per_call),
                         "passed": all(c[k] == 0 for c in per_call for k in differ),
                         "max_abs_err": max(c["max_abs_err"] for c in per_call),
                         "lanes": sum(c["lanes"] for c in per_call),
                         **{k: sum(c[k] for c in per_call) for k in differ},
                         "most_inside_sphere_generation": g,
                         "most_inside_sphere_lanes": per_call[g]["inside_sphere"],
                         "per_generation": per_call}
        return out

    # config4 (the app's frame): the forward kernels on generation 0, K9 on
    # every generation; configs 0 and 2: K9 on every generation.  Folded into
    # the rows below.
    on4 = check_forward(rec4.inputs)
    k9 = {label: check_k9(calls) for label, calls in k9_calls.items()}
    del k9_calls

    # K5 sky, on generation 0's directions (every primary ray)
    (sky_data, direction), _ = inputs["sky"]
    diff, sky_check = check_sky(sky_data, direction)
    n = direction.shape[0]
    record("sky", "raytracer_tpu_torch/csrc/sky.cu", "raytracer_tpu/ops/sky_sample.py:16",
           max(sky_check.pop("max_abs_err"), on4["sky"]["max_abs_err"]),
           cuda_ms(lambda: sky_sample.sample_sky(sky_data, direction), 20),
           cuda_ms(lambda: sky_sample.sample_sky_plain(sky_data, direction), 5),
           bound_ms(nbytes(direction, sky_data) + n * 12, n * OPS_SKY), None,
           sky_check.pop("passed") and on4["sky"]["passed"], **sky_check,
           device_ms=microbench.device_ms(lambda: sky_sample.sample_sky(sky_data, direction),
                                          dev),
           config4_900x600=on4["sky"],
           tolerance="texel values equal; <= 1e-3 of lanes may take a neighbouring "
                     "texel; on config3 and on config4")

    # K5 backward, on the same directions with a seeded cotangent.  A lane that
    # took a neighbouring texel in the forward scatters there, so the lanes
    # where the forward differs are left out of both.
    rows = sky_data.shape[0]
    cot = torch.randn((n, 3), generator=gen, device="cuda") * (diff == 0)[:, None]
    _, index = sky_sample.sample_forward(sky_data, direction, True)
    k_grad = sky_sample.sample_backward(index, cot, rows)
    again = sky_sample.sample_backward(index, cot, rows)
    spread, spread_rel = float((again - k_grad).abs().max()), l2rel(again, k_grad)
    leaf = sky_data.detach().clone().requires_grad_()
    p_graph = sky_sample.sample_sky_plain(leaf, direction)

    def p5b():
        return torch.autograd.grad(p_graph, leaf, cot, retain_graph=True)[0]

    p_grad = p5b()
    rel = l2rel(k_grad, p_grad)
    # the step's own generation-0 inputs (the backward call with one lane a
    # pixel), and the made-up patterns of microbench/scatter.py
    (index_c, cot_c, rows_c), _ = [c for c in step_rec.calls["sky_bwd"]
                                   if c[0][0].shape[0] == WIDTH * HEIGHT][-1]
    step_inputs = scatter.sky_bwd_measure(index_c, cot_c, rows_c, dev, 20)
    patterns = {}
    for pattern in scatter.SKY_PATTERNS:
        pidx, pcot = (torch.from_numpy(a).to(dev) for a in scatter.sky_inputs(pattern))
        patterns[pattern] = scatter.sky_bwd_measure(pidx, pcot, scatter.ROWS, dev, 20)
    del pidx, pcot
    checks = [step_inputs, *patterns.values()]
    record("sky_bwd", "raytracer_tpu_torch/csrc/sky.cu", "raytracer_tpu/ops/sky_sample.py:16",
           float((k_grad - p_grad).abs().max()),
           cuda_ms(lambda: sky_sample.sample_backward(index, cot, rows), 20), cuda_ms(p5b, 20),
           bound_ms(nbytes(index, cot) + rows * 12, n * OPS_SCATTER3),
           cuda_ms(lambda: torch.zeros_like(sky_data).index_add_(0, index, cot,
                                                                 alpha=1.0 / math.pi), 20),
           rel <= 1e-5 and all(c["l2_rel"] <= 1e-5 for c in checks),
           device_ms=microbench.device_ms(
               lambda: sky_sample.sample_backward(index, cot, rows), dev),
           library_device_ms=microbench.device_ms(
               lambda: torch.zeros_like(sky_data).index_add_(0, index, cot,
                                                             alpha=1.0 / math.pi), dev),
           lanes=n, lanes_left_out=int((diff != 0).sum()), l2_rel=rel,
           run_to_run_max_abs=spread, run_to_run_l2_rel=spread_rel,
           step_generation0=step_inputs, patterns=patterns,
           kernel_ms_in_step=step_kernel_ms["sky_bwd"],
           launches_in_step=train_launches["sky_bwd"],
           library="torch.zeros_like(sky).index_add_(0, index, cot, alpha=1/pi), one call "
                   "on the kernel's int32 index",
           tolerance="sky_data gradient within 1e-5 l2-relative, on the seeded cotangent, "
                     "the step's generation 0 and every pattern")
    del p_graph, leaf

    # K3 and K4 in one mode, on the inputs that mode's 1080p frame gave K3
    texture_replaces = {"nearest": 53, "bilinear": 64, "trilinear": 115, "aniso": 290,
                        "ewa": 200}

    def texture_rows(mode, calls, config4=None):
        """K3 on generation 0's lanes against sample_plain; K4 there and on the
        generation with the most top-texel lanes against autograd of
        sample_plain with a seeded cotangent.  Records both rows."""
        (tex, *lanes_in, kcfg), kw = calls[0]
        lanes_in = tuple(lanes_in)  # tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy
        data4, filt = kw["data4"], texture_sample.filter_of(kcfg)
        n, x_rows = lanes_in[1].shape[0], tex[0].shape[0]
        replaces = f"raytracer_tpu/ops/texture_sample.py:{texture_replaces[mode]}"

        def k3(lanes=lanes_in):
            return texture_sample.sample(tex, *lanes, kcfg, data4=data4)

        def p3(lanes=lanes_in):
            return texture_sample.sample_plain(tex, *lanes, kcfg, data4)

        # the work these lanes need (texture_sample.lane_work) and what the mode
        # reads: NEAREST and BILINEAR no derivative, NEAREST no quad atlas,
        # BILINEAR no base atlas
        work = texture_sample.lane_work(tex, lanes_in, kcfg)
        per_lane = texture_sample.lane_taps(tex, lanes_in, kcfg)
        spread = {"taps": tap_spread(per_lane.taps, per_lane.filtered)}
        if mode == "ewa":
            spread["weighted"] = tap_spread(per_lane.weighted, per_lane.filtered)
        del per_lane
        read_lanes = lanes_in[:3] if mode in ("nearest", "bilinear") else lanes_in
        atlases = {"nearest": (tex[0],), "bilinear": (data4,)}.get(mode, (tex[0], data4))
        lane_f, tap_f, lane_b, tap_b = OPS_MODE[mode]
        fwd_ops = (n * lane_f + work["bilinear"] * OPS_TAP + work["taps"] * tap_f
                   + work["weighted"] * OPS_EWA_TEXEL)
        bwd_ops = (n * lane_b + work["bilinear"] * OPS_TAPBWD + work["taps"] * tap_b
                   + work["weighted"] * OPS_EWABWD_TEXEL + work["top"] * 3)

        fcheck = check_texture(tex, lanes_in, kcfg, data4)
        fmax, fpassed = fcheck.pop("max_abs_err"), fcheck.pop("passed")
        if config4 is not None:
            fmax, fpassed = max(fmax, config4["max_abs_err"]), fpassed and config4["passed"]
            fcheck["config4_900x600"] = config4
        # the kernel launched alone (sample_forward, no autograd.Function)
        def forward(f=filt):
            return texture_sample.sample_forward(tex, lanes_in, f, data4)

        span1 = {}
        if mode == "ewa":
            # the set-up's share: the window cut to one texel
            span1["forward_device_ms_span1"] = microbench.device_ms(
                lambda: forward(filt._replace(ewa_span=1)), dev)
        record(f"texture_{mode}", "raytracer_tpu_torch/csrc/texture.cu", replaces, fmax,
               cuda_ms(k3, 20), cuda_ms(p3, 5),
               bound_ms(nbytes(*read_lanes, *atlases, *tex[1:5]) + n * 12, fwd_ops), None,
               fpassed, **fcheck, device_ms=microbench.device_ms(k3, dev),
               forward_ms=cuda_ms(forward, 20),
               forward_device_ms=microbench.device_ms(forward, dev), **span1,
               kernel=f"vector_kernel<{texture_sample.MODES.index(mode)}>",
               work=work, lane_spread=spread,
               tolerance="max abs <= 1e-5 on >= 99.9% of lanes"
                         + (", on config3 and on config4" if config4 else ""))

        # A lane whose K3 result differs (another mip level at a rounding
        # boundary) sends its gradient to other texels, so those lanes are left
        # out of both.
        def k4_vs_plain(lanes):
            e = (k3(lanes) - p3(lanes)).abs().amax(dim=1)
            cot = torch.randn((e.shape[0], 3), generator=gen, device="cuda") * (e <= 1e-5)[:, None]
            kd, kd4, kl = texture_sample.sample_backward(tex, lanes, filt, data4, cot,
                                                         True, True, True)
            leaves = [tex[0].detach().clone().requires_grad_()]
            if data4 is not None:
                leaves.append(data4.detach().clone().requires_grad_())
            leaves += [x.detach().clone().requires_grad_() for x in lanes[1:]]
            p_graph = texture_sample.sample_plain((leaves[0], *tex[1:]), lanes[0],
                                                  *leaves[-6:], kcfg,
                                                  leaves[1] if data4 is not None else None)

            def p4():
                grads = torch.autograd.grad(p_graph, leaves, cot, retain_graph=True,
                                            allow_unused=True)
                return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]

            pg = p4()
            pd, pl = pg[0], pg[-6:]
            lane_ok = [float((((kl[k] - g).abs() / g.abs().max().clamp_min(1e-30)) <= 1e-5)
                             .float().mean()) for k, g in enumerate(pl)]
            errs = [float((kd - pd).abs().max())] + [float((kl[k] - g).abs().max())
                                                     for k, g in enumerate(pl)]
            got = {"lanes": e.shape[0], "lanes_left_out": int((e > 1e-5).sum()),
                   "top_lanes": texture_sample.lane_work(tex, lanes, kcfg)["top"],
                   "l2_rel_data": l2rel(kd, pd),
                   "lanes_within_tolerance": dict(zip(("s", "t", "ds_dx", "ds_dy", "dt_dx",
                                                       "dt_dy"), lane_ok))}
            passed = min(lane_ok) >= 0.999
            if data4 is not None:
                got["l2_rel_data4"] = l2rel(kd4, pg[1])
                errs.append(float((kd4 - pg[1]).abs().max()))
            # the atlas gradients against the plain version's float32 autograd
            # and against its per-lane values summed in float64: within 1e-5 of
            # both, or, where the float32 autograd is itself further than the
            # kernel from the float64 sums (hot rows that thousands of lanes
            # add into), within 1e-5 of the float64 sums
            wd, wd4 = texture_sample.scatter_sums_plain(
                texture_sample.tap_slots_plain(tex, lanes, kcfg, cot), x_rows)
            for name, k, p, w in (("data", kd, pd, wd), ("data4", kd4, pg[1], wd4)):
                if k is None:
                    continue
                if not bool(w.any()):  # no lane sends a gradient there
                    passed = passed and not bool(k.any())
                    continue
                f64 = float((k.double() - w).norm() / w.norm())
                plain_f64 = float((p.double() - w).norm() / w.norm())
                got[f"l2_rel_{name}_f64"], got[f"plain_l2_rel_{name}_f64"] = f64, plain_f64
                passed = passed and f64 <= 1e-5 and (got[f"l2_rel_{name}"] <= 1e-5
                                                      or f64 <= plain_f64)
            del wd, wd4
            if not bool(pd.any()):
                got["l2_rel_data"] = "not exercised: no lane sends a gradient to data"
            got.update(max_abs_err=max(errs), passed=passed)
            return got, cot, p4

        # the top-texel branch (grad data atomics), on the mode's generation with
        # the most top-texel lanes; where none has one, on generation 0's lanes
        # with each lane's derivatives scaled by 2^u (u seeded, uniform in
        # [0, 16)), which sends a share of them to the top texel
        if mode in ("nearest", "bilinear"):
            top_check = {"passed": True, "max_abs_err": 0.0,
                         "inputs": "none: the mode has no top-texel branch"}
        else:
            tops = [texture_sample.lane_work(tex, tuple(c[0][1:8]), kcfg)["top"]
                    for c in calls]
            g_top = max(range(len(tops)), key=tops.__getitem__)
            if tops[g_top] > 0:
                top_in, top_from = tuple(calls[g_top][0][1:8]), f"generation {g_top}"
            else:
                u = torch.exp2(torch.rand(n, generator=gen, device="cuda") * 16)
                top_in = (*lanes_in[:3], *(x * u for x in lanes_in[3:]))
                top_from = "generation 0, derivatives x 2^u, u seeded uniform in [0, 16)"
            top_check, _, _ = k4_vs_plain(top_in)
            top_check.update(inputs=top_from, top_lanes_per_generation=tops)
            top_check["passed"] = top_check["passed"] and top_check["top_lanes"] > 0
            del top_in

        # K4 on generation 0's lanes: timed, and the row of the kernels line
        check, cot, p4 = k4_vs_plain(lanes_in)

        def k4():
            return texture_sample.sample_backward(tex, lanes_in, filt, data4, cot, True, True,
                                                  True)

        first, again = k4(), k4()
        spread = {k: {"max_abs": float((b - a).abs().max()), "l2_rel": l2rel(b, a)}
                  for k, a, b in (("data", first[0], again[0]), ("data4", first[1], again[1]))
                  if a is not None}
        del first, again
        # the kernel on these lanes, and the runs and atomics it gives; under
        # ANISOTROPIC also on the training step's own generations 0 and 1 and on
        # the made-up patterns
        measured = scatter.k4_measure(tex, lanes_in, kcfg, data4, cot, dev, 20)
        runs = scatter.k4_runs(tex, lanes_in, kcfg, cot)

        def sums_hold(m) -> bool:
            """Within 1e-5 l2-relative of the float64 sums, or no further from
            them than the plain version's float32 sums of the same values (every
            lane on one row: 2 M float32 adds into one row are ~1e-5 off in any
            order)."""
            return all(m.get(f"l2_rel_{k}", 0.0) <= max(1e-5, m.get(f"plain_l2_rel_{k}", 0.0))
                       for k in ("data", "data4"))

        sums_ok = sums_hold(measured)
        step_gens, patterns = {}, {}
        if mode == "aniso":
            # autograd runs the last generation's backward first
            step_calls = step_rec.calls["texture_aniso_bwd"][::-1][:2]
            if step_calls[0][0][4].shape[0] != WIDTH * HEIGHT:
                raise RuntimeError("K4's step calls are not in generation order")
            for g, ((stex, slanes, _f, sdata4, scot, *_), _) in enumerate(step_calls):
                step_gens[f"generation{g}"] = {
                    "runs": scatter.k4_runs(stex, slanes, kcfg, scot),
                    "measured": scatter.k4_measure(stex, slanes, kcfg, sdata4, scot, dev, 20)}
                if g == 0:
                    for pattern, (plan, pcot) in scatter.k4_patterns(slanes, scot, stex,
                                                                      kcfg).items():
                        patterns[pattern] = {
                            "runs": scatter.k4_runs(stex, plan, kcfg, pcot),
                            "measured": scatter.k4_measure(stex, plan, kcfg, sdata4, pcot,
                                                           dev, 5)}
            for entry in (*step_gens.values(), *patterns.values()):
                sums_ok = sums_ok and sums_hold(entry["measured"])
        bwd_in = nbytes(*read_lanes, cot, *tex[1:5]) + (0 if data4 is None else nbytes(data4))
        bwd_out = x_rows * (12 * (mode != "bilinear") + 48 * (data4 is not None)) + n * 24
        record(f"texture_{mode}_bwd", "raytracer_tpu_torch/csrc/texture_bwd.cu", replaces,
               max(check.pop("max_abs_err"), top_check["max_abs_err"]), cuda_ms(k4, 20),
               cuda_ms(p4, 1 if mode == "ewa" else 5), bound_ms(bwd_in + bwd_out, bwd_ops),
               None, check.pop("passed") and top_check["passed"] and sums_ok, work=work,
               device_ms=microbench.device_ms(k4, dev, 20), atomics=runs["atomics"], runs=runs,
               measured=measured,
               **step_gens, patterns=patterns, **check, top_texel_check=top_check,
               run_to_run=spread,
               tolerance="data and data4 gradients within 1e-5 l2-relative of the float64 "
                         "sums of the plain version's per-lane values, and of its float32 "
                         "autograd unless that is further from the float64 sums than the "
                         "kernel (data on the top-texel check where the mode has one, as "
                         "generation 0 may have no top-texel lane); each lane gradient "
                         "within 1e-5 of its max |grad| on >= 99.9% of lanes; on every input, "
                         "within 1e-5 of the float64 sums or no further than the plain "
                         "version's float32 sums")

    tex_calls = rec.calls["texture_aniso"]
    texture_rows("aniso", tex_calls, config4=on4["texture_aniso"])
    # the other modes also on config4's generation-0 lanes (a lane's inputs do
    # not depend on the mode)
    (tex4, *lanes4, tcfg4), kw4 = rec4.inputs["texture_aniso"]
    for mode in FILTER_MODES:
        texture_rows(mode, filter_calls[mode], config4=check_texture(
            tex4, tuple(lanes4), tcfg4.replace(**mode_changes[mode]), kw4["data4"]))
    del tex4, lanes4
    del tex_calls, filter_calls, rec, step_rec

    # K6 compaction, on generation 0's 2N candidate flags
    (flags,), _ = inputs["compact"]
    got = check_compact(flags)
    n = flags.shape[0]
    flag_inputs = scatter.compact_measure(flags, dev, 20)
    rng = np.random.default_rng(1)
    uniform = torch.from_numpy(rng.random(n + 1)).to(dev)
    densities = {}
    for density in scatter.DENSITIES:
        dflags = uniform < density
        densities[f"{density:.3g}"] = scatter.compact_measure(dflags[:-1], dev, 20)
        densities[f"{density:.3g} flags[1:]"] = scatter.compact_measure(dflags[1:], dev, 20)
    del uniform, dflags
    record("compact", "raytracer_tpu_torch/csrc/compact.cu",
           "raytracer_tpu/ops/compaction.py:26",
           max(got.pop("max_abs_err"), on4["compact"]["max_abs_err"]),
           cuda_ms(lambda: compaction.compact(flags), 20),
           cuda_ms(lambda: compaction.compact_plain(flags), 20),
           bound_ms(n + 4 * got["active"] + 4, n), cuda_ms(lambda: torch.nonzero(flags), 20),
           got.pop("passed") and on4["compact"]["passed"] and flag_inputs["exact"]
           and all(d["exact"] for d in densities.values()), **got,
           device_ms=flag_inputs["device_ms"], launch_ms=flag_inputs["launch_ms"],
           densities=densities, kernel_ms_in_step=step_kernel_ms["compact"],
           launches_in_step=train_launches["compact"],
           config4_900x600=on4["compact"], library="torch.nonzero(flags)",
           tolerance="exact, on config3 and on config4, and on every density")

    # K6's framebuffer scatter, on generation 1's contributions (the first
    # scatter: generation 0 adds densely), against index_add_ in float64
    (fb1, pixel1, contrib1), _ = inputs["fb_scatter"]
    n = pixel1.shape[0]
    want = fb1.double().index_add_(0, pixel1, contrib1.double())
    got = framebuffer.accumulate(fb1.clone(), pixel1, contrib1)
    again = framebuffer.accumulate(fb1.clone(), pixel1, contrib1)
    fb_rel = float((got.double() - want).norm() / want.norm().clamp_min(1e-30))
    plain_rel = float((framebuffer.accumulate_plain(fb1.clone(), pixel1, contrib1).double()
                       - want).norm() / want.norm().clamp_min(1e-30))
    fbw = fb1.clone()
    rows_named = int(torch.unique(pixel1).shape[0])
    record("fb_scatter", "raytracer_tpu_torch/csrc/framebuffer.cu",
           "raytracer_tpu/render/renderer.py:439",
           float((got.double() - want).abs().max()),
           cuda_ms(lambda: framebuffer.accumulate(fbw, pixel1, contrib1), 20),
           cuda_ms(lambda: framebuffer.accumulate_plain(fbw, pixel1, contrib1), 20),
           bound_ms(nbytes(pixel1, contrib1) + 2 * 12 * rows_named, n * OPS_SCATTER3),
           cuda_ms(lambda: fbw.index_add_(0, pixel1, contrib1), 20), fb_rel <= 1e-5,
           device_ms=microbench.device_ms(
               lambda: framebuffer.accumulate(fbw, pixel1, contrib1), dev),
           library_device_ms=microbench.device_ms(
               lambda: fbw.index_add_(0, pixel1, contrib1), dev),
           lanes=n, rows=fb1.shape[0], rows_named=rows_named, l2_rel=fb_rel,
           plain_f32_l2_rel=plain_rel,
           run_to_run_l2_rel=float((again - got).norm() / got.norm().clamp_min(1e-30)),
           kernel_ms_in_step=step_kernel_ms["fb_scatter"],
           launches_in_step=train_launches["fb_scatter"],
           library="fb.index_add_(0, pixel, contribution), the plain version itself",
           tolerance="within 1e-5 l2-relative of index_add_ in float64")
    del fb1, fbw, got, again, want

    # the shading kernels (csrc/shade.cu) on config3's generation 0 against
    # the torch glue they replace on the same trace: bits, and the frame's
    # dense add within 1e-6; ms of the two launches, and of the stage with K5
    # and K3 beside the glue's (the plain column: its ~200 torch ops)
    (s_scene, s_hits, s_dir, s_weight, s_sigma, s_active, s_cfg, s_tex4), _ = inputs["shade"]
    n = s_dir.shape[0]
    # only the direction of the rays is read by the glue
    s_gen = renderer._Generation(rays=intersect.Rays(*(s_dir,) * 6), weight=s_weight,
                                 sigma=s_sigma, pixel=None, active=s_active)
    s_bvh = traversal_wide.build_scene_bvh(s_scene)
    s_zero = torch.zeros((), dtype=torch.int32, device=dev)
    s_stats = renderer.RenderStats(s_zero, s_zero, s_zero, s_zero, s_zero, s_zero)
    with torch.no_grad():
        s_sky = sky_sample.sample_sky(s_scene.sky_data, s_dir)
        s_tex = texture_sample.sample(renderer._tex_tuple(s_scene),
                                      shade.tex_ids(s_scene, s_hits), s_hits.u, s_hits.v,
                                      s_hits.ds_dx, s_hits.ds_dy, s_hits.dt_dx, s_hits.dt_dy,
                                      s_cfg, data4=s_tex4)
        surf = shade.surface_launch(s_scene, s_hits, s_weight, s_sigma, s_active, s_sky, s_tex,
                                    s_cfg)
        glue = renderer._surface_glue(s_scene, s_gen, s_hits, s_cfg, s_tex4)
        s_blocked, s_inc = renderer.intersect_scene(s_scene, s_bvh, *surf.shadow, s_cfg)
        s_fb = torch.zeros((n, 3), device=dev)
        fb_k, s_shadow, _ = shade.lights_launch(s_scene.ambient, surf, s_blocked, s_fb.clone(),
                                                s_zero, s_zero, s_zero, s_inc)
        contribution, s_want = renderer._lights_glue(s_scene, glue, s_blocked, s_stats, s_zero,
                                                     s_inc)
        fb_g = s_fb + contribution
        fields = ["w", "refl_c", "trans_c", "ior", "miss", "w_albedo", "shadow_active"]
        pairs = {f: (getattr(surf, f), getattr(glue, f)) for f in fields}
        pairs["contribs"] = (surf.contribs, torch.stack(glue.contribs))
        pairs.update({f"shadow[{k}]": ab for k, ab in enumerate(zip(surf.shadow, glue.shadow))})

        def bits(x):
            return x.view(torch.int32) if x.dtype == torch.float32 else x

        differ = [f for f, (a, b) in pairs.items() if not torch.equal(bits(a), bits(b))]
        s_rel = float(((fb_k - fb_g).abs() / fb_g.abs().clamp_min(1e-30)).max())
        n_lights = surf.contribs.shape[0]

        def two_kernels():
            sf = shade.surface_launch(s_scene, s_hits, s_weight, s_sigma, s_active, s_sky, s_tex,
                                      s_cfg)
            shade.lights_launch(s_scene.ambient, sf, s_blocked, s_fb, s_zero, s_zero, s_zero,
                                s_inc)

        def stage():
            sf = shade.surface(s_scene, s_hits, s_dir, s_weight, s_sigma, s_active, s_cfg, s_tex4)
            shade.lights_launch(s_scene.ambient, sf, s_blocked, s_fb, s_zero, s_zero, s_zero,
                                s_inc)

        def glue_stage():
            gl = renderer._surface_glue(s_scene, s_gen, s_hits, s_cfg, s_tex4)
            renderer._lights_glue(s_scene, gl, s_blocked, s_stats, s_zero, s_inc)

        surface_reads = nbytes(s_hits.hit, s_hits.t, s_hits.material_id, s_hits.point,
                               s_hits.normal, s_active, s_weight, s_sigma, s_sky, s_tex,
                               *(getattr(s_scene, f) for f in shade.SURFACE_TABLES))
        surface_writes = nbytes(*(getattr(surf, f) for f in fields), surf.contribs,
                                *surf.shadow, surf.num_shadow)
        lights_bytes = nbytes(surf.miss, surf.w_albedo, surf.shadow_active, surf.contribs,
                              s_blocked, surf.num_shadow) + 2 * nbytes(s_fb)
        launches["shade"] = launches["shade_surface"] + launches["shade_lights"]
        record("shade", "raytracer_tpu_torch/csrc/shade.cu",
               "none (the glue of raytracer_tpu/render/renderer.py:_shade_generation, "
               "fused by XLA on the TPU)", s_rel, cuda_ms(two_kernels, 20),
               cuda_ms(glue_stage, 5),
               bound_ms(surface_reads + surface_writes + lights_bytes,
                        n * (OPS_SHADE_LANE + OPS_SHADE_LIGHT * n_lights)),
               None, not differ and s_rel <= 1e-6
               and int(s_shadow) == int(s_want.num_shadow),
               device_ms=microbench.device_ms(two_kernels, dev),
               surface_device_ms=microbench.device_ms(
                   lambda: shade.surface_launch(s_scene, s_hits, s_weight, s_sigma, s_active,
                                                s_sky, s_tex, s_cfg), dev),
               lights_device_ms=microbench.device_ms(
                   lambda: shade.lights_launch(s_scene.ambient, surf, s_blocked, s_fb, s_zero,
                                               s_zero, s_zero, s_inc), dev),
               stage_ms=cuda_ms(stage, 20), stage_device_ms=microbench.device_ms(stage, dev),
               # ~20 ms of the host's issue a call: 2 fit behind the wait kernel
               glue_device_ms=microbench.device_ms(glue_stage, dev, reps=2),
               differ=differ, frame_max_rel=s_rel, lanes=n, lights=n_lights,
               shadow_rays=int(s_shadow), bytes={"surface_reads": surface_reads,
                                                 "surface_writes": surface_writes,
                                                 "lights": lights_bytes},
               launches_of={k: launches[k] for k in SHADE_KERNELS},
               library="none: no one PyTorch call computes the shading",
               tolerance="every surface output and shadow operand bit for bit; the dense "
                         "frame add within 1e-6 relative")
    del s_scene, s_hits, s_dir, s_weight, s_sigma, s_active, s_tex4, s_gen, s_bvh, surf, glue
    del s_sky, s_tex, s_blocked, s_fb, fb_k, fb_g, contribution

    # the children kernels (csrc/spawn.cu) on config3's generation 0 against
    # the glue they replace (_compact of _spawn): the next queue's ten fields
    # bit for bit and the counts; ms of the stage (both launches, K6 and its
    # read) beside the glue's, device time of each launch and of the stage
    # without the read, and the glue's without it
    (p_rays, p_pixel, p_hits, p_w, p_refl, p_trans, p_ior), _ = inputs["spawn"]
    p_zero = torch.zeros((), dtype=torch.int32, device=dev)
    p_stats = renderer.RenderStats(*(p_zero,) * 6)
    # _spawn reads the generation's rays and pixels alone
    p_gen = renderer._Generation(rays=p_rays, weight=None, sigma=None, pixel=p_pixel,
                                 active=None)
    p_args = (p_rays, p_pixel, p_hits, p_w, p_refl, p_trans, p_ior)
    with torch.no_grad():
        cand, want_stats = renderer._spawn(p_gen, p_hits, p_w, p_refl, p_trans, p_ior, p_stats)
        want = renderer._compact(cand)
        parents = spawn.flags(*p_args)
        got, got_stats = renderer._next_queue(parents, p_stats)
        p_fields = {**dict(zip(intersect.Rays._fields, zip(got.rays, want.rays))),
                    **{f: (getattr(got, f), getattr(want, f))
                       for f in ("weight", "sigma", "pixel", "active")}}
        differ = [f for f, (a, b) in p_fields.items() if a.shape != b.shape or not torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)]
        counts_equal = all(int(getattr(got_stats, f)) == int(getattr(want_stats, f))
                           for f in ("num_reflection", "num_refraction"))
        n = p_pixel.shape[0]
        n_active = got.pixel.shape[0]
        sel, _ = compaction.compact(parents.flags)
        parent_rows = int(torch.unique(sel % n).numel())
        refracting = int((p_hits.hit & ((p_trans * p_trans).sum(1) > 0)).sum())

        def stage():
            spawn.children(spawn.flags(*p_args), p_zero, p_zero)

        def stage_no_read():
            pa = spawn.flags(*p_args)
            spawn.write(pa, compaction.compact_launch(pa.flags)[0][:n_active], p_zero, p_zero)

        def glue_stage():
            renderer._compact(renderer._spawn(p_gen, p_hits, p_w, p_refl, p_trans, p_ior,
                                              p_stats)[0])

        def glue_no_read():
            c, _ = renderer._spawn(p_gen, p_hits, p_w, p_refl, p_trans, p_ior, p_stats)
            idx = compaction.compact_launch(c["active"])[0][:n_active]
            for v in c.values():
                v.index_select(0, idx)

        # the flags read hit and both material rows of every lane, direction,
        # normal and ior of a refracting one, and write 2 flags a lane and 2
        # counts a block; a child reads its index and its parent's rows (152
        # B, each parent's once) and writes 101 B
        flag_bytes = n * (1 + 12 + 12 + 2) + refracting * (12 + 12 + 4) + parents.counts.numel() * 4
        write_bytes = n_active * (4 + spawn.QUEUE_SLOT_BYTES) + parent_rows * 152
        launches["spawn"] = launches["spawn_flags"] + launches["spawn_write"]
        p_err = max((float((a - b).abs().max()) for a, b in p_fields.values()
                     if a.dtype == torch.float32 and a.shape == b.shape and a.numel()),
                    default=0.0)
        record("spawn", "raytracer_tpu_torch/csrc/spawn.cu",
               "none (the glue of raytracer_tpu/render/renderer.py:_spawn and _compact, "
               "fused by XLA on the TPU)", p_err, cuda_ms(stage, 20),
               cuda_ms(glue_stage, 5),
               bound_ms(flag_bytes + write_bytes, n * OPS_SPAWN_LANE + n_active * OPS_SPAWN_CHILD),
               None, not differ and counts_equal,
               device_ms=microbench.device_ms(stage_no_read, dev),
               flags_device_ms=microbench.device_ms(lambda: spawn.flags(*p_args), dev),
               write_device_ms=microbench.device_ms(
                   lambda: spawn.write(parents, sel, p_zero, p_zero), dev),
               glue_device_ms=microbench.device_ms(glue_no_read, dev, reps=2),
               differ=differ, counts_equal=counts_equal, lanes=n, children=n_active,
               parent_rows=parent_rows, refracting_lanes=refracting,
               bytes={"flags": flag_bytes, "write": write_bytes},
               launches_of={k: launches[k] for k in SPAWN_KERNELS},
               library="none: no one PyTorch call computes the children",
               tolerance="the next queue's ten fields bit for bit, the counts equal")
    del p_rays, p_pixel, p_hits, p_w, p_refl, p_trans, p_ior, p_gen, p_args, cand, want, got
    del parents, sel

    # K1 closest hit, on the primary rays; K2 any hit, on generation 0's shadow
    # rays
    walk_visits = {}  # the walks' visits, beside which the gather phase puts K12's
    for name, any_hit, replaces in (
        ("traverse_closest", False, "raytracer_tpu/ops/traversal_wide.py:503"),
        ("traverse_any", True, "raytracer_tpu/ops/traversal_wide.py:523"),
    ):
        (bvh, o, d, t_max, active, kcfg), _ = inputs[name]
        fn = traversal_wide.trace_any if any_hit else traversal_wide.trace_closest
        got, walk = check_traverse(any_hit, bvh, o, d, t_max, active, kcfg)
        nodes = float(walk.steps.sum())
        leaves_ = float(walk.leaves.sum())
        walk_visits[name] = {"lanes": o.shape[0], "active": int(active.sum()),
                             "node_visits": nodes, "leaf_visits": leaves_}
        out_bytes = o.shape[0] * (1 if any_hit else 12)
        lane_bytes = nbytes(o, d, t_max, active) + out_bytes
        st = got["stats"]
        issued = issued_bytes(st, lane_bytes)
        plain_ms = cuda_ms(lambda: traversal_wide.trace_plain(
            bvh, o, d, t_max, active, kcfg.wide_stack_size, ordered(kcfg), any_hit), 1)
        k_ms = cuda_ms(lambda: fn(bvh, o, d, t_max, active, kcfg), 5)
        k_dev = microbench.device_ms(lambda: fn(bvh, o, d, t_max, active, kcfg), dev, reps=20)
        # the same launch with the 16-entry stack that was the default before
        # the walk took the scene's bound
        k16 = kcfg.replace(wide_stack_size=16)
        k16_dev = microbench.device_ms(lambda: fn(bvh, o, d, t_max, active, k16), dev, reps=20)
        k16_out = fn(bvh, o, d, t_max, active, k16)
        stack = {"entries": traversal_wide.walk_stack(bvh, kcfg.wide_stack_size),
                 "device_ms_at_16": k16_dev, "at_bound_over_at_16": k_dev / k16_dev,
                 "incomplete_at_16": int(k16_out[1] if any_hit else k16_out.incomplete)}
        record(name, "raytracer_tpu_torch/csrc/traverse.cu", replaces,
               max(got.pop("max_abs_err"), on4[name]["max_abs_err"]), k_ms, plain_ms,
               bound_ms(nbytes(o, d, t_max, active, bvh.table, bvh.inst_mat) + out_bytes,
                        (nodes + leaves_) * OPS_ITER + nodes * OPS_NODE
                        + leaves_ * OPS_LEAF), None,
               got.pop("passed") and on4[name]["passed"], **got, device_ms=k_dev,
               bytes_as_issued=issued, stack=stack,
               undecided_share=st["undecided_children"]
               / max(8 * st["quantised_node_visits"], 1),
               exact_lane_share=st["exact_lanes"] / max(int(active.sum()), 1),
               live_per_leaf_visit=st["live_tests"] / max(st["leaf_visits"], 1),
               node_visits=nodes, leaf_visits=leaves_, config4_900x600=on4[name],
               tolerance="ids, steps and found identical; t within 1e-6 relative; on "
                         "config3 and on config4; the kernel's counters equal the plain "
                         "walk's, its quantised test the exact one's")
        del walk

    # K7, forward on every generation of config3's frame and of config4's,
    # against mesh_hits_plain; backward against autograd of mesh_hits_plain with
    # seeded cotangents, the ray fields and the prior record on every
    # generation, the triangle and instance tables on generation 0
    tables = hits.GEOMETRY + INSTANCE_TABLES

    def float_ulps(a, b) -> int:
        """Largest distance in units in the last place between two float32
        tensors of one shape (equal infinities and NaNs count 0)."""
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            return 0

        def as_ordered_int(x):
            i = x.contiguous().view(torch.int32).to(torch.int64)
            return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

        return int((as_ordered_int(a) - as_ordered_int(b)).abs()[~same].max())

    def check_hits_fwd(args) -> dict:
        with torch.no_grad():
            k = hits.mesh_hits(*args)
            p = hits.mesh_hits_plain(*args)
        ulps = {f: float_ulps(getattr(k, f), getattr(p, f)) for f in hits.FLOAT_FIELDS}
        exact = all(torch.equal(getattr(k, f), getattr(p, f))
                    for f in ("hit", "material_id", "bvh_steps"))
        err = max(float((getattr(k, f) - getattr(p, f)).nan_to_num(0.0, 0.0, 0.0).abs().max())
                  for f in hits.FLOAT_FIELDS)
        return {"lanes": args[1].count, "mesh_lanes": int((args[2].tri >= 0).sum()),
                "ids_exact": exact, "max_ulps": ulps, "max_abs_err": err,
                "passed": exact and not any(ulps.values())}

    def check_hits_bwd(args, with_tables: bool) -> dict:
        scene_, rays_, res_, prior_, obj = args
        cots = [torch.randn(getattr(prior_, f).shape, generator=gen, device="cuda")
                for f in hits.FLOAT_FIELDS]
        grads = []
        for fn in (hits.mesh_hits, hits.mesh_hits_plain):
            r = renderer.Rays(*(x.detach().clone().requires_grad_() for x in rays_))
            prior_leaves = prior_._replace(**{
                f: getattr(prior_, f).detach().clone().requires_grad_()
                for f in hits.FLOAT_FIELDS})
            tabs = ({f: getattr(scene_, f).detach().clone().requires_grad_() for f in tables}
                    if with_tables else {})
            out = fn(scene_._replace(**tabs), r, res_, prior_leaves, obj)
            leaves = [*r, *(getattr(prior_leaves, f) for f in hits.FLOAT_FIELDS), *tabs.values()]
            grads.append(torch.autograd.grad([getattr(out, f) for f in hits.FLOAT_FIELDS],
                                             leaves, cots))
        names = [*renderer.Rays._fields, *(f"prior_{f}" for f in hits.FLOAT_FIELDS),
                 *(tables if with_tables else ())]
        rel = {n: l2rel(a, b) if float(b.norm()) > 0 else float(a.norm())
               for n, a, b in zip(names, *grads)}
        err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        finite = all(bool(torch.isfinite(a).all()) for a in grads[0])
        got = {"lanes": rays_.count, "tables": with_tables, "l2_rel": rel, "max_abs_err": err}
        held = {n: v for n, v in rel.items() if n not in tables}
        if with_tables:
            # A table's gradient sums every lane that hit its row (a large
            # triangle thousands, each of config3's 3 instance rows ~2M at
            # 1080p), and the float32 plain version's own sum (index_add_'s
            # atomics) moves by more than 1e-5 of the result from run to run.
            # The tables are held to 1e-5 l2-relative of the plain version's
            # float32 per-lane gradients (each lane given its own copy of its
            # rows) summed in float64; the float32 plain sum's distance from
            # the same reference is reported beside.  The kernel sums in
            # float64 and rounds once, so the order of its sum, which changes
            # from run to run, does not move its reading.
            valid = res_.tri >= 0
            rows = {f: torch.clamp_min(res_.tri, 0).long() for f in hits.GEOMETRY}
            rows.update({f: torch.clamp_min(res_.inst, 0).long() for f in INSTANCE_TABLES})
            lane = {f: getattr(scene_, f).index_select(0, rows[f]).detach().requires_grad_()
                    for f in tables}
            ar = torch.arange(valid.shape[0], dtype=torch.int32, device="cuda")
            lanes_scene = scene_._replace(
                tr_material=scene_.tr_material.index_select(0, rows["tr_p0"]), **lane)
            lanes_res = res_._replace(tri=torch.where(valid, ar, -1), inst=ar)
            out = hits.mesh_hits_plain(lanes_scene, rays_, lanes_res, prior_, obj)
            contrib = torch.autograd.grad([getattr(out, f) for f in hits.FLOAT_FIELDS],
                                          list(lane.values()), cots)
            got["l2_rel_to_exact_sum"], got["plain_l2_rel_to_exact_sum"] = {}, {}
            for f, c in zip(tables, contrib):
                k_g, p_g = (g[names.index(f)].double() for g in grads)
                exact = torch.zeros_like(k_g).index_add_(0, rows[f], c.double())
                held[f] = got["l2_rel_to_exact_sum"][f] = l2rel(k_g, exact)
                got["plain_l2_rel_to_exact_sum"][f] = l2rel(p_g, exact)
            del out, contrib, lane, lanes_scene
        got["passed"] = finite and all(v <= 1e-5 for v in held.values())
        return got

    fwd_checks = {label: [check_hits_fwd(a) for a, _ in calls]
                  for label, calls in hits_calls.items()}
    bwd_checks = {label: [check_hits_bwd(a, g == 0) for g, (a, _) in enumerate(calls)]
                  for label, calls in hits_calls.items()}
    hits_args, _ = hits_calls["config3"][0]
    del hits_calls
    h_scene, h_rays, h_res, h_prior, h_obj = hits_args
    n = h_rays.count
    valid = h_res.tri >= 0
    n_mesh = int(valid.sum())
    h_tables = [getattr(h_scene, f) for f in hits.GEOMETRY]
    # what this run's lanes need (csrc/hits.cu): the ray fields, cotangents and
    # table rows of the lanes with a mesh hit (each distinct row once), the
    # prior record of the others, the ids and the output of every lane
    rows = int(torch.unique(h_res.tri[valid]).numel())
    row_bytes = rows * sum(t.shape[1] * 4 for t in h_tables)
    inst_bytes = nbytes(h_scene.inst_inv, h_scene.inst_world)
    rec_lane = sum(x[:1].numel() * x.element_size() for x in h_prior)  # 109 bytes
    ray_lane = sum(x[:1].numel() * x.element_size() for x in h_rays)  # 72 bytes
    cot_lane = rec_lane - 9  # the 13 float fields
    fwd_bytes = (n * 12 + n_mesh * (ray_lane + 4) + rows * 4 + row_bytes + inst_bytes
                 + (n - n_mesh) * rec_lane + n * rec_lane)
    bwd_bytes = n * 8 + n_mesh * (ray_lane + cot_lane) + row_bytes + inst_bytes + n * ray_lane

    def k7():
        with torch.no_grad():
            return hits.mesh_hits(*hits_args)

    def p7():
        with torch.no_grad():
            return hits.mesh_hits_plain(*hits_args)

    record("hits", "raytracer_tpu_torch/csrc/hits.cu", "raytracer_tpu/render/renderer.py:124",
           max(c["max_abs_err"] for v in fwd_checks.values() for c in v),
           cuda_ms(k7, 20), cuda_ms(p7, 5), bound_ms(fwd_bytes, n_mesh * OPS_HITS_FWD), None,
           all(c["passed"] for v in fwd_checks.values() for c in v),
           device_ms=microbench.device_ms(k7, dev), lanes=n, mesh_lanes=n_mesh,
           table_rows=rows, bytes=fwd_bytes, per_generation=fwd_checks,
           launches_per_frame=launches["hits"], launches_per_step=train_launches["hits"],
           tolerance="every field equal on every lane (0 ulps) of every generation of "
                     "config3's 1080p frame and config4's frame")

    # K7 backward as the main path runs it (the ray fields' gradients only), on
    # generation 0; and with the tables' gradients
    cots = [torch.randn(getattr(h_prior, f).shape, generator=gen, device="cuda")
            for f in hits.FLOAT_FIELDS]
    geom_args = (h_res.tri, h_res.inst, h_rays, tuple(h_tables), h_scene.tr_material,
                 h_scene.inst_inv, h_scene.inst_world, cots, h_obj)
    no13 = (False,) * len(hits.FLOAT_FIELDS)

    def k7b():
        return hits.hits_backward(*geom_args, (True,) * 6, no13, (False,) * 9, (False, False))

    def k7b_tables():
        return hits.hits_backward(*geom_args, (True,) * 6, no13, (True,) * 9, (True, True))

    ray_leaves = renderer.Rays(*(x.detach().clone().requires_grad_() for x in h_rays))
    p_out = hits.mesh_hits_plain(h_scene, ray_leaves, h_res, h_prior, h_obj)
    p_outs = [getattr(p_out, f) for f in hits.FLOAT_FIELDS]

    def p7b():
        return torch.autograd.grad(p_outs, list(ray_leaves), cots, retain_graph=True)

    bwd_ms_tables = cuda_ms(k7b_tables, 10)
    record("hits_bwd", "raytracer_tpu_torch/csrc/hits.cu", "raytracer_tpu/render/renderer.py:124",
           max(c["max_abs_err"] for v in bwd_checks.values() for c in v),
           cuda_ms(k7b, 20), cuda_ms(p7b, 5), bound_ms(bwd_bytes, n_mesh * OPS_HITS_BWD), None,
           all(c["passed"] for v in bwd_checks.values() for c in v),
           device_ms=microbench.device_ms(k7b, dev), lanes=n, mesh_lanes=n_mesh,
           bytes=bwd_bytes, ms_with_table_gradients=bwd_ms_tables,
           per_generation=bwd_checks, launches_per_step=train_launches["hits_bwd"],
           tolerance="each gradient within 1e-5 l2-relative of the plain version's: "
                     "the ray fields' and the prior record's on every generation of "
                     "config3's and config4's frames; the nine triangle tables' and both "
                     "instance tables' on generation 0, against the plain version's "
                     "float32 per-lane gradients summed in float64")
    del hits_args, h_scene, h_rays, h_res, h_prior, geom_args, p_out, p_outs, ray_leaves, cots
    del valid

    # K10 closest and any hit, on every generation of the threaded frames of
    # config3 and config4, against traversal.trace_plain; timed on config3's
    # generation 0 in each form
    def check_threaded(any_hit, bvh, o, d, t_max, active, kcfg, walk=None):
        if walk is None:
            walk = traversal.trace_plain(bvh, o, d, t_max, active, ordered(kcfg), any_hit)
        if any_hit:
            kfound, kinc = traversal.trace_any(bvh, o, d, t_max, active, kcfg)
            same = bool(torch.equal(kfound, walk.found))
            got = {"found_differs": int((kfound != walk.found).sum())}
        else:
            res = traversal.trace_closest(bvh, o, d, t_max, active, kcfg)
            kinc = res.incomplete
            kbest = torch.where(res.tri >= 0, (res.tri << 8) | (res.inst + 1), -1)
            same = bool(torch.equal(kbest, walk.best) and torch.equal(res.steps, walk.steps)
                        and torch.equal(res.t, walk.t))
            got = {"ids_differ": int((kbest != walk.best).sum()),
                   "steps_differ": int((res.steps != walk.steps).sum()),
                   "t_differ": int((res.t != walk.t).sum())}
        got.update(passed=same and int(kinc) == 0, lanes=o.shape[0], active=int(active.sum()),
                   incomplete=int(kinc), node_visits=int(walk.steps.sum()),
                   pair_visits=int(walk.pairs.sum()), entries=int(walk.entries.sum()),
                   max_abs_err=0.0 if same else float("inf"))
        return got

    for name, any_hit, replaces in (
        ("threaded_closest", False, "raytracer_tpu/ops/traversal.py:361"),
        ("threaded_any", True, "raytracer_tpu/ops/traversal.py:381"),
    ):
        calls = threaded_calls[name]
        (bvh, o, d, t_max, active, kcfg), _ = calls[0]
        walk = traversal.trace_plain(bvh, o, d, t_max, active, ordered(kcfg), any_hit,
                                     visits=True)
        checked = [check_threaded(any_hit, *a, walk=walk if k == 0 else None)
                   for k, (a, _) in enumerate(calls)]
        checked4 = [check_threaded(any_hit, *a) for a, _ in threaded4_calls[name]]
        fn = traversal.trace_any if any_hit else traversal.trace_closest
        nodes, pairs = checked[0]["node_visits"], checked[0]["pair_visits"]
        entries, rays = checked[0]["entries"], checked[0]["active"]
        out_bytes = o.shape[0] * (1 if any_hit else 12)
        k_dev = microbench.device_ms(lambda: fn(bvh, o, d, t_max, active, kcfg), dev, reps=20)
        traffic = mb_threaded.traffic(walk, o.shape[0], any_hit)
        iters = walk.steps + walk.pairs
        plain_ms = cuda_ms(lambda: traversal.trace_plain(bvh, o, d, t_max, active,
                                                         ordered(kcfg), any_hit), 1)
        record(name, "raytracer_tpu_torch/csrc/traverse_threaded.cu", replaces,
               max(c["max_abs_err"] for c in checked + checked4),
               cuda_ms(lambda: fn(bvh, o, d, t_max, active, kcfg), 5), plain_ms,
               bound_ms(nbytes(o, d, t_max, active, bvh.box, bvh.node, bvh.links, bvh.inst_mat,
                               bvh.inst_root, bvh.tri) + out_bytes,
                        rays * OPS_TRAY + entries * OPS_TENTRY + nodes * OPS_TNODE
                        + pairs * OPS_TPAIR),
               None, all(c["passed"] for c in checked + checked4),
               device_ms=k_dev, kernel=f"rec_kernel<{str(any_hit).lower()}>", **traffic,
               tables=mb_threaded.tables(bvh),
               warp_efficiency=mb_threaded.warp_efficiency(iters),
               warp_efficiency_compacted=mb_threaded.warp_efficiency(iters[active]),
               node_visits=nodes, pair_visits=pairs, entries=entries,
               per_generation=checked, config4_per_generation=checked4,
               tolerance="ids, t, steps and found identical on every lane of every "
                         "generation of the threaded 1080p frame and of config4's "
                         "threaded frame")
        del walk
    del threaded_calls, threaded4_calls
    del inputs

    # K8 FXAA on config4's frame (the app's shape) and on config3's 1080p frame
    fx = {}
    for label, img_in in (("900x600", rec4.inputs["fxaa"][0][0]), ("1920x1080", image)):
        px = img_in.shape[0] * img_in.shape[1]
        got = fxaa.fxaa(img_in)
        err = (got - fxaa.fxaa_plain(img_in)).abs().amax(dim=-1)
        fx[label] = {
            "pixels": px, "max_abs_err": float(err.max()),
            "pixels_within_tolerance": float((err <= 1e-5).float().mean()),
            "mean_abs_err": float(err.mean()),
            "ms": cuda_ms(lambda: fxaa.fxaa(img_in), 20),
            "device_ms": microbench.device_ms(lambda: fxaa.fxaa(img_in), dev),
            "plain_ms": cuda_ms(lambda: fxaa.fxaa_plain(img_in), 5),
            "bound": bound_ms(2 * nbytes(img_in), px * OPS_FXAA)}
    fx_ok = all(v["pixels_within_tolerance"] >= 0.999 and v["mean_abs_err"] <= 1e-6
                for v in fx.values())
    row = fx.pop("900x600")
    record("fxaa", "raytracer_tpu_torch/csrc/fxaa.cu", "raytracer_tpu/ops/fxaa.py:45",
           row.pop("max_abs_err"), row.pop("ms"), row.pop("plain_ms"), row.pop("bound"),
           None, fx_ok, **row, kernel="tile_kernel",
           launches_per_frame=app_launches["fxaa"] / APP_FRAMES,
           at_1920x1080={**fx["1920x1080"], "bound_ms": fx["1920x1080"].pop("bound")[0]},
           tolerance="<= 1e-5 abs on >= 99.9% of pixels, mean <= 1e-6, at both sizes")

    # K9, timed on config4's generation 0: the primaries' closest hit, the shadow
    # rays' any hit (3 lights in one launch).  Its check covers every generation
    # of config4, config0 and config2 (check_k9): the refraction chains start
    # inside the dielectric spheres, where the sphere's t is t1.
    def k9_checked(name):
        per_config = {label: {k: v for k, v in got[name].items() if k != "max_abs_err"}
                      for label, got in k9.items()}
        return (max(got[name]["max_abs_err"] for got in k9.values()),
                all(got[name]["passed"] for got in k9.values()), per_config)

    (prims, o9, d9), _ = rec4.inputs["prim_closest"]
    n_s, n_p = prims.n_spheres, prims.n_planes
    n = o9.shape[0]
    max_err, passed, per_config = k9_checked("prim_closest")
    record("prim_closest", "raytracer_tpu_torch/csrc/primitives.cu",
           "raytracer_tpu/ops/intersect.py:122", max_err,
           cuda_ms(lambda: intersect.pick_closest(prims, o9, d9), 20),
           cuda_ms(lambda: intersect.pick_closest_plain(prims, o9, d9), 5),
           bound_ms(nbytes(o9, d9) + n * 8,
                    n * (OPS_PRIM_LANE + n_s * OPS_PRIM_SPHERE + n_p * OPS_PRIM_PLANE)),
           None, passed,
           device_ms=microbench.device_ms(lambda: intersect.pick_closest(prims, o9, d9), dev),
           lanes=n, spheres=n_s, planes=n_p, checked=per_config,
           launches_per_frame=app_launches["prim_closest"] / APP_FRAMES,
           also_replaces="raytracer_tpu/ops/intersect.py:222 (plane_trace)",
           tolerance="winner ids and t identical on every lane of every generation "
                     "of config4, config0 and config2")

    (prims, oa, da, tmax, act), _ = rec4.inputs["prim_any"]
    n, n_act = oa.shape[0], int(act.sum())
    max_err, passed, per_config = k9_checked("prim_any")
    # operations as if every active lane tested every primitive: bytes bind either way
    record("prim_any", "raytracer_tpu_torch/csrc/primitives.cu",
           "raytracer_tpu/ops/intersect.py:203", max_err,
           cuda_ms(lambda: intersect.pick_any(prims, oa, da, tmax, act), 20),
           cuda_ms(lambda: intersect.pick_any_plain(prims, oa, da, tmax, act), 5),
           bound_ms(n * 2 + n_act * 28, n_act * (n_s * OPS_ANY_SPHERE + n_p * OPS_ANY_PLANE)),
           None, passed,
           device_ms=microbench.device_ms(
               lambda: intersect.pick_any(prims, oa, da, tmax, act), dev),
           lanes=n, active=n_act, checked=per_config,
           launches_per_frame=app_launches["prim_any"] / APP_FRAMES,
           also_replaces="raytracer_tpu/ops/intersect.py:265 (plane_intersect)",
           tolerance="blocked identical on every lane of every generation of config4, "
                     "config0 and config2")
    del rec4, prims, k9

    # ------------------------------------------------ 7b. the gather microbenchmarks
    problems = gather_phase(scene, record, launches, report, walk_visits, smi)
    if problems:
        return fail("gather: " + "; ".join(problems))

    # ----------------------------------------------------- 8. small-input checks
    def small_forward(label, packed, scfg) -> bool:
        """One frame on the card against the same frame on the CPU."""
        on_card = renderer.Renderer(scfg, device="cuda")
        gimg, gstats = on_card(on_card.upload(packed))
        on_cpu = renderer.Renderer(scfg, device="cpu")
        cimg, cstats = on_cpu(on_cpu.upload(packed))
        gcount = {k: int(v) for k, v in gstats._asdict().items()}
        ccount = {k: int(v) for k, v in cstats._asdict().items()}
        d = (gimg.cpu() - cimg).abs()
        mean_abs = float(d.mean())
        frac_1e3 = float((d.amax(dim=-1) <= 1e-3).float().mean())
        # The elementwise torch between the kernels rounds differently on the
        # card (rsqrt, transcendental functions) and shadow rays start ON
        # surfaces, so a marginal shadow decision may flip: the shadow count may
        # differ by 0.5%.
        shadow_rel = (abs(gcount["num_shadow"] - ccount["num_shadow"])
                      / max(ccount["num_shadow"], 1))
        passed = (all(gcount[k] == ccount[k] for k in gcount if k != "num_shadow")
                  and shadow_rel <= 5e-3 and mean_abs <= 1e-3 and frac_1e3 >= 0.99
                  and gcount["num_dropped"] == 0 and gcount["num_incomplete"] == 0
                  and bool(torch.isfinite(gimg).all()))
        emit("small_input", config=label, width=scfg.width, height=scfg.height,
             bounces=scfg.num_bounces, counters_cuda=gcount, counters_cpu=ccount,
             image_mean_abs_diff=mean_abs, frac_pixels_within_tolerance=frac_1e3,
             passed=passed, tolerance="counters equal (shadow within 0.5%), dropped and "
                                      "incomplete 0; mean abs <= 1e-3; >= 99% of pixels "
                                      "within 1e-3")
        return passed

    def small_grads(label, packed, scfg) -> bool:
        """fwd+bwd (zero target, all 17 fields), the card against the CPU."""
        sgrads, slosses = [], []
        for dev in ("cuda", "cpu"):
            r = renderer.Renderer(scfg, device=dev)
            sscene = r.upload(packed)
            sparams = train.extract_params(sscene)
            sloss = train.render_loss(sparams, sscene, torch.zeros(
                (scfg.height, scfg.width, 3), device=r.device), scfg)
            sloss.backward()
            slosses.append(float(sloss.detach()))
            sgrads.append({k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                           for k, p in sparams.items()})
        field_rel = {k: l2rel(sgrads[0][k], c) if float(c.norm()) > 0
                     else float(sgrads[0][k].norm()) for k, c in sgrads[1].items()}
        loss_rel = abs(slosses[0] - slosses[1]) / slosses[1]
        passed = (all(bool(torch.isfinite(g).all()) for g in sgrads[0].values())
                  and loss_rel <= 1e-3
                  and all(v <= SMALL_GRAD_TOL.get(k, SMALL_GRAD_TOL["*"])
                          for k, v in field_rel.items()))
        emit("small_input_grads", config=label, width=scfg.width, height=scfg.height,
             loss_cuda=slosses[0], loss_cpu=slosses[1], loss_rel=loss_rel,
             l2_rel_per_field=field_rel, passed=passed,
             tolerance=f"loss within 1e-3; per-field l2-relative {SMALL_GRAD_TOL}")
        return passed

    def small_vertex_grads(label, packed, scfg) -> bool:
        """Gradients of a seeded weighted image sum with respect to the triangle
        tables and the instance matrices (K7 bwd's float64 sums), the card
        against the CPU."""
        weight = torch.from_numpy(np.random.default_rng(6).random(
            (scfg.height, scfg.width, 3), dtype=np.float32))
        vgrads = []
        for dev in ("cuda", "cpu"):
            r = renderer.Renderer(scfg, device=dev)
            sc = r.upload(packed)
            leaves = {f: getattr(sc, f).detach().clone().requires_grad_() for f in tables}
            img, _ = renderer.render_with_stats(sc._replace(**leaves), scfg)
            g = torch.autograd.grad((img * weight.to(r.device)).sum(), list(leaves.values()),
                                    allow_unused=True)
            vgrads.append({f: (torch.zeros_like(x) if gx is None else gx).cpu()
                           for (f, x), gx in zip(leaves.items(), g)})
        field_rel = {k: l2rel(vgrads[0][k], c) if float(c.norm()) > 0
                     else float(vgrads[0][k].norm()) for k, c in vgrads[1].items()}
        passed = (all(bool(torch.isfinite(g).all()) for g in vgrads[0].values())
                  and all(v <= VERTEX_GRAD_TOL.get(k, VERTEX_GRAD_TOL["*"])
                          for k, v in field_rel.items())
                  and float(vgrads[1]["tr_p0"].norm()) > 0)
        emit("small_input_vertex_grads", config=label, width=scfg.width, height=scfg.height,
             l2_rel_per_table=field_rel, passed=passed,
             tolerance=f"per-table l2-relative {VERTEX_GRAD_TOL}")
        return passed

    sdesc, scfg = scenes.config3_sponza(64, 36, target_triangles=20_000)
    packed3 = ScenePacker(sdesc, 64, 36).frame()
    small = [("config3_sponza, 20k triangles", packed3, scfg, True),
             ("config3_sponza, 20k triangles, threaded", packed3,
              scfg.replace(traversal_kernel="threaded"), False)]
    ok = small_vertex_grads("config3_sponza, 20k triangles", packed3, scfg) and ok
    sdesc, scfg = scenes.config4_dynamic(96, 64)
    spacker = ScenePacker(sdesc, 96, 64)
    small.append(("config4, frame 0", spacker.frame(), scfg, True))
    sdesc.update(1.0 / 60.0)
    sdesc.update(1.0 / 60.0)
    small.append(("config4, frame 2", spacker.frame(), scfg, False))
    sdesc, scfg = scenes.config2_dielectric()
    scfg = scfg.replace(width=64, height=64)
    small.append(("config2", ScenePacker(sdesc, 64, 64).frame(), scfg, False))
    for label, packed, scfg, with_grads in small:
        ok = small_forward(label, packed, scfg) and ok
        if with_grads:
            ok = small_grads(label, packed, scfg) and ok

    # ----------------------------- 8b-8d. the oracle, pixel and scene sharding
    problems = oracle_phase(smi)
    problems += sharded_phase(scene, cfg, image, counters, train_kernels, smi)
    problems += scene_sharded_phase(desc, cfg, image, counters, train_loss, smi)
    if problems:
        return fail("; ".join(problems))

    # ------------------------------------------------------------- 9. result lines
    print(json.dumps({"kernels": report}), flush=True)
    print(smi, flush=True)
    if not ok:
        return fail("a kernel or the small-input check disagreed with its plain version")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
