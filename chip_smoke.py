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
   (each must be > 0), the six ray counters (dropped and incomplete must be 0),
   the median frame time of 3 frames after a warm-up, forward MRays/s, the time
   of each kernel inside a frame by CUDA events, peak device memory, and one
   frame under torch.profiler (device busy share, top operators by device time);
4. the training path: fwd+bwd of ``image_loss(render_with_stats(...))`` against
   a zero target over the 17 differentiable fields, one autograd graph over the
   whole 1080p frame — the launch counts of all seven kernels in one step (the
   backward kernels K4 and K5 bwd among them), the counters, the loss, every
   field's gradient norm (finite, not all zero), the median step time of 3 after
   a warm-up split into forward and backward, fwd+bwd MRays/s, each kernel's time
   inside a step, an Adam update's time, peak device memory and one profiled
   step; then 3 steps of ``diff.train.make_train_step``, whose loss must fall;
5. kernel vs plain: each kernel and its plain PyTorch version on the card, on
   the inputs the main path gave that kernel in generation 0, with the stated
   tolerance (a backward kernel against autograd of the plain forward, with a
   seeded cotangent); then each kernel's time, its plain version's time, the one
   PyTorch call that computes the same function where there is one, and the
   least time the card could take (bytes over 3.35 TB/s or float32 operations
   over 67 TFLOP/s, whichever is larger);
6. small-input check: config3 at 64x36 (20k triangles) on the card against the
   same render on the CPU through the plain versions, forward and fwd+bwd;
7. the kernels line, the ``nvidia-smi`` line, and last the device line.

It imports nothing of JAX.  Without a CUDA card, or run outside the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
WIDTH, HEIGHT, TRIANGLES = 1920, 1080, 260_000

# float32 operations per unit of work, counted from the kernel sources
# (csrc/traverse.cu): every iteration transforms the ray into instance space
# (33), a node visit adds 3 reciprocals and 8 slab tests of 25, a leaf visit
# 8 Moller-Trumbore tests of 54.
OPS_ITER, OPS_NODE, OPS_LEAF = 33, 3 + 8 * 25, 8 * 54
OPS_SKY = 25  # per lane (csrc/sky.cu)
OPS_TEX_LANE, OPS_TEX_TAP = 25, 30  # per lane; per bilinear tap (csrc/texture.cu)
# csrc/texture_bwd.cu: per tap the forward set-up (20), the weight and position
# cotangents (49), 12 products and 12 atomic adds into the row, and 6 to move
# and accumulate; per lane the set-up and the cotangent / n (28)
OPS_TEXBWD_LANE, OPS_TEXBWD_TAP = 28, 99
OPS_SKYBWD = 6  # per lane: 3 products and 3 atomic adds (csrc/sky.cu)
# card against CPU on config3 64x36 fwd+bwd: per-field l2-relative bound on the
# gradients ("*" for every other field).  Measured on an H100: <= 2.5e-5 (the
# camera fields), tex_data 8.8e-4 (the card's log2 moves a few lanes to another
# mip level); the bounds leave room for the shadow flips the forward check allows
SMALL_GRAD_TOL = {"*": 1e-3, "tex_data": 1e-2}
# the appearance fields the make_train_step check trains (a zero target pulls
# every one of them down, so the loss falls from the first step)
TRAIN_FIELDS = ("mat_diffuse", "mat_reflection", "mat_transmittance", "tex_data",
                "sky_data", "pl_colour", "sl_colour", "dl_colour", "ambient")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    row would count its kernel twice), their share of the wall time, and the
    largest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_events": sum(n for _, n in by_name.values()),
        "top_device_kernels": [{"name": k[:90], "ms": ms, "count": n}
                               for k, (ms, n) in top],
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs one CUDA card")
    if not os.path.isdir(os.path.join(REPO, "raytracer_tpu_torch")):
        return fail(f"{REPO} holds no raytracer_tpu_torch package: run from a checkout")
    sys.path.insert(0, REPO)

    from raytracer_tpu_torch import kernels
    from raytracer_tpu_torch.config import TraversalStrategy
    from raytracer_tpu_torch.diff import train
    from raytracer_tpu_torch.ops import (
        compaction, sky_sample, texture_sample, traversal_wide,
    )
    from raytracer_tpu_torch.render import renderer
    from raytracer_tpu_torch.scene import scenes
    from raytracer_tpu_torch.scene.device import ScenePacker

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
    cfg = cfg.replace(wide_stack_size=max(cfg.wide_stack_size, 24))  # lossless profile
    packed = ScenePacker(desc, WIDTH, HEIGHT).frame()
    rend = renderer.Renderer(cfg, device="cuda")
    scene = rend.upload(packed)
    torch.cuda.synchronize()
    emit("scene", name="config3_sponza", width=WIDTH, height=HEIGHT,
         triangles=int(packed.tr_p0.shape[0]), instances=int(packed.inst_inv.shape[0]),
         wide_records=list(packed.wd_rec.shape), texels=int(packed.tex_data.shape[0]),
         seconds=time.perf_counter() - t0)

    # where each kernel's wrapper counts its launches
    fwd_counts = {
        "traverse_closest": (traversal_wide, "closest_launches"),
        "traverse_any": (traversal_wide, "any_launches"),
        "texture_aniso": (texture_sample, "launches"),
        "sky": (sky_sample, "launches"),
        "compact": (compaction, "launches"),
    }
    counts = {**fwd_counts,
              "texture_aniso_bwd": (texture_sample, "bwd_launches"),
              "sky_bwd": (sky_sample, "bwd_launches")}
    targets = [(traversal_wide, "trace_closest", "traverse_closest"),
               (traversal_wide, "trace_any", "traverse_any"),
               (texture_sample, "sample", "texture_aniso"),
               (sky_sample, "sample_sky", "sky"),
               (compaction, "compact", "compact")]
    bwd_targets = [(texture_sample, "sample_backward", "texture_aniso_bwd"),
                   (sky_sample, "sample_backward", "sky_bwd")]

    def reset_counts():
        for module, attr in counts.values():
            setattr(module, attr, 0)

    def read_counts():
        return {name: getattr(module, attr) for name, (module, attr) in counts.items()}

    # one frame with the counts at 0: the forward path's run
    reset_counts()
    rec = Recorder(targets, every_call=("texture_aniso",))
    with rec:
        rec.capture = True
        image, stats = rend(scene)
        torch.cuda.synchronize()
        rec.capture = False
    launches = {k: n for k, n in read_counts().items() if k in fwd_counts}
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
    rays = (counters["num_primary"] + counters["num_shadow"]
            + counters["num_reflection"] + counters["num_refraction"])
    emit("frame", config="config3_sponza", width=WIDTH, height=HEIGHT,
         frame_ms=frame_ms, frame_ms_all=[s * 1e3 for s in frame_s],
         fwd_mrays_per_s=rays / (frame_ms / 1e3) / 1e6, counters=counters,
         image_shape=list(image.shape), image_mean=img_mean, image_finite=finite,
         launches=launches, kernel_ms_in_frame=frame_kernel_ms, profile=profile,
         max_memory_allocated_bytes=peak_mem, nvidia_smi=smi)
    problems = [f"{k} launched {n} times in the main path" for k, n in launches.items()
                if n <= 0]
    if counters["num_dropped"] or counters["num_incomplete"]:
        problems.append(f"loss counters not 0: {counters}")
    if not finite or tuple(image.shape) != (HEIGHT, WIDTH, 3):
        problems.append("image not finite or of the wrong shape")
    if problems:
        return fail("; ".join(problems))

    # ------------------------------------------------------- 4. the training path
    params = train.extract_params(scene)
    target = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device="cuda")

    def fwd_bwd(split=None):
        """One fwd+bwd step over the whole frame (one autograd graph); with
        ``split``, synchronise after the forward and append (fwd s, bwd s)."""
        for p in params.values():
            p.grad = None
        t0 = time.perf_counter()
        img, st = renderer.render_with_stats(train.apply_params(scene, params), cfg)
        loss = train.image_loss(img, target)
        if split is not None:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        loss.backward()
        if split is not None:
            torch.cuda.synchronize()
            split.append((t1 - t0, time.perf_counter() - t1))
        return loss.detach(), st

    # one step with the counts at 0: the training path's run (and the warm-up)
    reset_counts()
    loss, tstats = fwd_bwd()
    torch.cuda.synchronize()
    train_launches = read_counts()
    tcounters = {k: int(v) for k, v in tstats._asdict().items()}
    grad_norms = {k: None if p.grad is None else float(p.grad.norm())
                  for k, p in params.items()}
    train_loss = float(loss)

    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(3):
        fwd_bwd(splits)
    train_peak_mem = torch.cuda.max_memory_allocated()
    step_ms = statistics.median((a + b) * 1e3 for a, b in splits)
    with Recorder(targets + bwd_targets) as timer:
        timer.timing = True
        fwd_bwd()
        step_kernel_ms = timer.kernel_ms()
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    adam_ms = cuda_ms(opt.step, 3)  # on the last step's gradients
    train_profile = profile_frame(fwd_bwd)
    del opt, params

    init, step = train.make_train_step(cfg, fields=TRAIN_FIELDS)
    tparams, topt = init(scene)
    train_losses = []
    for _ in range(3):
        tparams, topt, tl = step(tparams, topt, scene, target)
        train_losses.append(float(tl))
    del tparams, topt
    trays = (tcounters["num_primary"] + tcounters["num_shadow"]
             + tcounters["num_reflection"] + tcounters["num_refraction"])
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
    problems = [f"{k} launched {n} times in the training step"
                for k, n in train_launches.items() if n <= 0]
    if tcounters["num_dropped"] or tcounters["num_incomplete"]:
        problems.append(f"loss counters not 0 in the training step: {tcounters}")
    norms = [v for v in grad_norms.values() if v is not None]
    if not all(math.isfinite(v) for v in norms) or not any(v > 0 for v in norms):
        problems.append(f"gradients not finite or all zero: {grad_norms}")
    if not math.isfinite(train_loss) or not train_losses[-1] < train_losses[0]:
        problems.append(f"make_train_step's loss did not fall: {train_losses}")
    if problems:
        return fail("; ".join(problems))

    # --------------------------------------------------------- 5. kernel vs plain
    inputs, tex_calls = rec.inputs, rec.calls["texture_aniso"]
    del rec
    report = []
    ok = True
    launches.update({k: train_launches[k] for k in ("texture_aniso_bwd", "sky_bwd")})
    gen = torch.Generator(device="cuda").manual_seed(7)

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

    # K5 sky, on generation 0's directions (every primary ray)
    (sky_data, direction), _ = inputs["sky"]
    k_out = sky_sample.sample_sky(sky_data, direction)
    p_out = sky_sample.sample_sky_plain(sky_data, direction)
    diff = (k_out - p_out).abs().amax(dim=1)
    frac_other = float((diff > 0).float().mean())
    n = direction.shape[0]
    record("sky", "raytracer_tpu_torch/csrc/sky.cu", "raytracer_tpu/ops/sky_sample.py:16",
           float(diff.max()), cuda_ms(lambda: sky_sample.sample_sky(sky_data, direction), 20),
           cuda_ms(lambda: sky_sample.sample_sky_plain(sky_data, direction), 5),
           bound_ms(nbytes(direction, sky_data) + n * 12, n * OPS_SKY), None,
           frac_other <= 1e-3, lanes=n, lanes_other_texel=frac_other,
           tolerance="texel values equal; <= 1e-3 of lanes may take a neighbouring texel")

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
    scaled, index_long = cot * (1.0 / math.pi), index.long()
    record("sky_bwd", "raytracer_tpu_torch/csrc/sky.cu", "raytracer_tpu/ops/sky_sample.py:16",
           float((k_grad - p_grad).abs().max()),
           cuda_ms(lambda: sky_sample.sample_backward(index, cot, rows), 20), cuda_ms(p5b, 20),
           bound_ms(nbytes(index, cot) + rows * 12, n * OPS_SKYBWD),
           cuda_ms(lambda: torch.zeros_like(sky_data).index_add_(0, index_long, scaled), 20),
           rel <= 1e-5, lanes=n, lanes_left_out=int((diff != 0).sum()), l2_rel=rel,
           run_to_run_max_abs=spread, run_to_run_l2_rel=spread_rel,
           atomic_rmw_bytes_in_l2=n * 3 * 8, library="torch.zeros + index_add_ of cot / pi",
           tolerance="sky_data gradient within 1e-5 l2-relative")
    del p_graph, leaf

    # K3 texture, on generation 0's hits
    (tex, *lanes_in, tcfg), kw = tex_calls[0]
    lanes_in = tuple(lanes_in)  # tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy
    data4, maxa = kw["data4"], float(tcfg.max_anisotropy)

    def k3(lanes=lanes_in):
        return texture_sample.sample(tex, *lanes, tcfg, data4=data4)

    def p3(lanes=lanes_in):
        return texture_sample.sample_plain(tex, *lanes, tcfg, data4)

    def branches(lanes):
        """The branch each lane takes (texture.cuh aniso_setup): the level-0 tap,
        the top texel, or n taps at level_c.  Returns (bilinear taps, top-texel
        lanes): the work depends on them."""
        tid, _, _, sx, sy, tx, ty = lanes
        levels = tex[3][tid.long()]
        p_x = torch.maximum(sx.abs(), tx.abs())
        p_y = torch.maximum(sy.abs(), ty.abs())
        p_max = torch.maximum(p_x, p_y)
        taps = torch.clamp(torch.ceil(p_max / torch.clamp_min(torch.minimum(p_x, p_y), 1e-20)),
                           1.0, maxa)
        level = torch.round(levels.float() - 1.0
                            + torch.log2(torch.clamp_min(p_max / taps, 1e-20)))
        top = (levels > 1) & (level >= levels - 1)
        aniso = (levels > 1) & (level >= 0) & ~top
        return (float(torch.where(aniso, taps, torch.where(top, 0.0, 1.0)).sum()),
                float(top.sum()))

    err = (k3() - p3()).abs().amax(dim=1)
    n = lanes_in[1].shape[0]
    frac_ok = float((err <= 1e-5).float().mean())
    n_taps, n_top = branches(lanes_in)
    record("texture_aniso", "raytracer_tpu_torch/csrc/texture.cu",
           "raytracer_tpu/ops/texture_sample.py:290", float(err.max()), cuda_ms(k3, 20),
           cuda_ms(p3, 5),
           bound_ms(nbytes(*lanes_in, tex[0], data4, *tex[1:5]) + n * 12,
                    n * OPS_TEX_LANE + n_taps * OPS_TEX_TAP), None,
           frac_ok >= 0.999, lanes=n, lanes_within_tolerance=frac_ok, bilinear_taps=n_taps,
           top_lanes=n_top, tolerance="max abs <= 1e-5 on >= 99.9% of lanes")

    # K4 against autograd of sample_plain, same lanes, seeded cotangent.  A lane
    # whose K3 result differs (another mip level at a rounding boundary) sends
    # its gradient to other texels, so those lanes are left out of both.
    def k4_vs_plain(lanes):
        e = (k3(lanes) - p3(lanes)).abs().amax(dim=1)
        cot = torch.randn((e.shape[0], 3), generator=gen, device="cuda") * (e <= 1e-5)[:, None]
        kd, kd4, kl = texture_sample.sample_backward(tex, lanes, maxa, data4, cot,
                                                     True, True, True)
        d_leaf = tex[0].detach().clone().requires_grad_()
        d4_leaf = data4.detach().clone().requires_grad_()
        f_leaf = [x.detach().clone().requires_grad_() for x in lanes[1:]]
        p_graph = texture_sample.sample_plain((d_leaf, *tex[1:]), lanes[0], *f_leaf, tcfg,
                                              d4_leaf)

        def p4():
            return torch.autograd.grad(p_graph, [d_leaf, d4_leaf, *f_leaf], cot,
                                       retain_graph=True)

        pd, pd4, *pl = p4()
        lane_ok = [float((((kl[k] - g).abs() / g.abs().max().clamp_min(1e-30)) <= 1e-5)
                         .float().mean()) for k, g in enumerate(pl)]
        got = {"lanes": e.shape[0], "lanes_left_out": int((e > 1e-5).sum()),
               "top_lanes": branches(lanes)[1],
               "l2_rel_data": l2rel(kd, pd), "l2_rel_data4": l2rel(kd4, pd4),
               "lanes_within_tolerance": dict(zip(("s", "t", "ds_dx", "ds_dy", "dt_dx",
                                                   "dt_dy"), lane_ok)),
               "max_abs_err": max(float((kd - pd).abs().max()), float((kd4 - pd4).abs().max()),
                                  max(float((kl[k] - g).abs().max())
                                      for k, g in enumerate(pl)))}
        got["passed"] = (got["l2_rel_data4"] <= 1e-5 and min(lane_ok) >= 0.999
                         and (got["top_lanes"] == 0 or got["l2_rel_data"] <= 1e-5))
        if got["top_lanes"] == 0:  # grad data comes only from top-texel lanes
            got["l2_rel_data"] = "not exercised: no top-texel lane"
        return got, cot, p4

    # the top-texel branch (K4's grad data atomics), on the main path's
    # generation with the most top-texel lanes; where none has one, on generation
    # 0's lanes with each lane's derivatives scaled by 2^u (u seeded, uniform in
    # [0, 16)), which sends a share of them to the top texel
    tops = [branches(tuple(c[0][1:8]))[1] for c in tex_calls]
    g_top = max(range(len(tops)), key=tops.__getitem__)
    if tops[g_top] > 0:
        top_in, top_from = tuple(tex_calls[g_top][0][1:8]), f"generation {g_top}"
    else:
        u = torch.exp2(torch.rand(n, generator=gen, device="cuda") * 16)
        top_in = (*lanes_in[:3], *(x * u for x in lanes_in[3:]))
        top_from = "generation 0, derivatives x 2^u, u seeded uniform in [0, 16)"
    top_check, _, _ = k4_vs_plain(top_in)
    top_check.update(inputs=top_from, top_lanes_per_generation=tops)
    top_ok = top_check["passed"] and top_check["top_lanes"] > 0
    del top_in, tex_calls

    # K4 on generation 0's lanes: timed, and the row of the kernels line
    check, cot, p4 = k4_vs_plain(lanes_in)

    def k4():
        return texture_sample.sample_backward(tex, lanes_in, maxa, data4, cot, True, True, True)

    kd4, again = k4()[1], k4()[1]
    spread, spread_rel = float((again - kd4).abs().max()), l2rel(again, kd4)
    del kd4, again
    x_rows = tex[0].shape[0]
    atomics = n_taps * 12 + n_top * 3
    record("texture_aniso_bwd", "raytracer_tpu_torch/csrc/texture_bwd.cu",
           "raytracer_tpu/ops/texture_sample.py:290",
           max(check.pop("max_abs_err"), top_check["max_abs_err"]), cuda_ms(k4, 20),
           cuda_ms(p4, 5),
           bound_ms(nbytes(*lanes_in, cot, data4, *tex[1:5]) + x_rows * (12 + 48) + n * 24,
                    n * OPS_TEXBWD_LANE + n_taps * OPS_TEXBWD_TAP + n_top * 3), None,
           check.pop("passed") and top_ok, bilinear_taps=n_taps, atomics=atomics,
           atomic_rmw_bytes_in_l2=atomics * 8, **check, top_texel_check=top_check,
           run_to_run_max_abs_data4=spread, run_to_run_l2_rel_data4=spread_rel,
           tolerance="data and data4 gradients within 1e-5 l2-relative (data on the "
                     "top-texel check, as generation 0 may have no top-texel lane); each "
                     "lane gradient within 1e-5 of its max |grad| on >= 99.9% of lanes")
    del p4, cot

    # K6 compaction, on generation 0's 2N candidate flags
    (flags,), _ = inputs["compact"]
    k_idx, k_n = compaction.compact(flags)
    p_idx, p_n = compaction.compact_plain(flags)
    exact = k_n == p_n and bool(torch.equal(k_idx, p_idx))
    n = flags.shape[0]
    record("compact", "raytracer_tpu_torch/csrc/compact.cu",
           "raytracer_tpu/ops/compaction.py:26", 0.0 if exact else float("inf"),
           cuda_ms(lambda: compaction.compact(flags), 20),
           cuda_ms(lambda: compaction.compact_plain(flags), 20),
           bound_ms(n + 4 * k_n + 4, n), cuda_ms(lambda: torch.nonzero(flags), 20),
           exact, lanes=n, active=k_n, tolerance="exact")

    # K1 closest hit, on the primary rays; K2 any hit, on generation 0's shadow rays
    ordered = cfg.traversal_strategy == TraversalStrategy.ORDERED
    for name, any_hit, replaces in (
        ("traverse_closest", False, "raytracer_tpu/ops/traversal_wide.py:503"),
        ("traverse_any", True, "raytracer_tpu/ops/traversal_wide.py:523"),
    ):
        (bvh, o, d, t_max, active, kcfg), _ = inputs[name]
        fn = traversal_wide.trace_any if any_hit else traversal_wide.trace_closest
        walk = traversal_wide.trace_plain(bvh, o, d, t_max, active, kcfg.wide_stack_size,
                                          ordered, any_hit)
        if any_hit:
            kfound, kinc = fn(bvh, o, d, t_max, active, kcfg)
            same = bool(torch.equal(kfound, walk.found))
            max_err = 0.0 if same else float("inf")
            extra = {"found_differs": int((kfound != walk.found).sum())}
        else:
            res = fn(bvh, o, d, t_max, active, kcfg)
            kinc = res.incomplete
            kbest = torch.where(res.tri >= 0, (res.tri << 8) | (res.inst + 1), -1)
            same = bool(torch.equal(kbest, walk.best) and torch.equal(res.steps, walk.steps))
            fin = torch.isfinite(walk.t)
            gap = (res.t - walk.t)[fin].abs()
            max_err = float(gap.max()) if bool(fin.any()) else 0.0
            rel = float((gap / walk.t[fin].abs()).max()) if bool(fin.any()) else 0.0
            same = same and rel <= 1e-6
            extra = {"ids_differ": int((kbest != walk.best).sum()),
                     "steps_differ": int((res.steps != walk.steps).sum()), "t_max_rel": rel}
        nodes = float(walk.steps.sum())
        leaves_ = float(walk.leaves.sum())
        out_bytes = o.shape[0] * (1 if any_hit else 12)
        plain_ms = cuda_ms(lambda: traversal_wide.trace_plain(
            bvh, o, d, t_max, active, kcfg.wide_stack_size, ordered, any_hit), 1)
        record(name, "raytracer_tpu_torch/csrc/traverse.cu", replaces, max_err,
               cuda_ms(lambda: fn(bvh, o, d, t_max, active, kcfg), 5), plain_ms,
               bound_ms(nbytes(o, d, t_max, active, bvh.table, bvh.inst_mat) + out_bytes,
                        (nodes + leaves_) * OPS_ITER + nodes * OPS_NODE
                        + leaves_ * OPS_LEAF), None,
               same and int(kinc) == 0 and int(walk.incomplete) == 0,
               lanes=o.shape[0], active=int(active.sum()), node_visits=nodes,
               leaf_visits=leaves_, incomplete=int(kinc),
               tolerance="ids, steps and found identical; t within 1e-6 relative",
               **extra)
    del inputs

    # ------------------------------------------------------ 6. small-input check
    sdesc, scfg = scenes.config3_sponza(64, 36, target_triangles=20_000)
    spacked = ScenePacker(sdesc, 64, 36).frame()
    on_card = renderer.Renderer(scfg, device="cuda")
    gimg, gstats = on_card(on_card.upload(spacked))
    on_cpu = renderer.Renderer(scfg, device="cpu")
    cimg, cstats = on_cpu(on_cpu.upload(spacked))
    gcount = {k: int(v) for k, v in gstats._asdict().items()}
    ccount = {k: int(v) for k, v in cstats._asdict().items()}
    d = (gimg.cpu() - cimg).abs()
    mean_abs = float(d.mean())
    frac_1e3 = float((d.amax(dim=-1) <= 1e-3).float().mean())
    # The elementwise torch between the kernels rounds differently on the card
    # (rsqrt, transcendental functions) and shadow rays start ON surfaces, so a
    # marginal shadow decision may flip: the shadow count may differ by 0.5%.
    shadow_rel = abs(gcount["num_shadow"] - ccount["num_shadow"]) / max(ccount["num_shadow"], 1)
    small_ok = (all(gcount[k] == ccount[k] for k in gcount if k != "num_shadow")
                and shadow_rel <= 5e-3 and mean_abs <= 1e-3 and frac_1e3 >= 0.99
                and bool(torch.isfinite(gimg).all()))
    emit("small_input", config="config3_sponza", width=64, height=36, triangles=20_000,
         counters_cuda=gcount, counters_cpu=ccount, image_mean_abs_diff=mean_abs,
         frac_pixels_within_tolerance=frac_1e3, passed=small_ok,
         tolerance="counters equal (shadow within 0.5%); mean abs <= 1e-3; "
                   ">= 99% of pixels within 1e-3")
    ok = ok and small_ok

    # the same scene fwd+bwd (zero target, all 17 fields), card against CPU
    sgrads, slosses = [], []
    for r in (on_card, on_cpu):
        sscene = r.upload(spacked)
        sparams = train.extract_params(sscene)
        sloss = train.render_loss(sparams, sscene,
                                  torch.zeros((36, 64, 3), device=r.device), scfg)
        sloss.backward()
        slosses.append(float(sloss.detach()))
        sgrads.append({k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                       for k, p in sparams.items()})
    field_rel = {k: l2rel(sgrads[0][k], c) if float(c.norm()) > 0
                 else float(sgrads[0][k].norm()) for k, c in sgrads[1].items()}
    loss_rel = abs(slosses[0] - slosses[1]) / slosses[1]
    grads_ok = (all(bool(torch.isfinite(g).all()) for g in sgrads[0].values())
                and loss_rel <= 1e-3
                and all(v <= SMALL_GRAD_TOL.get(k, SMALL_GRAD_TOL["*"])
                        for k, v in field_rel.items()))
    emit("small_input_grads", config="config3_sponza", width=64, height=36,
         loss_cuda=slosses[0], loss_cpu=slosses[1], loss_rel=loss_rel,
         l2_rel_per_field=field_rel, passed=grads_ok,
         tolerance=f"loss within 1e-3; per-field l2-relative {SMALL_GRAD_TOL}")
    ok = ok and grads_ok

    # ------------------------------------------------------------- 7. result lines
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
