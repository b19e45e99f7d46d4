"""Headless frame-loop application (the Main.cpp analog), on the port.

The reference's game loop (Main.cpp:51-118) is: scene.update(dt) -> wake workers
over tiles -> barrier -> blit + FXAA -> timing + MRays/s panel -> swap.  Here:
host-side animation + per-frame TLAS rebuild (``ScenePacker.frame()``) ->
upload -> wavefront render on the card -> optional FXAA post pass (K8) -> PNG
frames + one JSON metrics line per frame on stdout, with the JAX app's flags
and keys.

The JAX app re-renders a frame whose loss counters are nonzero at larger
capacities (``RobustRenderer``).  The port's queues are exact and its walks run
to the end, so a frame is lossless by construction: ``--no-lossless-retry`` is
accepted and changes nothing, and ``lossless_retry`` is always false.

``--trace-frames N`` runs ``torch.profiler`` over the first N frames and writes
``<out>/trace.json`` (``export_chrome_trace``): the program's ``rt.*`` spans
(``utils/trace.py``) beside the kernels, on one clock.

Usage:  python -m raytracer_tpu_torch.app --scene config4 --frames 10 --fxaa --out out/
        (``--cpu`` runs the plain PyTorch versions of the kernels on the CPU)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _rounded(metrics: dict) -> dict:
    return {k: round(v, 2) if isinstance(v, float) else v for k, v in metrics.items()}


def _write_trace(prof, out: str, frames: int) -> None:
    prof.stop()
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Wrote the trace of {frames} frame(s) to {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Whitted ray tracer, PyTorch + CUDA")
    ap.add_argument("--scene", default="config0", help="config0..config4")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--dt", type=float, default=1.0 / 60.0)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--bounces", type=int, default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--fxaa", action="store_true")
    ap.add_argument("--heatmap", action="store_true",
                    help="BVH traversal-step heatmap render (Config.h:23)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); default: cuda")
    ap.add_argument("--batch-frames", type=int, default=1,
                    help="animate and upload N frames, then render them together "
                    "(renderer.render_frames)")
    ap.add_argument("--no-lossless-retry", action="store_true",
                    help="accepted for the JAX app's command lines; the port is "
                    "lossless by construction, so there is nothing to retry")
    ap.add_argument("--trace-frames", type=int, default=0,
                    help="profile the first N frames and write OUT/trace.json (Chrome "
                    "trace format: the program's rt.* spans beside the kernels)")
    args = ap.parse_args(argv)

    import torch

    from .render import renderer
    from .scene import scenes
    from .scene.device import ScenePacker
    from .utils import image as image_util
    from .utils.stats import mrays_per_second
    from .utils.timer import FrameTimer, ScopeTimer

    desc, cfg = scenes.make_scene(args.scene)
    if args.width:
        cfg = cfg.replace(width=args.width)
    if args.height:
        cfg = cfg.replace(height=args.height)
    if args.bounces is not None:
        cfg = cfg.replace(num_bounces=args.bounces)
    cfg = cfg.replace(enable_fxaa=args.fxaa, visualize_heatmap=args.heatmap)

    with ScopeTimer("Scene build"):
        packer = ScenePacker(desc, cfg.width, cfg.height)
    print(f"Scene contains {desc.triangle_count} triangles.")

    rend = renderer.Renderer(cfg, device="cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    timer = FrameTimer()

    def host(t):
        return t.detach().cpu().numpy()

    # chunks of n frames (n = 1 unless --batch-frames): animate and upload each,
    # render them (render_frames), present the last; the clock ticks per chunk
    chunk = max(args.batch_frames, 1)
    frame = 0
    prof = None
    if args.trace_frames > 0:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if rend.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    while frame < args.frames:
        n = min(chunk, args.frames - frame)
        frames = []
        for _ in range(n):
            desc.update(args.dt)
            frames.append(rend.upload(packer.frame()))
        with torch.no_grad():
            imgs, stats_n = renderer.render_frames(frames, cfg)
            shown = renderer.present(imgs[n - 1], cfg)
        float(shown.sum())  # scalar readback: the frame clock waits for the card
        delta = timer.tick() / n
        for k in range(n):
            stats = renderer.RenderStats(*(c[k] for c in stats_n))
            keys = ({"batched": n} if chunk > 1
                    else {"fps_avg": round(timer.fps, 2), "lossless_retry": False})
            print(json.dumps({"frame": frame, "ms": round(delta * 1e3, 2), **keys,
                              **_rounded(mrays_per_second(stats, delta))}))
            # the line's keys are the JAX app's, which has no key for rays a
            # walk could not finish: a loss is told on stderr
            lost = int(stats.num_incomplete)
            if lost:
                print(f"frame {frame}: {lost} rays lost (num_incomplete: the wide walk's "
                      "stack overflowed the wide_stack_size set)", file=sys.stderr)
            image_util.save_png(os.path.join(args.out, f"frame_{frame:04d}.png"),
                                host(imgs[k]))
            frame += 1
        if prof is not None and frame >= args.trace_frames:
            _write_trace(prof, args.out, frame)
            prof = None
            timer.last = time.perf_counter()  # the export is no frame's time
    if prof is not None:  # fewer frames than --trace-frames
        _write_trace(prof, args.out, frame)
    # final frame also saved presented (gamma/FXAA applied)
    image_util.save_png(os.path.join(args.out, "final_presented.png"), host(shown),
                        gamma=False)
    print(f"Wrote {args.frames} frame(s) to {args.out}/")


if __name__ == "__main__":
    main()
