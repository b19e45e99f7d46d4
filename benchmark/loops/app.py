"""The app's frame loop (``raytracer_tpu_torch/app.py``) in a closed loop, without
its PNG sink.  Each frame:

1. ``SceneDescription.update(dt)`` (the program's animation), then
   ``ScenePacker.frame()`` (the TLAS rebuilt on the host), then
   ``Renderer.upload`` (span ``app.host``);
2. the render (``render``), then ``present`` (FXAA, K8; ``present``);
3. the presented image copied to host memory, what the reference's blit shows
   (``readback``).

Mix parameters: ``dt`` (the animation's step a frame), ``start_period`` (the seed
sets the animation's start time within it), ``warmup_frames``,
``check_first_within``, ``check_pixels``, ``pixel_tol`` and ``limits``.  The rays
lost and the primary rays are counted over every frame of the window.
"""

from __future__ import annotations

import copy
import importlib

import numpy as np
import torch

from .. import program
from ..reference import compare
from ..reference import fxaa as ref_fxaa
from ..reference.render import Reference
from ..yardstick import geometry


class Loop:
    def __init__(self, config, mix, seed, device, tracer):
        self.config, self.mix, self.device, self.tracer = config, mix, device, tracer
        self.rng = np.random.default_rng(seed)
        self.kept = {}
        self.counters = []  # every frame's RenderStats of the window

    def setup(self):
        from raytracer_tpu_torch.render.renderer import Renderer, present
        from raytracer_tpu_torch.scene.device import ScenePacker

        c = self.config
        self.scene_mod = importlib.import_module(f"benchmark.yardstick.scenes.{c['scene']}")
        self.raw = self.scene_mod.build(c)
        self.start = copy.deepcopy(self.raw.instances), self.raw.time
        self.desc = program.description(self.raw, c["program_scene"])
        self.cfg = program.render_config(c)
        self.present = present
        self.packer = ScenePacker(self.desc, self.cfg.width, self.cfg.height)
        self.rend = Renderer(self.cfg, device=self.device)
        self.dt = float(self.mix["dt"])
        t0 = float(self.rng.random()) * float(self.mix["start_period"])
        self.desc.update(t0)
        self.deltas = [t0]  # every step the program's animation has taken
        self.first = int(self.rng.integers(0, int(self.mix["check_first_within"])))
        for _ in range(int(self.mix["warmup_frames"])):
            self._frame()

    def _frame(self):
        t = self.tracer
        with t.span("app.host"):
            self.desc.update(self.dt)
            self.deltas.append(self.dt)
            packed = self.packer.frame()
            scene = self.rend.upload(packed)
        with t.span("render"):
            image, stats = self.rend(scene)
        with t.span("present"):
            shown = self.present(image, self.cfg)
        with t.span("readback"):
            host = shown.cpu().numpy()
        return packed.inst_world, image, stats, host

    def frame(self, i):
        got = self._frame()
        self.counters.append(got[2])
        out = (len(self.deltas), *got)  # the animation steps this frame shows
        if i == self.first:
            self.kept["first"] = out
        self.kept["last"] = out

    def release(self):
        del self.rend, self.packer, self.desc

    def _instances(self, steps: int, dtype=np.float64) -> list:
        """The reference's instances after the first ``steps`` animation steps,
        their state held in ``dtype`` (float64, as the program states it; the
        control holds it in float32)."""
        raw = copy.copy(self.raw)
        raw.instances, raw.time = copy.deepcopy(self.start[0]), self.start[1]
        for delta in self.deltas[:steps]:
            self.scene_mod.animate(raw, delta)
            for inst in raw.instances:
                inst.position = np.asarray(inst.position, dtype)
                inst.rotation = np.asarray(inst.rotation, dtype)
        return raw.instances

    @staticmethod
    def _world(instances) -> np.ndarray:
        """[N, 3, 4] world matrices, in float64."""
        return np.stack([geometry.compose(i.position, i.rotation)[:3, :4]
                         for i in instances])

    def check(self, control=False):
        c, mix = self.config, self.mix
        ref = Reference(self.raw, c, self.device)
        low = Reference(self.raw, c, self.device, dtype=torch.bfloat16) if control else None
        cam = ref.camera(self.raw.camera_position, self.raw.camera_rotation)
        n_pixels = int(c["resolution"][0]) * int(c["resolution"][1])
        inst_err = off = present_err = 0.0
        lost, primary = compare.lost_rays(self.counters, n_pixels)
        judged = {v[0]: v for v in self.kept.values()}  # the first may be the last
        for steps, inst_world, image, _, host in judged.values():
            instances = self._instances(steps)
            if low is not None:  # the control: state held in float32, bfloat16 pixels
                inst_world = self._world(self._instances(steps, np.float32)).astype(np.float32)
            inst_err = max(inst_err, compare.ulps32(inst_world, self._world(instances)))
            ref.set_instances(instances)
            pixels = compare.sample_pixels(self.rng, n_pixels, int(mix["check_pixels"]))
            want = ref.render(cam, pixels)
            if low is None:
                got = image.reshape(-1, 3)[pixels.to(image.device)]
            else:
                low.set_instances(instances)
                got = low.render(low.camera(self.raw.camera_position, self.raw.camera_rotation),
                                 pixels)
                host = ref_fxaa.fxaa(image.to(torch.bfloat16)).float().cpu().numpy()
            off = max(off, compare.share_off(got, want, float(mix["pixel_tol"])))
            presented = ref_fxaa.fxaa(image.float())
            present_err = max(present_err, compare.max_abs(host, presented.cpu().numpy()))
        lim = mix["limits"]
        return [("instance_err", inst_err, lim["instance_err"]),
                ("pixels_off", off, lim["pixels_off"]),
                ("present_err", present_err, lim["present_err"]),
                ("rays_lost", lost, 0), ("primary_missing", primary, 0)]
