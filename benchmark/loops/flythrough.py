"""Forward frames in a closed loop, the camera flying along the scene's path.

The scene stays on the card; each frame only the camera moves: its four fields
(``cam_pos``, ``cam_top_left``, ``cam_x``, ``cam_y``) are replaced on the
uploaded ``DeviceScene``, from the program's ``Camera.device_arrays()`` as
``ScenePacker.frame()`` maps them (computed for every pose in set-up).  A frame is
``Renderer.__call__`` and a scalar read of its image on the host.

Mix parameters: ``poses`` (the cycle of poses spaced evenly over the whole
path, each at the middle of its interval; the seed sets the pose the window
starts at, so every seed renders the same poses in another order),
``warmup_frames``,
``check_first_within`` (the first frame judged is drawn from the seed among
these; the window's last frame is judged too), ``check_pixels`` (pixels drawn
from the seed in each judged frame), ``pixel_tol`` and ``limits``.  The rays
lost (``num_dropped`` + ``num_incomplete``) and the primary rays are counted over
every frame of the window.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .. import program
from ..reference import compare
from ..reference.render import Reference

_CAMERA = {"cam_pos": "cam_position", "cam_top_left": "cam_top_left",
           "cam_x": "cam_x_axis", "cam_y": "cam_y_axis"}


class Loop:
    def __init__(self, config, mix, seed, device, tracer):
        self.config, self.mix, self.device, self.tracer = config, mix, device, tracer
        self.rng = np.random.default_rng(seed)
        self.kept = {}
        self.counters = []  # every frame's RenderStats of the window

    def setup(self):
        from raytracer_tpu_torch.render.renderer import Renderer
        from raytracer_tpu_torch.scene.device import ScenePacker

        c = self.config
        scene_mod = importlib.import_module(f"benchmark.yardstick.scenes.{c['scene']}")
        self.raw = scene_mod.build(c)
        desc = program.description(self.raw, c["program_scene"])
        self.cfg = program.render_config(c)
        packer = ScenePacker(desc, self.cfg.width, self.cfg.height)
        self.rend = Renderer(self.cfg, device=self.device)
        self.scene = self.rend.upload(packer.frame())
        self.poses = scene_mod.camera_path(int(self.mix["poses"]), 0.5)
        self.start = int(self.rng.integers(0, len(self.poses)))
        arrays = []
        for position, rotation in self.poses:
            desc.camera.position, desc.camera.rotation = position, rotation
            arrays.append(desc.camera.device_arrays())
        self.cams = {f: torch.from_numpy(np.stack([a[k] for a in arrays])).to(self.rend.device)
                     for f, k in _CAMERA.items()}
        self.first = int(self.rng.integers(0, int(self.mix["check_first_within"])))
        for i in range(int(self.mix["warmup_frames"])):
            self._render(i)

    def _render(self, i):
        k = (self.start + i) % len(self.poses)
        with self.tracer.span("render"):
            image, stats = self.rend(self.scene._replace(
                **{f: v[k] for f, v in self.cams.items()}))
        float(image.sum())  # the frame ends on a read of its image on the host
        return k, image, stats

    def frame(self, i):
        k, image, stats = self._render(i)
        self.counters.append(stats)
        if i == self.first:
            self.kept["first"] = (i, k, image, stats)
        self.kept["last"] = (i, k, image, stats)

    def profile_from(self, after: int) -> int:
        """The first frame from ``after`` on that shows the path's first pose, so
        that every seed profiles the same poses."""
        return after + (-(self.start + after)) % len(self.poses)

    def release(self):
        del self.scene, self.rend, self.cams

    def check(self, control=False):
        c, mix = self.config, self.mix
        ref = Reference(self.raw, c, self.device)
        low = Reference(self.raw, c, self.device, dtype=torch.bfloat16) if control else None
        n_pixels = int(c["resolution"][0]) * int(c["resolution"][1])
        lost, primary = compare.lost_rays(self.counters, n_pixels)
        off = 0.0
        judged = {v[0]: v for v in self.kept.values()}  # the first may be the last
        for i, k, image, _ in judged.values():
            pixels = compare.sample_pixels(self.rng, n_pixels, int(mix["check_pixels"]))
            want = ref.render(ref.camera(*self.poses[k]), pixels)
            if low is None:
                got = image.reshape(-1, 3)[pixels.to(image.device)]
            else:
                got = low.render(low.camera(*self.poses[k]), pixels)
            off = max(off, compare.share_off(got, want, float(mix["pixel_tol"])))
        return [("pixels_off", off, mix["limits"]["pixels_off"]),
                ("rays_lost", lost, 0), ("primary_missing", primary, 0)]
