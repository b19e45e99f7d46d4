"""Sharded rendering: pixels over the ranks of a mesh, scene replicated
(counterpart of ``raytracer_tpu/parallel/shard.py``).

The reference's tile work-stealing scheduler (WorkerThread.cpp:49-69) becomes a
fixed round-robin assignment: each rank renders the pixels
``strided_pixel_permutation`` gives its shard through ``render_pixels``, as one
wavefront; rendering needs no cross-ray communication (SURVEY.md 2.3), so the
frame's only collectives are one all-gather of the ``[n,3]`` slices, which
every rank assembles into the whole image, and one all-reduce of the ray
counters (the analog of WorkerThreads::sum_performance_stats,
WorkerThread.cpp:131-148).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..render import renderer
from . import collectives
from .mesh import shard_slots


def axes_group(mesh, axes):
    """(process group, number of shards) of the mesh dimensions ``axes``: one
    named dimension, or all of them (the whole mesh)."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    n_shards = int(np.prod([mesh.size(names.index(a)) for a in axes]))
    if len(axes) == 1:
        return mesh.get_group(axes[0]), n_shards
    if sorted(axes) == sorted(names):
        return collectives.whole_group(mesh), n_shards
    raise ValueError(f"axes {axes}: one dimension of the mesh, or all of {names}")


class PixelShards:
    """This rank's pixels of a strided split over a group, and the image's
    assembly from every rank's slice."""

    def __init__(self, cfg: RenderConfig, group, n_shards: int):
        self.cfg, self.group = cfg, group
        slots, inverse = shard_slots(cfg.num_pixels, n_shards)
        self._host = (slots[dist.get_rank(group)], inverse)
        self._on = {}  # device -> (pixels, inverse) tensors

    def _tensors(self, device):
        if device not in self._on:
            self._on[device] = tuple(torch.from_numpy(a).to(device) for a in self._host)
        return self._on[device]

    def pixels(self, device) -> torch.Tensor:
        """[m] int32 global pixel indices this rank renders (-1: padding)."""
        return self._tensors(device)[0]

    def image(self, rgb: torch.Tensor) -> torch.Tensor:
        """[H,W,3] from this rank's [m,3] slice: one all-gather; padded slots
        are never read."""
        every = collectives.all_gather(rgb, self.group).reshape(-1, 3)
        inverse = self._tensors(rgb.device)[1]
        return every.index_select(0, inverse).reshape(self.cfg.height, self.cfg.width, 3)

    def sum_stats(self, stats):
        """The counters summed over the group: one all-reduce."""
        summed = collectives.all_reduce_sum(torch.stack(list(stats)), self.group)
        return type(stats)(*summed.unbind())


def make_sharded_renderer(cfg: RenderConfig, mesh, axes=None):
    """Returns run(scene) -> ([H,W,3] image, RenderStats) with pixels sharded over
    ``axes`` of ``mesh`` (default: all of them); every rank of the mesh calls it
    with the same scene and gets the whole image and the summed counters."""
    px = PixelShards(cfg, *axes_group(mesh, axes if axes is not None else mesh.mesh_dim_names))

    def run(scene):
        with torch.no_grad():
            rgb, stats = renderer.render_pixels(scene, cfg, px.pixels(scene.cam_pos.device))
            return px.image(rgb), px.sum_stats(stats)

    return run
