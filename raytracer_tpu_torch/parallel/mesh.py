"""Device meshes over the process group, and the strided pixel assignment.

The JAX package shards pixels over a ``jax.sharding.Mesh`` (``shard_map``); the
port runs one process a device and names the ranks' layout with a
``torch.distributed.device_mesh.DeviceMesh``, whose named dimensions give their
sub-groups (``mesh.get_group("sp")``).  ``strided_pixel_permutation`` is the JAX
package's numpy function, copied.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(shape: tuple | None = None, axis_names: tuple = ("dp", "sp"),
              device_type: str | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the initialised process group, in
    rank order (``distributed.initialize`` first).

    shape: per-axis sizes; defaults to (world size, 1, ...) folded to
    len(axis_names).  ``device_type`` is ``cuda`` unless the caller asks for
    ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.initialize first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"make_mesh: shape {shape} does not hold the group's {n} ranks")
    return DeviceMesh(device_type or "cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def strided_pixel_permutation(num_pixels: int, num_shards: int) -> np.ndarray:
    """Permutation assigning pixels round-robin to shards for load balance.

    Contiguous tile sharding load-imbalances (sky rows vs geometry rows); striding
    interleaves so every shard sees a statistically identical workload (SURVEY.md 7,
    'Multi-host efficiency' hard part).  Returns idx [num_pixels_padded] such that
    shard k renders pixels idx[k*m:(k+1)*m].
    """
    pad = (-num_pixels) % num_shards
    total = num_pixels + pad
    idx = np.arange(total)
    # pixel p goes to shard p % num_shards, preserving order within a shard
    idx = idx.reshape(total // num_shards, num_shards).T.reshape(-1)
    # padded slots point at pixel 0 (their output is discarded)
    idx = np.where(idx < num_pixels, idx, 0)
    return idx.astype(np.int32)


def shard_slots(num_pixels: int, num_shards: int):
    """(slots [num_shards, m] int32, inverse [num_pixels] int64): row k holds the
    pixels shard k renders, as ``strided_pixel_permutation`` assigns them, with
    the padded slots set to -1 (lanes that trace nothing and add nothing: the
    renderer's padding) instead of pixel 0; ``inverse[p]`` is pixel p's slot in
    the flattened rows."""
    total = num_pixels + (-num_pixels) % num_shards
    slots = np.arange(total).reshape(-1, num_shards).T.reshape(-1)
    slots = np.where(slots < num_pixels, slots, -1)
    inverse = np.empty(num_pixels, np.int64)
    inverse[slots[slots >= 0]] = np.flatnonzero(slots >= 0)
    return slots.astype(np.int32).reshape(num_shards, -1), inverse
