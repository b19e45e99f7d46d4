"""Process-group set-up (counterpart of ``raytracer_tpu/parallel/distributed.py``).

The JAX package initialises ``jax.distributed`` from its cluster variables; the
port initialises ``torch.distributed`` from torchrun's (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) or from arguments,
and stays single-process when it is given neither, so the same entry points
work everywhere.  The backend is ``nccl`` on the card and ``gloo`` where the
caller asks for it (the CPU, or several ranks sharing one card); asking for
``nccl`` without CUDA raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import devices
from .mesh import make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, local_rank: int | None = None,
               backend: str | None = None, device=None) -> int:
    """Join the process group if the environment or the arguments call for it.

    Returns this process's rank (0 when it stays single-process).  Arguments
    left out are read from torchrun's variables; ``init_method`` defaults to
    ``tcp://MASTER_ADDR:MASTER_PORT`` and may be any ``torch.distributed`` URL
    (``file://`` for a ``FileStore``).  ``device`` is ``cuda`` unless the
    caller asks for the CPU; on the card the process is pinned to
    ``cuda:LOCAL_RANK``.  ``backend`` defaults to ``nccl`` on the card and
    ``gloo`` on the CPU."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "0") or 0)
    if init_method is None or not world_size:
        return 0
    rank = int(env.get("RANK", "0")) if rank is None else rank
    dev = devices.resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: nccl needs a CUDA device; pass backend='gloo' "
                           "and device='cpu' to run on the CPU")
    if dev.type == "cuda":
        local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return rank


def global_mesh(shape=None, axis_names=("dp", "sp"), device_type: str | None = None):
    """``make_mesh`` over all ranks of the process group."""
    return make_mesh(shape, axis_names, device_type)
