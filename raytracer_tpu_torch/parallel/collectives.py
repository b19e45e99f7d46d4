"""The parallel layer's collectives, counted.

Every collective of the port goes through here, so ``counts`` is its whole
inventory (the JAX package audits its lowered programs for the same,
``tests/test_collectives.py``).  Tensors go to the backend as they are: a
``gloo`` group (several ranks sharing one card, where ``nccl`` refuses) takes
CUDA tensors itself.

The renderer finds the scene-shard group from ``RenderConfig.scene_shard_axis``,
a string, which keeps the config hashable: ``mesh_axes(mesh)`` makes the named
dimensions of one mesh the ones ``group`` returns, for the calls made inside
it and nowhere else (the sharded renderer and train step enter it around
each frame and step).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

counts = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}
_axes: contextvars.ContextVar = contextvars.ContextVar("mesh_axes", default=None)


def reset() -> None:
    for k in counts:
        counts[k] = 0


@contextlib.contextmanager
def mesh_axes(mesh):
    """Inside the block, ``group(name)`` is the group of ``mesh``'s dimension
    ``name``; the mesh active before is restored on leaving."""
    token = _axes.set({name: mesh.get_group(name) for name in mesh.mesh_dim_names})
    try:
        yield
    finally:
        _axes.reset(token)


def group(axis: str):
    """The process group of a named dimension of the active mesh."""
    axes = _axes.get()
    if axes is None:
        raise RuntimeError(f"mesh axis {axis!r} is used outside a mesh; render through "
                           "make_primitive_sharded_renderer or make_tensor_parallel_train_step")
    try:
        return axes[axis]
    except KeyError:
        raise KeyError(f"the active mesh has no axis {axis!r} (it has {sorted(axes)})") from None


def whole_group(mesh):
    """The group of every rank of ``mesh``, which must cover the process group."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must cover every rank of the process group")
    return dist.group.WORLD


def all_reduce_sum(x: torch.Tensor, g) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (a new tensor; no autograd)."""
    counts["all_reduce"] += 1
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=g)
    return y


def _gather(x: torch.Tensor, g) -> torch.Tensor:
    counts["all_gather"] += 1
    src = x.detach().contiguous()
    n = dist.get_world_size(g)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=g)
    return out.view((n,) + tuple(src.shape))


def _reduce_scatter_sum(x: torch.Tensor, g) -> torch.Tensor:
    """This rank's slice along dim 0 of the sum of ``x`` [S, ...] over the
    group's S ranks (JAX's ``psum_scatter``)."""
    counts["reduce_scatter"] += 1
    src = x.contiguous()
    out = src.new_empty(tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src.view((-1,) + tuple(src.shape[2:])), group=g)
    return out


class _AllGather(torch.autograd.Function):
    """[S, ...] of every rank's ``x``; the backward sums each rank's cotangent
    for its own slice over the group (the transpose of an all-gather: one
    reduce-scatter), so a gradient reaches the rank whose record won.
    ``torch.distributed.nn.functional.all_gather`` computes the same
    (tests/test_torch_parallel.py holds the two equal) but is deprecated and
    counts nothing."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_sum(grad, ctx.g), None


def all_gather(x: torch.Tensor, g) -> torch.Tensor:
    """[S, ...] stack of ``x`` from every rank of the group, in group-rank
    order; differentiable in ``x``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, g)
    return _gather(x, g)
