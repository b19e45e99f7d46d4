"""Differentiable rendering: losses, parameter extraction and train steps
(counterpart of ``raytracer_tpu/diff/train.py``).

Pixel gradients flow to materials, lights, textures, sky and camera.  Traversal
is discrete (the renderer detaches its inputs); hit attributes are re-derived
differentiably from the hit ids (``render/renderer.py:_mesh_hits_into``).  On the
card the hit reconstruction's, the texture's and the sky's gradients are the
hand-written kernels K7 bwd, K4 and K5 bwd (``ops/hits.MeshHits``,
``ops/texture_sample.TextureSample``, ``ops/sky_sample.SkySample``); everything
else is torch autograd.

Parameters are a ``torch.nn.ParameterDict`` of leaf tensors that require grad;
the optimizer is a ``torch.optim`` optimizer over them (default Adam, whose
defaults are optax.adam's: betas 0.9 / 0.999, eps 1e-8 outside the square root).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import RenderConfig
from ..render import renderer

# DeviceScene fields that are meaningfully differentiable scene parameters.
DIFFERENTIABLE_FIELDS = (
    "mat_diffuse",
    "mat_reflection",
    "mat_transmittance",
    "mat_ior",
    "tex_data",
    "sky_data",
    "pl_pos",
    "pl_colour",
    "sl_pos",
    "sl_colour",
    "dl_colour",
    "dl_neg_dir",
    "cam_pos",
    "cam_top_left",
    "cam_x",
    "cam_y",
    "ambient",
)


def extract_params(scene, fields=DIFFERENTIABLE_FIELDS) -> torch.nn.ParameterDict:
    """The fields as leaf tensors that require grad: copies, so an optimizer's
    in-place updates never write into ``scene``."""
    return torch.nn.ParameterDict(
        {f: torch.nn.Parameter(getattr(scene, f).detach().clone()) for f in fields}
    )


def apply_params(scene, params):
    return scene._replace(**dict(params.items()))


def image_loss(img, target):
    """Mean squared error in linear radiance."""
    return torch.mean((img - target) ** 2)


def render_loss(params, scene, target, cfg: RenderConfig, pixel_idx=None):
    scene = apply_params(scene, params)
    if pixel_idx is None:
        img, _ = renderer.render_with_stats(scene, cfg)
        return image_loss(img, target)
    rgb, _ = renderer.render_pixels(scene, cfg, pixel_idx)
    return image_loss(rgb, target)


def make_accum_grad_fn(cfg: RenderConfig, chunk: int | None = None):
    """Chunked fwd+bwd: one backward pass per strided pixel chunk, gradients
    summed and scaled once.  Memory is bounded by the chunk's graph, not the
    frame's.

    Chunk c takes pixels c, c + n_chunks, ... (as ``render_pixels`` strides them
    in the JAX package), the last chunk padded with -1 lanes that trace nothing.
    Returns ``fn(params, scene, target) -> (loss, grads {field: tensor},
    RenderStats)`` with the whole-frame MSE and its gradients.
    """
    chunk = chunk or cfg.traversal_chunk

    def fn(params, scene, target):
        n = cfg.num_pixels
        n_chunks = -(-n // chunk)
        dev = target.device
        idx = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                         torch.full((n_chunks * chunk - n,), -1, dtype=torch.int32,
                                    device=dev)])
        idx_chunks = idx.reshape(chunk, n_chunks).t()
        target_flat = target.reshape(-1, 3)
        names = list(params.keys())
        leaves = [params[k] for k in names]
        bvh = (renderer._traversal_module(cfg).build_scene_bvh(scene)
               if scene.n_instances > 0 else None)
        loss, grads, stats = None, None, None
        for c in range(n_chunks):
            pixel_idx = idx_chunks[c].contiguous()
            rgb, st = renderer.render_wavefront(apply_params(scene, params), cfg,
                                                pixel_idx, bvh=bvh)
            tgt = target_flat.index_select(0, torch.clamp_min(pixel_idx, 0))
            valid = (pixel_idx >= 0)[:, None]
            s = torch.sum(torch.where(valid, (rgb - tgt) ** 2, 0.0))
            g = torch.autograd.grad(s, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]
            s = s.detach()
            loss = s if loss is None else loss + s
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            stats = st if stats is None else type(st)(*(a + b for a, b in zip(stats, st)))
        scale = 1.0 / (n * 3)
        return loss * scale, {k: x * scale for k, x in zip(names, grads)}, stats

    return fn


def make_train_step(cfg: RenderConfig,
                    optimizer: Callable[..., torch.optim.Optimizer] | None = None,
                    fields=DIFFERENTIABLE_FIELDS):
    """Adam train step over the differentiable scene parameters (one device).

    ``optimizer`` makes a ``torch.optim`` optimizer from an iterable of
    parameters (default ``Adam(lr=1e-2)``).  Returns ``(init, step)``:
    ``init(scene) -> (params, opt)``; ``step(params, opt, scene, target) ->
    (params, opt, loss)``, which updates ``params`` in place and returns the
    loss before the update, as the JAX step does.
    """
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-2))

    def init(scene):
        params = extract_params(scene, fields)
        return params, make_opt(params.values())

    def step(params, opt, scene, target):
        opt.zero_grad(set_to_none=True)
        loss = render_loss(params, scene, target, cfg)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return init, step


def _reduced_grads(params, loss, group, divide: float = 1.0):
    """Sum ``loss`` and every parameter's gradient over ``group`` in ONE
    all-reduce, divide by ``divide``, and leave the result in each ``.grad``;
    returns the reduced loss."""
    from ..parallel import collectives

    leaves = list(params.values())
    flat = torch.cat([loss.detach().reshape(1)] + [
        (torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1) for p in leaves])
    flat = collectives.all_reduce_sum(flat, group)
    if divide != 1.0:
        flat = flat / divide
    off = 1
    for p in leaves:
        p.grad = flat[off:off + p.numel()].reshape(p.shape).clone()
        off += p.numel()
    return flat[0]


def _local_loss(params, scene, target_flat, cfg, pixel_idx):
    """This rank's share of the frame's mean squared error: the sum over its
    pixels (padded lanes, -1, add nothing) scaled by 1/(num_pixels*3), so that
    the sum over the ranks is the whole frame's mean.  Scaling before the
    backward pass gives every lane the cotangent ``image_loss``'s mean gives
    it, so one rank reproduces ``make_train_step``'s gradients."""
    rgb, _ = renderer.render_pixels(apply_params(scene, params), cfg, pixel_idx)
    tgt = target_flat.index_select(0, torch.clamp_min(pixel_idx, 0))
    valid = (pixel_idx >= 0)[:, None]
    return torch.sum(torch.where(valid, (rgb - tgt) ** 2, 0.0)) * (1.0 / (cfg.num_pixels * 3))


def make_sharded_train_step(cfg: RenderConfig, mesh, axes=None,
                            optimizer: Callable[..., torch.optim.Optimizer] | None = None,
                            fields=DIFFERENTIABLE_FIELDS):
    """Multi-rank fwd+bwd step: pixels sharded over ``axes`` of ``mesh`` (default
    all), scene parameters replicated, each rank's loss its pixels' share of
    the frame's mean, the loss and every parameter gradient summed over the
    ranks (the collective inventory of SURVEY.md 2.3/5.8; here one all-reduce
    of them all).

    Returns ``(init, step)`` as ``make_train_step``: ``init(scene) -> (params,
    opt)``; ``step(params, opt, scene, target) -> (params, opt, loss)``, the loss
    before the update.  Every rank calls both with the same scene and target."""
    from ..parallel.shard import PixelShards, axes_group

    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-2))
    group, n_shards = axes_group(mesh, axes if axes is not None else mesh.mesh_dim_names)
    px = PixelShards(cfg, group, n_shards)

    def init(scene):
        params = extract_params(scene, fields)
        return params, make_opt(params.values())

    def step(params, opt, scene, target):
        opt.zero_grad(set_to_none=True)
        local = _local_loss(params, scene, target.reshape(-1, 3), cfg, px.pixels(target.device))
        local.backward()
        loss = _reduced_grads(params, local, group)
        opt.step()
        return params, opt, loss

    return init, step


def make_tensor_parallel_train_step(cfg: RenderConfig, mesh, dp_axis="dp", sp_axis="sp",
                                    optimizer: Callable[..., torch.optim.Optimizer]
                                    | None = None, fields=DIFFERENTIABLE_FIELDS):
    """Fwd+bwd step with pixels sharded over ``dp_axis`` AND triangle geometry
    over ``sp_axis`` (parallel/scene_shard.py).

    Scene parameters (materials/lights/camera/textures/sky) are replicated —
    they are identical across scene shards by construction (split_description
    shares the material buffer).  Every sp member computes the loss over its
    dp-shard of pixels redundantly (shading is post-combine), and BOTH gradient
    paths — the shading path on each member and the hit-reconstruction path
    flowing back through the all-gather to the winning shard — appear once in
    every member's loss, so the sum over dp averaged over sp is exactly the
    single-device gradient.  ``init(scene)`` takes the parameters from this
    rank's own shard scene; ``step(params, opt, scene, target)`` as
    ``make_train_step``."""
    from ..parallel import collectives
    from ..parallel.shard import PixelShards

    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-2))
    names = tuple(mesh.mesh_dim_names)
    dp, sp = mesh.size(names.index(dp_axis)), mesh.size(names.index(sp_axis))
    every = collectives.whole_group(mesh)
    cfg_sp = cfg.replace(scene_shard_axis=sp_axis)
    px = PixelShards(cfg, mesh.get_group(dp_axis), dp)

    def init(scene):
        params = extract_params(scene, fields)
        return params, make_opt(params.values())

    def step(params, opt, scene, target):
        opt.zero_grad(set_to_none=True)
        with collectives.mesh_axes(mesh):
            local = _local_loss(params, scene, target.reshape(-1, 3), cfg_sp,
                                px.pixels(target.device))
            local.backward()
        # psum over dp, then pmean over sp: the sum over every rank over sp
        loss = _reduced_grads(params, local, every, float(sp))
        opt.step()
        return params, opt, loss

    return init, step
