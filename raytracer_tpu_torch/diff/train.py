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
