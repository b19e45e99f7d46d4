"""Texture filtering over the flat mip atlas (counterpart of
``raytracer_tpu/ops/texture_sample.py``), kernel K3.

Reference (clayne/CPU-Raytracer): Texture.cpp — bilinear (157-186) and anisotropic
(OpenGL EXT spec; 207-239).  Every lane carries its own texture id, so one call
filters the whole wavefront across all textures.

This slice ports what config3 runs: MIPMAP mode with the ANISOTROPIC filter.
``sample`` launches ``csrc/texture.cu`` (K3) for CUDA tensors and runs
``sample_plain`` for CPU tensors; its gradient on the card is
``csrc/texture_bwd.cu`` (K4, ``TextureSample``), on the CPU autograd of
``sample_plain``.  NEAREST, BILINEAR, TRILINEAR and EWA raise
``NotImplementedError``: they are still to be ported (ROADMAP.md queue B, K3).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import MipmapFilter, RenderConfig, TextureSampleMode

# rt_texture_aniso (K3) and rt_texture_aniso_bwd (K4) launches (reset and read by
# chip_smoke.py)
launches = 0
bwd_launches = 0

_NOT_PORTED = (
    "texture filtering mode {} is not ported yet: only MIPMAP + ANISOTROPIC "
    "(ROADMAP.md queue B, K3: NEAREST/TRILINEAR/EWA texture kernels)"
)


def expand_quads(tex) -> torch.Tensor:
    """[X,12] quad-row atlas: each row holds a texel's full 2x2 bilinear footprint
    (wrap baked into tex.quad_idx at pack time), so one tap reads ONE row.
    Scene-only: the renderer builds it once per frame.  A torch gather, so its
    autograd carries the [X,12] row gradient back to tex data, as the transpose
    of ``jnp.take`` does in JAX."""
    data, _w, _h, _l, _o, quad = tex
    return data[quad.reshape(-1).long()].reshape(-1, 12)


def _sample_bilinear(tex, tex_id, s, t, level, data4):
    """Texture.cpp:157-186 through the quad atlas. level: [N] int32."""
    _, width, height, _, offsets, _ = tex
    lwi = torch.clamp_min(width[tex_id] >> level, 1)
    lhi = torch.clamp_min(height[tex_id] >> level, 1)
    lw = lwi.to(torch.float32)
    lh = lhi.to(torch.float32)
    ss = s * lw - 0.5
    tt = t * lh - 0.5
    fs = ss - torch.floor(ss)
    ft = tt - torch.floor(tt)
    w0 = (1.0 - fs) * (1.0 - ft)
    w1 = fs * (1.0 - ft)
    w2 = (1.0 - fs) * ft
    w3 = 1.0 - w0 - w1 - w2
    x0 = torch.floor(ss).to(torch.int32)
    y0 = torch.floor(tt).to(torch.int32)
    x = torch.remainder(x0, lwi)
    y = torch.remainder(y0, lhi)
    q = data4[(offsets[tex_id, level] + x + y * lwi).long()]
    return (
        w0[:, None] * q[:, 0:3]
        + w1[:, None] * q[:, 3:6]
        + w2[:, None] * q[:, 6:9]
        + w3[:, None] * q[:, 9:12]
    )


def _top_texel(tex, tex_id):
    """fetch_texel(0, 0, last_mip): the 1x1 coarsest level."""
    data, _, _, levels, offsets, _ = tex
    return data[offsets[tex_id, levels[tex_id] - 1].long()]


def _sample_anisotropic(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy,
                        max_anisotropy: float, data4, base, top):
    """OpenGL-EXT-style anisotropic filtering (Texture.cpp:207-239): up to N probes
    along the major axis at a sharper mip level."""
    _, _, _, levels, _, _ = tex
    lv = levels[tex_id]
    lf = lv.to(torch.float32)
    p_x = torch.maximum(torch.abs(ds_dx), torch.abs(dt_dx))
    p_y = torch.maximum(torch.abs(ds_dy), torch.abs(dt_dy))
    p_min = torch.minimum(p_x, p_y)
    p_max = torch.maximum(p_x, p_y)

    n = torch.clamp_max(torch.ceil(p_max / torch.clamp_min(p_min, 1e-20)), max_anisotropy)
    n = torch.clamp_min(n, 1.0)
    lam = lf - 1.0 + torch.log2(torch.clamp_min(p_max / n, 1e-20))
    level = torch.round(lam).to(torch.int32)  # half to even, as jnp.round
    level_c = torch.minimum(torch.clamp_min(level, 0), lv - 1)

    x_major = p_x > p_y
    step_s = torch.where(x_major, ds_dx, ds_dy)
    step_t = torch.where(x_major, dt_dx, dt_dy)
    inv_np1 = 1.0 / (n + 1.0)

    acc = torch.zeros((s.shape[0], 3), dtype=s.dtype, device=s.device)
    for i in range(1, int(max_anisotropy) + 1):
        fi = float(i)
        use = fi <= n + 0.001
        x = s + step_s * (fi * inv_np1 - 0.5)
        y = t + step_t * (fi * inv_np1 - 0.5)
        tap = _sample_bilinear(tex, tex_id, x, y, level_c, data4)
        acc = acc + torch.where(use[:, None], tap, 0.0)
    aniso = acc / n[:, None]

    out = torch.where((level < 0)[:, None], base, aniso)
    return torch.where((level >= lv - 1)[:, None], top, out)


def _check_mode(cfg: RenderConfig) -> None:
    if cfg.texture_sample_mode != TextureSampleMode.MIPMAP:
        raise NotImplementedError(_NOT_PORTED.format(cfg.texture_sample_mode.name))
    if cfg.mipmap_filter != MipmapFilter.ANISOTROPIC:
        raise NotImplementedError(_NOT_PORTED.format(cfg.mipmap_filter.name))


def sample_plain(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg: RenderConfig,
                 data4) -> torch.Tensor:
    """MIPMAP + ANISOTROPIC sample (texture_sample.py:290-339 of the JAX package).

    tex: (data [X,3], width [K], height [K], levels [K], offsets [K,16], quad [X,4]);
    tex_id: [N] int32 (0 = none -> white); data4: ``expand_quads(tex)``.
    """
    _check_mode(cfg)
    tex_id = tex_id.long()
    levels = tex[3]
    zero = torch.zeros_like(tex_id, dtype=torch.int32)
    bil = _sample_bilinear(tex, tex_id, s, t, zero, data4)
    top = _top_texel(tex, tex_id)
    mip = _sample_anisotropic(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy,
                              cfg.max_anisotropy, data4, base=bil, top=top)
    return torch.where((levels[tex_id] > 1)[:, None], mip, bil)


def _check_inputs(tex, lanes, data4) -> None:
    data, width, height, levels, offsets, _quad = tex
    tex_id, s = lanes[0], lanes[1]
    n = s.shape[0]
    if any(x.shape != (n,) for x in lanes):
        raise ValueError("texture sample: per-lane inputs must all be [N]")
    if tex_id.dtype != torch.int32 or any(x.dtype != torch.float32 for x in lanes[1:]):
        raise TypeError("texture sample: tex_id int32 and float32 coordinates expected")
    if data.dtype != torch.float32 or data4.dtype != torch.float32:
        raise TypeError("texture sample: float32 atlases expected")
    if data4.shape != (data.shape[0], 12) or offsets.shape[1] != 16:
        raise ValueError("texture sample: data4 [X,12] and offsets [K,16] expected")
    if any(x.dtype != torch.int32 for x in (width, height, levels, offsets)):
        raise TypeError("texture sample: int32 atlas tables expected")
    if any(x.device != s.device for x in (data, data4, width, height, levels, offsets,
                                          *lanes)):
        raise ValueError("texture sample: inputs on different devices")
    kernels.require_contiguous("texture sample", data, data4, width, height, levels,
                               offsets, *lanes)


def _atlas_ptrs(tex, data4) -> list:
    data, width, height, levels, offsets, _quad = tex
    return [x.data_ptr() for x in (data, data4, width, height, levels, offsets)]


def sample_forward(tex, lanes, max_anisotropy: float, data4) -> torch.Tensor:
    """K3, one ``rt_texture_aniso`` launch (counted in ``launches``).
    lanes: (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy), each [N]."""
    global launches
    _check_inputs(tex, lanes, data4)
    n = lanes[1].shape[0]
    dev = lanes[1].device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    P, I, F = kernels.P, kernels.I, kernels.F
    fn = kernels.entry("texture", "rt_texture_aniso", [P] * 13 + [I, F, P, P])
    err = fn(*_atlas_ptrs(tex, data4), *(x.data_ptr() for x in lanes), n,
             float(max_anisotropy), out.data_ptr(), kernels.stream_ptr(dev))
    launches += 1
    kernels.check(err, "rt_texture_aniso")
    return out


def sample_backward(tex, lanes, max_anisotropy: float, data4, cot, need_data: bool,
                    need_data4: bool, need_lanes: bool):
    """K4, one ``rt_texture_aniso_bwd`` launch (counted in ``bwd_launches``).

    Returns (grad data [X,3] or None, grad data4 [X,12] or None, lane gradients
    [6,N] (s, t, ds_dx, ds_dy, dt_dx, dt_dy) or None), each computed only when
    asked for.  The atlas gradients are zeroed here and scattered into with fp32
    atomics, so their summation order changes from run to run."""
    global bwd_launches
    _check_inputs(tex, lanes, data4)
    n = lanes[1].shape[0]
    dev = lanes[1].device
    if cot.shape != (n, 3) or cot.dtype != torch.float32 or cot.device != dev:
        raise ValueError("texture sample backward: cot [N,3] float32 on the lanes' device "
                         "expected")
    kernels.require_contiguous("texture sample backward", cot)
    x = tex[0].shape[0]
    grad_data = torch.zeros((x, 3), dtype=torch.float32, device=dev) if need_data else None
    grad_data4 = (torch.zeros((x, 12), dtype=torch.float32, device=dev)
                  if need_data4 else None)
    grad_lanes = (torch.empty((6, n), dtype=torch.float32, device=dev)
                  if need_lanes else None)
    if n == 0:
        if grad_lanes is not None:
            grad_lanes.zero_()
        return grad_data, grad_data4, grad_lanes

    def ptr(t):
        return None if t is None else t.data_ptr()

    P, I, F = kernels.P, kernels.I, kernels.F
    fn = kernels.entry("texture_bwd", "rt_texture_aniso_bwd", [P] * 14 + [I, F, P, P, P, P])
    err = fn(*_atlas_ptrs(tex, data4), *(x.data_ptr() for x in lanes), cot.data_ptr(), n,
             float(max_anisotropy), ptr(grad_data), ptr(grad_data4), ptr(grad_lanes),
             kernels.stream_ptr(dev))
    bwd_launches += 1
    kernels.check(err, "rt_texture_aniso_bwd")
    return grad_data, grad_data4, grad_lanes


class TextureSample(torch.autograd.Function):
    """K3 and K4 on the card: the forward launches ``rt_texture_aniso``, the
    backward ``rt_texture_aniso_bwd``, which recomputes each lane's set-up from
    the saved inputs.  Gradients reach data (top texels), data4 (quad rows; the
    caller's ``expand_quads`` gather folds them into the atlas) and the six
    float lane inputs; the integer tables and tex_id get none."""

    @staticmethod
    def forward(ctx, max_anisotropy, data, data4, width, height, levels, offsets,
                tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy):
        tex = (data, width, height, levels, offsets, None)
        lanes = (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)
        out = sample_forward(tex, lanes, max_anisotropy, data4)
        ctx.max_anisotropy = max_anisotropy
        ctx.save_for_backward(data, data4, width, height, levels, offsets, *lanes)
        return out

    @staticmethod
    def backward(ctx, cot):
        data, data4, width, height, levels, offsets, *lanes = ctx.saved_tensors
        needs = ctx.needs_input_grad
        lane_needs = needs[8:14]
        grad_data, grad_data4, grad_lanes = sample_backward(
            (data, width, height, levels, offsets, None), tuple(lanes),
            ctx.max_anisotropy, data4, cot.contiguous(), needs[1], needs[2],
            any(lane_needs))
        lane_grads = [grad_lanes[k] if need else None for k, need in enumerate(lane_needs)]
        return (None, grad_data, grad_data4, None, None, None, None, None, *lane_grads)


def sample(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg: RenderConfig,
           data4) -> torch.Tensor:
    """K3, differentiable.  CPU tensors take ``sample_plain`` (differentiated by
    autograd); CUDA tensors go through ``TextureSample``, whose forward launches
    ``rt_texture_aniso`` (counted in ``launches``) and whose backward launches
    ``rt_texture_aniso_bwd`` (counted in ``bwd_launches``)."""
    if s.device.type == "cpu":
        return sample_plain(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg, data4)
    _check_mode(cfg)
    data, width, height, levels, offsets, _quad = tex
    return TextureSample.apply(float(cfg.max_anisotropy), data, data4, width, height,
                               levels, offsets, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)
