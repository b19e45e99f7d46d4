"""Texture filtering over the flat mip atlas (counterpart of
``raytracer_tpu/ops/texture_sample.py``), kernel K3.

Reference (clayne/CPU-Raytracer): Texture.cpp — bilinear (157-186) and anisotropic
(OpenGL EXT spec; 207-239).  Every lane carries its own texture id, so one call
filters the whole wavefront across all textures.

This slice ports what config3 runs: MIPMAP mode with the ANISOTROPIC filter.
``sample`` launches ``csrc/texture.cu`` for CUDA tensors and runs ``sample_plain``
for CPU tensors.  NEAREST, BILINEAR, TRILINEAR and EWA raise
``NotImplementedError``: they are still to be ported (ROADMAP.md queue B, K3).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import MipmapFilter, RenderConfig, TextureSampleMode

launches = 0  # rt_texture_aniso launches (reset and read by chip_smoke.py)

_NOT_PORTED = (
    "texture filtering mode {} is not ported yet: only MIPMAP + ANISOTROPIC "
    "(ROADMAP.md queue B, K3: NEAREST/TRILINEAR/EWA texture kernels)"
)


def expand_quads(tex) -> torch.Tensor:
    """[X,12] quad-row atlas: each row holds a texel's full 2x2 bilinear footprint
    (wrap baked into tex.quad_idx at pack time), so one tap reads ONE row.
    Scene-only: the renderer builds it once per frame."""
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


def sample(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg: RenderConfig,
           data4) -> torch.Tensor:
    """K3.  CPU tensors take ``sample_plain``; CUDA tensors launch
    ``rt_texture_aniso`` (module attribute ``launches`` counts them)."""
    global launches
    if s.device.type == "cpu":
        return sample_plain(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg, data4)
    _check_mode(cfg)
    data, width, height, levels, offsets, _quad = tex
    lanes = (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)
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
    kernels.require_cuda_input("texture sample", data, data4, width, height, levels,
                               offsets, *lanes)
    out = torch.empty((n, 3), dtype=torch.float32, device=s.device)
    if n == 0:
        return out
    P, I, F = kernels.P, kernels.I, kernels.F
    fn = kernels.entry("texture", "rt_texture_aniso", [P] * 13 + [I, F, P, P])
    err = fn(data.data_ptr(), data4.data_ptr(), width.data_ptr(), height.data_ptr(),
             levels.data_ptr(), offsets.data_ptr(), *(x.data_ptr() for x in lanes),
             n, float(cfg.max_anisotropy), out.data_ptr(), kernels.stream_ptr(s.device))
    launches += 1
    kernels.check(err, "rt_texture_aniso")
    return out

