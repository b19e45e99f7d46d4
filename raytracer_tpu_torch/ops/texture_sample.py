"""Texture filtering over the flat mip atlas (counterpart of
``raytracer_tpu/ops/texture_sample.py``), kernels K3 (forward) and K4 (its gradient).

Reference (clayne/CPU-Raytracer): Texture.cpp — nearest (149-155), bilinear
(157-186), trilinear (PBRT 10.4; 189-204), anisotropic (OpenGL EXT spec; 207-239)
and EWA (242-337).  Every lane carries its own texture id, so one call filters the
whole wavefront across all textures.

Every mode of the JAX package runs: NEAREST, BILINEAR, and MIPMAP with the
TRILINEAR, ANISOTROPIC or EWA filter.  EWA scans a window of at most
``ewa_max_span``² texels, as the JAX package does.  ``sample`` launches
``csrc/texture.cu`` (K3, one template instance per mode) for CUDA tensors and runs
``sample_plain`` for CPU tensors; its gradient on the card is
``csrc/texture_bwd.cu`` (K4, ``TextureSample``), on the CPU autograd of
``sample_plain``.  The plain version follows JAX's expressions in JAX's order,
with ``torch.maximum`` where JAX has ``jnp.maximum`` (both split the gradient of
a tie in half).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..config import MipmapFilter, RenderConfig, TextureSampleMode
from ..core.vecmath import safe_sqrt
from ..utils import trace

_EWA_ALPHA = 2.0
_EWA_TABLE_SIZE = 128  # Texture.h:52-62

# the modes of ``sample``, in the order of texture.cuh's ``enum Mode``
MODES = ("nearest", "bilinear", "trilinear", "aniso", "ewa")
# K3's forms, in the order of texture.cu's ``enum Form``: "vector" (the
# renderer's: the level read once a lane, 16-byte quad-row loads, the wrap
# without division, EWA's weights from a table) and "first", the first design,
# kept as the yardstick of chip_smoke.py's K3 rows and never picked by a render
# or training path; both give the same bits
FWD_FORMS = ("vector", "first")
# K4's ways of adding into the atlas gradients, in the order of texture_bwd.cu's
# ``enum Form``: "lane" is the earlier design (one-float atomics from every lane, zero
# cotangents too; kept as the yardstick of chip_smoke.py's K4 rows), "scan"
# the warp form (zero lanes skip, a warp's runs of one row summed first)
BWD_FORMS = ("lane", "scan")

_FILTERS = {MipmapFilter.TRILINEAR: "trilinear", MipmapFilter.ANISOTROPIC: "aniso",
            MipmapFilter.EWA: "ewa"}


class Filter(NamedTuple):
    """The non-tensor arguments of K3 and K4: the mode (one of ``MODES``), the
    anisotropic tap cap and the side of EWA's window."""

    mode: str
    max_anisotropy: float
    ewa_span: int


def filter_of(cfg: RenderConfig) -> Filter:
    if cfg.texture_sample_mode == TextureSampleMode.NEAREST:
        mode = "nearest"
    elif cfg.texture_sample_mode == TextureSampleMode.BILINEAR:
        mode = "bilinear"
    else:
        mode = _FILTERS[MipmapFilter(cfg.mipmap_filter)]
    return Filter(mode, float(cfg.max_anisotropy), int(cfg.ewa_max_span))


def expand_quads(tex) -> torch.Tensor:
    """[X,12] quad-row atlas: each row holds a texel's full 2x2 bilinear footprint
    (wrap baked into tex.quad_idx at pack time), so one tap reads ONE row.
    Scene-only: the renderer builds it once per frame.  A torch gather, so its
    autograd carries the [X,12] row gradient back to tex data, as the transpose
    of ``jnp.take`` does in JAX."""
    data, _w, _h, _l, _o, quad = tex
    return data[quad.reshape(-1).long()].reshape(-1, 12)


def _max(x, c: float):
    """``jnp.maximum(x, c)`` for a constant c: NaN-propagating, and a tie splits
    the gradient in half (``torch.clamp_min`` would give x all of it)."""
    return torch.maximum(x, x.new_full((), c))


def _texel_row(tex, tex_id, x, y, level):
    """The row of ``data`` holding texel (x, y) of ``level``, wrapped
    (Texture.cpp:131-147). x, y, level: [N] int32."""
    _, width, height, _, offsets, _ = tex
    w = torch.clamp_min(width[tex_id] >> level, 1)
    h = torch.clamp_min(height[tex_id] >> level, 1)
    x = torch.remainder(x, w)  # positive mod, as jnp.mod (Math.h:44-52)
    y = torch.remainder(y, h)
    return (offsets[tex_id, level] + x + y * w).long()


def _fetch_texel(tex, tex_id, x, y, level):
    """Wrap-around texel fetch (Texture.cpp:131-147). x, y, level: [N] int32."""
    return tex[0][_texel_row(tex, tex_id, x, y, level)]


def _nearest_row(tex, tex_id, s, t):
    """Texture.cpp:149-155; torch.round rounds half to even, as jnp.round."""
    _, width, height, _, _, _ = tex
    x = torch.round(s * width[tex_id].to(torch.float32)).to(torch.int32)
    y = torch.round(t * height[tex_id].to(torch.float32)).to(torch.int32)
    return _texel_row(tex, tex_id, x, y, torch.zeros_like(x))


def _sample_nearest(tex, tex_id, s, t):
    return tex[0][_nearest_row(tex, tex_id, s, t)]


def _bilinear_tap(tex, tex_id, s, t, level):
    """One bilinear tap (Texture.cpp:157-186): the quad-atlas row it reads and
    its four weights. level: [N] int32."""
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
    return (offsets[tex_id, level] + x + y * lwi).long(), (w0, w1, w2, w3)


def _sample_bilinear(tex, tex_id, s, t, level, data4):
    """Texture.cpp:157-186 through the quad atlas. level: [N] int32."""
    row, (w0, w1, w2, w3) = _bilinear_tap(tex, tex_id, s, t, level)
    q = data4[row]
    return (
        w0[:, None] * q[:, 0:3]
        + w1[:, None] * q[:, 3:6]
        + w2[:, None] * q[:, 6:9]
        + w3[:, None] * q[:, 9:12]
    )


def _top_row(tex, tex_id):
    """The row of ``data`` of fetch_texel(0, 0, last_mip): the 1x1 coarsest level."""
    _, _, _, levels, offsets, _ = tex
    return offsets[tex_id, levels[tex_id] - 1].long()


def _top_texel(tex, tex_id):
    return tex[0][_top_row(tex, tex_id)]


def _clip_level(level, lv):
    """jnp.clip(level, 0, levels - 1) on int32 levels."""
    return torch.minimum(torch.clamp_min(level, 0), lv - 1)


def _trilinear_level(lv, ds_dx, ds_dy, dt_dx, dt_dy):
    """PBRT's LOD from the max abs derivative (Texture.cpp:189-195): (lam, level).
    ``torch.abs`` has gradient 0 at 0 where ``jnp.abs`` has 1; that only differs
    where the max is 0, and there ``max(width, 1e-8)`` takes the constant."""
    width = 2.0 * torch.maximum(
        torch.maximum(torch.abs(ds_dx), torch.abs(ds_dy)),
        torch.maximum(torch.abs(dt_dx), torch.abs(dt_dy)),
    )
    lam = lv.to(torch.float32) - 1.0 + torch.log2(_max(width, 1e-8))
    return lam, torch.floor(lam).to(torch.int32)


def _sample_trilinear(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, data4, base, top):
    """Two bilinear taps at floor(lam) and floor(lam) + 1, blended by frac(lam)
    (Texture.cpp:189-204)."""
    lv = tex[3][tex_id]
    lam, level = _trilinear_level(lv, ds_dx, ds_dy, dt_dx, dt_dy)
    lo = _clip_level(level, lv)
    hi = _clip_level(level + 1, lv)
    f = (lam - torch.floor(lam))[:, None]
    mixed = (1.0 - f) * _sample_bilinear(
        tex, tex_id, s, t, lo, data4
    ) + f * _sample_bilinear(tex, tex_id, s, t, hi, data4)
    out = torch.where((level < 0)[:, None], base, mixed)
    return torch.where((level >= lv - 1)[:, None], top, out)


class _Aniso(NamedTuple):
    """_sample_anisotropic's footprint: tap count, level, major axis step."""

    n: torch.Tensor
    level: torch.Tensor
    step_s: torch.Tensor
    step_t: torch.Tensor


def _aniso_setup(lv, ds_dx, ds_dy, dt_dx, dt_dy, max_anisotropy: float) -> _Aniso:
    lf = lv.to(torch.float32)
    p_x = torch.maximum(torch.abs(ds_dx), torch.abs(dt_dx))
    p_y = torch.maximum(torch.abs(ds_dy), torch.abs(dt_dy))
    p_min = torch.minimum(p_x, p_y)
    p_max = torch.maximum(p_x, p_y)

    n = torch.clamp_max(torch.ceil(p_max / torch.clamp_min(p_min, 1e-20)), max_anisotropy)
    n = torch.clamp_min(n, 1.0)
    lam = lf - 1.0 + torch.log2(torch.clamp_min(p_max / n, 1e-20))
    level = torch.round(lam).to(torch.int32)  # half to even, as jnp.round
    x_major = p_x > p_y
    return _Aniso(n, level, torch.where(x_major, ds_dx, ds_dy),
                  torch.where(x_major, dt_dx, dt_dy))


def _sample_anisotropic(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy,
                        max_anisotropy: float, data4, base, top):
    """OpenGL-EXT-style anisotropic filtering (Texture.cpp:207-239): up to N probes
    along the major axis at a sharper mip level."""
    lv = tex[3][tex_id]
    f = _aniso_setup(lv, ds_dx, ds_dy, dt_dx, dt_dy, max_anisotropy)
    level_c = _clip_level(f.level, lv)
    inv_np1 = 1.0 / (f.n + 1.0)

    acc = torch.zeros((s.shape[0], 3), dtype=s.dtype, device=s.device)
    for i in range(1, int(max_anisotropy) + 1):
        fi = float(i)
        use = fi <= f.n + 0.001
        x = s + f.step_s * (fi * inv_np1 - 0.5)
        y = t + f.step_t * (fi * inv_np1 - 0.5)
        tap = _sample_bilinear(tex, tex_id, x, y, level_c, data4)
        acc = acc + torch.where(use[:, None], tap, 0.0)
    aniso = acc / f.n[:, None]

    out = torch.where((f.level < 0)[:, None], base, aniso)
    return torch.where((f.level >= lv - 1)[:, None], top, out)


def _ewa_weight(r2):
    """Quantized gaussian falloff, the reference's 128-entry table (Texture.h:53-62);
    the index rounds to nearest (Util::float_to_int, Texture.cpp:327)."""
    idx = torch.clamp_max(torch.floor(r2 * _EWA_TABLE_SIZE + 0.5), _EWA_TABLE_SIZE - 1)
    r2q = idx / (_EWA_TABLE_SIZE - 1)
    return torch.exp(-_EWA_ALPHA * r2q) - math.exp(-_EWA_ALPHA)


def ewa_weight_table() -> torch.Tensor:
    """[128] ``_ewa_weight`` at each of its indices, as K3's vector form builds
    its table once a device (``csrc/texture.cu``: exp(-2 i / 127) - exp(-2))."""
    idx = torch.arange(_EWA_TABLE_SIZE, dtype=torch.float32)
    return torch.exp(-_EWA_ALPHA * (idx / (_EWA_TABLE_SIZE - 1))) - math.exp(-_EWA_ALPHA)


def ewa_weight_lookup(table, r2):
    """``_ewa_weight(r2)`` for r2 < 1 as the vector form reads it (``table_weight``):
    the table at the rounded index, capped at 127; an index below 0 (r2 rounded
    below 0) takes ``_ewa_weight`` itself."""
    idx = torch.clamp_max(torch.floor(r2 * _EWA_TABLE_SIZE + 0.5), _EWA_TABLE_SIZE - 1)
    return torch.where(idx >= 0, table[idx.clamp_min(0).long()], _ewa_weight(r2))


class _Ewa(NamedTuple):
    """_sample_ewa's ellipse at level_c: its quadratic form (a, b, c) about the
    texel-space centre (ss, tt), its box [s0, s1] x [t0, t1] and its branch."""

    level_c: torch.Tensor
    use_top: torch.Tensor  # too_big | at_top
    degenerate: torch.Tensor
    ss: torch.Tensor
    tt: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor


def _ewa_setup(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, max_anisotropy: float) -> _Ewa:
    """Texture.cpp:242-301, in the JAX package's form (texture_sample.py:205-260)."""
    _, width, height, levels, _, _ = tex
    lv = levels[tex_id]
    lf = lv.to(torch.float32)
    wf = width[tex_id].to(torch.float32)

    maj_x, maj_y = ds_dx, dt_dx
    min_x, min_y = ds_dy, dt_dy
    maj_len = safe_sqrt(maj_x * maj_x + maj_y * maj_y)
    min_len = safe_sqrt(min_x * min_x + min_y * min_y)
    swap = min_len > maj_len
    maj_x, min_x = torch.where(swap, min_x, maj_x), torch.where(swap, maj_x, min_x)
    maj_y, min_y = torch.where(swap, min_y, maj_y), torch.where(swap, maj_y, min_y)
    maj_len, min_len = (torch.where(swap, min_len, maj_len),
                        torch.where(swap, maj_len, min_len))

    degenerate = min_len < 1e-5
    too_big = maj_len > wf

    # eccentricity clamp (Texture.cpp:262-268)
    scale = maj_len / _max(min_len * max_anisotropy, 1e-20)
    need = min_len * max_anisotropy < maj_len
    min_x = torch.where(need, min_x * scale, min_x)
    min_y = torch.where(need, min_y * scale, min_y)
    min_len = torch.where(need, min_len * scale, min_len)

    lam = _max(lf - 1.0 + torch.log2(_max(min_len, 1e-20)), 0.0)
    level = torch.round(lam).to(torch.int32)
    at_top = level >= lv - 1
    level_c = _clip_level(level, lv)

    lw = torch.clamp_min(width[tex_id] >> level_c, 1).to(torch.float32)
    lh = torch.clamp_min(height[tex_id] >> level_c, 1).to(torch.float32)
    ss = s * lw - 0.5
    tt = t * lh - 0.5
    majx = maj_x * lw
    majy = maj_y * lh
    minx = min_x * lw
    miny = min_y * lh

    a = 1.0 + (majy * majy + miny * miny)
    b = -2.0 * (majx * majy + minx * miny)
    c = 1.0 + (majx * majx + minx * minx)
    inv_f = 1.0 / (a * c - b * b * 0.25)
    a, b, c = a * inv_f, b * inv_f, c * inv_f

    det = -b * b + 4.0 * a * c
    sqrt_u = safe_sqrt(det * c)
    sqrt_v = safe_sqrt(det * a)
    two_inv_det = 2.0 / det
    # Util::float_to_int rounds to nearest: round(x) == floor(x + 0.5)
    s0 = torch.floor(ss - two_inv_det * sqrt_u + 1.0).to(torch.int32)
    s1 = torch.floor(ss + two_inv_det * sqrt_u).to(torch.int32)
    t0 = torch.floor(tt - two_inv_det * sqrt_v + 1.0).to(torch.int32)
    t1 = torch.floor(tt + two_inv_det * sqrt_v).to(torch.int32)
    return _Ewa(level_c, too_big | at_top, degenerate, ss, tt, a, b, c, s0, s1, t0, t1)


def _ewa_window(e: _Ewa, span: int):
    """The window's texels in JAX's dj-major order: (si, tj, in_box, r2), each [N];
    taps outside the ``span`` x ``span`` window are dropped, as in JAX."""
    for dj in range(span):
        tj = e.t0 + dj
        for di in range(span):
            si = e.s0 + di
            in_box = (si <= e.s1) & (tj <= e.t1)
            uu = si.to(torch.float32) - e.ss
            vv = tj.to(torch.float32) - e.tt
            yield si, tj, in_box, e.a * uu * uu + e.b * uu * vv + e.c * vv * vv


def _sample_ewa(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, filt: Filter, base, top):
    """Elliptical weighted average (Texture.cpp:242-337), bounded-window form.

    The lanes reach the result only through floor and integer conversions, so
    EWA's own lane gradient is zero (JAX's floor has a symbolic zero tangent);
    the set-up runs on detached lanes, which also keeps autograd from forming
    0 * inf on lanes whose ellipse overflows."""
    lanes = [x.detach() for x in (s, t, ds_dx, ds_dy, dt_dx, dt_dy)]
    e = _ewa_setup(tex, tex_id, *lanes, filt.max_anisotropy)
    acc = torch.zeros((s.shape[0], 3), dtype=s.dtype, device=s.device)
    wsum = torch.zeros_like(lanes[0])
    for si, tj, in_box, r2 in _ewa_window(e, filt.ewa_span):
        wgt = torch.where(in_box & (r2 < 1.0), _ewa_weight(r2), 0.0)
        acc = acc + wgt[:, None] * _fetch_texel(tex, tex_id, si, tj, e.level_c)
        wsum = wsum + wgt
    ewa = acc / _max(wsum, 1e-20)[:, None]
    out = torch.where(e.degenerate[:, None], base, ewa)
    return torch.where(e.use_top[:, None], top, out)


def sample_plain(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg: RenderConfig,
                 data4=None) -> torch.Tensor:
    """Config-dispatched texture sample (texture_sample.py:290-339 of the JAX
    package).

    tex: (data [X,3], width [K], height [K], levels [K], offsets [K,16], quad [X,4]);
    tex_id: [N] int32 (0 = none -> white); data4: ``expand_quads(tex)``, built here
    when not given (NEAREST reads ``data`` only and needs none).
    """
    filt = filter_of(cfg)
    tex_id = tex_id.long()
    if filt.mode == "nearest":
        return _sample_nearest(tex, tex_id, s, t)
    if data4 is None:
        data4 = expand_quads(tex)
    bil = _sample_bilinear(tex, tex_id, s, t, torch.zeros_like(tex_id, dtype=torch.int32),
                           data4)
    if filt.mode == "bilinear":
        return bil
    # MIPMAP: non-mipmapped textures (levels == 1) fall back to bilinear; the
    # level-0 tap and the top texel are shared with the filter's fallbacks
    top = _top_texel(tex, tex_id)
    derivs = (ds_dx, ds_dy, dt_dx, dt_dy)
    if filt.mode == "trilinear":
        mip = _sample_trilinear(tex, tex_id, s, t, *derivs, data4, bil, top)
    elif filt.mode == "aniso":
        mip = _sample_anisotropic(tex, tex_id, s, t, *derivs, filt.max_anisotropy, data4,
                                  bil, top)
    else:
        mip = _sample_ewa(tex, tex_id, s, t, *derivs, filt, bil, top)
    return torch.where((tex[3][tex_id] > 1)[:, None], mip, bil)


class LaneTaps(NamedTuple):
    """Per lane [N]: which term of ``sample`` it returns (``top``, ``filtered``;
    the rest the level-0 bilinear tap), its filter's taps (0 off the filter
    branch) and, under EWA, the taps inside the ellipse (``weighted``)."""

    top: torch.Tensor
    filtered: torch.Tensor
    taps: torch.Tensor
    weighted: torch.Tensor


@torch.no_grad()
def lane_taps(tex, lanes, cfg: RenderConfig) -> LaneTaps:
    """``lane_work`` lane by lane.  lanes: (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)."""
    filt = filter_of(cfg)
    tex_id, s, t, *derivs = lanes
    if filt.mode in ("nearest", "bilinear"):
        none = torch.zeros_like(s, dtype=torch.bool)
        return LaneTaps(none, ~none, torch.ones_like(s), torch.zeros_like(s))
    tex_id = tex_id.long()
    lv = tex[3][tex_id]
    weighted = torch.zeros_like(s)
    if filt.mode == "trilinear":
        level = _trilinear_level(lv, *derivs)[1]
        use_top, use_bil = level >= lv - 1, level < 0
        taps = torch.full_like(s, 2.0)
    elif filt.mode == "aniso":
        f = _aniso_setup(lv, *derivs, filt.max_anisotropy)
        use_top, use_bil, taps = f.level >= lv - 1, f.level < 0, f.n
    else:
        e = _ewa_setup(tex, tex_id, s, t, *derivs, filt.max_anisotropy)
        use_top, use_bil = e.use_top, e.degenerate
        taps = torch.zeros_like(s)
        for _si, _tj, in_box, r2 in _ewa_window(e, filt.ewa_span):
            taps += in_box
            weighted += in_box & (r2 < 1.0)
    mip = lv > 1
    top = mip & use_top
    filtered = mip & ~use_top & ~use_bil
    return LaneTaps(top, filtered, torch.where(filtered, taps, 0.0),
                    torch.where(filtered, weighted, 0.0))


def lane_work(tex, lanes, cfg: RenderConfig) -> dict:
    """What ``sample`` computes on these lanes, for the kernels' bounds and for
    coverage checks: how many lanes return the level-0 bilinear tap
    (``bilinear``), the top texel (``top``) or the mode's own filter (``filter``),
    and that filter's taps (``taps``: texels for NEAREST, bilinear taps for
    BILINEAR, TRILINEAR and ANISOTROPIC, the window's texels inside the
    ellipse's box for EWA, of which ``weighted`` lie inside the ellipse).
    lanes: (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)."""
    got = lane_taps(tex, lanes, cfg)
    return {"bilinear": float((~got.top & ~got.filtered).sum()), "top": float(got.top.sum()),
            "filter": float(got.filtered.sum()), "taps": float(got.taps.sum()),
            "weighted": float(got.weighted.sum())}


class TapSlot(NamedTuple):
    """One slot of K4's scatter: ``rows`` [N] int64 (rows of ``data4`` where
    ``kind`` is "quad", of ``data`` where "texel"; -1 where the lane adds
    nothing in this slot) and ``values`` (what each lane adds there: [N,12]
    w_k h for a quad row, [N,3] for a texel)."""

    kind: str
    rows: torch.Tensor
    values: torch.Tensor


@torch.no_grad()
def tap_slots_plain(tex, lanes, cfg: RenderConfig, cot: torch.Tensor):
    """K4's scatter slot by slot, as the warp form of ``csrc/texture_bwd.cu``
    take it: yields a ``TapSlot`` for each tap slot of the mode (NEAREST's
    texel; BILINEAR's tap; TRILINEAR's lo and hi taps; ANISOTROPIC's
    ``max_anisotropy`` taps; a bilinear-branch lane's level-0 tap in the first
    quad slot), then the top texel, then each texel of EWA's window.  A lane
    whose cotangent is all +-0 names no row.  The values are the plain
    version's per-lane terms in its own float32 arithmetic, so their sums
    (``scatter_sums_plain``) are autograd's atlas gradients up to the order of
    the sums.  lanes: (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy); cot [N,3]."""
    filt = filter_of(cfg)
    tex_id, s, t, *derivs = lanes
    tex_id = tex_id.long()
    live = (cot != 0).any(dim=1)  # NaN != 0: a NaN lane reaches its rows
    none = torch.full_like(tex_id, -1)
    zero = torch.zeros_like(tex_id, dtype=torch.int32)

    def quad(use, row, w, h):
        vals = torch.cat([wk[:, None] * h for wk in w], dim=1)
        return TapSlot("quad", torch.where(use & live, row, none), vals)

    def texel(use, row, h):
        return TapSlot("texel", torch.where(use & live, row, none), h)

    if filt.mode == "nearest":
        yield texel(torch.ones_like(live), _nearest_row(tex, tex_id, s, t), cot)
        return
    base_row, base_w = _bilinear_tap(tex, tex_id, s, t, zero)
    if filt.mode == "bilinear":
        yield quad(torch.ones_like(live), base_row, base_w, cot)
        return
    lv = tex[3][tex_id]
    mip = lv > 1
    if filt.mode == "trilinear":
        lam, level = _trilinear_level(lv, *derivs)
        top, bil = level >= lv - 1, level < 0
    elif filt.mode == "aniso":
        f = _aniso_setup(lv, *derivs, filt.max_anisotropy)
        top, bil = f.level >= lv - 1, f.level < 0
    else:
        e = _ewa_setup(tex, tex_id, s, t, *derivs, filt.max_anisotropy)
        top, bil = e.use_top, e.degenerate
    top = mip & top
    filtered = mip & ~top & ~bil
    bil = ~top & ~filtered
    if filt.mode == "trilinear":
        lo = _clip_level(level, lv)
        hi = _clip_level(level + 1, lv)
        frac = (lam - torch.floor(lam))[:, None]
        lo_row, lo_w = _bilinear_tap(tex, tex_id, s, t, lo)
        hi_row, hi_w = _bilinear_tap(tex, tex_id, s, t, hi)
        first = quad(filtered, lo_row, lo_w, cot * (1.0 - frac))
        from_base = quad(bil, base_row, base_w, cot)
        yield TapSlot("quad", torch.where(bil, from_base.rows, first.rows),
                      torch.where(bil[:, None], from_base.values, first.values))
        yield quad(filtered, hi_row, hi_w, cot * frac)
    elif filt.mode == "aniso":
        level_c = _clip_level(f.level, lv)
        inv_np1 = 1.0 / (f.n + 1.0)
        h = cot / f.n[:, None]
        for i in range(1, int(filt.max_anisotropy) + 1):
            fi = float(i)
            use = filtered & (fi <= f.n + 0.001)
            x = s + f.step_s * (fi * inv_np1 - 0.5)
            y = t + f.step_t * (fi * inv_np1 - 0.5)
            row, w = _bilinear_tap(tex, tex_id, x, y, level_c)
            slot = quad(use, row, w, h)
            if i == 1:
                from_base = quad(bil, base_row, base_w, cot)
                slot = TapSlot("quad", torch.where(bil, from_base.rows, slot.rows),
                               torch.where(bil[:, None], from_base.values, slot.values))
            yield slot
    else:
        yield quad(bil, base_row, base_w, cot)
    yield texel(top, _top_row(tex, tex_id), cot)
    if filt.mode == "ewa":
        window = list(_ewa_window(e, filt.ewa_span))
        wsum = torch.zeros_like(s)
        for _si, _tj, in_box, r2 in window:
            wsum = wsum + torch.where(in_box & (r2 < 1.0), _ewa_weight(r2), 0.0)
        h = cot / _max(wsum, 1e-20)[:, None]
        for si, tj, in_box, r2 in window:
            inside = filtered & in_box & (r2 < 1.0)
            wgt = torch.where(inside, _ewa_weight(r2), 0.0)
            yield texel(inside, _texel_row(tex, tex_id, si, tj, e.level_c), h * wgt[:, None])


def tap_rows_plain(tex, lanes, cfg: RenderConfig, cot: torch.Tensor) -> tuple:
    """The rows K4 adds into, for each lane and slot of ``tap_slots_plain``:
    (quad rows [Sq, N] of ``data4``, texel rows [St, N] of ``data``), int64,
    -1 where a lane has no tap in the slot or its cotangent is zero."""
    n = lanes[1].shape[0]
    slots = list(tap_slots_plain(tex, lanes, cfg, cot))
    quad = [x.rows for x in slots if x.kind == "quad"]
    texel = [x.rows for x in slots if x.kind == "texel"]
    empty = torch.empty((0, n), dtype=torch.int64, device=lanes[1].device)
    return (torch.stack(quad) if quad else empty, torch.stack(texel) if texel else empty)


@torch.no_grad()
def scatter_sums_plain(slots, x_rows: int, dtype=torch.float64) -> tuple:
    """The atlas gradients (grad data [X,3], grad data4 [X,12]) as the sums of
    ``tap_slots_plain``'s per-lane values, taken in ``dtype``."""
    gd = gd4 = None
    for slot in slots:
        if gd is None:
            dev = slot.values.device
            gd = torch.zeros((x_rows, 3), dtype=dtype, device=dev)
            gd4 = torch.zeros((x_rows, 12), dtype=dtype, device=dev)
        keep = slot.rows >= 0
        out = gd4 if slot.kind == "quad" else gd
        out.index_add_(0, slot.rows[keep], slot.values[keep].to(dtype))
    return gd, gd4


def _check_inputs(tex, lanes, data4, filt: Filter) -> None:
    data, width, height, levels, offsets, _quad = tex
    tex_id, s = lanes[0], lanes[1]
    n = s.shape[0]
    if filt.mode not in MODES:
        raise ValueError(f"texture sample: unknown mode {filt.mode!r}")
    if filt.mode == "ewa" and filt.ewa_span < 1:
        raise ValueError("texture sample: ewa_max_span must be at least 1")
    if any(x.shape != (n,) for x in lanes):
        raise ValueError("texture sample: per-lane inputs must all be [N]")
    if tex_id.dtype != torch.int32 or any(x.dtype != torch.float32 for x in lanes[1:]):
        raise TypeError("texture sample: tex_id int32 and float32 coordinates expected")
    atlases = (data,) if data4 is None else (data, data4)
    if data4 is None and filt.mode != "nearest":
        raise ValueError(f"texture sample: mode {filt.mode} reads the quad atlas data4")
    if any(x.dtype != torch.float32 for x in atlases):
        raise TypeError("texture sample: float32 atlases expected")
    if (data4 is not None and data4.shape != (data.shape[0], 12)) or offsets.shape[1] != 16:
        raise ValueError("texture sample: data4 [X,12] and offsets [K,16] expected")
    if any(x.dtype != torch.int32 for x in (width, height, levels, offsets)):
        raise TypeError("texture sample: int32 atlas tables expected")
    if any(x.device != s.device for x in (*atlases, width, height, levels, offsets, *lanes)):
        raise ValueError("texture sample: inputs on different devices")
    kernels.require_contiguous("texture sample", *atlases, width, height, levels, offsets,
                               *lanes)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _atlas_ptrs(tex, data4) -> list:
    data, width, height, levels, offsets, _quad = tex
    return [_ptr(x) for x in (data, data4, width, height, levels, offsets)]


def sample_forward(tex, lanes, filt: Filter, data4, form: str = "vector") -> torch.Tensor:
    """K3, one ``rt_texture`` launch in ``filt.mode`` and ``form`` (one of
    ``FWD_FORMS``; counted in ``trace.counters["launch.k3.<mode>"]``, the first
    form apart in ``"launch.k3.<mode>.first"``).  lanes: (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy),
    each [N]; data4 may be None under NEAREST."""
    _check_inputs(tex, lanes, data4, filt)
    if form not in FWD_FORMS:
        raise ValueError(f"texture sample: form must be one of {FWD_FORMS}")
    if form == "vector" and data4 is not None and data4.data_ptr() % 16:
        # its 48-byte rows are read as three 16-byte vectors
        raise ValueError("texture sample: data4 must be 16-byte aligned")
    n = lanes[1].shape[0]
    dev = lanes[1].device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    P, I, F = kernels.P, kernels.I, kernels.F
    fn = kernels.entry("texture", "rt_texture", [I, I] + [P] * 13 + [I, F, I, P, P])
    err = fn(MODES.index(filt.mode), FWD_FORMS.index(form), *_atlas_ptrs(tex, data4),
             *(x.data_ptr() for x in lanes), n, filt.max_anisotropy, filt.ewa_span,
             out.data_ptr(), kernels.stream_ptr(dev))
    trace.count(f"launch.k3.{filt.mode}" + ("" if form == "vector" else ".first"))
    kernels.check(err, f"rt_texture ({filt.mode}, {form})")
    return out


def sample_backward(tex, lanes, filt: Filter, data4, cot, need_data: bool,
                    need_data4: bool, need_lanes: bool, form: str = "scan"):
    """K4, one ``rt_texture_bwd`` launch in ``filt.mode`` (counted in
    ``trace.counters["launch.k4.<mode>"]``), adding into the atlas gradients in ``form`` (one of
    ``BWD_FORMS``).

    Returns (grad data [X,3] or None, grad data4 [X,12] or None, lane gradients
    [6,N] (s, t, ds_dx, ds_dy, dt_dx, dt_dy) or None), each computed only when
    asked for (grad data4 never without data4).  The atlas gradients are zeroed
    here and scattered into with fp32 atomics, so their summation order changes
    from run to run."""
    _check_inputs(tex, lanes, data4, filt)
    n = lanes[1].shape[0]
    dev = lanes[1].device
    if cot.shape != (n, 3) or cot.dtype != torch.float32 or cot.device != dev:
        raise ValueError("texture sample backward: cot [N,3] float32 on the lanes' device "
                         "expected")
    kernels.require_contiguous("texture sample backward", cot)
    if form not in BWD_FORMS:
        raise ValueError(f"texture sample backward: form must be one of {BWD_FORMS}")
    x = tex[0].shape[0]
    if x >= 2**31:
        raise ValueError("texture sample backward: fewer than 2^31 atlas rows expected")
    grad_data = torch.zeros((x, 3), dtype=torch.float32, device=dev) if need_data else None
    grad_data4 = (torch.zeros((x, 12), dtype=torch.float32, device=dev)
                  if need_data4 and data4 is not None else None)
    grad_lanes = (torch.empty((6, n), dtype=torch.float32, device=dev)
                  if need_lanes else None)
    if n == 0:
        return grad_data, grad_data4, grad_lanes
    if grad_data4 is not None and grad_data4.data_ptr() % 16:
        # its 48-byte rows take 16-byte vector atomics
        raise ValueError("texture sample backward: grad data4 must be 16-byte aligned")

    P, I, F = kernels.P, kernels.I, kernels.F
    fn = kernels.entry("texture_bwd", "rt_texture_bwd",
                       [I, I] + [P] * 14 + [I, F, I, P, P, P, P])
    err = fn(MODES.index(filt.mode), BWD_FORMS.index(form), *_atlas_ptrs(tex, data4),
             *(x.data_ptr() for x in lanes), cot.data_ptr(), n, filt.max_anisotropy,
             filt.ewa_span, _ptr(grad_data), _ptr(grad_data4), _ptr(grad_lanes),
             kernels.stream_ptr(dev))
    trace.count(f"launch.k4.{filt.mode}")
    kernels.check(err, f"rt_texture_bwd ({filt.mode})")
    return grad_data, grad_data4, grad_lanes


class TextureSample(torch.autograd.Function):
    """K3 and K4 on the card: the forward launches ``rt_texture``, the backward
    ``rt_texture_bwd``, which recomputes each lane's set-up from the saved inputs.
    Gradients reach data (top texels, NEAREST's texel, EWA's window), data4
    (bilinear taps; the caller's ``expand_quads`` gather folds them into the
    atlas) and the six float lane inputs; the integer tables and tex_id get none.
    ``data4`` is None under NEAREST."""

    @staticmethod
    def forward(ctx, filt, data, data4, width, height, levels, offsets,
                tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy):
        tex = (data, width, height, levels, offsets, None)
        lanes = (tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)
        out = sample_forward(tex, lanes, filt, data4)
        ctx.filt = filt
        ctx.save_for_backward(data, data4, width, height, levels, offsets, *lanes)
        return out

    @staticmethod
    def backward(ctx, cot):
        data, data4, width, height, levels, offsets, *lanes = ctx.saved_tensors
        needs = ctx.needs_input_grad
        lane_needs = needs[8:14]
        grad_data, grad_data4, grad_lanes = sample_backward(
            (data, width, height, levels, offsets, None), tuple(lanes), ctx.filt, data4,
            cot.contiguous(), needs[1], needs[2], any(lane_needs))
        lane_grads = [grad_lanes[k] if need else None for k, need in enumerate(lane_needs)]
        return (None, grad_data, grad_data4, None, None, None, None, None, *lane_grads)


def sample(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg: RenderConfig,
           data4=None) -> torch.Tensor:
    """K3, differentiable.  CPU tensors take ``sample_plain`` (differentiated by
    autograd); CUDA tensors go through ``TextureSample``, whose forward launches
    ``rt_texture`` (counted in ``trace.counters["launch.k3.<mode>"]``) and whose
    backward launches ``rt_texture_bwd`` (``"launch.k4.<mode>"``).  ``data4`` is built
    here when not given, except under NEAREST, which does not read it."""
    if s.device.type == "cpu":
        return sample_plain(tex, tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy, cfg, data4)
    filt = filter_of(cfg)
    if data4 is None and filt.mode != "nearest":
        data4 = expand_quads(tex)
    data, width, height, levels, offsets, _quad = tex
    return TextureSample.apply(filt, data, data4, width, height, levels, offsets,
                               tex_id, s, t, ds_dx, ds_dy, dt_dx, dt_dy)
