"""Host-side texture loading, mip-chain construction, and atlas packing.

Replaces the reference's stb_image decode (Texture.cpp:30-47) with PIL, and its
per-texture pointer + ``mip_offsets[]`` layout (Texture.cpp:76-121) with one flat
``[T,3]`` float32 atlas shared by every texture: each texture's mip level ``l`` lives at
``atlas[mip_offsets[k, l] : ...]``, so the device samples any texture of any size with
plain gathers — the TPU equivalent of the reference's per-lane scalar texel fetches
(Raytracer.cpp:119-141).

Texture id 0 is reserved as "no texture" (a single white texel), mirroring
``Material::texture == nullptr`` (Material.h:16-22).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _gamma_to_linear_np(x: np.ndarray) -> np.ndarray:
    """sRGB decode at load time (Texture.cpp:63-73, Math.h:67-77)."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _is_pot(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass
class TextureData:
    """One decoded texture with its full mip chain, flattened row-major per level."""

    data: np.ndarray  # [total_texels, 3] float32, linear space
    width: int
    height: int
    mip_levels: int
    mip_offsets: np.ndarray  # [mip_levels] int64, local offsets into `data`


_texture_cache: dict = {}


def clear_cache() -> None:
    _texture_cache.clear()


def from_array(rgb: np.ndarray, srgb: bool = True, build_mips: bool = True) -> TextureData:
    """Build a TextureData (+mip chain) from an [H,W,3] array in [0,1]."""
    rgb = np.asarray(rgb, dtype=np.float32)
    assert rgb.ndim == 3 and rgb.shape[2] == 3
    h, w = rgb.shape[:2]
    if srgb:
        rgb = _gamma_to_linear_np(rgb).astype(np.float32)

    mipmapped = build_mips and _is_pot(w) and _is_pot(h)
    levels = [rgb]
    if mipmapped:
        # 2x2 box filter per level (Texture.cpp:93-118)
        cur = rgb
        while cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = 0.25 * (
                cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
            )
            levels.append(cur.astype(np.float32))
        # mip_levels = 1 + log2(min(w,h)) (Texture.cpp:80); the loop above matches.

    offsets = np.zeros((len(levels),), dtype=np.int64)
    total = 0
    for i, lv in enumerate(levels):
        offsets[i] = total
        total += lv.shape[0] * lv.shape[1]
    flat = np.concatenate([lv.reshape(-1, 3) for lv in levels], axis=0)
    return TextureData(
        data=flat, width=w, height=h, mip_levels=len(levels), mip_offsets=offsets
    )


def load(path: str, build_mips: bool = True) -> TextureData:
    """Load an image file (PNG/TGA/JPG via PIL; stand-in for stb_image) with caching
    (Texture.cpp:11, 30-34)."""
    key = (str(path), build_mips)
    if key in _texture_cache:
        return _texture_cache[key]
    from PIL import Image

    img = Image.open(path).convert("RGB")
    rgb = np.asarray(img, dtype=np.float32) / 255.0
    tex = from_array(rgb, srgb=True, build_mips=build_mips)
    _texture_cache[key] = tex
    return tex


MAX_MIP_LEVELS = 16  # supports textures up to 32768^2


@dataclasses.dataclass
class TextureAtlas:
    """Flat device-side atlas of every texture + mip chain."""

    data: np.ndarray  # [T,3] float32
    width: np.ndarray  # [K] int32
    height: np.ndarray  # [K] int32
    mip_levels: np.ndarray  # [K] int32
    mip_offsets: np.ndarray  # [K, MAX_MIP_LEVELS] int32 global offsets
    # [T,4] int32: for each texel, the global rows of its bilinear footprint
    # ((x,y),(x+1,y),(x,y+1),(x+1,y+1), wrap-around baked in).  Lets the device
    # expand the atlas into quad rows [T,12] with ONE big gather and then fetch a
    # whole bilinear footprint per sample with ONE row gather instead of four
    # (gather count is the texture-filter cost on TPU, PERF.md).
    quad_idx: np.ndarray


def _quad_indices(t: TextureData) -> np.ndarray:
    """[total_texels, 4] LOCAL rows of each texel's 2x2 bilinear footprint,
    wrap-around addressing per level (Texture.cpp:131-147 semantics)."""
    out = np.zeros((t.data.shape[0], 4), np.int64)
    for lv in range(t.mip_levels):
        lw = max(t.width >> lv, 1)
        lh = max(t.height >> lv, 1)
        off = int(t.mip_offsets[lv])
        xx, yy = np.meshgrid(np.arange(lw), np.arange(lh))
        x1 = (xx + 1) % lw
        y1 = (yy + 1) % lh
        quad = np.stack(
            [
                off + xx + yy * lw,
                off + x1 + yy * lw,
                off + xx + y1 * lw,
                off + x1 + y1 * lw,
            ],
            axis=-1,
        )
        out[off : off + lw * lh] = quad.reshape(-1, 4)
    return out


def build_atlas(textures: list) -> TextureAtlas:
    """Pack textures into one flat buffer. Index 0 = "no texture" (white 1x1)."""
    none_tex = TextureData(
        data=np.ones((1, 3), np.float32),
        width=1,
        height=1,
        mip_levels=1,
        mip_offsets=np.zeros((1,), np.int64),
    )
    all_tex = [none_tex] + list(textures)

    k = len(all_tex)
    width = np.zeros((k,), np.int32)
    height = np.zeros((k,), np.int32)
    mip_levels = np.zeros((k,), np.int32)
    mip_offsets = np.zeros((k, MAX_MIP_LEVELS), np.int32)
    chunks = []
    quads = []
    base = 0
    for i, t in enumerate(all_tex):
        width[i] = t.width
        height[i] = t.height
        mip_levels[i] = t.mip_levels
        offs = base + t.mip_offsets
        mip_offsets[i, : t.mip_levels] = offs
        # pad remaining slots with the last mip so out-of-range gathers stay in-bounds
        if t.mip_levels < MAX_MIP_LEVELS:
            mip_offsets[i, t.mip_levels :] = offs[-1]
        chunks.append(t.data)
        quads.append(base + _quad_indices(t))
        base += t.data.shape[0]
    return TextureAtlas(
        data=np.concatenate(chunks, axis=0).astype(np.float32),
        width=width,
        height=height,
        mip_levels=mip_levels,
        mip_offsets=mip_offsets,
        quad_idx=np.concatenate(quads, axis=0).astype(np.int32),
    )
