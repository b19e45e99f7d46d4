"""Frozen copies of the port's procedural assets and texture pyramid: the sky
probe (``raytracer_tpu_torch/scene/sky.py:25-67``), the checker texture
(``scene/scenes.py:38-42``) and the 2x2 box-filtered mip chain
(``scene/textures.py:49-77``, Texture.cpp:93-118), which the reference builds
again from the base texture, as the program does.

Part of the benchmark's yardstick.  Later changes add files beside this one and
never edit it.
"""

from __future__ import annotations

import numpy as np


def procedural_probe(size: int = 256, seed: int = 0) -> tuple:
    """Generate an angular-map probe: blue-to-horizon gradient + warm sun disc.

    Angular map parameterization (https://www.pauldebevec.com/Probes/, Sky.cpp:34-37):
    pixel (u,v) in [0,1]^2 maps to direction where r = sqrt((u-.5)^2+(v-.5)^2),
    phi = atan2(v-.5, u-.5), theta = 2*pi*r;  dir = (sin th cos ph, sin th sin ph, cos th)
    i.e. the image center looks down +z, the ring r=0.5 is z=-1.
    """
    u, v = np.meshgrid(
        (np.arange(size) + 0.5) / size, (np.arange(size) + 0.5) / size, indexing="xy"
    )
    du = u - 0.5
    dv = v - 0.5
    r = np.sqrt(du * du + dv * dv)
    theta = 2.0 * np.pi * np.minimum(r, 0.5)
    phi = np.arctan2(dv, du)
    dir_x = np.sin(theta) * np.cos(phi)
    dir_y = np.sin(theta) * np.sin(phi)
    dir_z = np.cos(theta)

    # World-up is +y in the scenes; treat probe +y as up.
    elevation = dir_y  # -1 .. 1
    horizon = np.clip(1.0 - np.abs(elevation), 0.0, 1.0) ** 3
    zenith = np.clip(elevation, 0.0, 1.0)
    ground = np.clip(-elevation, 0.0, 1.0)

    col = np.zeros((size, size, 3), np.float32)
    # sky gradient
    col[..., 0] = 0.35 * horizon + 0.10 * zenith + 0.18 * ground
    col[..., 1] = 0.45 * horizon + 0.25 * zenith + 0.16 * ground
    col[..., 2] = 0.70 * horizon + 0.55 * zenith + 0.14 * ground

    # sun disc + glow
    sun_dir = np.array([0.35, 0.65, 0.35])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    cos_sun = dir_x * sun_dir[0] + dir_y * sun_dir[1] + dir_z * sun_dir[2]
    glow = np.exp((cos_sun - 1.0) * 40.0)
    disc = (cos_sun > 0.9995).astype(np.float32)
    col[..., 0] += 6.0 * glow + 40.0 * disc
    col[..., 1] += 5.0 * glow + 36.0 * disc
    col[..., 2] += 3.5 * glow + 30.0 * disc

    return col.reshape(-1, 3).astype(np.float32), size


def _checker_texture(size: int = 256) -> np.ndarray:
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    c = ((i // 32 + j // 32) % 2).astype(np.float32)
    rgb = np.stack([0.2 + 0.6 * c] * 3, axis=-1)
    return rgb


def mip_chain(rgb: np.ndarray) -> list:
    """The mip levels of an [H,W,3] linear texture, finest first: 2x2 box filter
    per level down to one row or column, only for power-of-two sides
    (``scene/textures.py:49-68``, with ``srgb=False`` as the packer calls it)."""
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w = rgb.shape[:2]
    levels = [rgb]
    if w > 0 and h > 0 and (w & (w - 1)) == 0 and (h & (h - 1)) == 0:
        cur = rgb
        while cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = 0.25 * (
                cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
            )
            levels.append(cur.astype(np.float32))
    return levels
