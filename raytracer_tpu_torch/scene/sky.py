"""Sky environment lighting: Debevec angular-map light probes.

The reference whole-file-reads a raw square ``.float`` image of packed float32 RGB
triples (Sky.cpp:8-26) and samples it as the miss shader.  We support the same file
format plus a procedural fallback (the repo snapshot of the reference is missing its
``rnl_probe.float`` asset — SURVEY.md end of section 6), generated in the exact same
angular-map parameterization so the device sampling math (ops/sky_sample.py) is shared.
"""

from __future__ import annotations

import numpy as np


def load_probe(path: str) -> np.ndarray:
    """Load a raw .float angular map -> [size*size, 3] float32 (Sky.cpp:8-26)."""
    raw = np.fromfile(path, dtype=np.float32)
    assert raw.size % 3 == 0, f"{path}: not a packed RGB float file"
    n = raw.size // 3
    size = int(np.sqrt(n))
    assert size * size == n, f"{path}: not square ({n} texels)"
    return raw.reshape(n, 3), size


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
