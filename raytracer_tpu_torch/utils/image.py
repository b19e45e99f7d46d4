"""Image IO: 8-bit RGB PNGs written and read with the standard library (zlib +
struct), so the frame loop needs no imaging package.  Replaces the reference's
SDL/GL presentation with headless rendering to arrays + saved PNGs."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_srgb_u8(linear_image: np.ndarray) -> np.ndarray:
    """Linear [H,W,3] float -> gamma-2.2 uint8 (Window.h:56-65 packs clamped RGB;
    the present shaders apply pow(1/2.2), fragment_identity.glsl:10-12)."""
    img = np.clip(np.asarray(linear_image), 0.0, 1.0) ** (1.0 / 2.2)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """[H,W,3] uint8 -> the bytes of an 8-bit RGB PNG (filter 0 on every row)."""
    h, w, c = rgb.shape
    if c != 3 or rgb.dtype != np.uint8:
        raise ValueError("encode_png: [H,W,3] uint8 expected")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, image: np.ndarray, gamma: bool = True) -> None:
    """Write a [H,W,3] float image: linear (gamma 1/2.2 applied, as the JAX
    package's ``save_png``) or, with ``gamma=False``, already gamma-space."""
    arr = to_srgb_u8(image) if gamma else (
        np.clip(np.asarray(image), 0, 1) * 255
    ).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def load_png(path: str) -> np.ndarray:
    """[H,W,3] float32 in [0,1] of a PNG as ``save_png`` writes it: 8-bit RGB,
    not interlaced, row filter 0.  Raises on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour != 2 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB PNGs are read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 3 * w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only PNGs without row filters are read")
    return rows[:, 1:].reshape(h, w, 3).astype(np.float32) / 255.0
