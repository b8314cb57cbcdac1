"""PNG output, barycentric shading and the leaf-visit heat map.

`write_png` uses the repo's C++ writer (`utils/native.py`) when it loads,
else the dependency-free zlib encoder below; both write the same pixels.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_png(path: str, rgba: np.ndarray, prefer_native: bool = True) -> str:
    """rgba: u8[H, W, 4]. Returns the codec that wrote the file: "native"
    (the C++ writer, when `prefer_native` and the library loads) or
    "python"."""
    h, w, c = rgba.shape
    if c != 4 or rgba.dtype != np.uint8:
        raise ValueError("write_png expects u8[H, W, 4]")
    if prefer_native:
        from . import native

        if native.write_png(path, rgba):
            return "native"

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgba[r].tobytes() for r in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
    return "python"


def shade_barycentric(hit_prim, hit_u, hit_v, width: int, height: int) -> np.ndarray:
    """RGBA = (u, v, 1-u-v) * 255 on a hit, else 0. The flat ray index is
    x * height + y, so the image is [W, H] (the reference renderer's
    orientation)."""
    u = _np(hit_u)
    v = _np(hit_v)
    hit = _np(hit_prim) >= 0
    img = np.zeros((width * height, 4), np.uint8)
    w = 1.0 - u - v
    img[hit, 0] = np.clip(u[hit] * 255, 0, 255).astype(np.uint8)
    img[hit, 1] = np.clip(v[hit] * 255, 0, 255).astype(np.uint8)
    img[hit, 2] = np.clip(w[hit] * 255, 0, 255).astype(np.uint8)
    img[hit, 3] = 255
    return img.reshape(width, height, 4)


def heatmap(counts, width: int, height: int) -> np.ndarray:
    """The reference's traversal heat map: each ray's leaf visits over the
    most any ray made, as red 150x and green 255x that share on full blue
    and alpha, an image [W, H] like `shade_barycentric`'s."""
    c = _np(counts).astype(np.float64)
    m = c.max() if c.max() > 0 else 1.0
    norm = c / m
    img = np.zeros((width * height, 4), np.uint8)
    img[:, 0] = np.clip(norm * 150, 0, 255).astype(np.uint8)
    img[:, 1] = np.clip(norm * 255, 0, 255).astype(np.uint8)
    img[:, 2] = 255
    img[:, 3] = 255
    return img.reshape(width, height, 4)
