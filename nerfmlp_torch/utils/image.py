"""Small image helpers: ``to8b`` and a PNG encoder on the standard library
(``zlib`` + ``struct``), so serving needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    """[0,1] float image -> uint8 (clip, scale, truncate)."""
    return (255 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> PNG file bytes (8-bit, no interlace, filter 0
    on every row)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"png_bytes takes (H, W, 3) uint8 pixels, got "
                         f"{arr.shape} {arr.dtype}")
    h, w, _ = arr.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
