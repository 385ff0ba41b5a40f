"""Small image helpers: ``to8b``, and a PNG encoder and decoder on the
standard library (``zlib`` + ``struct``), so serving and training need no
imaging package. Counterpart of ``nerfmlp_tpu/utils/image.py:1-40``
(``to8b``, ``save_png``, ``load_png``), which uses PIL."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour types this reader takes (8-bit): channels per pixel.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) image (uint8, or float in [0, 1]) as a PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to8b(arr)
    with open(path, "wb") as f:
        f.write(png_bytes(arr))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, expected "
                         f"{h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:      # Sub: running sum per byte lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.int64)
            row = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).ravel()
        elif kind == 2:      # Up
            row = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(stride)
            up = prior.tolist()
            src = line.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[x - bpp] if x >= bpp else 0)
                cur[x] = (src[x] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 (H, W, C) pixels: 8-bit grey, grey+alpha, RGB or
    RGBA, not interlaced, no palette. Every row filter is undone."""
    with open(path, "rb") as f:
        body = f.read()
    if body[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(body):
        (length,) = struct.unpack(">I", body[pos:pos + 4])
        tag = body[pos + 4:pos + 8]
        data = body[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, RGB or "
                         f"RGBA PNGs are read (bit depth {depth}, colour "
                         f"type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return pixels.reshape(h, w, ch)


def load_png(path: str) -> np.ndarray:
    """PNG -> float32 [0, 1] RGB array."""
    px = read_png(path)
    if px.shape[2] in (1, 2):
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].astype(np.float32) / 255.0
