"""Small image helpers on numpy and the standard library, so serving,
training and rendering need no imaging package: ``to8b``; a PNG encoder
and decoder (``zlib`` + ``struct``); :func:`read_image`, PNG or baseline
JPEG pixels (``utils/jpeg.py``, equal to Pillow's; the JPEG modes it
refuses are refused by name), and the image size from a PNG or JPEG
header; a LANCZOS resize equal to Pillow's; an animated-GIF writer for
videos.

Counterpart of ``nerfmlp_tpu/utils/image.py`` (``to8b``, ``save_png``,
``load_png``, ``write_video``), which uses PIL and imageio, and of the
``Image.resize(img_wh, LANCZOS)`` call in ``nerfmlp_tpu/data/blender.py``.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour types this reader takes (8-bit): channels per pixel.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}
IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def to8b(x: np.ndarray) -> np.ndarray:
    """[0,1] float image -> uint8 (clip, scale, truncate)."""
    return (255 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 (H, W, C) pixels -> PNG file bytes: C = 3 RGB (as served), 1
    grey, 2 grey + alpha, 4 RGBA (8-bit, no interlace, filter 0 on every
    row)."""
    arr = np.asarray(img)
    if (arr.dtype != np.uint8 or arr.ndim != 3
            or arr.shape[2] not in _COLOUR_TYPE):
        raise ValueError(f"png_bytes takes (H, W, C) uint8 pixels, C in "
                         f"1-4, got {arr.shape} {arr.dtype}")
    h, w, c = arr.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
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


def _is_jpeg(path: str) -> bool:
    """Whether the file starts with JPEG's SOI marker (how Pillow tells a
    JPEG, whatever its name)."""
    with open(path, "rb") as f:
        return f.read(2) == b"\xff\xd8"


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file, told apart by its first bytes as Pillow tells
    them -> uint8 (H, W, C) pixels: PNG's channels (:func:`read_png`), or
    a JPEG's (1 grey or 3 RGB, :func:`~nerfmlp_torch.utils.jpeg.decode_jpeg`)."""
    from nerfmlp_torch.utils.jpeg import read_jpeg

    return read_jpeg(path) if _is_jpeg(path) else read_png(path)


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3) as ``Image.open(path).convert("RGB")`` gives it:
    grey replicated, alpha dropped."""
    px = read_image(path)
    if px.shape[2] in (1, 2):
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3]


def png_size(path: str):
    """(width, height) from a PNG's IHDR chunk, without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def _jpeg_size(path: str):
    """(width, height) from a JPEG's start-of-frame marker."""
    with open(path, "rb") as f:
        b = f.read()
    if b[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    while pos + 4 <= len(b):
        if b[pos] != 0xFF:
            raise ValueError(f"{path}: bad JPEG marker at {pos}")
        marker = b[pos + 1]
        if marker == 0xFF:          # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:   # no length
            pos += 2
            continue
        (length,) = struct.unpack(">H", b[pos + 2:pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", b[pos + 5:pos + 9])
            return w, h
        pos += 2 + length
    raise ValueError(f"{path}: JPEG without a start-of-frame marker")


def image_size(path: str):
    """(width, height) of a PNG or JPEG file, from its header alone (what
    the JAX loaders read with ``Image.open(path).size``)."""
    return _jpeg_size(path) if _is_jpeg(path) else png_size(path)


def load_png(path: str) -> np.ndarray:
    """PNG -> float32 [0, 1] RGB array."""
    px = read_png(path)
    if px.shape[2] in (1, 2):
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].astype(np.float32) / 255.0


# -- Resize ---------------------------------------------------------------
# Pillow's 8-bit resampling (libImaging/Resample.c): coefficients in fixed
# point with this many fraction bits (32 - 8 - 2).
_PRECISION_BITS = 22
_LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -_LANCZOS_SUPPORT <= x < _LANCZOS_SUPPORT:
        return _sinc(x) * _sinc(x / _LANCZOS_SUPPORT)
    return 0.0


def _lanczos_taps(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one
    axis: (first input index (out,), fixed-point weights (out, ksize)).

    Scalar float64 arithmetic in Pillow's order: libm's ``sin`` (as
    ``math.sin``), the weights summed left to right (not ``sum``, which
    compensates), divided by that sum, scaled by 2^22 and rounded half
    away from 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    inv = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * inv) for x in range(n)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            v = (v / total if total != 0.0 else v) * (1 << _PRECISION_BITS)
            taps[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        first[xx] = xmin
    return first, taps


def _resample_axis(px: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` of int64
    pixels: a rounding offset of 2^21, the taps' products summed, shifted
    down by 22 bits and clipped to [0, 255]."""
    in_size = px.shape[axis]
    first, taps = _lanczos_taps(in_size, out_size)
    bshape = [1] * px.ndim
    bshape[axis] = out_size
    out_shape = list(px.shape)
    out_shape[axis] = out_size
    acc = np.full(out_shape, 1 << (_PRECISION_BITS - 1), np.int64)
    for x in range(taps.shape[1]):
        idx = np.minimum(first + x, in_size - 1)   # weight 0 past the end
        acc += np.take(px, idx, axis=axis) * taps[:, x].reshape(bshape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def resize_lanczos(px: np.ndarray, wh) -> np.ndarray:
    """uint8 (H, W, C) pixels -> uint8 (h, w, C) at ``wh`` = (w, h), equal
    to Pillow's ``Image.resize(wh, Image.Resampling.LANCZOS)`` bit for bit
    (checked against Pillow 12.1.0).

    Pillow's steps, on integers: an image with alpha (C = 2 or 4, the last
    channel) is premultiplied, ``c * a`` divided by 255 as ``MULDIV255``
    (``t = c * a + 128; ((t >> 8) + t) >> 8``); the horizontal pass, then
    the vertical, each in 22-bit fixed point and clipped to uint8 (a pass
    whose size does not change is skipped); then alpha is divided out,
    ``min(255 * c // a, 255)``, where it is neither 0 nor 255. An image
    already at ``wh`` is returned unchanged, as Pillow copies it."""
    arr = np.asarray(px)
    if arr.dtype != np.uint8 or arr.ndim != 3:
        raise ValueError(f"resize_lanczos takes (H, W, C) uint8 pixels, got "
                         f"{arr.shape} {arr.dtype}")
    w, h = int(wh[0]), int(wh[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize_lanczos: size {w}x{h} must be positive")
    if (arr.shape[1], arr.shape[0]) == (w, h):
        return arr.copy()
    a = arr.astype(np.int64)
    has_alpha = a.shape[2] in (2, 4)
    if has_alpha:
        alpha = a[..., -1:]
        t = a[..., :-1] * alpha + 128
        a = np.concatenate([((t >> 8) + t) >> 8, alpha], axis=-1)
    if w != a.shape[1]:
        a = _resample_axis(a, w, axis=1)
    if h != a.shape[0]:
        a = _resample_axis(a, h, axis=0)
    if has_alpha:
        alpha, c = a[..., -1:], a[..., :-1]
        div = np.minimum(255 * c // np.maximum(alpha, 1), 255)
        c = np.where((alpha == 0) | (alpha == 255), c, div)
        a = np.concatenate([c, alpha], axis=-1)
    return a.astype(np.uint8)


# -- Video ----------------------------------------------------------------
# RGB frames are quantised to a fixed 6 x 7 x 6 colour cube (252 of the 256
# palette entries): each channel to the nearest of its evenly spaced
# levels, so no value moves by more than RGB_GIF_MAX_ERR of 255.
_CUBE = (6, 7, 6)
RGB_GIF_MAX_ERR = 25


def _cube_palette() -> np.ndarray:
    r, g, b = (np.round(np.arange(n) * 255.0 / (n - 1)) for n in _CUBE)
    pal = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([pal, np.zeros((256 - len(pal), 3))]).astype(
        np.uint8)


def _cube_indices(rgb: np.ndarray) -> np.ndarray:
    lv = [np.round(rgb[..., i].astype(np.float64) * (n - 1) / 255.0)
          .astype(np.int64) for i, n in enumerate(_CUBE)]
    return ((lv[0] * _CUBE[1] + lv[1]) * _CUBE[2] + lv[2]).astype(np.uint8)


def _lzw(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW code stream (codes packed LSB first): a
    clear code first, a width step each time the next table code needs
    one more bit, and a clear code when the 4,096-code table is full."""
    clear = 1 << min_code_size
    size, nxt = min_code_size + 1, clear + 2
    table = {}
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear, size)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if nxt < 4096:
            table[key] = nxt
            if nxt == 1 << size:
                size += 1
            nxt += 1
        else:
            emit(clear, size)
            table.clear()
            size, nxt = min_code_size + 1, clear + 2
        prefix = b
    emit(prefix, size)
    emit(clear + 1, size)          # end of information
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_bytes(frames, fps: int = 30) -> bytes:
    """uint8 frames, all (H, W) grey or all (H, W, 3) RGB -> an animated
    GIF89a that loops forever (NETSCAPE2.0, loop 0), each frame shown for
    ``max(1000 // fps, 20)`` ms, in GIF's 10 ms units rounded down. Grey
    frames use a 256-grey palette and are exact; RGB frames are mapped to
    a 6 x 7 x 6 colour cube, within ``RGB_GIF_MAX_ERR`` (25 of 255) of
    their values in every channel."""
    frames = [np.asarray(f) for f in frames]
    if not frames or any(f.dtype != np.uint8 for f in frames):
        raise ValueError("gif_bytes takes one or more uint8 frames")
    shape = frames[0].shape
    grey = len(shape) == 2
    if any(f.shape != shape for f in frames) or not (
            grey or (len(shape) == 3 and shape[2] == 3)):
        raise ValueError("gif_bytes takes frames of one shape, (H, W) or "
                         f"(H, W, 3); got {[f.shape for f in frames]}")
    h, w = shape[:2]
    palette = (np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
               if grey else _cube_palette())
    delay = max(1000 // fps, 20) // 10
    out = bytearray(b"GIF89a")
    # Global colour table of 256 entries, 8 bits per primary.
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + palette.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = f if grey else _cube_indices(f)
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08"
        data = _lzw(np.ascontiguousarray(idx).tobytes())
        for i in range(0, len(data), 255):
            out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
        out += b"\x00"
    return bytes(out + b"\x3b")


def write_video(path_base: str, frames, fps: int = 30) -> str:
    """Write frames (uint8, or float in [0, 1]; (H, W) grey or (H, W, 3))
    as the animated GIF ``<path_base>.gif`` (:func:`gif_bytes`) and return
    its path. The JAX package writes mp4 through imageio, else a GIF
    through Pillow; neither is a dependency here."""
    frames = [np.asarray(f) for f in frames]
    frames = [f if f.dtype == np.uint8 else to8b(f) for f in frames]
    path = path_base + ".gif"
    with open(path, "wb") as f:
        f.write(gif_bytes(frames, fps=fps))
    return path
