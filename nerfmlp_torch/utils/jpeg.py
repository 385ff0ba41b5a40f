"""A JPEG decoder on numpy and the standard library, whose pixels equal
those of libjpeg-turbo with its default settings (what
``Image.open(path).convert("RGB")`` gives with Pillow), so that the port
reads the JPEG captures of LLFF scenes with no imaging package.

What it reads: Huffman-coded JPEG at 8-bit precision, sequential (SOF0
baseline and SOF1 extended) or progressive (SOF2: spectral selection and
successive approximation), one component (greyscale) or three (YCbCr, or
RGB where an Adobe marker or the component ids say so); 8- and 16-bit
quantisation tables; restart intervals, in progressive scans too;
interleaved and non-interleaved scans. APPn and COM segments are skipped,
so EXIF orientation is ignored, as ``Image.open`` ignores it.

How, step by step as libjpeg-turbo does it (its files named):

  * Huffman decoding from 16-bit lookup tables, one symbol per lookup;
    a progressive scan's DC first and refinement passes, AC first passes
    with end-of-band runs and AC refinement passes (``jdphuff.c``) build
    the coefficients up in the same per-component arrays, the
    quantisation table latched at the component's first scan; the whole
    file is read before the inverse DCT, as Pillow reads it, so no block
    smoothing applies;
  * dequantisation and the integer "islow" inverse DCT with its range
    limiting (``jidctint.c``: ``CONST_BITS`` 13, ``PASS1_BITS`` 2), over
    all blocks at once in numpy;
  * chroma upsampling with the "fancy" triangle filters (``jdsample.c``:
    h2v1, h2v2, h1v2) and edge replication at the components' real sizes,
    box replication for the other integral ratios;
  * YCbCr -> RGB through the fixed-point tables of ``jdcolor.c``
    (``SCALEBITS`` 16).

What it refuses, by name (ValueError, naming ROADMAP.md's item): lossless
(SOF3) and hierarchical (SOF5-7) JPEG, arithmetic coding (SOF9 and above,
DAC), 12-bit samples, four components (CMYK, YCCK), a height given by a
DNL marker. A stream that ends before its last MCU, or without an EOI
marker, is refused as truncated.
"""

from __future__ import annotations

import struct
from array import array

import numpy as np

NOT_DECODED = ("is not decoded by the PyTorch port (ROADMAP.md, Queue 1 "
               "item 28)")

# Natural-order index of the k-th coefficient in zig-zag order.
_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)

_REFUSED_SOF = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)",
}


def _refuse(name: str, what: str):
    raise ValueError(f"{name}: {what} {NOT_DECODED}")


def _truncated(name: str, where: str):
    raise ValueError(f"{name}: truncated JPEG stream ({where})")


class _Huffman:
    """One Huffman table as a 16-bit lookup: ``lut[next 16 bits]`` is
    ``(code length << 8) | symbol``, 0 where no code starts."""

    def __init__(self, counts, symbols):
        self.counts, self.symbols = bytes(counts), bytes(symbols)
        lut = [0] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            span = 1 << (16 - length)
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    raise ValueError("bad Huffman table")
                lo = code << (16 - length)
                lut[lo:lo + span] = [(length << 8) | symbols[k]] * span
                code += 1
                k += 1
            code <<= 1
        self.lut = lut


class _Component:
    """A frame component: its sampling factors, quantisation table (the
    one in force at its first scan, as libjpeg latches it) and quantised
    coefficients, int16 in natural order, over the MCU-padded block grid
    ``coefs_shape``; ``width_px`` / ``height_px`` its real size."""

    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.td = self.ta = 0     # its Huffman tables in its (last) scan
        self.quant = None
        self.scanned = False
        self.image_w = self.image_h = self.width_px = self.height_px = 0
        self.coefs_shape = (0, 0)
        self.flat = None


def _scan_end(data: bytes, pos: int):
    """(end, [restart marker offsets]) of the entropy-coded data starting
    at ``pos``: the first marker that is not RSTn (stuffed 0xFF00 and fill
    bytes skipped), or len(data) if none."""
    rst = []
    n = len(data)
    i = data.find(b"\xff", pos)
    while 0 <= i < n - 1:
        b = data[i + 1]
        if b == 0x00:
            i = data.find(b"\xff", i + 2)
        elif 0xD0 <= b <= 0xD7:
            rst.append(i)
            i = data.find(b"\xff", i + 2)
        elif b == 0xFF:
            i += 1
        else:
            return i, rst
    return n, rst


def _decode_blocks(buf: bytes, blocks, dc_luts, ac_luts, n_bits: int,
                   name: str) -> None:
    """Decode ``blocks`` — (coefficient array, offset, component slot) per
    block in scan order — from one restart interval's unstuffed bytes
    ``buf`` (padded), each block's DC difference against its component's
    predictor (which starts at 0)."""
    zz = _ZIGZAG
    frombytes = int.from_bytes
    pred = [0] * len(dc_luts)
    p = 0
    for coefs, base, slot in blocks:
        # DC: a size category, then that many bits of the difference.
        q = p >> 3
        w = frombytes(buf[q:q + 6], "big")
        avail = 48 - (p & 7)
        e = dc_luts[slot][(w >> (avail - 16)) & 0xFFFF]
        if not e:
            raise ValueError(f"{name}: bad Huffman code in a DC term")
        length, s = e >> 8, e & 0xFF
        diff = 0
        if s:
            diff = (w >> (avail - length - s)) & ((1 << s) - 1)
            if diff < 1 << (s - 1):
                diff -= (1 << s) - 1
        p += length + s
        pred[slot] += diff
        coefs[base] = pred[slot]
        # AC: (run, size) symbols until end of block.
        lut = ac_luts[slot]
        k = 1
        while k < 64:
            q = p >> 3
            w = frombytes(buf[q:q + 6], "big")
            avail = 48 - (p & 7)
            e = lut[(w >> (avail - 16)) & 0xFFFF]
            if not e:
                raise ValueError(f"{name}: bad Huffman code in an AC term")
            length, rs = e >> 8, e & 0xFF
            s = rs & 15
            if not s:
                p += length
                if rs != 0xF0:
                    break            # end of block
                k += 16              # sixteen zeros
                continue
            k += rs >> 4
            if k > 63:
                raise ValueError(f"{name}: AC run past the block's end")
            v = (w >> (avail - length - s)) & ((1 << s) - 1)
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            coefs[base + zz[k]] = v
            p += length + s
            k += 1
    if p > n_bits:
        _truncated(name, "the entropy-coded data ends inside a block")


def _read_bits(buf: bytes, p: int, n: int) -> int:
    """The ``n`` (<= 16) bits at bit ``p`` of ``buf``, MSB first."""
    w = int.from_bytes(buf[p >> 3:(p >> 3) + 4], "big")
    return (w >> (32 - (p & 7) - n)) & ((1 << n) - 1)


def _huff_symbol(buf: bytes, p: int, lut, name: str, what: str):
    """(code length, symbol) of the Huffman code at bit ``p``."""
    e = lut[_read_bits(buf, p, 16)]
    if not e:
        raise ValueError(f"{name}: bad Huffman code in {what}")
    return e >> 8, e & 0xFF


def _extend(v: int, s: int) -> int:
    """HUFF_EXTEND: ``s`` bits ``v`` as a signed difference."""
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _decode_progressive(buf: bytes, blocks, luts, n_bits: int, ss: int,
                        se: int, ah: int, al: int, name: str) -> None:
    """One restart interval of a progressive scan (libjpeg-turbo's
    ``jdphuff.c``: ``decode_mcu_DC_first``, ``decode_mcu_DC_refine``,
    ``decode_mcu_AC_first``, ``decode_mcu_AC_refine``) into ``blocks``'
    coefficients; ``luts``: each scan component's DC (DC scans) or AC
    table. The DC predictors and the end-of-band run start at 0."""
    zz = _ZIGZAG
    p = 0
    if ss == 0:                                         # DC scans
        pred = [0] * len(luts)
        for coefs, base, slot in blocks:
            if ah:                                      # refinement: 1 bit
                if _read_bits(buf, p, 1):
                    coefs[base] |= 1 << al
                p += 1
                continue
            length, s = _huff_symbol(buf, p, luts[slot], name, "a DC term")
            p += length
            diff = 0
            if s:
                diff = _extend(_read_bits(buf, p, s), s)
                p += s
            pred[slot] += diff
            coefs[base] = pred[slot] << al
    elif not ah:                                        # AC first
        lut = luts[0]
        eobrun = 0
        for coefs, base, _ in blocks:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                length, rs = _huff_symbol(buf, p, lut, name, "an AC term")
                p += length
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError(f"{name}: AC run past the block's "
                                         "end")
                    coefs[base + zz[k]] = _extend(_read_bits(buf, p, s),
                                                  s) << al
                    p += s
                elif r == 15:
                    k += 15                             # sixteen zeros
                else:                                   # end of band
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(buf, p, r)
                        p += r
                    eobrun -= 1
                    break
                k += 1
    else:                                               # AC refinement
        lut = luts[0]
        p1, m1 = 1 << al, -1 << al
        eobrun = 0
        for coefs, base, _ in blocks:
            k = ss
            if not eobrun:
                while k <= se:
                    length, rs = _huff_symbol(buf, p, lut, name,
                                              "an AC refinement")
                    p += length
                    r, s = rs >> 4, rs & 15
                    if s:
                        # Size 1 in a valid stream; libjpeg warns and reads
                        # one sign bit whatever it is.
                        s = p1 if _read_bits(buf, p, 1) else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += _read_bits(buf, p, r)
                            p += r
                        break
                    # Skip r zero terms, refining the nonzero ones passed.
                    while k <= se:
                        i = base + zz[k]
                        c = coefs[i]
                        if c:
                            if _read_bits(buf, p, 1) and not c & p1:
                                coefs[i] = c + (p1 if c >= 0 else m1)
                            p += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s:
                        if k > 63:
                            raise ValueError(f"{name}: AC run past the "
                                             "block's end")
                        coefs[base + zz[k]] = s
                    k += 1
            if eobrun:
                # The band's remaining nonzero terms take a correction bit.
                while k <= se:
                    i = base + zz[k]
                    c = coefs[i]
                    if c:
                        if _read_bits(buf, p, 1) and not c & p1:
                            coefs[i] = c + (p1 if c >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1
    if p > n_bits:
        _truncated(name, "the entropy-coded data ends inside a block")


def _decode_scan(data, pos, comps, scan, huff, restart, name,
                 progression=None):
    """Decode one scan starting at ``pos`` into its components'
    coefficient arrays: sequential, or with ``progression`` (Ss, Se, Ah,
    Al) one scan of a progressive frame. Returns the position of the
    marker after it."""
    end, rst = _scan_end(data, pos)
    if end >= len(data) - 1:
        _truncated(name, "no marker after the last scan")
    pieces, start = [], pos
    for r in rst:
        pieces.append(data[start:r])
        start = r + 2
    pieces.append(data[start:end])

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    blocks = []
    if len(scan) == 1:
        # Non-interleaved: one block an MCU, over the component's own
        # blocks (its real size, not the MCU-padded one).
        c = scan[0][0]
        cols = c.coefs_shape[1]
        for by in range(-(-c.height_px // 8)):
            for bx in range(-(-c.width_px // 8)):
                blocks.append((c.flat, (by * cols + bx) * 64, 0))
    else:
        mcux = -(-comps[0].image_w // (8 * hmax))
        mcuy = -(-comps[0].image_h // (8 * vmax))
        for my in range(mcuy):
            for mx in range(mcux):
                for slot, (c, _, _) in enumerate(scan):
                    cols = c.coefs_shape[1]
                    for v in range(c.v):
                        for h in range(c.h):
                            blocks.append((c.flat, ((my * c.v + v) * cols
                                                    + mx * c.h + h) * 64,
                                           slot))
    if len(scan) == 1:
        per_mcu = 1
    else:
        per_mcu = sum(c.h * c.v for c, _, _ in scan)
    n_mcus = len(blocks) // per_mcu
    interval = restart or n_mcus
    n_intervals = -(-n_mcus // interval)
    if len(pieces) < n_intervals:
        _truncated(name, f"{len(pieces)} of {n_intervals} restart intervals")
    if progression is None:
        dc_luts = [huff[(0, td)].lut for _, td, _ in scan]
        ac_luts = [huff[(1, ta)].lut for _, _, ta in scan]
    else:
        ss, se, ah, al = progression
        luts = ([None] * len(scan) if ss == 0 and ah else
                [huff[(0, td)].lut for _, td, _ in scan] if ss == 0 else
                [huff[(1, ta)].lut for _, _, ta in scan])
    for i in range(n_intervals):
        piece = pieces[i].replace(b"\xff\x00", b"\xff")
        chunk = blocks[i * interval * per_mcu:(i + 1) * interval * per_mcu]
        if progression is None:
            _decode_blocks(piece + b"\x00" * 8, chunk, dc_luts, ac_luts,
                           8 * len(piece), name)
        else:
            _decode_progressive(piece + b"\x00" * 8, chunk, luts,
                                8 * len(piece), ss, se, ah, al, name)
    return end


# -- inverse DCT (jidctint.c, jpeg_idct_islow) --------------------------- #
_CONST_BITS, _PASS1_BITS = 13, 2


def _idct_1d(d):
    """The islow 1-D inverse DCT of the eight int64 arrays ``d`` (one per
    input index), before descaling: its eight outputs."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t0 = t0 * 2446                              # FIX_0_298631336
    t1 = t1 * 16819                             # FIX_2_053119869
    t2 = t2 * 25172                             # FIX_3_072711026
    t3 = t3 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _idct_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit (jdmaster.c,
    prepare_range_limit_table), indexed by the descaled value & 1023:
    value + 128 clamped to [0, 255] for values in [-512, 511]."""
    t = np.empty(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[512:896] = 0
    t[896:] = np.arange(128)
    return t


_IDCT_LIMIT = _idct_limit_table()


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(..., 64) quantised coefficients in natural order and their (64,)
    table -> (..., 8, 8) uint8 samples, as jpeg_idct_islow gives them."""
    x = coefs.astype(np.int64) * quant.astype(np.int64)
    x = x.reshape(x.shape[:-1] + (8, 8))
    # Pass 1: columns (the input's row index u), into the work array.
    cols = _idct_1d([x[..., u, :] for u in range(8)])
    half = 1 << (_CONST_BITS - _PASS1_BITS - 1)
    ws = np.stack([(c + half) >> (_CONST_BITS - _PASS1_BITS) for c in cols],
                  axis=-2)
    # Pass 2: rows of the work array, descaled by 3 more for the 8x8 scale.
    shift = _CONST_BITS + _PASS1_BITS + 3
    rows = _idct_1d([ws[..., v] for v in range(8)])
    out = np.stack([(r + (1 << (shift - 1))) >> shift for r in rows],
                   axis=-1)
    return _IDCT_LIMIT[out & 1023]


# -- upsampling (jdsample.c) ---------------------------------------------- #
def _rows_nb(c: np.ndarray):
    """Each row's neighbour above and below, the edge rows replicated."""
    up = np.concatenate([c[:1], c[:-1]], axis=0)
    down = np.concatenate([c[1:], c[-1:]], axis=0)
    return up, down


def _cols_nb(c: np.ndarray):
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    return left, right


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        a.shape[:axis] + (2 * a.shape[axis],) + a.shape[axis + 1:])


def _h2v1_fancy(c):
    left, right = _cols_nb(c)
    return _interleave((3 * c + left + 1) >> 2, (3 * c + right + 2) >> 2, 1)


def _h1v2_fancy(c):
    up, down = _rows_nb(c)
    return _interleave((3 * c + up + 1) >> 2, (3 * c + down + 2) >> 2, 0)


def _h2v2_fancy(c):
    up, down = _rows_nb(c)
    out = []
    for colsum in (3 * c + up, 3 * c + down):
        left, right = _cols_nb(colsum)
        out.append(_interleave((3 * colsum + left + 8) >> 4,
                               (3 * colsum + right + 7) >> 4, 1))
    return _interleave(out[0], out[1], 0)


def _upsample(c: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """One component plane (its real size, int32) scaled up ``hx`` x
    ``vx``, by the method libjpeg-turbo picks with fancy upsampling on
    (jinit_upsampler)."""
    w = c.shape[1]
    if (hx, vx) == (1, 1):
        return c
    if (hx, vx) == (2, 1) and w > 2:
        return _h2v1_fancy(c)
    if (hx, vx) == (1, 2):
        return _h1v2_fancy(c)
    if (hx, vx) == (2, 2) and w > 2:
        return _h2v2_fancy(c)
    return np.repeat(np.repeat(c, vx, axis=0), hx, axis=1)


# -- colour (jdcolor.c) --------------------------------------------------- #
def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((_fix(1.40200) * x + half) >> 16,      # Cr -> R
            (_fix(1.77200) * x + half) >> 16,      # Cb -> B
            -_fix(0.71414) * x,                    # Cr -> G, scaled
            -_fix(0.34414) * x + half)             # Cb -> G, scaled + 1/2


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 YCbCr planes -> (H, W, 3) uint8 RGB, ycc_rgb_convert's
    arithmetic."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# -- the file ------------------------------------------------------------- #
def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """JPEG file bytes -> uint8 (H, W, C) pixels: C = 1 for greyscale, 3
    for colour (RGB). ``name`` labels the errors."""
    frame = parse_jpeg(data, name)
    return _pixels(frame["comps"], frame["size"], frame["adobe"],
                   frame["jfif"])


def parse_jpeg(data: bytes, name: str = "JPEG") -> dict:
    """Every marker of a JPEG file read and its scans entropy-decoded:
    {"size": (H, W), "comps": the frame's components (each with its
    quantised coefficients), "huffman": {(class, id): table}, "adobe":
    the Adobe marker's transform flag or None, "jfif": whether a JFIF
    marker was seen}."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    quant, huff, comps = {}, {}, None
    progressive = False
    restart = 0
    adobe = None            # the Adobe marker's transform flag
    jfif = False
    size = None
    pos = 2
    n = len(data)
    while True:
        if pos + 2 > n:
            _truncated(name, "no EOI marker")
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: bad JPEG marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                  # fill byte
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:                  # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n:
            _truncated(name, f"in the header of marker 0x{marker:02X}")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if pos + length > n or length < 2:
            _truncated(name, f"in segment 0x{marker:02X}")
        pos += length
        if marker == 0xDB:                  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[i + 1:i + 129])
                    i += 129
                else:
                    vals = seg[i + 1:i + 65]
                    i += 65
                if len(vals) != 64:
                    raise ValueError(f"{name}: short quantisation table")
                table = np.zeros(64, np.int64)
                table[list(_ZIGZAG)] = list(vals)
                quant[tq] = table
        elif marker == 0xC4:                # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                symbols = seg[i + 17:i + 17 + total]
                if len(counts) != 16 or len(symbols) != total:
                    raise ValueError(f"{name}: short Huffman table")
                huff[(tc, th)] = _Huffman(counts, symbols)
                i += 17 + total
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0, SOF1, SOF2 progressive
            progressive = marker == 0xC2
            precision, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                _refuse(name, f"{precision}-bit JPEG")
            if h == 0:
                _refuse(name, "a JPEG whose height is given by a DNL marker")
            if nc == 4:
                _refuse(name, "four-component (CMYK or YCCK) JPEG")
            if nc not in (1, 3):
                _refuse(name, f"{nc}-component JPEG")
            comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                                seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nc)]
            size = (h, w)
            if nc == 1:
                comps[0].h = comps[0].v = 1
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                if c.h not in (1, 2, 3, 4) or c.v not in (1, 2, 3, 4):
                    raise ValueError(f"{name}: bad sampling factors")
                c.image_w, c.image_h = w, h
                c.width_px = -(-w * c.h // hmax)
                c.height_px = -(-h * c.v // vmax)
                c.coefs_shape = (mcuy * c.v, mcux * c.h)
                c.flat = array("h", bytes(2 * 64 * mcuy * c.v * mcux * c.h))
        elif marker in _REFUSED_SOF:
            _refuse(name, _REFUSED_SOF[marker])
        elif marker >= 0xC9 and marker <= 0xCF or marker == 0xCC:
            _refuse(name, f"arithmetic-coded JPEG (marker 0x{marker:02X})")
        elif marker == 0xDD:                # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDC:
            _refuse(name, "a JPEG whose height is given by a DNL marker")
        elif marker == 0xDA:                # SOS
            if comps is None:
                raise ValueError(f"{name}: scan before the frame header")
            ns = seg[0]
            ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
            progression = None
            if progressive:
                progression = (ss, se, ahl >> 4, ahl & 15)
                if (ss > se or se > 63 or (ss == 0) != (se == 0)
                        or (ss and ns != 1)):
                    raise ValueError(f"{name}: bad progressive scan "
                                     f"({ss}-{se}, {ns} components)")
            # The Huffman tables the scan decodes with: a DC refinement
            # needs none, a progressive AC scan only its AC table.
            need_dc = progression is None or (ss == 0 and not ahl >> 4)
            need_ac = progression is None or ss > 0
            scan = []
            for k in range(ns):
                cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
                found = [c for c in comps if c.id == cid]
                if not found:
                    raise ValueError(f"{name}: scan of unknown component "
                                     f"{cid}")
                c = found[0]
                td, ta = tables >> 4, tables & 15
                if ((need_dc and (0, td) not in huff)
                        or (need_ac and (1, ta) not in huff)):
                    raise ValueError(f"{name}: scan uses an undefined "
                                     "Huffman table")
                if c.quant is None:
                    if c.tq not in quant:
                        raise ValueError(f"{name}: component {cid} uses an "
                                         "undefined quantisation table")
                    c.quant = quant[c.tq]
                c.scanned, c.td, c.ta = True, td, ta
                scan.append((c, td, ta))
            pos = _decode_scan(data, pos, comps, scan, huff, restart, name,
                               progression)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
    if comps is None or not all(c.scanned for c in comps):
        _truncated(name, "a component without a scan")
    return {"size": size, "comps": comps, "huffman": huff, "adobe": adobe,
            "jfif": jfif}


def _pixels(comps, size, adobe, jfif) -> np.ndarray:
    h, w = size
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        rows, cols = c.coefs_shape
        coefs = np.frombuffer(c.flat, dtype=np.int16).reshape(rows, cols, 64)
        px = idct_islow(coefs, c.quant)                    # rows, cols, 8, 8
        px = px.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        px = px[:c.height_px, :c.width_px].astype(np.int32)
        planes.append(_upsample(px, hmax // c.h, vmax // c.v)[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[..., None]
    # libjpeg's colour space guess (jdapimin.c, default_decompress_parms).
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.id for c in comps] == [ord("R"), ord("G"), ord("B")]
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*(p.astype(np.uint8) for p in planes))


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> uint8 (H, W, C) pixels (:func:`decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), name=path)
