"""Write the JPEG fixtures of the port's decoder, from seed 0, with Pillow:

    python tests/data/jpeg/make_fixtures.py

Into this directory:

  * ``cases/<name>.jpg``: small seeded images (37x29, sizes that are not
    multiples of 8 or 16) in every mode the decoder reads — 4:4:4, 4:2:2,
    4:2:0 and 4:4:0 chroma, greyscale, qualities 50-95, restart markers,
    optimised Huffman tables, 16-bit quantisation tables (SOF1), an Adobe
    RGB file and non-interleaved scans; progressive files (``prog_*``,
    libjpeg's default script: spectral selection and successive
    approximation) in 4:2:0 and 4:4:4 chroma, greyscale, with restart
    markers and at 61x45 — and ``cases/<name>.png``, the pixels
    ``Image.open(jpg).convert("RGB")`` gives;
  * ``capture_progressive/``: the capture below stored as progressive
    q90 JPEG (the same quantised coefficients, so the same pixels), which
    ``chip_smoke.py`` decodes, times and trains on;
  * ``capture/``: the 12-view forward-facing capture that ``chip_smoke.py``
    trains in phase 8 (``make_synthetic_llff_scene(style="forward",
    seed=0)``), rendered at 384x288 and stored as JPEG ``images/`` with its
    ``poses_bounds.npy``;
  * ``manifest.json``: each JPEG's Pillow decode, its shape and sha256.

Pillow writes no 4:4:0 or non-interleaved baseline file, so those two are
transcoded here from files it wrote (:func:`transpose_422`,
:func:`encode_baseline`): their coefficients are Pillow's, re-entropy-coded
with its Huffman tables.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
CASE_WH = (37, 29)
CAPTURE_WH = (384, 288)
CAPTURE_VIEWS = 12
CAPTURE_QUALITY = 90


def seeded_image(rng, h, w, channels=3):
    """Smooth colour fields plus noise: every block has AC terms."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / (4.0 + k) + k)
                    * np.cos(y / (6.0 - k) - k) for k in range(channels)],
                   axis=-1)
    img = img + rng.normal(0.0, 18.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pillow_jpeg(img, **kw):
    from PIL import Image

    mode = "RGB" if img.ndim == 3 and img.shape[2] == 3 else "L"
    buf = io.BytesIO()
    Image.fromarray(img if mode == "RGB" else img.reshape(img.shape[:2]),
                    mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow_rgb(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# -- a baseline entropy coder, for the transcoded cases ------------------- #
def _codes(table):
    """Symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(table.counts[length - 1]):
            out[table.symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value, length):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def _encode_block(bits, coefs, pred, dc, ac):
    from nerfmlp_torch.utils.jpeg import _ZIGZAG

    diff = int(coefs[0]) - pred
    s = _category(diff)
    bits.put(*dc[s])
    if s:
        bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
    run = 0
    for k in range(1, 64):
        v = int(coefs[_ZIGZAG[k]])
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        s = _category(v)
        bits.put(*ac[(run << 4) | s])
        bits.put(v if v > 0 else v + (1 << s) - 1, s)
        run = 0
    if run:
        bits.put(*ac[0x00])
    return int(coefs[0])


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_baseline(frame, scans):
    """A baseline JFIF file of a parsed frame's quantised coefficients:
    its quantisation and Huffman tables, its components' sampling factors,
    and ``scans`` (lists of component indices; one index per scan makes
    non-interleaved scans)."""
    from nerfmlp_torch.utils.jpeg import _ZIGZAG

    comps, (h, w) = frame["comps"], frame["size"]
    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq in sorted({c.tq for c in comps}):
        q = next(c.quant for c in comps if c.tq == tq)
        out += _segment(0xDB, bytes([tq]) + bytes(int(q[i]) for i in _ZIGZAG))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for c in comps:
        sof += bytes([c.id, (c.h << 4) | c.v, c.tq])
    out += _segment(0xC0, sof)
    for (tc, th), t in sorted(frame["huffman"].items()):
        out += _segment(0xC4, bytes([(tc << 4) | th]) + t.counts + t.symbols)
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for scan in scans:
        cs = [comps[i] for i in scan]
        sos = bytes([len(cs)])
        for c in cs:
            sos += bytes([c.id, (c.td << 4) | c.ta])
        out += _segment(0xDA, sos + b"\x00\x3f\x00")
        grids = {id(c): np.frombuffer(c.flat, np.int16).reshape(
            *c.coefs_shape, 64) for c in cs}
        tables = {id(c): (_codes(frame["huffman"][(0, c.td)]),
                          _codes(frame["huffman"][(1, c.ta)])) for c in cs}
        pred = {id(c): 0 for c in cs}
        bits = _Bits()
        if len(cs) == 1:
            c = cs[0]
            order = [(c, by, bx) for by in range(-(-c.height_px // 8))
                     for bx in range(-(-c.width_px // 8))]
        else:
            order = [(c, my * c.v + v, mx * c.h + hh)
                     for my in range(-(-h // (8 * vmax)))
                     for mx in range(-(-w // (8 * hmax)))
                     for c in cs for v in range(c.v) for hh in range(c.h)]
        for c, by, bx in order:
            dc, ac = tables[id(c)]
            pred[id(c)] = _encode_block(bits, grids[id(c)][by, bx],
                                        pred[id(c)], dc, ac)
        out += bits.flush()
    return bytes(out + b"\xff\xd9")


def transpose_422(data):
    """A 4:2:2 (h2v1) file -> the 4:4:0 (h1v2) file of the transposed
    image: every block's coefficients, the block grids and the
    quantisation tables transposed, the sampling factors swapped."""
    from nerfmlp_torch.utils.jpeg import parse_jpeg

    frame = parse_jpeg(data)
    t = np.arange(64).reshape(8, 8).T.reshape(64)
    for c in frame["comps"]:
        grid = np.frombuffer(c.flat, np.int16).reshape(*c.coefs_shape, 64)
        grid = grid[..., t].transpose(1, 0, 2)
        c.flat = np.ascontiguousarray(grid).tobytes()
        c.coefs_shape = grid.shape[:2]
        c.quant = c.quant[t]
        c.h, c.v = c.v, c.h
        c.width_px, c.height_px = c.height_px, c.width_px
    h, w = frame["size"]
    frame["size"] = (w, h)
    return encode_baseline(frame, [list(range(len(frame["comps"])))])


def non_interleaved(data):
    """The same coefficients and tables, one scan per component."""
    from nerfmlp_torch.utils.jpeg import parse_jpeg

    frame = parse_jpeg(data)
    return encode_baseline(frame, [[i] for i in range(len(frame["comps"]))])


def cases():
    """name -> JPEG bytes of every decoder case."""
    rng = np.random.default_rng(SEED)
    w, h = CASE_WH
    img = lambda c=3: seeded_image(rng, h, w, c)
    out = {
        "444_q75": pillow_jpeg(img(), quality=75, subsampling=0),
        "422_q50": pillow_jpeg(img(), quality=50, subsampling=1),
        "420_q95": pillow_jpeg(img(), quality=95, subsampling=2),
        "grey_q75": pillow_jpeg(img(1), quality=75),
        "420_restart": pillow_jpeg(img(), quality=75, subsampling=2,
                                   restart_marker_blocks=2),
        "420_optimized": pillow_jpeg(img(), quality=85, subsampling=2,
                                     optimize=True),
        "444_qtables16": pillow_jpeg(img(), subsampling=0,
                                     qtables=[[300] * 64, [400] * 64]),
        "rgb_adobe": pillow_jpeg(img(), quality=80, keep_rgb=True),
    }
    # 4:4:0: Pillow's 4:2:2 file of the transposed image, transposed.
    out["440_q75"] = transpose_422(pillow_jpeg(
        img().transpose(1, 0, 2).copy(), quality=75, subsampling=1))
    out["420_noninterleaved"] = non_interleaved(pillow_jpeg(
        img(), quality=75, subsampling=2))
    # Progressive files, from a generator of their own so that the files
    # above keep their bytes.
    rng = np.random.default_rng(SEED + 1)
    prog = dict(progressive=True)
    out.update({
        "prog_420_q75": pillow_jpeg(img(), quality=75, subsampling=2, **prog),
        "prog_444_q95": pillow_jpeg(img(), quality=95, subsampling=0, **prog),
        "prog_grey_q75": pillow_jpeg(img(1), quality=75, **prog),
        "prog_420_restart": pillow_jpeg(img(), quality=75, subsampling=2,
                                        restart_marker_blocks=2, **prog),
        "prog_422_61x45": pillow_jpeg(seeded_image(rng, 45, 61), quality=85,
                                      subsampling=1, optimize=True, **prog),
    })
    return out


def write_capture(root):
    """The phase-8 capture at CAPTURE_WH as JPEG ``images/``, baseline
    in ``root`` and progressive in ``<root>_progressive``."""
    import shutil
    import tempfile

    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene
    from nerfmlp_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_llff_scene(tmp, n_images=CAPTURE_VIEWS,
                                  img_wh=CAPTURE_WH, style="forward",
                                  seed=SEED)
        prog = root + "_progressive"
        for d in (root, prog):
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(os.path.join(d, "images"))
            shutil.copy(os.path.join(tmp, "poses_bounds.npy"), d)
        for name in sorted(os.listdir(os.path.join(tmp, "images"))):
            px = read_png(os.path.join(tmp, "images", name))
            stem = os.path.splitext(name)[0]
            with open(os.path.join(root, "images", stem + ".jpg"), "wb") as f:
                f.write(pillow_jpeg(px, quality=CAPTURE_QUALITY))
            with open(os.path.join(prog, "images", stem + ".jpg"),
                      "wb") as f:
                f.write(pillow_jpeg(px, quality=CAPTURE_QUALITY,
                                    progressive=True))


def digest(px):
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()


def main():
    sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))
    from nerfmlp_torch.utils.image import save_png

    manifest = {}
    case_dir = os.path.join(HERE, "cases")
    os.makedirs(case_dir, exist_ok=True)
    for name, data in cases().items():
        with open(os.path.join(case_dir, name + ".jpg"), "wb") as f:
            f.write(data)
        px = pillow_rgb(data)
        save_png(os.path.join(case_dir, name + ".png"), px)
        manifest[f"cases/{name}.jpg"] = {"shape": list(px.shape),
                                         "sha256": digest(px)}
    capture = os.path.join(HERE, "capture")
    write_capture(capture)
    views = [f"{d}/images/{name}"
             for d in ("capture", "capture_progressive")
             for name in sorted(os.listdir(os.path.join(HERE, d, "images")))]
    for rel in views:
        with open(os.path.join(HERE, rel), "rb") as f:
            px = pillow_rgb(f.read())
        manifest[rel] = {"shape": list(px.shape), "sha256": digest(px)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{len(manifest)} JPEGs -> {HERE}")


if __name__ == "__main__":
    main()
