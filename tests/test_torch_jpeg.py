"""The port's JPEG decoder (nerfmlp_torch/utils/jpeg.py; baseline and
progressive) against
Pillow (libjpeg-turbo) on this host, and the JPEG captures it opens to the
port's loaders (LLFF, DeepVoxels, the train CLI's size probe) against the
JAX package's, which read them through Pillow.

Bar: the decoder's pixels equal ``Image.open(f).convert("RGB")``'s, max
|err| 0 in 8-bit levels, in every mode it reads: live files that Pillow
writes here from seeded numpy images, and the committed fixtures of
tests/data/jpeg/ against their stored decodes (made by
tests/data/jpeg/make_fixtures.py). The loaders: images and rays bit-equal
to JAX's, as tests/test_torch_llff.py holds them for PNG captures.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import test_llff as jax_llff_tests
from nerfmlp_tpu.data import deepvoxels as jdv
from nerfmlp_tpu.data import llff as jllff
from test_deepvoxels import _write_scene
from test_torch_llff import _assert_same_dataset, _copy

from nerfmlp_torch.data import deepvoxels as dv
from nerfmlp_torch.data import llff
from nerfmlp_torch.utils.image import (
    image_size, read_image, read_png, read_rgb, resize_lanczos,
)
from nerfmlp_torch.utils.jpeg import decode_jpeg, read_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
sys.path.insert(0, FIXTURES)
import make_fixtures as fixtures  # noqa: E402

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module, so that parallel test workers
    do not oversubscribe the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgb(px):
    return np.repeat(px, 3, axis=2) if px.shape[2] == 1 else px


def _assert_pillow_equal(data, name=""):
    want = fixtures.pillow_rgb(data)
    got = _rgb(decode_jpeg(data, name))
    assert got.dtype == np.uint8 and got.shape == want.shape
    err = np.abs(got.astype(np.int64) - want).max()
    assert err == 0, f"{name}: max |err| {err} levels"


def _image(seed, wh, channels=3):
    return fixtures.seeded_image(np.random.default_rng(seed), wh[1], wh[0],
                                 channels)


# -- live files, written by Pillow here ---------------------------------- #
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_decoder_equals_pillow(subsampling, quality):
    """Each chroma subsampling Pillow writes, at three qualities, at a size
    that is a multiple of neither 8 nor 16 and at one that is."""
    for seed, wh in ((quality, (37, 29)), (quality + 1, (48, 32))):
        data = fixtures.pillow_jpeg(_image(seed, wh), quality=quality,
                                    subsampling=subsampling)
        _assert_pillow_equal(data, f"{subsampling} q{quality} {wh}")


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decoder_equals_pillow_440_and_grey(quality):
    """4:4:0 (h1v2, transcoded from Pillow's 4:2:2 file of the transposed
    image: tests/data/jpeg/make_fixtures.py) and greyscale, replicated to
    three channels as convert("RGB") does."""
    img = _image(quality, (29, 37))
    _assert_pillow_equal(fixtures.transpose_422(fixtures.pillow_jpeg(
        img, quality=quality, subsampling=1)), f"4:4:0 q{quality}")
    grey = _image(quality, (37, 29), channels=1)
    data = fixtures.pillow_jpeg(grey, quality=quality)
    assert decode_jpeg(data).shape == (29, 37, 1)
    _assert_pillow_equal(data, f"grey q{quality}")


@pytest.mark.parametrize("case", ["restart_blocks", "restart_rows",
                                  "optimized", "qtables16", "adobe_rgb",
                                  "non_interleaved", "odd_sizes"])
def test_decoder_equals_pillow_modes(case):
    """Restart markers (every 3 MCUs, every MCU row), optimised Huffman
    tables, 16-bit quantisation tables (SOF1), an Adobe RGB file,
    non-interleaved scans (one a component, transcoded) and tiny sizes
    (chroma two or one sample wide: libjpeg's box upsampling there)."""
    img = _image(7, (37, 29))
    if case == "restart_blocks":
        files = [fixtures.pillow_jpeg(img, restart_marker_blocks=3)]
    elif case == "restart_rows":
        files = [fixtures.pillow_jpeg(img, restart_marker_rows=1,
                                      subsampling=s) for s in (0, 1, 2)]
    elif case == "optimized":
        files = [fixtures.pillow_jpeg(img, optimize=True, quality=q)
                 for q in (60, 90)]
    elif case == "qtables16":
        files = [fixtures.pillow_jpeg(img, qtables=[[300] * 64,
                                                    [400] * 64])]
        assert b"\xff\xc1" in files[0]
    elif case == "adobe_rgb":
        files = [fixtures.pillow_jpeg(img, keep_rgb=True)]
    elif case == "non_interleaved":
        files = [fixtures.non_interleaved(fixtures.pillow_jpeg(
            img, subsampling=s)) for s in (0, 1, 2)]
    else:
        files = [fixtures.pillow_jpeg(_image(1, wh), subsampling=2)
                 for wh in ((1, 1), (3, 17), (4, 5), (17, 3))]
    for i, data in enumerate(files):
        _assert_pillow_equal(data, f"{case} {i}")


# -- progressive files (SOF2), written by Pillow here --------------------- #
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_progressive_decoder_equals_pillow(subsampling, quality):
    """libjpeg's default progressive script (DC first and refinement, AC
    first scans with end-of-band runs, AC successive-approximation
    refinement: jdphuff.c) in each chroma subsampling and greyscale, at
    sizes that are multiples of neither 8 nor 16 and at one that is."""
    grey = subsampling == "grey"
    for seed, wh in ((quality, (37, 29)), (quality + 1, (48, 32)),
                     (quality + 2, (61, 45))):
        img = _image(seed, wh, channels=1 if grey else 3)
        kw = {} if grey else {"subsampling": subsampling}
        data = fixtures.pillow_jpeg(img, quality=quality, progressive=True,
                                    **kw)
        assert b"\xff\xc2" in data
        _assert_pillow_equal(data, f"progressive {subsampling} q{quality} "
                                   f"{wh}")


@pytest.mark.parametrize("case", ["restart_blocks", "restart_rows",
                                  "optimized", "odd_sizes"])
def test_progressive_decoder_equals_pillow_modes(case):
    """Progressive files with restart intervals inside their scans (every
    2 MCUs, every MCU row: the end-of-band run and DC predictors restart),
    optimised Huffman tables (long end-of-band runs), and tiny sizes."""
    img = _image(11, (37, 29))
    prog = dict(progressive=True)
    if case == "restart_blocks":
        files = [fixtures.pillow_jpeg(img, restart_marker_blocks=2,
                                      subsampling=s, **prog)
                 for s in (0, 2)]
    elif case == "restart_rows":
        files = [fixtures.pillow_jpeg(img, restart_marker_rows=1,
                                      subsampling=s, **prog)
                 for s in (0, 1, 2)]
    elif case == "optimized":
        files = [fixtures.pillow_jpeg(img, optimize=True, quality=q, **prog)
                 for q in (40, 90)]
    else:
        files = [fixtures.pillow_jpeg(_image(1, wh), subsampling=2, **prog)
                 for wh in ((1, 1), (3, 17), (4, 5), (17, 3))]
    for i, data in enumerate(files):
        _assert_pillow_equal(data, f"{case} {i}")


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_progressive_truncated_is_refused(cut):
    """A progressive stream cut inside its scans is refused as truncated
    (Pillow refuses it too, without LOAD_TRUNCATED_IMAGES)."""
    data = fixtures.pillow_jpeg(_image(3, (37, 29)), quality=75,
                                progressive=True)
    with pytest.raises(ValueError, match="truncated JPEG stream"):
        decode_jpeg(data[:int(len(data) * cut)], "x.jpg")
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data[:int(len(data) * cut)])).convert("RGB")


# -- the committed fixtures ---------------------------------------------- #
@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_committed_fixtures_equal_their_pillow_decodes(name):
    """Every committed JPEG decodes to the pixels Pillow gave when the
    fixtures were written (sha256 of the RGB pixels; for the decoder
    cases also their stored PNG), and Pillow here agrees."""
    path = os.path.join(FIXTURES, name)
    got = _rgb(read_jpeg(path))
    want = MANIFEST[name]
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    if name.startswith("cases/"):
        np.testing.assert_array_equal(got, read_png(path[:-4] + ".png"))
    np.testing.assert_array_equal(got, np.asarray(
        Image.open(path).convert("RGB")))


# -- refusals ------------------------------------------------------------- #
def _patched(data, marker_from, marker_to=None, offset=None, value=None):
    """``data`` with its SOF marker changed, or one byte of the SOF
    segment (``offset`` past the marker) set to ``value``."""
    out = bytearray(data)
    i = out.index(bytes([0xFF, marker_from]))
    if marker_to is not None:
        out[i + 1] = marker_to
    if offset is not None:
        out[i + 2 + offset] = value
    return bytes(out)


def _cmyk():
    buf = io.BytesIO()
    Image.fromarray(_image(3, (16, 16), channels=4), "CMYK").save(buf,
                                                                  "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("make, match", [
    (lambda d: _patched(d, 0xC0, 0xC5),
     "hierarchical JPEG \\(SOF5\\) is not decoded .*item 28"),
    (lambda d: _patched(d, 0xC0, 0xC9),
     "arithmetic-coded JPEG \\(marker 0xC9\\) is not decoded .*item 28"),
    (lambda d: _patched(d, 0xC0, 0xC3),
     "lossless JPEG \\(SOF3\\) is not decoded .*item 28"),
    (lambda d: _patched(d, 0xC0, offset=2, value=12),
     "12-bit JPEG is not decoded .*item 28"),
    (lambda d: _cmyk(),
     "four-component \\(CMYK or YCCK\\) JPEG is not decoded .*item 28"),
    (lambda d: d[:len(d) // 2],
     "truncated JPEG stream"),
    (lambda d: d[:-2],
     "truncated JPEG stream"),
], ids=["hierarchical", "arithmetic", "lossless", "12bit", "cmyk",
        "truncated_half", "truncated_eoi"])
def test_refusals_name_the_mode(make, match):
    """Each mode the decoder does not read raises a ValueError that names
    it and ROADMAP.md's item; a cut stream is refused as truncated (Pillow
    raises too)."""
    base = fixtures.pillow_jpeg(_image(2, (37, 29)), quality=75)
    with pytest.raises(ValueError, match=match):
        decode_jpeg(make(base), "x.jpg")


def test_read_image_tells_png_from_jpeg_by_content(tmp_path):
    """read_image picks the decoder from the file's first bytes, as
    Pillow does (a JPEG named .png is a JPEG); read_rgb replicates grey and
    drops alpha, as convert("RGB") does."""
    img = _image(4, (20, 12))
    png = str(tmp_path / "a.png")
    Image.fromarray(img).save(png)
    jpg_as_png = str(tmp_path / "b.png")
    with open(jpg_as_png, "wb") as f:
        f.write(fixtures.pillow_jpeg(img, quality=80))
    np.testing.assert_array_equal(read_image(png), img)
    np.testing.assert_array_equal(read_rgb(jpg_as_png), np.asarray(
        Image.open(jpg_as_png).convert("RGB")))
    grey = str(tmp_path / "g.jpg")
    Image.fromarray(img[..., 0]).save(grey, quality=90)
    assert read_image(grey).shape == (12, 20, 1)
    np.testing.assert_array_equal(read_rgb(grey), np.asarray(
        Image.open(grey).convert("RGB")))
    rgba = str(tmp_path / "c.png")
    Image.fromarray(np.dstack([img, img[..., :1]])).save(rgba)
    np.testing.assert_array_equal(read_rgb(rgba), img)


# -- the loaders ---------------------------------------------------------- #
@pytest.fixture(scope="module")
def jpeg_scene(tmp_path_factory):
    """tests/test_llff.py's forward-facing capture (8 views, 40x30) with
    its images/ stored as JPEG by Pillow."""
    root = jax_llff_tests.llff_scene.__wrapped__(tmp_path_factory)
    src = os.path.join(root, "images")
    for n in sorted(os.listdir(src)):
        path = os.path.join(src, n)
        Image.open(path).save(path[:-4] + ".jpg", quality=92)
        os.remove(path)
    return root


def test_llff_minify_from_jpeg(jpeg_scene, tmp_path):
    """--factor on JPEG images/: the port writes <stem>.png holding
    Pillow's decode after its LANCZOS (the JAX loader re-encodes a q75 JPEG
    under the same name; ROADMAP Queue 3), the same count and order of
    files; and each loader reads the other's directory: the port's and
    JAX's datasets on either are bit-equal, rays included."""
    ours = _copy(jpeg_scene, tmp_path, "ours")
    theirs = _copy(jpeg_scene, tmp_path, "theirs")
    out = llff.LLFFDataset._ensure_factor_dir(ours, 2)
    jout = jllff.LLFFDataset._ensure_factor_dir(theirs, 2)
    names, jnames = sorted(os.listdir(out)), sorted(os.listdir(jout))
    assert [n[:-4] for n in names] == [n[:-4] for n in jnames]
    assert all(n.endswith(".png") for n in names)
    assert all(n.endswith(".jpg") for n in jnames)
    for n in names:
        with Image.open(os.path.join(ours, "images", n[:-4] + ".jpg")) as im:
            want = np.asarray(im.resize((20, 15), Image.Resampling.LANCZOS))
        np.testing.assert_array_equal(read_png(os.path.join(out, n)), want)
        np.testing.assert_array_equal(
            resize_lanczos(read_image(os.path.join(ours, "images",
                                                   n[:-4] + ".jpg")),
                           (20, 15)), want)
    for d in (ours, theirs):
        _assert_same_dataset(
            llff.LLFFDataset(d, "train", img_wh=(20, 15), factor=2),
            jllff.LLFFDataset(d, "train", img_wh=(20, 15), factor=2))
        _assert_same_dataset(
            llff.LLFFDataset(d, "val", img_wh=(20, 15), factor=2),
            jllff.LLFFDataset(d, "val", img_wh=(20, 15), factor=2))


def test_llff_progressive_capture_equals_jax(jpeg_scene, tmp_path):
    """A progressive JPEG images/ capture (Pillow's progressive q92
    re-encode of the baseline capture): the port's LLFFDataset equals
    JAX's on the same files, at the native size, resized and through the
    minify, as the baseline capture's tests hold them."""
    d = _copy(jpeg_scene, tmp_path, "progressive")
    src = os.path.join(d, "images")
    for n in sorted(os.listdir(src)):
        path = os.path.join(src, n)
        with Image.open(path) as im:
            px = np.asarray(im.convert("RGB"))
        Image.fromarray(px).save(path, quality=92, progressive=True)
        with open(path, "rb") as f:
            assert b"\xff\xc2" in f.read()
    for wh in ((40, 30), (32, 24)):
        _assert_same_dataset(llff.LLFFDataset(d, "train", img_wh=wh),
                             jllff.LLFFDataset(d, "train", img_wh=wh))
    theirs = _copy(d, tmp_path, "progressive_jax")
    llff.LLFFDataset._ensure_factor_dir(d, 2)
    jllff.LLFFDataset._ensure_factor_dir(theirs, 2)
    for root in (d, theirs):    # each package's minify, read by both
        _assert_same_dataset(
            llff.LLFFDataset(root, "val", img_wh=(20, 15), factor=2),
            jllff.LLFFDataset(root, "val", img_wh=(20, 15), factor=2))


def test_llff_jpeg_images_at_native_and_resized(jpeg_scene):
    """JPEG images/ without a factor, at the native size and resized
    (LANCZOS of the decoded pixels), bit-equal to JAX's datasets."""
    for wh in ((40, 30), (32, 24)):
        _assert_same_dataset(llff.LLFFDataset(jpeg_scene, "train", img_wh=wh),
                             jllff.LLFFDataset(jpeg_scene, "train",
                                               img_wh=wh))


def test_llff_minify_refuses_colliding_names(jpeg_scene, tmp_path):
    """a.jpg and a.png would both become a.png: refused before anything
    is written."""
    d = _copy(jpeg_scene, tmp_path, "collide")
    src = os.path.join(d, "images")
    first = sorted(os.listdir(src))[0]
    Image.open(os.path.join(src, first)).save(
        os.path.join(src, first[:-4] + ".png"))
    with pytest.raises(ValueError, match="collide"):
        llff.LLFFDataset._ensure_factor_dir(d, 2)
    assert not os.path.exists(os.path.join(d, "images_2"))
    assert not os.path.exists(os.path.join(d, "images_2.tmp"))


def test_train_cli_sizes_a_jpeg_capture(jpeg_scene, tmp_path):
    """The train CLI's default resolution at --factor: images_{factor}/'s
    native size, made from JPEG images/ (the JAX CLI's Image.open(...).size
    of the first image, scripts/train.py:352-365)."""
    from nerfmlp_torch.scripts import train as train_cli

    d = _copy(jpeg_scene, tmp_path, "cli")
    args = train_cli.parse_args(["--datadir", d, "--dataset_type", "llff",
                                 "--factor", "4"])
    assert train_cli._default_wh(args) == [10, 7]
    assert image_size(os.path.join(d, "images", "img_000.jpg")) == (40, 30)


def test_deepvoxels_reads_jpeg_content(tmp_path):
    """The DeepVoxels loaders glob rgb/*.png and open each by content: a
    capture whose .png files hold JPEG bytes loads bit-equal in both."""
    root = _write_scene(str(tmp_path / "dv"), scene="cube")
    rgb = os.path.join(root, "train", "cube", "rgb")
    for n in sorted(os.listdir(rgb)):
        path = os.path.join(rgb, n)
        with Image.open(path) as im:
            data = fixtures.pillow_jpeg(np.asarray(im.convert("RGB")),
                                        quality=85)
        with open(path, "wb") as f:
            f.write(data)
    for wh in ((16, 16), (8, 8)):
        ds = dv.DeepVoxelsDataset(root, "train", shape="cube", img_wh=wh)
        jds = jdv.DeepVoxelsDataset(root, "train", shape="cube", img_wh=wh)
        for name in ("images", "all_rays_o", "all_rays_d", "all_rgbs"):
            np.testing.assert_array_equal(getattr(ds, name),
                                          getattr(jds, name), err_msg=name)
