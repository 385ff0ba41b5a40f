"""The port's data path (nerfmlp_torch/data, utils/image.py, train/metrics.py)
against the JAX package's: synthetic scenes, the standard-library PNG
reader against PIL, the Blender loader, the host batch loader and the
device ray pool."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from nerfmlp_tpu.data import blender as jblender
from nerfmlp_tpu.data import pipeline as jpipeline
from nerfmlp_tpu.data import synthetic as jsynthetic
from nerfmlp_tpu.train import metrics as jmetrics

from nerfmlp_torch.data import blender, pipeline, synthetic
from nerfmlp_torch.data.device_pool import DeviceRayPool
from nerfmlp_torch.train import metrics
from nerfmlp_torch.utils.image import png_bytes, read_png


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same synthetic scene written by both packages."""
    root = tmp_path_factory.mktemp("scenes")
    kw = dict(n_train=3, n_val=2, n_test=1, img_wh=(24, 20), seed=4)
    port = synthetic.make_synthetic_scene(str(root / "port"), **kw)
    jax_ = jsynthetic.make_synthetic_scene(str(root / "jax"), **kw)
    return port, jax_


@pytest.mark.parametrize("field", ["default", "hard"])
def test_analytic_render_equals_jax(field):
    from nerfmlp_torch.ops.rays import look_at_matrix

    pose = look_at_matrix(np.array([3.0, 1.0, 2.0]), np.zeros(3))
    got = synthetic.render_analytic(pose, 12, 10, 20.0, n_samples=64,
                                    field=synthetic.FIELDS[field])
    want = jsynthetic.render_analytic(pose, 12, 10, 20.0, n_samples=64,
                                      field=jsynthetic.FIELDS[field])
    np.testing.assert_array_equal(got, want)


def test_synthetic_scene_equals_jax(scenes):
    port, jax_ = scenes
    for split in ("train", "val", "test"):
        with open(os.path.join(port, f"transforms_{split}.json")) as f:
            a = f.read()
        with open(os.path.join(jax_, f"transforms_{split}.json")) as f:
            assert f.read() == a
        for name in sorted(os.listdir(os.path.join(jax_, split))):
            want = np.asarray(Image.open(os.path.join(jax_, split, name)))
            got = read_png(os.path.join(port, split, name))
            np.testing.assert_array_equal(got, want)


def _png_with_filters(px, filters):
    """Encode uint8 (H, W, C) pixels with the given per-row filter types."""
    h, w, ch = px.shape
    raw = px.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        f, row = filters[y % len(filters)], raw[y]
        left = np.concatenate([np.zeros(ch, np.int64), row[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(f)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_matches_pil(tmp_path, channels):
    """Every row filter (None, Sub, Up, Average, Paeth), grey, grey+alpha,
    RGB and RGBA: the reader returns PIL's pixels; so for PIL's own
    (adaptively filtered) files and the port's writer."""
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, size=(9, 7, channels)).astype(np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_with_filters(px, [0, 1, 2, 3, 4, 4, 3, 1, 2]))
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(read_png(str(path)),
                                  pil.reshape(px.shape))
    np.testing.assert_array_equal(read_png(str(path)), px)
    smooth = (np.add.outer(np.arange(30), np.arange(40)) % 256).astype(
        np.uint8)
    img = np.repeat(smooth[..., None], channels, axis=2)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img.squeeze(-1) if channels == 1 else img, mode).save(
        tmp_path / "pil.png")
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil.png")), img)
    if channels == 3:
        (tmp_path / "port.png").write_bytes(png_bytes(img))
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port.png")), img)


def test_blender_dataset_matches_jax(scenes):
    """Same files through both loaders (the bars of
    tests/test_reference_parity.py:165-176)."""
    port, _ = scenes
    for split in ("train", "val"):
        ours = blender.BlenderDataset(port, split, img_wh=(24, 20))
        want = jblender.BlenderDataset(port, split, img_wh=(24, 20))
        np.testing.assert_allclose(ours.images, want.images, atol=1e-6)
        assert abs(ours.focal - want.focal) < 1e-6
        np.testing.assert_allclose(ours.all_rays_o, want.all_rays_o, atol=1e-6)
        np.testing.assert_allclose(ours.all_rays_d, want.all_rays_d, atol=1e-5)
        np.testing.assert_allclose(ours.all_rgbs, want.all_rgbs, atol=1e-6)
        assert ours.dynamic_near_far() == pytest.approx(
            want.dynamic_near_far())
        for a, b in zip(ours.image_rays(1), want.image_rays(1)):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_blender_alpha_composite_matches_jax(tmp_path, scenes):
    """RGBA frames: white-background compositing, as the JAX loader's."""
    port, _ = scenes
    rng = np.random.default_rng(0)
    root = tmp_path / "rgba"
    os.makedirs(root / "train")
    import json
    import shutil

    shutil.copy(os.path.join(port, "transforms_train.json"), root)
    with open(root / "transforms_train.json") as f:
        frames = json.load(f)["frames"]
    for fr in frames:
        name = fr["file_path"].split("/")[-1] + ".png"
        px = rng.integers(0, 256, size=(20, 24, 4)).astype(np.uint8)
        Image.fromarray(px, "RGBA").save(root / "train" / name)
    for white in (True, False):
        ours = blender.BlenderDataset(str(root), "train", img_wh=(24, 20),
                                      white_bkgd=white)
        want = jblender.BlenderDataset(str(root), "train", img_wh=(24, 20),
                                       white_bkgd=white)
        np.testing.assert_allclose(ours.images, want.images, atol=1e-6)


def test_blender_refuses_a_resize(scenes):
    """Images are resized now (tests/test_torch_resize.py); a size that is
    not positive is refused, as Pillow refuses it."""
    with pytest.raises(ValueError, match="positive"):
        blender.BlenderDataset(scenes[0], "train", img_wh=(0, 10))


@pytest.mark.parametrize("mode", ["global", "image", "precrop", "tiny"])
def test_ray_batch_loader_same_batches_as_jax(scenes, mode):
    ds = blender.BlenderDataset(scenes[0], "train", img_wh=(24, 20))
    batch = 4096 if mode == "tiny" else 64
    kw = dict(seed=7, image_mode=mode == "image")
    ours = pipeline.RayBatchLoader.from_dataset(ds, batch, **kw)
    want = jpipeline.RayBatchLoader.from_dataset(ds, batch, **kw)
    if mode == "precrop":
        ours.set_precrop(0.5)
        want.set_precrop(0.5)
    for _ in range(25):    # past an epoch of the 1440-ray pool
        np.testing.assert_array_equal(ours.next_batch(), want.next_batch())
    assert ours.epoch == want.epoch
    assert pipeline.auto_tune_batch_size(len(ds)) == \
        jpipeline.auto_tune_batch_size(len(ds))


def test_device_pool_epochs_are_permutations():
    rng = np.random.default_rng(0)
    pool_np = rng.normal(size=(1000, 9)).astype(np.float32)
    pool_np[:, 0] = np.arange(1000)           # row ids
    pool = DeviceRayPool(pool_np, 96, seed=3, device="cpu")
    assert pool.steps_per_epoch == 10 and len(pool) == 1000
    stacks = []
    for epoch in range(3):
        stack = pool.ensure_epoch(epoch)
        assert stack.shape == (10, 96, 9)
        ids = stack[..., 0].reshape(-1).long()
        assert len(set(ids.tolist())) == 960    # no row twice
        np.testing.assert_array_equal(stack.reshape(-1, 9).numpy(),
                                      pool_np[ids.numpy()])
        stacks.append(stack.clone())
    assert not torch.equal(stacks[0], stacks[1])
    # A fresh pool (a resumed run) rebuilds the same epoch stack.
    again = DeviceRayPool(pool_np, 96, seed=3, device="cpu")
    assert torch.equal(again.ensure_epoch(1), stacks[1])
    assert pool.epoch_of(25) == 2
    assert torch.equal(pool.batch(25), stacks[2][5])
    with pytest.raises(ValueError, match="smaller than one batch"):
        DeviceRayPool(pool_np[:50], 96, device="cpu")


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(17, 13, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    assert metrics.psnr_images(a, b) == jmetrics.psnr_images(a, b)
    assert metrics.ssim(a, b) == jmetrics.ssim(a, b)
    assert metrics.psnr(0.01) == jmetrics.psnr(0.01)
    assert metrics.convert_for_json(
        {"x": torch.tensor(1.5), "y": np.float32(2.0), "z": torch.ones(2)}
    ) == {"x": 1.5, "y": 2.0, "z": [1.0, 1.0]}
