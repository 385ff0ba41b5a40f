"""The port's LANCZOS resize (nerfmlp_torch/utils/image.py::resize_lanczos)
against Pillow's ``Image.resize(wh, LANCZOS)``, and the Blender loader at
half resolution against the JAX loader, which resizes with Pillow.

Bar: bit-exact uint8, every value (held against Pillow 12.1.0): RGBA with
alpha 0, 1-254 and 255 (premultiplied by Pillow), RGB, grey and
grey+alpha; even and odd sizes, down and up."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from nerfmlp_tpu.data.blender import BlenderDataset as JaxBlenderDataset

from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.utils.image import resize_lanczos

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _pixels(h, w, c, seed=0):
    """Smooth colour ramps plus noise; alpha 0 on the top rows, 255 on the
    next and every value between below them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 255.0 / max(w - 1, 1) + y * 97.0 / max(h - 1, 1))[..., None]
    px = (base + np.arange(c) * 60 + rng.normal(0, 20, (h, w, c))) % 256
    px = px.astype(np.uint8)
    if c in (2, 4):
        a = rng.integers(1, 255, (h, w), dtype=np.uint8)
        a[: h // 4] = 0
        a[h // 4: h // 2] = 255
        px[..., -1] = a
    return px


@pytest.mark.parametrize("src, dst", [
    ((64, 64), (32, 32)), ((63, 63), (31, 31)), ((200, 200), (100, 100)),
    ((32, 32), (64, 64)), ((31, 17), (47, 9)), ((40, 40), (40, 20)),
    ((40, 40), (20, 40)), ((7, 5), (3, 2)),
])
@pytest.mark.parametrize("channels", [4, 3])
def test_resize_bit_exact_with_pillow(src, dst, channels):
    px = _pixels(src[1], src[0], channels, seed=src[0] + dst[0])
    want = np.asarray(Image.fromarray(px, MODES[channels]).resize(
        dst, Image.Resampling.LANCZOS))
    got = resize_lanczos(px, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_resize_grey_bit_exact_with_pillow(channels):
    px = _pixels(33, 50, channels)
    img = Image.fromarray(px[..., 0] if channels == 1 else px,
                          MODES[channels])
    want = np.asarray(img.resize((25, 17), Image.Resampling.LANCZOS))
    got = resize_lanczos(px, (25, 17))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_resize_same_size_and_bad_input():
    px = _pixels(9, 8, 4)
    out = resize_lanczos(px, (8, 9))
    np.testing.assert_array_equal(out, px)
    assert out is not px
    with pytest.raises(ValueError, match="positive"):
        resize_lanczos(px, (0, 4))
    with pytest.raises(ValueError, match="uint8"):
        resize_lanczos(px.astype(np.float32), (4, 4))


def _rgba_scene(root, grey=False):
    """A Blender-format split of RGBA (or grey+alpha) PNGs written with
    Pillow, alpha 0 to 255."""
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for k in range(3):
        px = _pixels(30, 40, 2 if grey else 4, seed=k)
        Image.fromarray(px, "LA" if grey else "RGBA").save(
            os.path.join(root, "train", f"r_{k}.png"))
        pose = np.eye(4)
        pose[:3, 3] = [0.0, -4.0 + k, 1.0]
        frames.append({"file_path": f"./train/r_{k}",
                       "transform_matrix": pose.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return root


@pytest.mark.parametrize("kind", ["rgba", "grey_alpha", "synthetic"])
@pytest.mark.parametrize("white", [True, False])
def test_half_res_loader_equals_jax(tmp_path, kind, white):
    """BlenderDataset at half the stored size: images and rays equal to the
    JAX loader's (its resize is Pillow's)."""
    root = str(tmp_path / kind)
    if kind == "synthetic":
        make_synthetic_scene(root, n_train=2, n_val=0, n_test=0,
                             img_wh=(32, 32))
        half = (16, 16)
    else:
        _rgba_scene(root, grey=kind == "grey_alpha")
        half = (20, 15)
    ours = BlenderDataset(root, "train", img_wh=half, white_bkgd=white)
    want = JaxBlenderDataset(root, "train", img_wh=half, white_bkgd=white)
    assert ours.images.shape == want.images.shape == (
        ours.n_images, half[1], half[0], 3)
    np.testing.assert_array_equal(ours.images, want.images)
    np.testing.assert_array_equal(ours.all_rays_o, want.all_rays_o)
    np.testing.assert_array_equal(ours.all_rays_d, want.all_rays_d)
    assert ours.focal == want.focal
