"""The port's animated-GIF writer (nerfmlp_torch/utils/image.py::gif_bytes,
write_video), decoded by Pillow: frame count, delay, loop 0; grey frames
exact, RGB frames within RGB_GIF_MAX_ERR (25 of 255) of their values."""

import io

import numpy as np
import pytest
from PIL import Image

from nerfmlp_torch.utils.image import (
    RGB_GIF_MAX_ERR, gif_bytes, write_video,
)


def _decode(data, mode):
    im = Image.open(io.BytesIO(data))
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert(mode)))
    return im.info, frames


@pytest.mark.parametrize("fps, ms", [(30, 30), (5, 200), (60, 20), (1, 1000)])
def test_delay_and_loop(fps, ms):
    """The reference's GIF delay, max(1000 // fps, 20) ms, in GIF's 10 ms
    units; loop 0 (forever)."""
    frames = [np.full((4, 6), v, np.uint8) for v in (0, 128, 255)]
    info, got = _decode(gif_bytes(frames, fps=fps), "L")
    assert len(got) == 3
    assert info["loop"] == 0
    assert info["duration"] == max(1000 // fps, 20) // 10 * 10 == ms


@pytest.mark.parametrize("shape", [(300, 257), (64, 64), (1, 1), (13, 7)])
def test_grey_frames_exact(shape):
    """Random grey frames (the LZW table fills and restarts at 300x257)."""
    rng = np.random.default_rng(shape[0])
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    frames.append(np.zeros(shape, np.uint8))
    _, got = _decode(gif_bytes(frames), "L")
    assert len(got) == 4
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


def test_rgb_frames_within_bound():
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (40, 33, 3), dtype=np.uint8)
              for _ in range(2)]
    ramp = np.zeros((3, 256, 3), np.uint8)
    for c in range(3):
        ramp[c, :, c] = np.arange(256)
    frames.append(np.pad(ramp, ((0, 37), (0, 0), (0, 0)))[:40, :33])
    _, got = _decode(gif_bytes(frames), "RGB")
    worst = max(int(np.abs(g.astype(int) - f).max())
                for g, f in zip(got, frames))
    assert worst <= RGB_GIF_MAX_ERR
    # Every channel value of each primary: the bound is reached.
    _, (full,) = _decode(gif_bytes([ramp]), "RGB")
    assert int(np.abs(full.astype(int) - ramp).max()) == RGB_GIF_MAX_ERR


def test_write_video_paths_and_floats(tmp_path):
    frames = np.linspace(0.0, 1.0, 2 * 8 * 8).reshape(2, 8, 8)
    path = write_video(str(tmp_path / "clip"), frames, fps=10)
    assert path == str(tmp_path / "clip.gif")
    with open(path, "rb") as f:
        info, got = _decode(f.read(), "L")
    want = (255 * frames).astype(np.uint8)
    np.testing.assert_array_equal(np.stack(got), want)
    assert info["duration"] == 100


def test_bad_frames_are_refused():
    with pytest.raises(ValueError):
        gif_bytes([])
    with pytest.raises(ValueError):
        gif_bytes([np.zeros((4, 4), np.float32)])
    with pytest.raises(ValueError):
        gif_bytes([np.zeros((4, 4), np.uint8), np.zeros((4, 5), np.uint8)])
    with pytest.raises(ValueError):
        gif_bytes([np.zeros((4, 4, 4), np.uint8)])
