"""Ground truth rendered with torch (nerfmlp_torch/data/synthetic.py,
``render_analytic(..., device=)``) and the port's make_synthetic_scene CLI,
against the numpy path and the JAX package's (``use_jax`` and
scripts/make_synthetic_scene.py), on the CPU at 32-64 pixels a side.

Bars: float32 trig differs between numpy, torch and XLA by ulps, and the
hard field's steep tanh edges amplify that; so the torch path is held at
1e-4 in linear RGB and 1 level of 8-bit sRGB, and the numpy path of the
CLI (``--device numpy``) bit for bit.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from nerfmlp_tpu.data import synthetic as jsyn

from nerfmlp_torch.data import synthetic as syn
from nerfmlp_torch.data.blender import linear_to_srgb
from nerfmlp_torch.ops.rays import look_at_matrix
from nerfmlp_torch.scripts import make_synthetic_scene as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module (restored after), so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(img):
    return (linear_to_srgb(img) * 255.0).round().astype(np.int32)


@pytest.mark.parametrize("field", ["default", "hard"])
@pytest.mark.parametrize("aa", [1, 2])
def test_torch_ground_truth_matches_numpy_and_jax(field, aa):
    """A 32x32 view (x aa) in chunks of 700 rays, so the last chunk is
    padded: the torch path against the numpy path and JAX's jitted
    ``use_jax`` path."""
    pose = look_at_matrix(np.array([3.0, 1.5, 2.0]), np.zeros(3))
    hw, focal = 32 * aa, 40.0 * aa
    kw = dict(n_samples=96, near=2.0, far=6.0, chunk=700)
    assert (hw * hw) % kw["chunk"]
    got = syn.render_analytic(pose, hw, hw, focal, field=syn.FIELDS[field],
                              device="cpu", **kw)
    ref = syn.render_analytic(pose, hw, hw, focal, field=syn.FIELDS[field],
                              **kw)
    jx = jsyn.render_analytic(pose, hw, hw, focal, field=jsyn.FIELDS[field],
                              use_jax=True, **kw)
    assert got.shape == (hw, hw, 3) and got.dtype == np.float32
    for want in (ref, jx):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert np.abs(_levels(got) - _levels(want)).max() <= 1
    # Not a constant image: the field is in view.
    assert got.min() < 0.5 < got.max()


def test_llff_scene_rendered_with_torch(tmp_path):
    """make_synthetic_llff_scene(device=): the numpy writer's poses and
    bounds, its images within one 8-bit level."""
    from nerfmlp_torch.utils.image import read_png

    a = syn.make_synthetic_llff_scene(str(tmp_path / "np"), n_images=2,
                                      img_wh=(24, 18), style="forward")
    b = syn.make_synthetic_llff_scene(str(tmp_path / "t"), n_images=2,
                                      img_wh=(24, 18), style="forward",
                                      device="cpu")
    np.testing.assert_array_equal(np.load(os.path.join(a, "poses_bounds.npy")),
                                  np.load(os.path.join(b, "poses_bounds.npy")))
    for name in sorted(os.listdir(os.path.join(a, "images"))):
        got = read_png(os.path.join(b, "images", name)).astype(np.int32)
        want = read_png(os.path.join(a, "images", name)).astype(np.int32)
        assert np.abs(got - want).max() <= 1


def test_torch_ground_truth_renders_only_the_package_fields():
    pose = look_at_matrix(np.array([4.0, 0.0, 1.0]), np.zeros(3))
    with pytest.raises(ValueError, match="package's fields"):
        syn.render_analytic(pose, 4, 4, 5.0, field=lambda p: p,
                            device="cpu")


def _jax_cli():
    sys.path.insert(0, ROOT)
    from scripts import make_synthetic_scene as jcli

    return jcli


def _images(d):
    return {os.path.relpath(os.path.join(r, f), d):
            np.asarray(Image.open(os.path.join(r, f)).convert("RGB"),
                       np.int32)
            for r, _, fs in os.walk(d) for f in fs if f.endswith(".png")}


@pytest.mark.parametrize("flags, device", [
    (["--field", "default"], "numpy"),
    (["--field", "default"], "cpu"),
    (["--field", "hard", "--aa", "2"], "numpy"),
    (["--field", "hard", "--aa", "2"], "cpu"),
    (["--format", "llff", "--llff_style", "360"], "numpy"),
    (["--format", "llff", "--llff_style", "forward"], "cpu"),
])
def test_cli_matches_the_jax_cli(flags, device, tmp_path, capsys):
    """The same flags through both CLIs (JAX's on its numpy path): equal
    transforms JSON or poses_bounds.npy, the same summary line, and PNGs
    bit-equal with --device numpy, within one level with --device cpu."""
    common = ["--img_wh", "32", "24", "--n_train", "3", "--n_val", "1",
              "--n_test", "2", "--gt_samples", "64", "--seed", "3"] + flags
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    cli.main(["--outdir", mine, "--device", device] + common)
    said = capsys.readouterr().out.replace(mine, "OUT")
    _jax_cli().main(["--outdir", theirs] + common)
    assert said == capsys.readouterr().out.replace(theirs, "OUT")
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names
    for name in names:
        if name.endswith(".json"):
            with open(os.path.join(mine, name)) as a, \
                    open(os.path.join(theirs, name)) as b:
                assert json.load(a) == json.load(b)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(mine, name)),
                                          np.load(os.path.join(theirs, name)))
    got, want = _images(mine), _images(theirs)
    assert sorted(got) == sorted(want) and len(want) >= 3
    for k in want:
        assert got[k].shape == want[k].shape
        gap = np.abs(got[k] - want[k]).max()
        assert gap <= (0 if device == "numpy" else 1), (k, gap)


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """--device defaults to cuda and raises without a GPU: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--outdir", str(tmp_path / "s"), "--img_wh", "8", "8"])
    assert not os.path.exists(tmp_path / "s")
