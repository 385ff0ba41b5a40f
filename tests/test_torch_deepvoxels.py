"""The port's DeepVoxels loader (nerfmlp_torch/data/deepvoxels.py) and the
CLIs with --dataset_type deepvoxels against the JAX package on the CPU,
on captures written by tests/test_deepvoxels.py's own writer.

Bars: bit-equal for the intrinsics, poses (the OpenCV -> OpenGL flip),
focal, images (the resize is bit-equal to Pillow's LANCZOS), rays (the
same numpy operations), render_poses and near / far.
"""

import os

import numpy as np
import pytest
import torch

from nerfmlp_tpu.data import deepvoxels as jdv
from test_deepvoxels import _write_scene

from nerfmlp_torch.data import deepvoxels as dv

NET = ["--N_samples", "8", "--N_importance", "8", "--device", "cpu",
       "--netdepth", "2", "--netwidth", "32"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module, so that parallel test workers
    do not oversubscribe the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dv_root(tmp_path_factory):
    """4 train / 2 validation / 3 test views of 16x16 on a hemisphere of
    radius 2.5 (tests/test_deepvoxels.py::_write_scene)."""
    return _write_scene(str(tmp_path_factory.mktemp("dv")), scene="cube")


def test_intrinsics_and_pose_files_match_jax(dv_root):
    base = os.path.join(dv_root, "train", "cube")
    got = dv.parse_intrinsics(os.path.join(base, "intrinsics.txt"))
    want = jdv.parse_intrinsics(os.path.join(base, "intrinsics.txt"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["focal"] == 32.0 and (got["width"], got["height"]) == (16, 16)
    pose = os.path.join(base, "pose", "000000.txt")
    np.testing.assert_array_equal(dv.load_pose(pose), jdv.load_pose(pose))


@pytest.mark.parametrize("split, kw", [
    ("train", dict(img_wh=(16, 16))),
    ("val", dict(img_wh=(16, 16))),              # the "validation" directory
    ("test", dict(img_wh=(16, 16), testskip=2)),
    ("train", dict(img_wh=(8, 8))),              # LANCZOS down, focal / 2
    ("train", dict(img_wh=(24, 24), apply_srgb_to_linear=True)),
])
def test_dataset_matches_jax(dv_root, split, kw):
    ds = dv.DeepVoxelsDataset(dv_root, split, shape="cube", **kw)
    jds = jdv.DeepVoxelsDataset(dv_root, split, shape="cube", **kw)
    assert (ds.H, ds.W, ds.focal, ds.n_images, len(ds)) == (
        jds.H, jds.W, jds.focal, jds.n_images, len(jds))
    for name in ("poses", "images", "all_rays_o", "all_rays_d", "all_rgbs"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name),
                                      err_msg=name)
    np.testing.assert_array_equal(ds.render_poses(n_frames=6),
                                  jds.render_poses(n_frames=6))
    assert ds.dynamic_near_far() == jds.dynamic_near_far()
    for a, b in zip(ds.image_rays(ds.n_images - 1),
                    jds.image_rays(jds.n_images - 1)):
        np.testing.assert_array_equal(a, b)


def test_splits_pose_flip_and_bounds(dv_root):
    """tests/test_deepvoxels.py's behaviour: split sizes, the flipped
    camera looking at the origin, the hemisphere near / far, focal
    rescaling, the 40-frame orbit at the capture's radius."""
    train = dv.DeepVoxelsDataset(dv_root, "train", img_wh=(16, 16),
                                 shape="cube")
    assert train.n_images == 4 and train.images.shape == (4, 16, 16, 3)
    assert dv.DeepVoxelsDataset(dv_root, "val", img_wh=(16, 16),
                                shape="cube").n_images == 2
    assert dv.DeepVoxelsDataset(dv_root, "test", img_wh=(16, 16),
                                shape="cube", testskip=2).n_images == 2
    c2w = train.poses[0]
    eye = c2w[:3, 3]
    np.testing.assert_allclose(-c2w[:3, 2], -eye / np.linalg.norm(eye),
                               atol=1e-5)
    np.testing.assert_allclose(c2w[:3, :3] @ c2w[:3, :3].T, np.eye(3),
                               atol=1e-5)
    near, far = train.dynamic_near_far()
    assert near == pytest.approx(1.5, abs=1e-4)
    assert far == pytest.approx(3.5, abs=1e-4)
    rp = train.render_poses()
    assert rp.shape == (40, 4, 4)
    np.testing.assert_allclose(np.linalg.norm(rp[:, :3, 3], axis=-1), 2.5,
                               atol=1e-4)
    with pytest.raises(FileNotFoundError):
        dv.DeepVoxelsDataset(dv_root, "train", img_wh=(16, 16),
                             shape="vase")


def test_train_and_inference_clis_on_deepvoxels(dv_root, tmp_path):
    """The train CLI with --dataset_type deepvoxels --shape cube (the
    hemisphere bounds, white composite), then render_video's orbit, eval
    and render_example on its checkpoint."""
    from nerfmlp_torch.scripts import eval as eval_cli
    from nerfmlp_torch.scripts import render_example, render_video, train

    out = str(tmp_path / "dv_out")
    dvs = ["--datadir", dv_root, "--dataset_type", "deepvoxels", "--shape",
           "cube"]
    m = train.main(dvs + NET + [
        "--img_wh", "16", "16", "--batch_size", "64", "--iters", "6",
        "--save_dir", out, "--quick_val_interval", "6",
        "--quick_val_res", "16", "16", "--quick_val_subset", "1",
        "--i_video", "3", "--video_frames", "2", "--i_print", "3"])
    r = m["config"]["render"]
    assert m["step"] == 6 and np.isfinite(m["final_val"]["psnr"])
    assert r["white_bkgd"] and not r["ndc"]
    assert (r["near"], r["far"]) == pytest.approx((1.5, 3.5), abs=1e-4)
    assert os.path.exists(os.path.join(out, "dv_out_spiral_000003_rgb.gif"))
    ckpt = os.path.join(out, "model_final.pt")
    vid = render_video.main(dvs + NET + ["--ckpt", ckpt, "--out_dir",
                                         str(tmp_path / "v"), "--n_frames",
                                         "2", "--size", "16"])
    assert vid["rgbs"].shape == (2, 16, 16, 3) and vid["cfg"].white_bkgd
    rep = eval_cli.main(dvs + NET + ["--ckpt", ckpt, "--split", "val",
                                     "--img_wh", "16", "16", "--out",
                                     str(tmp_path / "e.json")])
    assert rep["n_views"] == 2
    assert rep["mean_psnr"] == pytest.approx(m["final_val"]["psnr"],
                                             abs=0.5)
    assert render_example.main(dvs + NET + [
        "--ckpt", ckpt, "--img_wh", "16", "16", "--out_dir",
        str(tmp_path / "r")])
