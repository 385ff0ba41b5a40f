"""The port's trajectory rendering (nerfmlp_torch/render_path.py, the
trajectories of ops/rays.py, BlenderDataset.render_poses) and the
Trainer's render events, against the JAX package on the CPU at a small
size: a 2x32 net, 8 + 8 samples, 16x16 frames, the same weights
(converted with models/convert.py) and poses in both packages.

Bars. Trajectories: 1e-6. Frames: the renderer's bars of
tests/test_torch_render.py, rgb 3e-3 after the fine pass and depth 1e-2,
which is 2.5e-3 of disparity at depths beyond near = 2 (measured here:
rgb 9.6e-4, disparity 5.0e-4; the positional encoding turns ulps of the
points into ~1e-4 of output, so 1e-5 does not hold even on identical
rays). With a grid, the samples the grid places jump with rounding: JAX's
jitted render_path and its own eager renderer lie up to 8.2e-2 apart, on
~5% of values (mean 7.9e-4). So there the port's frames are held to the
rgb bar in the mean over all values, and to equal, bit for bit, the
port's own renderer called on each frame's rays."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.data.blender import BlenderDataset as JaxBlenderDataset
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops import occupancy as jocc
from nerfmlp_tpu.ops import rays as jrays
from nerfmlp_tpu.render_path import render_path as jax_render_path

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import occupancy as occ
from nerfmlp_torch.ops import rays
from nerfmlp_torch.ops.render import render_image_maps
from nerfmlp_torch.render_path import (
    rays_for_pose_device, render_path, save_path_videos,
)
from nerfmlp_torch.train.loop import Trainer

AABB = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)
KW = dict(depth=2, width=32, N_samples=8, N_importance=8, near=2.0, far=6.0,
          perturb=False, raw_noise_std=0.0)
HWF = (16, 16, 20.0)
RGB_TOL, DISP_TOL, PSNR_TOL = 3e-3, 2.5e-3, 1e-2


@pytest.mark.parametrize("name, kw", [
    ("blender_render_poses", {}),
    ("blender_render_poses", dict(n_frames=7, phi_deg=-10.0, radius=2.5)),
    ("flythrough_poses", {}),
    ("flythrough_poses", dict(n_frames=9, radius=3.0, phi_amp_deg=5.0,
                              target=np.array([0.1, -0.2, 0.3]))),
])
def test_trajectories_match_jax(name, kw):
    got = getattr(rays, name)(**kw)
    want = getattr(jrays, name)(**kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert rays.mean_camera_radius(got) == pytest.approx(
        jrays.mean_camera_radius(want), abs=1e-6)



@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small nets on the CPU: one intra-op thread for this module's tests
    and fixtures, so that parallel test workers do not oversubscribe the
    cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rp_scene"))
    make_synthetic_scene(root, n_train=4, n_val=1, n_test=2, img_wh=(16, 16))
    return root


def test_dataset_render_poses_match_jax(scene):
    ours = BlenderDataset(scene, "train", img_wh=(16, 16))
    want = JaxBlenderDataset(scene, "train", img_wh=(16, 16))
    np.testing.assert_allclose(ours.render_poses(n_frames=5),
                               want.render_poses(n_frames=5), atol=1e-6)
    assert ours.render_poses().shape == (40, 4, 4)


def _both(**extra):
    kw = dict(KW, **extra)
    jcfg, cfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    jp = {"coarse": jax_init_model(jax.random.PRNGKey(0), jcfg.model_config())}
    jp["coarse"]["sigma"]["bias"] = jp["coarse"]["sigma"]["bias"] + 0.5
    tp = {"coarse": model_from_params(jax.tree.map(np.asarray, jp["coarse"]),
                                      cfg.model_config(), device="cpu")}
    return jp, jcfg, tp, cfg


def _poses(n=3):
    return rays.blender_render_poses(n_frames=n, radius=4.0)


@pytest.mark.parametrize("case", ["gt", "render_factor", "static_cam",
                                  "occupancy"])
def test_render_path_matches_jax(case, tmp_path):
    """rgbs, disps and per-frame PSNRs of both packages' render_path."""
    extra = dict(aabb=AABB, use_occupancy=True, occ_grid_size=8,
                 occ_dense_samples=16) if case == "occupancy" else {}
    jp, jcfg, tp, cfg = _both(**extra)
    poses = _poses()
    rng = np.random.default_rng(0)
    gt = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    kw = dict(gt_images=gt, tile=128, verbose=False)
    jkw = dict(kw)
    if case == "render_factor":
        kw["render_factor"] = jkw["render_factor"] = 2
    if case == "static_cam":
        kw["static_cam_pose"] = jkw["static_cam_pose"] = poses[0]
    if case == "occupancy":
        g = jocc.update_grid(jocc.create_grid(8), jp, jcfg,
                             jax.random.PRNGKey(3), decay=0.0)
        dens = np.asarray(g.density).copy()
        dens[:4] = 0.0                      # half the box empty
        jkw["occ_grid"] = jocc.OccupancyGrid(density=jnp.asarray(dens))
        kw["occ_grid"] = occ.OccupancyGrid(torch.from_numpy(dens))
    want = jax_render_path(jp, poses, HWF, jcfg, **jkw)
    got = render_path(tp, poses, HWF, cfg, save_dir=str(tmp_path / "f"),
                      **kw)
    side = 8 if case == "render_factor" else 16
    assert got[0].shape == (3, side, side, 3) and got[1].shape == (3, side,
                                                                    side)
    if case == "occupancy":
        _assert_occupancy_frames(got, want, poses, tp, cfg, kw["occ_grid"])
    else:
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=RGB_TOL)
        np.testing.assert_allclose(got[1], np.asarray(want[1]),
                                   atol=DISP_TOL)
    if case == "render_factor":
        assert got[2] is None and want[2] is None
    else:
        assert len(got[2]) == 3
        if case != "occupancy":
            np.testing.assert_allclose(got[2], want[2], atol=PSNR_TOL)
    assert float(got[0].std()) > 1e-3           # not a blank frame
    assert sorted(os.listdir(tmp_path / "f")) == ["000.png", "001.png",
                                                  "002.png"]


def _assert_occupancy_frames(got, want, poses, tp, cfg, grid):
    """The mean rgb distance from JAX's render_path within the rgb bar, and
    each frame equal to the port's renderer on the same rays and grid."""
    assert np.abs(got[0] - np.asarray(want[0])).mean() <= RGB_TOL
    for pose, rgb in zip(poses, got[0]):
        o, d, _ = rays_for_pose_device(pose, *HWF, cfg, device="cpu")
        out = render_image_maps(tp, o, d, 16, 16, cfg, tile=128,
                                occ_grid=grid)
        np.testing.assert_array_equal(out["rgb_map"].numpy(), rgb)


def test_render_path_without_gt_and_refusals(tmp_path):
    _, _, tp, cfg = _both()
    rgbs, disps, psnrs = render_path(tp, _poses(2), HWF, cfg, verbose=False)
    assert psnrs is None and rgbs.shape == (2, 16, 16, 3)
    rgb, disp = save_path_videos(str(tmp_path / "v"), rgbs, disps)
    assert rgb.endswith("v_rgb.gif") and disp.endswith("v_disp.gif")
    assert os.path.getsize(rgb) > 0 and os.path.getsize(disp) > 0
    # mesh= was refused until frames could be rendered over several
    # devices: over two (here both the CPU) the frames are the local ones.
    shard = render_path(tp, _poses(2), HWF, cfg, verbose=False,
                        mesh=["cpu", "cpu"])
    np.testing.assert_allclose(shard[0], rgbs, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(shard[1], disps, rtol=2e-4, atol=2e-5)


def test_trainer_render_events(scene, tmp_path):
    """The i_video / i_testset / i_img events of a tiny CPU Trainer, as
    tests/test_train_loop.py:81-140 checks them in the JAX package: files
    at step 30 and not at the last step (60), the test sweep at the
    render_factor's size with its PSNR recorded, the final-model frame."""
    from PIL import Image

    wh = (16, 16)
    ds = BlenderDataset(scene, "train", img_wh=wh)
    val = BlenderDataset(scene, "val", img_wh=wh)
    test = BlenderDataset(scene, "test", img_wh=wh)
    near, far = ds.dynamic_near_far()
    rc = RenderConfig(depth=2, width=32, N_samples=8, N_importance=8,
                      near=near, far=far, perturb=True, aabb=AABB)
    tc = TrainConfig(batch_size=128, iters=60, quick_val_interval=30,
                     full_val_interval=0, quick_val_subset=1,
                     log_interval=0, ckpt_interval=30, i_video=30,
                     i_testset=30, i_img=30, render_factor=2)
    save_dir = str(tmp_path / "ev")
    t = Trainer(rc, tc, ds, val, val, save_dir=save_dir, verbose=False,
                device="cpu", render_poses=ds.render_poses(n_frames=2),
                test_ds=test)
    t.train()
    for kind in ("rgb", "disp", "rgb_still"):
        vids = glob.glob(os.path.join(save_dir, f"*_spiral_000030_{kind}.gif"))
        assert len(vids) == 1, os.listdir(save_dir)
        with Image.open(vids[0]) as im:
            assert im.n_frames == 2 and im.size == (8, 8)
    assert not glob.glob(os.path.join(save_dir, "*_spiral_000060_*"))
    tdir = os.path.join(save_dir, "testset_000030")
    assert sorted(os.listdir(tdir)) == ["000.png", "001.png"]
    assert Image.open(os.path.join(tdir, "000.png")).size == (8, 8)
    assert not os.path.exists(os.path.join(save_dir, "testset_000060"))
    assert t.history["testset_steps"] == [30]
    assert np.isfinite(t.history["testset_psnrs"][0])
    for step in (30, 60):
        assert os.path.exists(os.path.join(save_dir, f"val_{step:06d}.png"))


def test_trainer_events_are_best_effort(scene, tmp_path):
    """A failing event is logged and training goes on."""
    wh = (16, 16)
    ds = BlenderDataset(scene, "train", img_wh=wh)
    rc = RenderConfig(depth=2, width=32, N_samples=8, N_importance=8,
                      near=2.0, far=6.0)
    tc = TrainConfig(batch_size=128, iters=4, quick_val_interval=0,
                     full_val_interval=0, log_interval=0, ckpt_interval=0,
                     i_video=2)
    logs = []
    t = Trainer(rc, tc, ds, save_dir=str(tmp_path / "be"), device="cpu",
                render_poses=np.zeros((1, 3, 3), np.float32))   # bad poses
    t._log = logs.append
    t.train()
    assert t.state.step == 4
    assert any("i_video event failed" in m for m in logs)
