"""The port's LLFF path (nerfmlp_torch/data/llff.py, ops/rays.py's
ndc_rays and spiral_poses, make_synthetic_llff_scene, the NDC render and
train step, and the CLIs with --dataset_type llff) against the JAX
package on the CPU, on scenes written with the JAX tests' own writers
(tests/test_llff.py's fixtures) and with both packages' synthetic
writers.

Bars, each stated where it is used:
  * bit-equal: the pose math (recenter_poses, spherify_poses,
    spiral_render_poses, the bd_factor rescale), focal, bounds,
    render_poses, the loaded images (the resize is bit-equal to Pillow's),
    the PNG minify of images_{factor}/, the synthetic scenes;
  * 1e-6 of the largest value: ndc_rays and the loaders' rays and
    viewdirs (measured: 0.0, bit-equal; torch and eager XLA compute the
    same float32 operations in the same order);
  * the renderer's bars (rgb 3e-3, depth 1e-2; ROADMAP Queue 3): a dense
    NDC render_rays with world viewdirs, deterministic (its disparity at
    2.5e-3 too), and render_path over two spiral poses. render_path's
    disparity is not held at the metric scenes' 2.5e-3: that bar is the
    depth bar at depths beyond near = 2, and NDC depths lie in [0, 1],
    where an error d in depth is d / depth^2 in disparity. Measured
    there: 8.4e-3 in disparity at 2 of 600 values (a fine sample that
    moves, as ROADMAP Queue 3 records), 1.2e-3 in 1 / disparity (depth
    over opacity), which is held at the depth bar, 1e-2;
  * tests/test_torch_train_step.py's: one train step on a 12-column LLFF
    batch, loss within 1e-5 and per-leaf gradients at relative Frobenius
    < 5e-2, cosine > 0.995.
"""

import dataclasses
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_llff as jax_llff_tests
from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.config import TrainConfig as JaxTrainConfig
from nerfmlp_tpu.data import llff as jllff
from nerfmlp_tpu.data.pipeline import RayBatchLoader as JaxRayBatchLoader
from nerfmlp_tpu.data.synthetic import (
    make_synthetic_llff_scene as jax_make_llff_scene,
)
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops import rays as jrays
from nerfmlp_tpu.ops.render import render_rays as jax_render_rays
from nerfmlp_tpu.render_path import render_path as jax_render_path
from test_torch_train_step import (
    _jax_loss_grads, _port_loss_grads, _rel_and_cos,
)

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data import llff
from nerfmlp_torch.data.pipeline import RayBatchLoader
from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import rays
from nerfmlp_torch.ops.render import render_rays
from nerfmlp_torch.render_path import render_path
from nerfmlp_torch.utils.image import image_size, read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_TOL = 1e-6          # of the largest |value|; measured 0.0
RGB_TOL, DISP_TOL, DEPTH_TOL = 3e-3, 2.5e-3, 1e-2
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
def scene(tmp_path_factory):
    """tests/test_llff.py's forward-facing capture: 8 cameras near z = +4
    looking down -z, 40x30 noise images."""
    return jax_llff_tests.llff_scene.__wrapped__(tmp_path_factory)


@pytest.fixture(scope="module")
def scene_360(tmp_path_factory):
    """tests/test_llff.py's 360 capture: 10 cameras on a ring."""
    return jax_llff_tests.llff_360_scene.__wrapped__(tmp_path_factory)


def _close(got, want, tol=RAY_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


# -- Rays and pose math ------------------------------------------------------

@pytest.mark.parametrize("hwf", [(30, 40, 50.0), (378, 504, 604.8)])
def test_ndc_rays_matches_jax(hwf):
    """ndc_rays on torch float32 against the JAX package's (eager XLA):
    measured bit-equal, held at 1e-6 of the largest value."""
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(4096, 3)) * 0.3).astype(np.float32)
    o[:, 2] += 0.2
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    H, W, f = hwf
    jo, jd = jrays.ndc_rays(H, W, f, 1.0, jnp.asarray(o), jnp.asarray(d))
    to, td = rays.ndc_rays(H, W, f, 1.0, torch.from_numpy(o),
                           torch.from_numpy(d))
    _close(to.numpy(), jo)
    _close(td.numpy(), jd)
    # After the projection, o + d lands on the far plane (z = 1).
    np.testing.assert_allclose((to + td).numpy()[:, 2], 1.0, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(radius=4.0), dict(
    radius=2.5, n_frames=7, height=0.5,
                                         target=np.array([0.1, 0.0, -0.2]),
                                         n_rots=2.0)])
def test_spiral_poses_match_jax(kw):
    got, want = rays.spiral_poses(**kw), jrays.spiral_poses(**kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _rig(seed=3, n=9):
    """A jittered forward-facing rig of (n, 4, 4) c2w and its bounds."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        eye = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3),
                        4.0 + rng.uniform(-0.2, 0.2)])
        poses.append(rays.look_at_matrix(
            eye, rng.uniform(-0.2, 0.2, 3), up=np.array([0.0, 1.0, 0.0])))
    bounds = rng.uniform(2.0, 8.0, size=(n, 2))
    return np.stack(poses).astype(np.float32), bounds


@pytest.mark.parametrize("fn", ["recenter_poses", "spherify_poses",
                                "spiral_render_poses", "_focus_point"])
def test_pose_math_matches_jax(fn):
    """Bit-equal: the same numpy operations in the same order."""
    poses, bounds = _rig()
    args = (poses,) if fn in ("recenter_poses", "_focus_point") else (
        poses, bounds)
    got, want = getattr(llff, fn)(*args), getattr(jllff, fn)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- The loader ----------------------------------------------------------

def _assert_same_dataset(ds, jds):
    """Poses, bounds, focal, images, render poses and near / far bit-equal;
    rays and viewdirs at RAY_TOL."""
    assert (ds.W, ds.H, ds.img_wh, ds.use_ndc) == (jds.W, jds.H, jds.img_wh,
                                                   jds.use_ndc)
    assert ds.focal == jds.focal
    for name in ("poses", "bounds", "_full_bounds", "_full_poses", "images"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name),
                                      err_msg=name)
    _close(ds.all_rays_o, jds.all_rays_o)
    _close(ds.all_rays_d, jds.all_rays_d)
    if jds.all_viewdirs is None:
        assert ds.all_viewdirs is None
    else:
        _close(ds.all_viewdirs, jds.all_viewdirs)
    np.testing.assert_array_equal(ds.all_rgbs, jds.all_rgbs)
    np.testing.assert_array_equal(ds.render_poses(n_frames=12),
                                  jds.render_poses(n_frames=12))
    assert ds.dynamic_near_far() == jds.dynamic_near_far()
    assert ds.n_images == jds.n_images and len(ds) == len(jds)
    for i in range(ds.n_images):
        for a, b in zip(ds.image_rays(i), jds.image_rays(i)):
            np.testing.assert_array_equal(a, b)
        vd, jvd = ds.image_viewdirs(i), jds.image_viewdirs(i)
        assert (vd is None) == (jvd is None)
        if vd is not None:
            np.testing.assert_array_equal(vd, jvd)


@pytest.mark.parametrize("case, kw", [
    ("ndc", dict(img_wh=(40, 30))),
    ("metric", dict(img_wh=(40, 30), use_ndc=False)),
    ("raw_frame", dict(img_wh=(40, 30), bd_factor=0.0, recenter=False,
                       use_ndc=False)),
    ("val_hold4", dict(split="val", img_wh=(40, 30), llffhold=4)),
    ("resized", dict(img_wh=(80, 60))),
    ("all_train", dict(img_wh=(20, 15), llffhold=0)),
    ("srgb", dict(img_wh=(40, 30), apply_srgb_to_linear=True)),
])
def test_loader_matches_jax(scene, case, kw):
    kw = dict(kw)
    split = kw.pop("split", "train")
    _assert_same_dataset(llff.LLFFDataset(scene, split, **kw),
                         jllff.LLFFDataset(scene, split, **kw))


def test_aspect_snap_and_opt_out(scene, capsys):
    """A square request against the 4:3 capture snaps the height (as
    --quick_val_res 256 256 meets fern); keep_aspect=False honours it and
    warns. Both against JAX's."""
    ds = llff.LLFFDataset(scene, "train", img_wh=(32, 32))
    assert (ds.W, ds.H) == (32, 24) and ds.images.shape[1:3] == (24, 32)
    assert "snapped height" in capsys.readouterr().out
    _assert_same_dataset(ds, jllff.LLFFDataset(scene, "train",
                                               img_wh=(32, 32)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ds = llff.LLFFDataset(scene, "train", img_wh=(32, 32),
                              keep_aspect=False)
    assert (ds.W, ds.H) == (32, 32)
    assert any("non-native aspect" in str(x.message) for x in w)
    _assert_same_dataset(ds, jllff.LLFFDataset(scene, "train",
                                               img_wh=(32, 32),
                                               keep_aspect=False))


def test_spherify_loader_matches_jax(scene_360):
    """--spherify: metric rays, the unit-sphere rig and the 120-pose circle
    (resampled to n_frames), as tests/test_llff.py checks, and equal to
    JAX's."""
    ds = llff.LLFFDataset(scene_360, "train", img_wh=(40, 30), llffhold=0,
                          spherify=True)
    assert ds.use_ndc is False and ds.all_viewdirs is None
    rad = np.sqrt(np.mean(np.sum(ds.poses[:, :3, 3] ** 2, axis=-1)))
    assert abs(rad - 1.0) < 1e-4
    assert ds.render_poses().shape == (120, 4, 4)
    for p in ds.render_poses(n_frames=10):
        np.testing.assert_allclose(p[:3, 2], p[:3, 3] / np.linalg.norm(
            p[:3, 3]), atol=1e-5)
    _assert_same_dataset(ds, jllff.LLFFDataset(
        scene_360, "train", img_wh=(40, 30), llffhold=0, spherify=True))


def test_llffhold_zero(scene):
    with pytest.raises(ValueError, match="llffhold"):
        llff.LLFFDataset(scene, "val", img_wh=(20, 15), llffhold=0)
    assert llff.LLFFDataset(scene, "train", img_wh=(20, 15),
                            llffhold=0).n_images == 8


def _copy(scene, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(scene, dst, ignore=shutil.ignore_patterns("images_*"))
    return dst


def test_factor_minify_matches_jax(scene, tmp_path):
    """images_{factor}/ made from images/ by both packages: the same
    files, decoded to the same pixels (the port's PNG writer, JAX's
    Pillow); then each loads the other's directory to the same dataset."""
    ours, theirs = _copy(scene, tmp_path, "ours"), _copy(scene, tmp_path,
                                                         "theirs")
    out = llff.LLFFDataset._ensure_factor_dir(ours, 4)
    jout = jllff.LLFFDataset._ensure_factor_dir(theirs, 4)
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jout)) and len(names) == 8
    for n in names:
        px = read_png(os.path.join(out, n))
        want = np.asarray(Image.open(os.path.join(jout, n)))
        assert px.shape == (7, 10, 3)            # 40x30 // 4
        np.testing.assert_array_equal(px, want)
        np.testing.assert_array_equal(np.asarray(Image.open(
            os.path.join(out, n))), want)
    assert not os.path.exists(out + ".tmp")
    _assert_same_dataset(llff.LLFFDataset(ours, "train", img_wh=(10, 7),
                                          factor=4),
                         jllff.LLFFDataset(theirs, "train", img_wh=(10, 7),
                                           factor=4))


def test_factor_dir_edge_cases(scene, tmp_path):
    """tests/test_llff.py:325-355 and the rest of _ensure_factor_dir: a
    partial images_{factor}/ is refused, never deleted; a rebuild goes
    through a .tmp directory that the picker never takes; a directory of
    other files is refused; a pre-minified directory without images/ is
    trusted; neither directory is a FileNotFoundError."""
    d = _copy(scene, tmp_path, "edge")
    fdir = llff.LLFFDataset._ensure_factor_dir(d, 4)
    for f in sorted(os.listdir(fdir))[4:]:
        os.remove(os.path.join(fdir, f))
    for pkg in (llff, jllff):
        with pytest.raises(ValueError, match="Delete"):
            pkg.LLFFDataset._ensure_factor_dir(d, 4)
    assert len(os.listdir(fdir)) == 4
    shutil.rmtree(fdir)
    assert llff.LLFFDataset._ensure_factor_dir(d, 4) == fdir
    assert len(os.listdir(fdir)) == 8 and not os.path.isdir(fdir + ".tmp")
    stale = os.path.join(d, "images_9.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "a.png"), "wb") as f:
        f.write(b"junk")
    for pkg in (llff, jllff):
        assert pkg.LLFFDataset._pick_image_dir(d, 40) == os.path.join(
            d, "images")
        assert pkg.LLFFDataset._pick_image_dir(d, 10) == fdir
    other = os.path.join(d, "images_3")
    os.makedirs(other)
    with open(os.path.join(other, "x.tif"), "wb") as f:
        f.write(b"tif")
    for pkg in (llff, jllff):
        with pytest.raises(ValueError, match="no recognized images"):
            pkg.LLFFDataset._ensure_factor_dir(d, 3)
    pre = _copy(scene, tmp_path, "pre")
    shutil.copytree(fdir, os.path.join(pre, "images_4"))
    shutil.rmtree(os.path.join(pre, "images"))
    assert llff.LLFFDataset._ensure_factor_dir(pre, 4) == os.path.join(
        pre, "images_4")
    _assert_same_dataset(
        llff.LLFFDataset(pre, "train", img_wh=(10, 7), factor=4),
        jllff.LLFFDataset(pre, "train", img_wh=(10, 7), factor=4))
    with pytest.raises(FileNotFoundError, match="neither"):
        llff.LLFFDataset._ensure_factor_dir(pre, 2)


def test_jpeg_refused_by_name_and_sized_from_its_header(scene, tmp_path):
    """JPEG captures load as the JAX loader loads them (the decoder's
    pixels equal Pillow's: tests/test_torch_jpeg.py), sized from the
    header as Pillow sizes them; a JPEG mode the decoder does not read is
    refused naming its ROADMAP item, where the JAX loader opens one
    (loading, minifying), and a refused minify leaves no directory; a
    pre-minified PNG images_{factor}/ beside JPEG images/ loads through
    --factor, as a real capture's layout does."""
    d = _copy(scene, tmp_path, "jpeg")
    src = os.path.join(d, "images")
    for n in sorted(os.listdir(src)):
        path = os.path.join(src, n)
        Image.open(path).save(path[:-4] + ".jpg", quality=90)
        os.remove(path)
    first = os.path.join(src, sorted(os.listdir(src))[0])
    assert image_size(first) == Image.open(first).size == (40, 30)
    _assert_same_dataset(llff.LLFFDataset(d, "train", img_wh=(40, 30)),
                         jllff.LLFFDataset(d, "train", img_wh=(40, 30)))
    # Progressive files, refused until the decoder read them, load as
    # JAX's loader loads them; a CMYK capture is refused.
    prog = _copy(scene, tmp_path, "progressive")
    cmyk = _copy(scene, tmp_path, "cmyk")
    for root, kw in ((prog, dict(progressive=True)), (cmyk, {})):
        for n in sorted(os.listdir(os.path.join(root, "images"))):
            path = os.path.join(root, "images", n)
            im = Image.open(path)
            (im if kw else im.convert("CMYK")).save(path[:-4] + ".jpg", **kw)
            os.remove(path)
    _assert_same_dataset(llff.LLFFDataset(prog, "train", img_wh=(40, 30)),
                         jllff.LLFFDataset(prog, "train", img_wh=(40, 30)))
    with pytest.raises(ValueError, match="four-component.*item 28"):
        llff.LLFFDataset(cmyk, "train", img_wh=(40, 30))
    with pytest.raises(ValueError, match="four-component.*item 28"):
        llff.LLFFDataset._ensure_factor_dir(cmyk, 2)
    assert not os.path.exists(os.path.join(cmyk, "images_2.tmp"))
    assert not os.path.exists(os.path.join(cmyk, "images_2"))
    fdir = os.path.join(d, "images_2")
    shutil.copytree(llff.LLFFDataset._ensure_factor_dir(
        _copy(scene, tmp_path, "png"), 2), fdir)
    ds = llff.LLFFDataset(d, "train", img_wh=(20, 15), factor=2)
    assert ds.images.shape == (7, 15, 20, 3)


@pytest.mark.parametrize("style", ["forward", "360"])
def test_synthetic_llff_scene_matches_jax(style, tmp_path):
    """make_synthetic_llff_scene writes the JAX writer's poses_bounds.npy
    and, decoded, its pixels."""
    ours = make_synthetic_llff_scene(str(tmp_path / "o"), n_images=3,
                                     img_wh=(16, 12), style=style)
    theirs = jax_make_llff_scene(str(tmp_path / "t"), n_images=3,
                                 img_wh=(16, 12), style=style)
    np.testing.assert_array_equal(
        np.load(os.path.join(ours, "poses_bounds.npy")),
        np.load(os.path.join(theirs, "poses_bounds.npy")))
    names = sorted(os.listdir(os.path.join(theirs, "images")))
    assert sorted(os.listdir(os.path.join(ours, "images"))) == names
    for n in names:
        np.testing.assert_array_equal(
            read_png(os.path.join(ours, "images", n)),
            np.asarray(Image.open(os.path.join(theirs, "images", n))))


def test_batches_carry_world_viewdirs(scene):
    """The pool rows are 12 columns [o | d_ndc | viewdir | rgb], the same
    rows as JAX's loader draws with the same seed."""
    ds = llff.LLFFDataset(scene, "train", img_wh=(40, 30))
    jds = jllff.LLFFDataset(scene, "train", img_wh=(40, 30))
    b = RayBatchLoader.from_dataset(ds, 64, seed=3).next_batch()
    jb = JaxRayBatchLoader.from_dataset(jds, 64, seed=3).next_batch()
    assert b.shape == (64, 12)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_allclose(np.linalg.norm(b[:, 6:9], axis=-1), 1.0,
                               atol=1e-5)
    assert np.abs(ds.all_viewdirs - ds.all_rays_d).max() > 0.1


# -- Rendering and training on NDC rays ----------------------------------

KW = dict(depth=2, width=32, N_samples=8, N_importance=8, near=0.0, far=1.0,
          perturb=False, raw_noise_std=0.0, white_bkgd=False, ndc=True)


def _both(**extra):
    kw = dict(KW, **extra)
    jcfg, cfg = JaxRenderConfig(**kw), RenderConfig(**kw)
    jp = {"coarse": jax_init_model(jax.random.PRNGKey(0), jcfg.model_config())}
    jp["coarse"]["sigma"]["bias"] = jp["coarse"]["sigma"]["bias"] + 0.5
    tp = {"coarse": model_from_params(jax.tree.map(np.asarray, jp["coarse"]),
                                      cfg.model_config(), device="cpu")}
    return jp, jcfg, tp, cfg


def test_ndc_render_rays_matches_jax(scene):
    """A dense NDC render of a held-out view's rays with its world
    viewdirs, deterministic, at the renderer's bars; without viewdirs
    both packages refuse."""
    ds = llff.LLFFDataset(scene, "val", img_wh=(40, 30))
    o, d, _ = ds.image_rays(0)
    vd = ds.image_viewdirs(0)
    sl = slice(0, 1200, 3)
    o, d, vd = o[sl], d[sl], vd[sl]
    jp, jcfg, tp, cfg = _both()
    want = jax_render_rays(jp, jnp.asarray(o), jnp.asarray(d), None, jcfg,
                           viewdirs=jnp.asarray(vd))
    with torch.no_grad():
        got = render_rays(tp, torch.from_numpy(o), torch.from_numpy(d), None,
                          cfg, viewdirs=torch.from_numpy(vd))
    np.testing.assert_allclose(got["rgb_map"].numpy(),
                               np.asarray(want["rgb_map"]), atol=RGB_TOL)
    np.testing.assert_allclose(got["disp_map"].numpy(),
                               np.asarray(want["disp_map"]), atol=DISP_TOL)
    np.testing.assert_allclose(got["depth_map"].numpy(),
                               np.asarray(want["depth_map"]), atol=DEPTH_TOL)
    assert float(got["rgb_map"].std()) > 1e-3
    with pytest.raises(ValueError, match="viewdirs"):
        render_rays(tp, torch.from_numpy(o), torch.from_numpy(d), None, cfg)


def test_render_path_spiral_matches_jax(scene, tmp_path):
    """Two poses of the loader's spiral through both render_paths (device
    rays, NDC projection, world viewdirs), and the static-camera video."""
    ds = llff.LLFFDataset(scene, "train", img_wh=(20, 15))
    poses = ds.render_poses(n_frames=2)
    hwf = (ds.H, ds.W, ds.focal)
    jp, jcfg, tp, cfg = _both()
    for kw in ({}, {"static_cam_pose": poses[0]}):
        want = jax_render_path(jp, poses, hwf, jcfg, tile=128, verbose=False,
                               **kw)
        got = render_path(tp, poses, hwf, cfg, tile=128, verbose=False,
                          save_dir=str(tmp_path / "f"), **kw)
        assert got[0].shape == (2, 15, 20, 3)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=RGB_TOL)
        np.testing.assert_allclose(1.0 / got[1], 1.0 / np.asarray(want[1]),
                                   atol=DEPTH_TOL)
        assert float(got[0].std()) > 1e-3


def test_train_step_on_llff_batch_matches_jax(scene):
    """Loss and per-leaf gradients of one deterministic step on a 12-column
    batch (world viewdirs), fp32, at tests/test_torch_train_step.py's
    bars."""
    ds = llff.LLFFDataset(scene, "train", img_wh=(40, 30))
    batch = RayBatchLoader.from_dataset(ds, 32, seed=1).next_batch()
    kw = dict(KW, depth=6, width=64, N_samples=32, N_importance=16)
    jcfg, rc = JaxRenderConfig(**kw), RenderConfig(**kw)
    params = jax_init_model(jax.random.PRNGKey(5), jcfg.model_config())
    loss_j, grads_j = _jax_loss_grads(params, batch, jcfg, JaxTrainConfig(),
                                      jit=True)
    nets = {"coarse": model_from_params(jax.tree.map(np.asarray, params),
                                        rc.model_config(), device="cpu")}
    loss_t, grads_t = _port_loss_grads(nets, batch, rc, TrainConfig())
    assert abs(loss_j - loss_t) < 1e-5
    for name in grads_j:
        for leaf in ("kernel", "bias"):
            rel, cos = _rel_and_cos(grads_t[name][leaf], grads_j[name][leaf])
            assert rel < 5e-2, f"{name}.{leaf}: relF {rel:.2e}"
            assert cos > 0.995, f"{name}.{leaf}: cosine {cos:.5f}"


# -- The CLIs, as configs/fern.txt runs them -------------------------------

@pytest.fixture(scope="module")
def fern_scene(tmp_path_factory):
    """A forward-facing synthetic capture stored as a pre-minified
    images_8/ (no images/), so configs/fern.txt's factor = 8 reads it at
    its native 32x24."""
    d = str(tmp_path_factory.mktemp("fern"))
    make_synthetic_llff_scene(d, n_images=10, img_wh=(32, 24),
                              style="forward")
    os.rename(os.path.join(d, "images"), os.path.join(d, "images_8"))
    return d


@pytest.fixture(scope="module")
def fern_run(fern_scene, tmp_path_factory):
    """configs/fern.txt through the train CLI for 4 steps, with every
    render event at step 2; returns (metrics, save dir, stdout)."""
    from nerfmlp_torch.scripts import train

    out = str(tmp_path_factory.mktemp("fernout"))
    m = train.main([
        "--config", os.path.join(ROOT, "configs", "fern.txt"),
        "--datadir", fern_scene, "--save_dir", out, "--iters", "4",
        "--batch_size", "128", "--quick_val_interval", "4",
        "--quick_val_res", "16", "16", "--quick_val_subset", "1",
        "--i_video", "2", "--video_frames", "2", "--i_testset", "2",
        "--i_img", "2", "--i_print", "2", "--half_res"] + NET)
    return m, out


def test_fern_config_trains_through_the_cli(fern_run, capsys):
    """The config as it is: native images_8/ size, NDC rays, no white
    background, 64 + 64 samples (cut here to 8 + 8), raw noise 1, the
    spiral video and the test sweep with PSNR, held-out frames."""
    m, out = fern_run
    cfg = m["config"]
    assert m["step"] == 4 and np.isfinite(m["final_val"]["psnr"])
    assert cfg["full_val_res"] == [32, 24] and cfg["quick_val_res"] == [16, 12]
    r = cfg["render"]
    assert r["ndc"] and not r["white_bkgd"] and r["raw_noise_std"] == 1.0
    assert (r["near"], r["far"]) == (0.0, 1.0) and r["use_viewdirs"]
    with open(os.path.join(out, "args.txt")) as f:
        args_txt = f.read()
    assert "img_wh = [32, 24]" in args_txt and "factor = 8" in args_txt
    assert "no_white_bkgd = True" in args_txt
    names = set(os.listdir(out))
    stem = os.path.basename(out) + "_spiral_000002"
    assert {stem + "_rgb.gif", stem + "_disp.gif", stem + "_rgb_still.gif",
            "val_000002.png", "val_000004.png", "model_final.pt"} <= names
    assert sorted(os.listdir(os.path.join(out, "testset_000002"))) == [
        "000.png", "001.png"]
    assert m["testset_steps"] == [2] and np.isfinite(m["testset_psnrs"][0])


def test_train_cli_resolution_defaults(fern_scene, tmp_path, capsys):
    """--factor's native size (printed), 504x378 for LLFF without it,
    and --half_res ignored with a warning outside Blender."""
    from nerfmlp_torch.scripts import train

    args = train.parse_args(["--datadir", fern_scene, "--dataset_type",
                             "llff"])
    assert train._default_wh(args) == [504, 378]
    args = train.parse_args(["--config", os.path.join(ROOT, "configs",
                                                      "fern.txt"),
                             "--datadir", fern_scene])
    assert train._default_wh(args) == [32, 24]
    assert "--factor 8: native resolution 32x24" in capsys.readouterr().out
    args = train.parse_args(["--datadir", fern_scene, "--dataset_type",
                             "deepvoxels"])
    assert train._default_wh(args) == [512, 512]


def test_fern_resume_and_render_only(fern_run, fern_scene):
    """The same command resumes from the run's checkpoint; --render_only
    renders the spiral (120 frames by default, here 2) through NDC rays."""
    from nerfmlp_torch.scripts import train

    m, out = fern_run
    base = ["--config", os.path.join(ROOT, "configs", "fern.txt"),
            "--datadir", fern_scene, "--save_dir", out, "--batch_size",
            "128", "--quick_val_interval", "0", "--full_val_interval", "0",
            "--i_print", "0"] + NET
    assert train.main(base + ["--iters", "6"])["step"] == 6
    r = train.main(base + ["--iters", "6", "--render_only",
                           "--video_frames", "2"])
    assert r["render_only"].endswith("renderonly_path_000006")
    assert os.path.exists(os.path.join(r["render_only"], "video_rgb.gif"))


def test_inference_clis_on_llff(fern_run, fern_scene, tmp_path):
    """render_video (the loader's spiral, NDC, no white composite), eval,
    render_example and compare_single_view with --dataset_type llff, and
    the serve CLI's --datadir defaults: its frame of spiral pose 0 equals
    render_video's frame 0."""
    from nerfmlp_torch.scripts import compare_single_view, render_example
    from nerfmlp_torch.scripts import eval as eval_cli
    from nerfmlp_torch.scripts import render_video
    from nerfmlp_torch.scripts.serve import build_parser, build_service

    _, out = fern_run
    ckpt = os.path.join(out, "model_final.pt")
    llff_args = ["--datadir", fern_scene, "--dataset_type", "llff",
                 "--factor", "8", "--ckpt", ckpt]
    vid = render_video.main(llff_args + NET + [
        "--out_dir", str(tmp_path / "v"), "--n_frames", "2", "--size", "32"])
    assert vid["rgbs"].shape == (2, 24, 32, 3)
    assert vid["cfg"].ndc and not vid["cfg"].white_bkgd
    ds = llff.LLFFDataset(fern_scene, "train", img_wh=(32, 32), factor=8)
    args = build_parser().parse_args(
        ["--ckpt", ckpt, "--datadir", fern_scene, "--dataset_type", "llff",
         "--factor", "8", "--img_wh", "32", "24"] + NET)
    svc = build_service(args)
    assert svc.cfg.ndc and not svc.cfg.white_bkgd
    assert svc.defaults == {"H": 24, "W": 32, "focal": ds.focal,
                            "near": 0.0, "far": 1.0}
    frame = svc.render_pose(ds.render_poses(n_frames=2)[0])["rgb_map"]
    np.testing.assert_array_equal(frame, vid["rgbs"][0])
    # Without --datadir: NDC for LLFF unless --no_ndc; its bounds are given.
    base = ["--ckpt", ckpt, "--dataset_type", "llff", "--focal",
            str(ds.focal), "--img_wh", "32", "24"] + NET
    with pytest.raises(SystemExit):
        build_service(build_parser().parse_args(base))
    svc = build_service(build_parser().parse_args(
        base + ["--near", "0", "--far", "1"]))
    assert svc.cfg.ndc and svc.defaults["far"] == 1.0
    np.testing.assert_array_equal(svc.render_pose(
        ds.render_poses(n_frames=2)[0])["rgb_map"], vid["rgbs"][0])
    assert not build_service(build_parser().parse_args(
        base + ["--near", "0", "--far", "1", "--no_ndc"])).cfg.ndc
    with pytest.raises(SystemExit):     # parser.error: needs metric rays
        render_video.main(llff_args + NET + ["--flythrough", "--out_dir",
                                             str(tmp_path / "fly")])
    rep = eval_cli.main(llff_args + NET + [
        "--split", "val", "--img_wh", "32", "24",
        "--out", str(tmp_path / "e.json")])
    assert rep["n_views"] == 2 and np.isfinite(rep["mean_psnr"])
    written = render_example.main(llff_args + NET + [
        "--img_wh", "32", "24", "--out_dir", str(tmp_path / "r")])
    assert read_png(written[0]).shape == (24, 32, 3)
    psnr, _ = compare_single_view.main(
        ["--datadir", fern_scene, "--dataset_type", "llff", "--ckpt", ckpt,
         "--img_wh", "32", "24", "--out", str(tmp_path / "c.png")] + NET)
    assert np.isfinite(psnr)
    assert read_png(str(tmp_path / "c.png")).shape == (24, 64, 3)


def test_trainer_occupancy_and_resume_on_ndc(fern_scene, tmp_path):
    """Occupancy sampling on NDC rays, with no special case (as in JAX:
    the box is in NDC space), and a resume that rebuilds the grid."""
    from nerfmlp_torch.train.loop import Trainer

    ds = llff.LLFFDataset(fern_scene, "train", img_wh=(16, 16), factor=8)
    rc = RenderConfig(**dict(KW, perturb=True, use_occupancy=True,
                             aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                             occ_grid_size=8, occ_dense_samples=16,
                             occ_update_every=2))
    tc = TrainConfig(batch_size=64, iters=4, quick_val_interval=0,
                     full_val_interval=0, log_interval=0, ckpt_interval=0)
    t = Trainer(rc, tc, ds, ds, save_dir=str(tmp_path / "occ"),
                verbose=False, device="cpu")
    m = t.train()
    assert m["step"] == 4 and np.isfinite(m["final_val"]["psnr"])
    t2 = Trainer(rc, dataclasses.replace(tc, iters=6), ds, ds,
                 save_dir=str(tmp_path / "occ"), verbose=False, device="cpu")
    assert t2.resume(str(tmp_path / "occ" / "metrics_latest.pt"))
    assert t2.occ_grid is not None and t2.state.step == 4
    assert t2.train()["step"] == 6


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_channels_and_header_size(channels, tmp_path):
    """png_bytes writes grey, grey + alpha, RGB and RGBA (a minify keeps
    each source's channels, as Pillow's save does); Pillow decodes them to
    the same pixels, and png_size reads the size Pillow reports."""
    from nerfmlp_torch.utils.image import png_bytes, png_size

    px = np.random.default_rng(channels).integers(
        0, 256, size=(5, 7, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(png_bytes(px))
    with Image.open(path) as im:
        assert png_size(path) == im.size == (7, 5)
        got = np.asarray(im)
    np.testing.assert_array_equal(got.reshape(px.shape), px)
    np.testing.assert_array_equal(read_png(path), px)
