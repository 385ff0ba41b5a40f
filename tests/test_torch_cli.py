"""The port's inference CLIs and the train CLI's render flags on the CPU
(``--device cpu``, a 2x32 net, 8 + 8 samples, a 32x32 synthetic scene),
mirroring tests/test_cli.py: render_video, render_example, eval,
compare_single_view, zoom_example, train_only; --render_only with a custom
architecture; --half_res; the quick-validation default; a shipped config
file; and the refusals that stay."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from nerfmlp_tpu.data.blender import BlenderDataset as JaxBlenderDataset

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.scripts import compare_single_view, render_example
from nerfmlp_torch.scripts import eval as eval_cli
from nerfmlp_torch.scripts import render_video, train, train_only
from nerfmlp_torch.scripts import zoom_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = ["--N_samples", "8", "--N_importance", "8", "--device", "cpu",
       "--netdepth", "2", "--netwidth", "32"]
OCC = ["--use_occupancy", "--aabb", "-2", "-2", "-2", "2", "2", "2",
       "--occ_grid_size", "8", "--occ_dense_samples", "16"]



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
    d = str(tmp_path_factory.mktemp("cliscene"))
    make_synthetic_scene(d, n_train=4, n_val=2, n_test=2, img_wh=(32, 32))
    return d


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    """model_final.pt of a 30-step run: the checkpoint every CLI reads."""
    out = str(tmp_path_factory.mktemp("cliout"))
    train.main(["--datadir", scene, "--batch_size", "256", "--iters", "30",
                "--save_dir", out, "--quick_val_interval", "30",
                "--quick_val_res", "32", "32", "--quick_val_subset", "1",
                "--full_val_interval", "0", "--i_print", "10"] + NET)
    return os.path.join(out, "model_final.pt")


def _size(path):
    with Image.open(path) as im:
        return im.size


def test_render_video_cli(scene, trained, tmp_path):
    """Orbit, test split with psnr.json, fly-through, with the grid."""
    base = ["--datadir", scene, "--ckpt", trained, "--size", "32"] + NET
    out = str(tmp_path / "path")
    res = render_video.main(base + ["--out_dir", out, "--n_frames", "2"])
    assert res["rgbs"].shape == (2, 32, 32, 3) and res["psnrs"] is None
    for name in ("path_rgb.gif", "path_disp.gif", "frames/001.png"):
        assert os.path.exists(os.path.join(out, name)), name
    with Image.open(os.path.join(out, "path_rgb.gif")) as im:
        assert im.n_frames == 2

    out = str(tmp_path / "test")
    render_video.main(base + ["--out_dir", out, "--render_test",
                              "--render_factor", "2"])
    assert _size(os.path.join(out, "frames", "000.png")) == (16, 16)
    assert not os.path.exists(os.path.join(out, "psnr.json"))
    render_video.main(base + ["--out_dir", out, "--render_test"])
    with open(os.path.join(out, "psnr.json")) as f:
        rep = json.load(f)
    assert len(rep["per_frame_psnr"]) == 2 and np.isfinite(rep["mean_psnr"])

    out = str(tmp_path / "fly")
    res = render_video.main(base + ["--out_dir", out, "--flythrough",
                                    "--n_frames", "2"] + OCC)
    assert glob.glob(os.path.join(out, "flythrough_rgb.gif"))
    assert np.isfinite(res["rgbs"]).all()


def test_render_example_cli(scene, trained, tmp_path):
    base = ["--datadir", scene, "--split", "val", "--img_wh", "32", "32",
            "--ckpt", trained, "--num_views", "1", "--dynamic_bounds",
            "--tile", "256"] + NET
    out = str(tmp_path / "r")
    render_example.main(base + ["--out_dir", out])
    assert _size(os.path.join(out, "render_val_0.png")) == (32, 32)
    render_example.main(base + ["--out_dir", str(tmp_path / "occ")] + OCC)
    assert os.path.exists(tmp_path / "occ" / "render_val_0.png")
    written = render_example.main(base + [
        "--out_prefix", str(tmp_path / "pre" / "x"), "--view_idx", "3",
        "--apply_gamma", "--brightness_boost", "1.5"])
    assert written == [str(tmp_path / "pre" / "x_view3.png")]
    with pytest.raises(SystemExit):        # --use_occupancy without --aabb
        render_example.main(base + ["--use_occupancy"])


def test_compare_and_zoom_cli(scene, trained, tmp_path, monkeypatch):
    for extra in ([], OCC):
        out = str(tmp_path / f"cmp{len(extra)}.png")
        psnr, _ = compare_single_view.main([
            "--datadir", scene, "--img_wh", "32", "32", "--ckpt", trained,
            "--view_idx", "0", "--out", out, "--no_kernel"] + NET + extra)
        assert _size(out) == (64, 32) and np.isfinite(psnr)
    monkeypatch.setattr(zoom_example, "SCENARIOS",
                        [("normal", (3.0, -3.0, 2.0), 1.0)])
    for extra in ([], OCC):
        out = str(tmp_path / f"zoom{len(extra)}")
        written = zoom_example.main(["--datadir", scene, "--ckpt", trained,
                                     "--out_dir", out, "--size", "32"]
                                    + NET + extra)
        assert written == [os.path.join(out, "normal.png")]
        assert _size(written[0]) == (32, 32)


def test_train_only_cli(scene, tmp_path):
    out = str(tmp_path / "to")
    losses, psnrs = train_only.main([
        "--datadir", scene, "--img_wh", "32", "32", "--batch_size", "32",
        "--iters", "200", "--save_dir", out, "--N_samples", "8",
        "--N_importance", "8", "--compute_dtype", "float32", "--no_kernel",
        "--device", "cpu"])
    assert len(losses) == 2 and losses[-1] < losses[0]
    for name in ("model_final.pt", "final_metrics.json"):
        assert os.path.exists(os.path.join(out, name)), name


def test_eval_cli(scene, trained, tmp_path):
    base = ["--datadir", scene, "--split", "test", "--img_wh", "32", "32",
            "--ckpt", trained, "--tile", "256"] + NET
    report = eval_cli.main(base + ["--out", str(tmp_path / "e.json"),
                                   "--save_renders", str(tmp_path / "png")])
    assert report["n_views"] == 2 and len(report["per_view"]) == 2
    assert np.isfinite(report["mean_psnr"]) and report["mean_lpips"] is None
    with open(tmp_path / "e.json") as f:
        assert json.load(f)["mean_psnr"] == report["mean_psnr"]
    assert os.path.exists(tmp_path / "png" / "eval_test_1.png")
    report = eval_cli.main(base + OCC + ["--out", str(tmp_path / "o.json")])
    assert np.isfinite(report["mean_psnr"])


def test_custom_arch_train_and_render_only(scene, tmp_path):
    """Separate coarse and fine nets of their own shapes train, then
    --render_only renders the test split (with PSNRs) and the orbit (with
    its videos) from the auto-resumed checkpoint, without training."""
    out = str(tmp_path / "arch")
    common = ["--datadir", scene, "--batch_size", "128", "--N_samples",
              "8", "--N_importance", "8", "--quick_val_interval", "20",
              "--full_val_interval", "0", "--quick_val_res", "16", "16",
              "--quick_val_subset", "1", "--compute_dtype", "float32",
              "--no_kernel", "--device", "cpu", "--netdepth", "3",
              "--netwidth", "32", "--netdepth_fine", "4",
              "--netwidth_fine", "48", "--separate_fine", "--save_dir", out,
              "--iters", "20"]
    m = train.main(common + ["--i_print", "10", "--chunk", "256",
                             "--perturb", "0"])
    assert m["step"] == 20
    m = train.main(common + ["--render_only", "--render_test"])
    assert m["render_only"].endswith("renderonly_test_000020")
    assert len(m["psnrs"]) == 2 and np.isfinite(m["psnrs"]).all()
    assert os.path.exists(os.path.join(m["render_only"], "001.png"))
    m = train.main(common + ["--render_only", "--video_frames", "2"])
    assert m["render_only"].endswith("renderonly_path_000020")
    for name in ("video_rgb.gif", "video_disp.gif", "001.png"):
        assert os.path.exists(os.path.join(m["render_only"], name)), name


def test_half_res_and_quick_val_default(scene, tmp_path, capsys):
    """--half_res trains at half the stored size (read from the PNG
    header); quick validation reads the val views at the reference's
    256x256 default, the images equal to the JAX loader's."""
    out = str(tmp_path / "half")
    m = train.main(["--datadir", scene, "--half_res", "--batch_size", "64",
                    "--iters", "2", "--save_dir", out, "--quick_val_interval",
                    "2", "--quick_val_subset", "1", "--full_val_interval",
                    "0", "--N_samples", "8", "--N_importance", "0",
                    "--compute_dtype", "float32", "--no_kernel"] + NET[4:])
    assert "--half_res: training at 16x16" in capsys.readouterr().out
    assert m["config"]["quick_val_res"] == [256, 256]
    assert m["config"]["full_val_res"] == [16, 16]
    assert len(m["quick_val_psnrs"]) == 1
    ours = BlenderDataset(scene, "val", img_wh=(256, 256))
    want = JaxBlenderDataset(scene, "val", img_wh=(256, 256))
    np.testing.assert_array_equal(ours.images, want.images)


def test_shipped_config_runs(scene, tmp_path, capsys):
    """configs/lego_turbo_bf16.txt as it is (half_res, occupancy, bf16
    through the kernel flag), with a small net and its scene's box."""
    out = str(tmp_path / "turbo")
    m = train.main(["--config", os.path.join(ROOT, "configs",
                                             "lego_turbo_bf16.txt"),
                    "--datadir", scene, "--save_dir", out, "--iters", "4",
                    "--quick_val_interval", "4", "--quick_val_res", "16",
                    "16", "--quick_val_subset", "1", "--occ_grid_size", "8",
                    "--occ_update_every", "2"] + NET[4:])
    assert "--half_res: training at 16x16" in capsys.readouterr().out
    assert m["step"] == 4
    cfg = m["config"]["render"]
    assert cfg["use_occupancy"] and cfg["compute_dtype"] == "bfloat16"
    assert (cfg["N_samples"], cfg["N_importance"]) == (16, 48)


# --shard_render left this list when frames could be rendered over several
# devices (tests/test_torch_parallel.py::test_shard_render_on_one_device).
@pytest.mark.parametrize("cli, extra, match", [
    (eval_cli, ["--lpips"], "lpips"),
])
def test_refusals_that_stay(scene, cli, extra, match):
    argv = ["--datadir", scene, "--device", "cpu"] + extra
    if cli is not train:
        argv += ["--ckpt", "x.pt"]
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


@pytest.fixture(scope="module")
def other_scenes(tmp_path_factory):
    """A forward-facing LLFF capture (8 views of 16x12) and a DeepVoxels
    one (tests/test_deepvoxels.py's writer)."""
    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene
    from test_deepvoxels import _write_scene

    root = tmp_path_factory.mktemp("other")
    return {"llff": make_synthetic_llff_scene(
                str(root / "llff"), n_images=8, img_wh=(16, 12),
                style="forward"),
            "deepvoxels": _write_scene(str(root / "dv"), scene="greek")}


@pytest.mark.parametrize("cli, dataset", [(eval_cli, "llff"),
                                          (train, "deepvoxels")])
def test_other_datasets_run(other_scenes, trained, tmp_path, cli, dataset):
    """The two cases test_refusals_that_stay held until the LLFF and
    DeepVoxels loaders were ported: eval on an LLFF capture's held-out
    views (NDC rays, world viewdirs) and a few train steps on a
    DeepVoxels scene."""
    argv = ["--datadir", other_scenes[dataset], "--dataset_type",
            dataset] + NET
    if cli is train:
        m = cli.main(argv + ["--iters", "4", "--batch_size", "64",
                             "--save_dir", str(tmp_path / "o"),
                             "--img_wh", "16", "16",
                             "--quick_val_interval", "4",
                             "--quick_val_res", "16", "16",
                             "--quick_val_subset", "1"])
        assert m["step"] == 4 and np.isfinite(m["final_val"]["psnr"])
    else:
        rep = cli.main(argv + ["--ckpt", trained, "--split", "val",
                               "--img_wh", "16", "12", "--out",
                               str(tmp_path / "e.json")])
        assert rep["n_views"] == 1 and np.isfinite(rep["mean_psnr"])


def test_ckpt_files_are_refused(scene, trained, tmp_path):
    """A .ckpt that does not decode is refused by name; the trained weights
    as the JAX package's .ckpt render the .pt's frame."""
    from nerfmlp_torch.train.checkpoint import (
        CheckpointCorruptError, jax_params_tree, load_params_any, save_ckpt,
    )

    argv = ["--datadir", scene, "--split", "val", "--img_wh", "32", "32",
            "--num_views", "1"] + NET
    bad = tmp_path / "model.ckpt"
    bad.write_bytes(b"\x85\xa4step")
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        render_example.main(argv + ["--ckpt", str(bad)])
    good = str(tmp_path / "model_final.ckpt")
    save_ckpt(good, jax_params_tree(load_params_any(
        trained, RenderConfig(depth=2, width=32).model_config(),
        device="cpu")))
    frames = []
    for i, path in enumerate((trained, good)):
        render_example.main(argv + ["--ckpt", path, "--out_prefix",
                                    str(tmp_path / f"r{i}")])
        frames.append(sorted(glob.glob(str(tmp_path / f"r{i}*.png"))))
    assert len(frames[0]) == len(frames[1]) > 0
    for a, b in zip(*frames):
        assert open(a, "rb").read() == open(b, "rb").read()
