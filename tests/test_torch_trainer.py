"""The port's Trainer, checkpoints and train CLI on the CPU, on a tiny
synthetic scene: a few dozen steps, the metrics JSON in the JAX Trainer's
schema, resume, and the CLI end to end."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train.loop import Trainer

WH = (16, 16)
RC = RenderConfig(depth=2, width=32, N_samples=8, N_importance=8,
                  near=2.0, far=6.0, compute_dtype="bfloat16",
                  use_kernel=True)
TC = TrainConfig(batch_size=128, iters=24, quick_val_interval=12,
                 full_val_interval=0, quick_val_subset=1, log_interval=0,
                 ckpt_interval=12, seed=1, lr=5e-3)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_synthetic_scene(root, n_train=4, n_val=1, n_test=0, img_wh=WH)
    return (BlenderDataset(root, "train", img_wh=WH),
            BlenderDataset(root, "val", img_wh=WH), root)


def _trainer(scene, save_dir, **tc):
    train_ds, val_ds, _ = scene
    return Trainer(RC, dataclasses.replace(TC, **tc), train_ds, val_ds,
                   save_dir=str(save_dir), device="cpu", verbose=False)


def test_trainer_trains_and_writes_the_reference_schema(scene, tmp_path):
    """A few dozen steps through the fused path's plain versions: the loss
    falls, checkpoints appear, and the metrics JSON has the JAX Trainer's
    keys."""
    from nerfmlp_tpu.config import RenderConfig as JRC
    from nerfmlp_tpu.config import TrainConfig as JTC
    from nerfmlp_tpu.data.blender import BlenderDataset as JDS
    from nerfmlp_tpu.train.loop import Trainer as JTrainer

    tr = _trainer(scene, tmp_path, iters=48)
    losses = []
    inner = tr.step_fn
    tr.step_fn = lambda s, b: losses.append(float(inner(s, b)["loss"])) or {
        "loss": torch.tensor(losses[-1]), "psnr": torch.tensor(0.0)}
    out = tr.train()
    assert tr.state.step == 48 and tr.history["step"] == 48
    assert np.mean(losses[-8:]) < 0.8 * np.mean(losses[:8])
    for name in ("model_12.pt", "model_24.pt", "model_best.pt",
                 "model_final.pt", "metrics_latest.pt",
                 "metrics_latest.history.json", "metrics_latest.json",
                 "metrics_48_latest.json", "model_48_latest.pt",
                 "model_full_val_final.pt", "comprehensive_metrics.json"):
        assert os.path.exists(tmp_path / name), name
    assert tr.history["val_steps"] == [12, 24, 36, 48]
    assert out["final_val"]["psnr"] > 0

    root = scene[2]
    jtr = JTrainer(JRC(depth=2, width=32, N_samples=8, N_importance=8),
                   JTC(batch_size=128), JDS(root, "train", img_wh=WH),
                   JDS(root, "val", img_wh=WH),
                   save_dir=str(tmp_path / "jax"), verbose=False)
    with open(tmp_path / "metrics_latest.json") as f:
        snapshot = json.load(f)
    assert set(snapshot) == set(jtr.history) | {"config"}
    assert set(snapshot["config"]) == set(jtr._config_dict())
    assert set(snapshot["config"]["train"]) == set(
        dataclasses.asdict(jtr.tc))


def test_resume_restores_step_params_and_adam(scene, tmp_path):
    """24 steps, then a fresh Trainer resumes from metrics_latest.pt and
    runs 12 more: the same weights, Adam state and step as 36 steps
    without a break (the generator and the pool's epoch are restored)."""
    whole = _trainer(scene, tmp_path / "whole", iters=36)
    whole.train()
    first = _trainer(scene, tmp_path / "split", iters=24)
    first.train()
    second = _trainer(scene, tmp_path / "split", iters=36)
    path = ckpt.latest_checkpoint(str(tmp_path / "split"))
    assert path.endswith("metrics_latest.pt")
    assert second.resume(path)
    assert second.state.step == 24 and second.history["step"] == 24
    for (n, p), (_, q) in zip(second.state.params["coarse"].named_parameters(),
                              first.state.params["coarse"].named_parameters()):
        assert torch.equal(p, q), n
    second.train()
    assert second.state.step == 36
    for (n, p), (_, q) in zip(second.state.params["coarse"].named_parameters(),
                              whole.state.params["coarse"].named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    sa = second.state.optimizer.state_dict()["state"]
    sb = whole.state.optimizer.state_dict()["state"]
    for k in sb:
        assert torch.equal(sa[k]["exp_avg"], sb[k]["exp_avg"])


def test_resume_from_params_only_checkpoint(scene, tmp_path):
    tr = _trainer(scene, tmp_path, iters=12)
    tr.train()
    again = _trainer(scene, tmp_path / "b")
    assert again.resume(str(tmp_path / "model_12.pt"))
    assert again.state.step == 12 and int(again.state.counter) == 12
    opt = again.state.optimizer                 # fresh Adam moments
    assert float(opt.count) == 0
    assert not any(t.any() for t in opt.exp_avg + opt.exp_avg_sq)
    assert not again.resume(str(tmp_path / "missing.pt"))
    wide = Trainer(dataclasses.replace(RC, width=48), TC, scene[0],
                   save_dir=str(tmp_path / "c"), device="cpu", verbose=False)
    with pytest.raises(ValueError, match="architecture"):
        wide.resume(str(tmp_path / "model_12.pt"))


def test_trainer_refuses_occupancy(scene, tmp_path):
    """Occupancy without a scene box raises the JAX Trainer's ValueError
    naming aabb (occupancy itself is ported: test_torch_occupancy.py)."""
    with pytest.raises(ValueError, match="aabb"):
        Trainer(dataclasses.replace(RC, use_occupancy=True, aabb=None), TC,
                scene[0], save_dir=str(tmp_path), device="cpu")


def test_checkpoint_names_and_formats(tmp_path):
    assert ckpt.step_from_filename("model_120.pt") == 120
    assert ckpt.step_from_filename("x/model_7_latest.pt") == 7
    assert ckpt.step_from_filename("model_best.pt") == 0
    for name in ("model_3.pt", "model_20.pt", "model_best.pt"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("model_20.pt")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    # The JAX package's .ckpt names carry their step too; the files are
    # read (tests/test_torch_ckpt.py), and one that does not decode raises
    # by name.
    assert ckpt.step_from_filename("model_5_latest.ckpt") == 5
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "model_5.ckpt"))
    (tmp_path / "model_6.ckpt").write_bytes(b"")
    with pytest.raises(ckpt.CheckpointCorruptError, match="truncated"):
        ckpt.load_checkpoint(str(tmp_path / "model_6.ckpt"))


def test_trained_params_load_for_serving(scene, tmp_path):
    """model_final.pt (a bare state dict) and metrics_latest.pt (a whole
    train state) load through load_params_any, as the serve CLI does."""
    tr = _trainer(scene, tmp_path, iters=12)
    tr.train()
    mc = RC.model_config()
    for name, step in (("model_final.pt", 0), ("metrics_latest.pt", 12)):
        params, got_step = ckpt.load_params_any(str(tmp_path / name), mc,
                                                device="cpu", with_step=True)
        assert got_step == step
        for (n, p), (_, q) in zip(params["coarse"].named_parameters(),
                                  tr.state.params["coarse"].named_parameters()):
            assert torch.equal(p, q), n


def test_library_calls_leave_tf32_alone():
    """Only the entry points set the TF32 flags; the plain MLP versions and
    the module do not touch a caller's setting."""
    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops import fused_mlp

    net = init_model(RC.model_config(), device="cpu")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pts = torch.zeros(4, 3)
        dirs = torch.zeros(4, 27)
        fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, 10)
        net(torch.zeros(4, 63), dirs, compute_dtype=torch.float32)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_train_cli_on_cpu(tmp_path):
    """python -m nerfmlp_torch.scripts.train --device cpu on a synthetic
    scene it writes itself; then refused flags; then an LLFF capture."""
    from nerfmlp_torch.scripts import train as cli

    data, out = tmp_path / "scene", tmp_path / "out"
    args = ["--datadir", str(data), "--make_synthetic_scene", "--img_wh",
            "16", "16", "--device", "cpu", "--iters", "8", "--batch_size",
            "64", "--N_samples", "8", "--N_importance", "8", "--netdepth",
            "2", "--netwidth", "32", "--quick_val_interval", "4",
            "--quick_val_subset", "1", "--i_print", "4", "--i_weights", "4",
            "--save_dir", str(out)]
    metrics = cli.main(args)
    assert metrics["step"] == 8
    assert os.path.exists(out / "model_final.pt")
    assert os.path.exists(out / "metrics_latest.json")
    # Auto-resume: the same command continues from step 8.
    metrics = cli.main(args[:args.index("--iters") + 1] + ["12"]
                       + args[args.index("--iters") + 2:])
    assert metrics["step"] == 12
    # --tensor_parallel 2, refused until tensor parallelism was ported,
    # fails JAX's divisibility check on one device.
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        cli.main(args + ["--tensor_parallel", "2"])
    # --dataset_type llff, refused until the LLFF loader was ported, trains
    # on a forward-facing capture (NDC rays, no white background).
    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene

    fwd = str(tmp_path / "fwd")
    make_synthetic_llff_scene(fwd, n_images=9, img_wh=(16, 12),
                              style="forward")
    llff_args = [a for a in args if a != "--make_synthetic_scene"]
    llff_args[llff_args.index(str(data))] = fwd
    llff_args[llff_args.index(str(out))] = str(tmp_path / "llff_out")
    m = cli.main(llff_args[:llff_args.index("--img_wh")]
                 + llff_args[llff_args.index("--img_wh") + 3:]
                 + ["--dataset_type", "llff", "--img_wh", "16", "12"])
    assert m["step"] == 8 and m["config"]["render"]["ndc"]
    assert not m["config"]["render"]["white_bkgd"]
