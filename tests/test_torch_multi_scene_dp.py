"""Multi-scene training over several ranks (nerfmlp_torch/parallel/
multi_scene.py: scene_layout, make_scene_mesh, make_multi_scene_dp_step,
make_multi_scene_dp_grid_update, gather_scene_metrics; the
train_multi_scene CLI's --n_devices) on the CPU, with gloo ranks spawned
at a file:// rendezvous, each on one intra-op thread, running
nerfmlp_torch/parallel/checks.py::multi_scene_steps.

Both layouts against the unsharded stacked step on the same scenes,
weights (scene s seeded seed + 1000 s) and global batches, as
tests/test_multi_scene.py:114-155 and :275-327 hold JAX's:
  * whole scenes per rank (4 scenes on 2 ranks): nothing crosses ranks
    but the metrics, and a scene's computation is the stack's own, so
    metrics, parameters and grids are bit-equal;
  * ("scene", "data") (2 scenes on 4 ranks, 2 a scene): each scene's
    batch is split over its group and its gradient averaged there, so the
    first step's loss is held at rtol 1e-5, the parameters after the
    steps at atol 5e-3 (JAX's bars) and bit-equal within each group; the
    grids, refreshed alike on a group's ranks before any step, at 1e-6
    (JAX's 1e-5 holds).
"""

import os

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel.mesh import Mesh, launch
from nerfmlp_torch.parallel.multi_scene import scene_layout
from nerfmlp_torch.train.checkpoint import load_params_any

TIMEOUT_S = 60
KW = dict(depth=2, width=32, N_samples=8, N_importance=8, near=0.5, far=4.0,
          perturb=True)
OCC = dict(use_occupancy=True, aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
           occ_grid_size=8, occ_dense_samples=16)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n_scenes, n, steps, seed):
    """(n_scenes, n, 9) global batches of rays toward the origin."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = rng.normal(size=(n_scenes, n, 9)).astype(np.float32)
        b[..., 0:3] = b[..., 0:3] * 0.2 + np.array([0.0, 0.0, 3.0])
        b[..., 5] = -1.0
        b[..., 6:9] = np.abs(b[..., 6:9]) % 1.0
        out.append(b)
    return out


def _run(n_ranks, n_scenes, occupancy, steps=2):
    rc = RenderConfig(**KW, **(OCC if occupancy else {}))
    tc = TrainConfig(batch_size=64, seed=0)
    batches = _batches(n_scenes, 64, steps, seed=9)
    kw = dict(refresh_seed=100)
    one = checks.multi_scene_steps(None, rc, tc, batches, n_scenes,
                                   device="cpu", **kw)
    dp = launch(checks.multi_scene_steps, n_ranks,
                args=(rc, tc, batches, n_scenes), kwargs=kw, device="cpu",
                timeout_s=TIMEOUT_S)
    return one, dp


@pytest.mark.parametrize("occupancy", [False, True],
                         ids=["dense", "occupancy"])
def test_scene_data_layout_matches_unsharded(occupancy):
    one, dp = _run(4, 2, occupancy)
    assert dp["group_bit_equal"]
    np.testing.assert_allclose(dp["metrics"]["loss"][0],
                               one["metrics"]["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(dp["params"], one["params"], atol=5e-3)
    assert dp["params"].shape == one["params"].shape
    np.testing.assert_allclose(dp["grids"], one["grids"], atol=1e-6)


@pytest.mark.parametrize("occupancy", [False, True],
                         ids=["dense", "occupancy"])
def test_scenes_per_rank_equal_the_stack(occupancy):
    one, dp = _run(2, 4, occupancy)
    for k, v in one["metrics"].items():
        np.testing.assert_array_equal(dp["metrics"][k], v, err_msg=k)
    np.testing.assert_array_equal(dp["params"], one["params"])
    np.testing.assert_array_equal(dp["grids"], one["grids"])


def test_scene_layout_choice():
    def mesh(rank, world):
        return Mesh(rank=rank, world_size=world, device=torch.device("cpu"),
                    backend="gloo")

    lay = scene_layout(4, mesh(1, 2))
    assert lay.scenes == (2, 3) and lay.data is None
    with pytest.raises(ValueError, match="need one to divide"):
        scene_layout(3, mesh(0, 2))


def test_cli_over_ranks(tmp_path):
    """train_multi_scene --n_devices 4 on 2 scenes takes the ("scene",
    "data") layout and writes one checkpoint per scene, each equal to the
    same run's in one process at JAX's parameter bar; 3 scenes on 2 ranks
    are refused, as JAX refuses them."""
    from nerfmlp_torch.scripts import train_multi_scene as cli

    dirs = []
    for i in range(2):
        d = str(tmp_path / f"s{i}")
        make_synthetic_scene(d, n_train=2, n_val=1, n_test=0,
                             img_wh=(16, 16), seed=i)
        dirs.append(d)
    base = ["--datadirs"] + dirs + [
        "--img_wh", "16", "16", "--device", "cpu", "--N_samples", "8",
        "--N_importance", "8", "--batch_size", "64", "--iters", "3",
        "--log_interval", "1"]
    out = cli.main(base + ["--n_devices", "4", "--save_dir",
                           str(tmp_path / "dp")])
    assert out["loss"].shape == (2,) and np.isfinite(out["psnr"]).all()
    cli.main(base + ["--save_dir", str(tmp_path / "one")])
    for name in ("model_s0_final.pt", "model_s1_final.pt"):
        got = load_params_any(str(tmp_path / "dp" / name), device="cpu")
        want = load_params_any(str(tmp_path / "one" / name), device="cpu")
        for (n, a), (_, b) in zip(got["coarse"].named_parameters(),
                                  want["coarse"].named_parameters()):
            np.testing.assert_allclose(a.detach(), b.detach(), atol=5e-3,
                                       err_msg=n)
    assert os.path.exists(out["checkpoints"][1])
    with pytest.raises(SystemExit):
        cli.main(["--datadirs"] + dirs + [dirs[0]] + base[3:]
                 + ["--n_devices", "2", "--save_dir", str(tmp_path / "x")])
