"""Data parallelism on a GPU (nerfmlp_torch/parallel/): two gloo ranks
sharing one card against one process, and one NCCL rank whose all-reduce
is captured in the CUDA graph of steps_per_dispatch (K = 16 against
K = 1). The ranks are spawned processes running
nerfmlp_torch/parallel/checks.py.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_parallel_gpu.py --noconftest -q

Without a GPU every case skips (the kernels and CUDA graphs have no CPU
mode). chip_smoke.py's phase 13 repeats the checks at the flagship
recipe's size. Bars: the first step's averaged gradient within 1e-2 of
its largest element of one process's (the kernels' agreement bar;
the two differ only in the order of the gradient's sums); parameters
bit-equal across ranks, and at K = 16 bit-equal to K = 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.parallel import checks
from nerfmlp_torch.parallel.mesh import launch

WH = (32, 32)


def _setup(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_train=4, n_val=1, n_test=0, img_wh=WH)
    rc = RenderConfig(depth=4, width=128, N_samples=16, N_importance=16,
                      near=2.0, far=6.0, compute_dtype="bfloat16",
                      use_kernel=True, perturb=True)
    tc = TrainConfig(batch_size=512, iters=24, seed=3, quick_val_interval=0,
                     full_val_interval=0, log_interval=0, ckpt_interval=0)
    return scene, rc, tc


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(tmp_path):
    scene, rc, tc = _setup(tmp_path)
    rng = np.random.default_rng(0)
    batch = rng.normal(size=(512, 9)).astype(np.float32)
    batch[:, 5] = -1.0
    batch[:, 6:9] = np.abs(batch[:, 6:9]) % 1.0
    one = checks.dp_steps(None, rc, tc, [batch], device="cuda")
    two = launch(checks.dp_steps, 2, args=(rc, tc, [batch]), device="cuda",
                 backend="gloo", timeout_s=120)
    g = one["grads0"]
    assert np.abs(two["grads0"] - g).max() <= 1e-2 * np.abs(g).max()
    assert two["ranks_bit_equal"]
    run = launch(checks.dp_trainer, 2,
                 args=(rc, tc, scene, WH, str(tmp_path / "two")),
                 device="cuda", backend="gloo", timeout_s=120)
    assert run["ranks_bit_equal"] and np.isfinite(run["after"]["psnr"])
    assert run["step_launches"] == [[2 * tc.iters] * 4] * 2


@pytest.mark.cuda
def test_nccl_rank_graph_windows_equal_eager(tmp_path):
    scene, rc, tc = _setup(tmp_path)
    runs = {k: launch(checks.dp_trainer, 1,
                      args=(rc, dataclasses.replace(tc, steps_per_dispatch=k),
                            scene, WH, str(tmp_path / f"k{k}")),
                      device="cuda", backend="nccl", timeout_s=120)
            for k in (1, 16)}
    np.testing.assert_array_equal(runs[16]["params"], runs[1]["params"])
