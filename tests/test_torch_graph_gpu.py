"""steps_per_dispatch on a GPU: the train step captured in a CUDA graph and
replayed (train/graph.py) against eager steps.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_graph_gpu.py --noconftest -q

Without a GPU every case skips (a CUDA graph has no CPU mode).
chip_smoke.py's phase 9 repeats the check at the flagship recipe's size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.train.loop import Trainer

WH = (32, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel, occupancy", [
    (True, False), (False, False), (True, True)])
def test_graph_replays_equal_eager_steps(tmp_path, use_kernel, occupancy):
    """Capture succeeds, and K = 16 replays (pool windows crossing an epoch,
    a precrop stop's host windows before them) equal K = 1 eager steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    root = str(tmp_path / "scene")
    make_synthetic_scene(root, n_train=4, n_val=1, n_test=0, img_wh=WH)
    ds = BlenderDataset(root, "train", img_wh=WH)
    near, far = ds.dynamic_near_far()
    occ = dict(aabb=(-1.5, -1.5, -1.2, 1.5, 1.5, 1.5), use_occupancy=True,
               occ_grid_size=32, occ_dense_samples=32, occ_update_every=8)
    rc = RenderConfig(depth=4, width=128, N_samples=16, N_importance=16,
                      near=near, far=far, compute_dtype="bfloat16",
                      use_kernel=use_kernel, **(occ if occupancy else {}))
    tc = TrainConfig(batch_size=512, iters=40, precrop_iters=6, seed=3,
                     quick_val_interval=0, full_val_interval=0,
                     log_interval=0, ckpt_interval=0)

    def run(k):
        t = Trainer(rc, dataclasses.replace(tc, steps_per_dispatch=k), ds,
                    save_dir=str(tmp_path / f"k{k}"), verbose=False)
        t.train()
        return t

    eager, graph = run(1), run(16)
    assert sorted(graph.windows.graphs) == ["host", "pool"]
    assert graph.windows.replays == 40 and graph.state.step == 40
    assert int(graph.state.counter) == 40
    for net in eager.state.params:
        for (n, p), (_, q) in zip(eager.state.params[net].named_parameters(),
                                  graph.state.params[net].named_parameters()):
            np.testing.assert_allclose(q.detach().cpu().numpy(),
                                       p.detach().cpu().numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=n)
    assert torch.equal(eager.state.generator.get_state(),
                       graph.state.generator.get_state())
