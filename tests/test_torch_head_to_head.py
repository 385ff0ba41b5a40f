"""The port's Trainer against the JAX package's, trained head to head on
the CPU: the same 32x32 synthetic scene, batch 64, 150 steps, 16 + 16
samples, fp32, each side with its own initialisation and ray shuffling
(``tools/head_to_head.py::run_ours`` for JAX, as
tests/test_reference_parity.py's head-to-head runs it). The port's
held-out PSNR on the first val view must be at least JAX's less 0.5 dB,
and both must have learned (above 10 dB)."""

import numpy as np
import pytest
import torch

from nerfmlp_tpu.data.synthetic import make_synthetic_scene
from tools.head_to_head import run_ours

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.ops.render import render_image
from nerfmlp_torch.train.loop import Trainer
from nerfmlp_torch.train.metrics import psnr_images

WH = (32, 32)
RUN = dict(batch=64, iters=150, N_samples=16, N_importance=16, val_views=1,
           seed=0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_run(datadir, save_dir):
    """The port's Trainer at run_ours's configuration; held-out PSNR of
    the first val view through the port's renderer."""
    ds = BlenderDataset(datadir, "train", img_wh=WH)
    val = BlenderDataset(datadir, "val", img_wh=WH)
    near, far = ds.dynamic_near_far()
    rc = RenderConfig(N_samples=RUN["N_samples"],
                      N_importance=RUN["N_importance"], near=near, far=far,
                      perturb=True)
    tc = TrainConfig(batch_size=RUN["batch"], iters=RUN["iters"], lr=5e-4,
                     seed=RUN["seed"], quick_val_interval=0,
                     full_val_interval=0, log_interval=500)
    trainer = Trainer(rc, tc, ds, val, None, save_dir=save_dir,
                      verbose=False, device="cpu")
    trainer.train()
    rc_eval = RenderConfig(N_samples=rc.N_samples,
                           N_importance=rc.N_importance, near=near, far=far,
                           perturb=False)
    o, d, gt = val.image_rays(0)
    img = render_image(trainer.state.params, torch.from_numpy(o),
                       torch.from_numpy(d), val.H, val.W, rc_eval)
    return psnr_images(img.numpy(), gt)


def test_port_trainer_keeps_up_with_the_jax_trainer(tmp_path):
    scene = make_synthetic_scene(str(tmp_path / "h2h"), n_train=6, n_val=2,
                                 n_test=2, img_wh=WH, use_jax=True)
    jax_psnr = run_ours(datadir=scene, img_wh=WH, **RUN,
                        save_dir=str(tmp_path / "jax"))["val_psnr"]
    port_psnr = _port_run(scene, str(tmp_path / "port"))
    assert np.isfinite(port_psnr)
    assert jax_psnr > 10.0 and port_psnr > 10.0, (jax_psnr, port_psnr)
    assert port_psnr >= jax_psnr - 0.5, (
        f"port {port_psnr:.2f} dB vs JAX {jax_psnr:.2f} dB")
