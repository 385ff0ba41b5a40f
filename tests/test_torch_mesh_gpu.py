"""Mesh extraction on a GPU (nerfmlp_torch/ops/mesh.py): the marching-tets
stage on the card against the CPU's, and extract_mesh through the forward
kernel against the module path.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_mesh_gpu.py --noconftest -q

Without a GPU every case skips. chip_smoke.py's phase 10 repeats the
checks at 128^3 and 256^3 on a trained model.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp, mesh

BOX = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the forward kernel has no CPU "
                    "mode)")


@pytest.mark.cuda
def test_tet_stage_on_the_card_equals_the_cpu():
    _need_gpu()
    g = 65
    lin = np.arange(g) / (g - 1)
    ii, jj, kk = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.asarray(BOX[:3]) + np.stack([ii, jj, kk], -1) * (
        np.asarray(BOX[3:]) - np.asarray(BOX[:3]))
    vol = (1.0 - np.linalg.norm(pts * [1.0, 1.3, 0.8], axis=-1)
           + 0.05 * np.sin(7 * pts[..., 0])).astype(np.float32)
    cv, cf = mesh.mesh_from_volume(vol, BOX, 0.0, device="cpu")
    gv, gf = mesh.mesh_from_volume(torch.from_numpy(vol).cuda(), BOX, 0.0)
    assert gv.shape == cv.shape and gf.shape == cf.shape and len(cf) > 0
    np.testing.assert_allclose(gv, cv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gf, cf)


@pytest.mark.cuda
def test_extract_mesh_through_the_kernel():
    """bf16 through the forward kernel: one launch per density chunk and
    per colour chunk, the volume within the kernel's bar (1e-2 of its
    largest value) of the module path's. The meshes are compared in hi_lo
    mode (fp32 'high') against the fp32 module path: this random net's
    level set is a froth of cells near the threshold, which two bf16
    roundings split differently."""
    _need_gpu()
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True, aabb=BOX,
                       perturb=False)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    with torch.no_grad():
        net.sigma_linear.bias.add_(1.0)    # a surface inside the box
    params = {"coarse": net}
    plain = dataclasses.replace(cfg, use_kernel=False)
    g = 64
    fused_mlp.fused_nerf_mlp.launches = 0
    vk = mesh.density_volume(params, cfg, resolution=g)
    assert fused_mlp.fused_nerf_mlp.launches == -(-g ** 3 // 65536)
    vp = mesh.density_volume(params, plain, resolution=g)
    assert np.abs(vk - vp).max() <= 1e-2 * np.abs(vp).max()
    thr = float(np.quantile(vp, 0.5))
    fused_mlp.fused_nerf_mlp.launches = 0
    mk = mesh.extract_mesh(params, cfg, resolution=g, threshold=thr)
    n_v = len(mk["verts"])
    assert n_v > 0 and np.isfinite(mk["colors"]).all()
    assert fused_mlp.fused_nerf_mlp.launches == (
        -(-g ** 3 // 65536) + -(-n_v // 65536))
    hi_lo = dataclasses.replace(cfg, compute_dtype="float32",
                                fp32_precision="high")
    fp32 = dataclasses.replace(plain, compute_dtype="float32",
                               fp32_precision="highest")
    mh = mesh.extract_mesh(params, hi_lo, resolution=g, threshold=thr)
    mp = mesh.extract_mesh(params, fp32, resolution=g, threshold=thr)
    assert len(mp["faces"]) > 0
    assert abs(len(mh["faces"]) - len(mp["faces"])) <= 0.02 * len(
        mp["faces"])


@pytest.mark.cuda
def test_i_mesh_meshes_the_live_weights_under_graph_replays(tmp_path):
    """At K = 4 the replays update the nets in place: each i_mesh event's
    mesh equals a fresh extraction from a copy of the weights taken at the
    event, and the weights moved between events."""
    import copy

    from nerfmlp_torch.config import TrainConfig
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_scene
    from nerfmlp_torch.train.loop import Trainer

    _need_gpu()
    root = str(tmp_path / "scene")
    make_synthetic_scene(root, n_train=4, n_val=1, n_test=0, img_wh=(32, 32))
    ds = BlenderDataset(root, "train", img_wh=(32, 32))
    near, far = ds.dynamic_near_far()
    rc = RenderConfig(depth=4, width=128, N_samples=16, N_importance=16,
                      near=near, far=far, compute_dtype="bfloat16",
                      use_kernel=True, aabb=BOX)
    tc = TrainConfig(batch_size=512, iters=24, steps_per_dispatch=4,
                     log_interval=4, quick_val_interval=0,
                     full_val_interval=0, ckpt_interval=0, i_mesh=8,
                     mesh_resolution=32, mesh_threshold=0.05)
    tr = Trainer(rc, tc, ds, save_dir=str(tmp_path / "run"), verbose=False)
    events, inner = [], mesh.extract_mesh

    def spy(params, cfg, **kw):
        out = inner(params, cfg, **kw)
        events.append((copy.deepcopy(params), kw, out))
        return out

    mesh.extract_mesh = spy
    try:
        tr.train()
    finally:
        mesh.extract_mesh = inner
    assert tr.windows is not None and tr.windows.on_cuda
    assert len(events) == 2                     # steps 8 and 16
    for params, kw, out in events:
        again = inner(params, rc, **kw)
        assert again["sigma_max"] == out["sigma_max"]
        np.testing.assert_array_equal(again["verts"], out["verts"])
    assert events[0][2]["sigma_max"] != events[1][2]["sigma_max"]
