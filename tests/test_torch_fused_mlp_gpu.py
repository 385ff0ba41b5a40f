"""The fused MLP CUDA kernels (forward; the backward's two phases and their
reduction) against their plain versions, on a GPU.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_fused_mlp_gpu.py --noconftest -q

Without a GPU every case skips. chip_smoke.py repeats the check at the
serving path's full size.
"""

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp
from nerfmlp_torch.ops.encoding import positional_encoding


@pytest.mark.cuda
@pytest.mark.parametrize("use_viewdirs, dtype, tol", [
    (True, "bfloat16", 1e-2),   # a flipped bf16 rounding cascades
    (False, "bfloat16", 1e-2),
    (True, "float32", 1e-4),    # hi_lo: fp32 summation order only
])
def test_kernel_matches_plain_on_gpu(use_viewdirs, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, use_viewdirs=use_viewdirs)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    rng = np.random.default_rng(0)
    n = 1000  # not a multiple of the kernel's 64-point tile
    pts = torch.from_numpy((rng.normal(size=(n, 3)) * 3).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    pts = pts.cuda()
    dirs = positional_encoding(d, 4).cuda() if use_viewdirs else None
    before = fused_mlp.fused_nerf_mlp.launches
    with torch.no_grad():   # the serving path: no autograd record
        got = fused_mlp.fused_nerf_mlp(net, pts, dirs, cfg)
    want = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                          hi_lo=dtype == "float32")
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_mlp.launches == before + 1
    assert got.shape == want.shape == (n, 4)
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
# hi_lo: the activations carry bf16x3 noise, so any two summation orders
# flip the ReLU masks of the pre-activations nearest 0; a flip weighs less
# on a leaf summed over more points, so hi_lo runs at a larger n, where its
# bar sits below the bf16 kernel's distance from the same reference (the
# control, asserted). PERF.md gives the readings (chip_smoke.py).
@pytest.mark.parametrize("use_viewdirs, dtype, n, tol", [
    (True, "bfloat16", 1000, 1e-2),   # a flipped bf16 rounding cascades
    (False, "bfloat16", 1000, 1e-2),
    (True, "float32", 65535, 1e-3),   # chip_smoke.py's HI_LO_BWD_TOL
    # two chunks: BWD_CHUNK_ROWS points, then a ragged 4,097
    (True, "bfloat16", fused_mlp.BWD_CHUNK_ROWS + 4097, 1e-2),
])
def test_backward_kernel_matches_plain_on_gpu(use_viewdirs, dtype, n, tol):
    """The backward's kernels vs the plain backward, per parameter (max
    |err| / max |plain|), on a ragged n (not a multiple of phase 1's
    128-point tile); a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, use_viewdirs=use_viewdirs)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    rng = np.random.default_rng(1)
    # Points in the scene box and the cotangent of an MSE loss: with
    # far-out points and a random normal cotangent the sums cancel so much
    # that fp32 summation order alone flips bf16 roundings worth ~4% of a
    # leaf (measured on the CPU); here it is ~0.4%.
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    pts = pts.cuda()
    dirs = positional_encoding(d, 4).cuda() if use_viewdirs else None
    hi_lo = dtype == "float32"
    raw = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                         hi_lo=hi_lo)
    target = torch.from_numpy(rng.uniform(size=tuple(raw.shape)).astype(
        np.float32)).cuda()
    g = 2.0 / raw.numel() * (raw - target)
    counts = lambda: (fused_mlp.bwd_workspace.launches,
                      fused_mlp.weight_grads.launches,
                      fused_mlp.reduce_partials.launches)
    before = counts()
    got = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    again = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(net, pts, dirs, g,
                                              cfg.pos_enc_L, hi_lo=hi_lo)
    torch.cuda.synchronize()
    chunks = -(-n // fused_mlp.BWD_CHUNK_ROWS)
    assert counts() == (before[0] + 2 * chunks, before[1] + 2 * chunks,
                        before[2] + 2)

    def worst(grads):
        return max(float((grads[k] - want[k]).abs().max())
                   / float(want[k].abs().max().clamp_min(1e-12))
                   for k in want)

    for name, p in net.named_parameters():
        assert got[name].shape == p.shape
        assert torch.equal(got[name], again[name]), name
    assert worst(got) <= tol
    if hi_lo:   # the control: the bf16 kernel lands above the hi_lo bar
        bf16 = RenderConfig(compute_dtype="bfloat16", use_kernel=True)
        assert worst(fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g,
                                                  bf16)) > tol
