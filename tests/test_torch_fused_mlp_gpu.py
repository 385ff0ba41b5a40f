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
@pytest.mark.parametrize("use_viewdirs, dtype, width, tol", [
    (True, "bfloat16", 256, 1e-2),   # a flipped bf16 rounding cascades
    (False, "bfloat16", 256, 1e-2),
    (True, "float32", 256, 1e-4),    # hi_lo: fp32 summation order only
    (False, "float32", 256, 1e-4),
    # two 256-column passes per layer: 128-point tiles at 288, 64 at 512
    (True, "bfloat16", 288, 1e-2),
    (True, "bfloat16", 512, 1e-2),
    (False, "bfloat16", 512, 1e-2),
    (True, "float32", 320, 1e-4),    # hi_lo: 64-point tiles, two passes
    (True, "float32", 384, 1e-4),    # hi_lo: 32-point tiles
    (True, "float32", 608, 1e-4),    # the widest hi_lo net JAX admits
])
def test_kernel_matches_plain_on_gpu(use_viewdirs, dtype, width, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, use_viewdirs=use_viewdirs,
                       width=width)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    rng = np.random.default_rng(0)
    n = 1000  # not a multiple of the kernel's 128- or 64-point tile
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
    assert got.shape == want.shape
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


@pytest.mark.cuda
# Nets wider than one 256-column pass of phase 1: column passes, each with
# its own mask block, at 32-point tiles (8x512, 8x640, 8x384 hi_lo) and
# 16-point tiles (8x608 hi_lo). The bars
# and sizes of the 8x256 test.
@pytest.mark.parametrize("width, dtype, n, tol", [
    (512, "bfloat16", 1000, 1e-2),
    (640, "bfloat16", 1000, 1e-2),
    (384, "float32", 65535, 1e-3),
    (608, "float32", 65535, 1e-3),
])
def test_wide_backward_kernels_match_plain_on_gpu(width, dtype, n, tol):
    """The backward's kernels vs the plain backward at widths 264-688
    (bf16) and 264-608 (hi_lo), per parameter (max |err| / max |plain|),
    on a ragged n; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, width=width)
    hi_lo = dtype == "float32"
    assert fused_mlp.backward_fits(cfg.model_config(), True, hi_lo)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    pts, dirs = pts.cuda(), positional_encoding(d, 4).cuda()
    raw = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                         hi_lo=hi_lo)
    target = torch.from_numpy(rng.uniform(size=tuple(raw.shape)).astype(
        np.float32)).cuda()
    g = 2.0 / raw.numel() * (raw - target)
    got = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    again = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(net, pts, dirs, g,
                                              cfg.pos_enc_L, hi_lo=hi_lo)
    torch.cuda.synchronize()
    for name, p in net.named_parameters():
        assert got[name].shape == p.shape
        assert torch.equal(got[name], again[name]), name
    worst = max(float((got[k] - want[k]).abs().max())
                / float(want[k].abs().max().clamp_min(1e-12)) for k in want)
    assert worst <= tol


def _deep_net(mc, seed):
    """A random deep net that keeps live activations and forgets a rounding
    difference (chip_smoke.py's deep_net): lecun-normal weights, the
    trunk's scaled by 0.7, biases from N(0, 0.09). Zero biases let a deep
    trunk's activations vanish; weights that hold them at gain 1 carry
    every layer's summation-order difference to the output."""
    net = init_model(mc, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in net.pts_linears:
            lin.weight.mul_(0.7)
        for m in net.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=gen))
    return net.cuda()


@pytest.mark.cuda
# Nets past the old tables (96 phase-1 operations, 64 workspace matrices,
# 48 forward layers): 64-point tiles at 32x256, sized mask blocks at
# 32-point tiles for the narrow ones, 866x16's tables in device memory,
# and chunks cut to the workspace budget at 177x128; and the widest
# shallow nets JAX admits: 16-point tiles of both kernels at 1x1696 bf16,
# and at 1x1472 hi_lo phase 1's passes of 128 columns. The bars of the
# 8x256 tests.
@pytest.mark.parametrize("depth, width, dtype, n, tol", [
    (32, 256, "bfloat16", 1000, 1e-2),
    (177, 128, "bfloat16", 10000, 1e-2),
    (866, 16, "bfloat16", 1000, 1e-2),
    (43, 256, "float32", 65535, 1e-3),
    (600, 16, "float32", 65535, 1e-3),
    (1, 1696, "bfloat16", 1000, 1e-2),
    (1, 1472, "float32", 65535, 1e-3),
])
def test_deep_kernels_match_plain_on_gpu(depth, width, dtype, n, tol,
                                         monkeypatch):
    """The forward and the backward's kernels vs their plain versions at
    depths and widths up to the JAX gate's (max |err| / max |plain|: the
    forward, and per parameter the backward), on a ragged n; a second run
    gives the same bits. 177x128 runs in chunks of 4,096 points (its
    workspace budget cut to that): three chunks, the last ragged in phase
    2's 64-row stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, depth=depth, width=width)
    hi_lo = dtype == "float32"
    mc = cfg.model_config()
    assert fused_mlp.kernel_fits(mc, True, hi_lo)
    assert fused_mlp.backward_fits(mc, True, hi_lo)
    if width == 128:
        monkeypatch.setattr(fused_mlp, "BWD_WS_BUDGET",
                            4096 * fused_mlp.bwd_scratch_bytes(mc, True))
        assert fused_mlp.bwd_chunk_rows(mc, True) == 4096
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    pts, dirs = pts.cuda(), positional_encoding(d, 4).cuda()
    net = _deep_net(mc, seed=0)
    with torch.no_grad():
        out = fused_mlp.fused_nerf_mlp(net, pts, dirs, cfg)
        again = fused_mlp.fused_nerf_mlp(net, pts, dirs, cfg)
    raw = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                         hi_lo=hi_lo)
    assert torch.equal(out, again)
    assert float((out - raw).abs().max() / raw.abs().max()) <= (
        1e-4 if hi_lo else 1e-2)
    target = torch.from_numpy(rng.uniform(size=tuple(raw.shape)).astype(
        np.float32)).cuda()
    g = 2.0 / raw.numel() * (raw - target)
    got = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    again = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(net, pts, dirs, g,
                                              cfg.pos_enc_L, hi_lo=hi_lo)
    torch.cuda.synchronize()
    for name, p in net.named_parameters():
        assert got[name].shape == p.shape
        assert torch.equal(got[name], again[name]), name
    worst = max(float((got[k] - want[k]).abs().max())
                / float(want[k].abs().max().clamp_min(1e-12)) for k in want)
    assert worst <= tol
