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


@pytest.mark.cuda
# Phase 2 alone on phase 1's workspace: the units of 128 x 256 features
# (8x256), three products of two planes (8x512 hi_lo), the narrowest units
# (866x16: every block 16 x 16, its tables and program at their largest),
# the shallow wide net's narrow strips (1x1696), and a stack of two scenes.
# The bar is chip_smoke.py's PHASE2_TOL: the same products in another fp32
# summation order.
@pytest.mark.parametrize("depth, width, hi_lo, scenes", [
    (8, 256, False, 1),
    (8, 512, True, 1),
    (866, 16, False, 1),
    (1, 1696, False, 1),
    (8, 256, False, 2),
])
def test_phase2_matches_plain_on_gpu(depth, width, hi_lo, scenes):
    """Phase 2's partial slots vs weight_grads_plain on the same workspace
    (max |err| / max |plain| over the slots), a ragged 20,000 points a
    scene (the last split ends inside a stage); a repeat gives the same
    bits; a stack's scenes equal their single-scene launches bit for bit;
    one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True,
                       depth=depth, width=width)
    mc = cfg.model_config()
    nets = [_deep_net(mc, seed=s) for s in range(scenes)]
    n_s = 20_000
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (scenes * n_s, 3))
                           .astype(np.float32)).cuda()
    d = rng.normal(size=(scenes * n_s, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    dirs = positional_encoding(d, 4).cuda()
    g = torch.from_numpy(rng.normal(size=(scenes * n_s, 4)).astype(
        np.float32)).cuda() / n_s
    packs = [fused_mlp.pack_params(net, cfg.pos_enc_L, True, hi_lo)
             for net in nets]
    packed = (fused_mlp.pack_params_stack(nets, cfg.pos_enc_L, True, hi_lo)
              if scenes > 1 else packs[0])
    if hi_lo:
        dirs = dirs.float()
    rows = fused_mlp.ws_rows(n_s, packed.bwd_rows)
    splits, split_rows = fused_mlp.bwd_splits(rows, packed.bwd_units)
    ws = torch.empty(scenes * rows * packed.ws_cols, device="cuda",
                     dtype=torch.bfloat16)
    fused_mlp.bwd_workspace(packed, pts, dirs, g, ws)
    stride = fused_mlp.part_stride(packed.grad_total)
    shape = (scenes, splits, stride) if scenes > 1 else (splits, stride)
    part = torch.empty(shape, device="cuda")
    again = torch.empty(shape, device="cuda")
    before = fused_mlp.weight_grads.launches
    fused_mlp.weight_grads(packed, ws, rows, split_rows, part)
    fused_mlp.weight_grads(packed, ws, rows, split_rows, again)
    want = fused_mlp.weight_grads_plain(packed, ws, rows, split_rows)
    torch.cuda.synchronize()
    assert fused_mlp.weight_grads.launches == before + 2
    total = packed.grad_total
    assert torch.equal(part[..., :total], again[..., :total])
    err = float((part[..., :total] - want[..., :total]).abs().max())
    assert err / float(want[..., :total].abs().max()) <= 1e-4
    for s in range(scenes if scenes > 1 else 0):
        # scene s alone: its workspace rows, its own launch
        one = torch.empty(rows * packed.ws_cols, device="cuda",
                          dtype=torch.bfloat16)
        sl = slice(s * n_s, (s + 1) * n_s)
        fused_mlp.bwd_workspace(packs[s], pts[sl].contiguous(),
                                dirs[sl].contiguous(), g[sl].contiguous(),
                                one)
        solo = torch.empty((splits, stride), device="cuda")
        fused_mlp.weight_grads(packs[s], one, rows, split_rows, solo)
        assert torch.equal(solo[:, :total], part[s, :, :total])


@pytest.mark.cuda
# The residual handover against the recompute at the nets it reaches: 8x256
# (128-point tiles; hi_lo 64), 8x512 (the forward's 64-point tiles, phase
# 1's own 32), a stack of two, 60x704 hi_lo (phase 1's own tables in
# device memory, the handover's in shared memory), 1x1696 (16-point tiles)
# and a net without the view head; n ragged in every tile.
@pytest.mark.parametrize("depth, width, hi_lo, scenes, vdirs", [
    (8, 256, False, 1, True),
    (8, 256, True, 1, True),
    (8, 512, False, 1, True),
    (8, 256, False, 2, True),
    (60, 704, True, 1, True),
    (1, 1696, False, 1, True),
    (6, 64, False, 1, False),
])
def test_handover_equals_recompute_on_gpu(depth, width, hi_lo, scenes,
                                          vdirs):
    """The training forward with its residuals gives the serving forward's
    output bit for bit; phase 1 without its forward then leaves the same
    workspace as phase 1 that recomputes it, every row; the mask images
    hold the activations' ReLU bits (real points); the gradients are
    bit-equal; each launch is counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True,
                       depth=depth, width=width, use_viewdirs=vdirs)
    mc = cfg.model_config()
    assert fused_mlp.handover_misfit(mc, vdirs, hi_lo) is None
    nets = [_deep_net(mc, seed=s) for s in range(scenes)]
    packed = (fused_mlp.pack_params_stack(nets, cfg.pos_enc_L, vdirs, hi_lo)
              if scenes > 1 else
              fused_mlp.pack_params(nets[0], cfg.pos_enc_L, vdirs, hi_lo))
    n = scenes * (3000 if depth * width < 20_000 else 700)
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3))
                           .astype(np.float32)).cuda()
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    dirs = positional_encoding(d, 4).cuda() if vdirs else None
    if hi_lo and vdirs:
        dirs = dirs.float()
    g = torch.from_numpy(rng.normal(size=(n, packed.out_w)).astype(
        np.float32)).cuda() / n
    counts = lambda: (fused_mlp.fused_nerf_mlp.launches,
                      fused_mlp.fused_nerf_mlp.residual_launches,
                      fused_mlp.bwd_workspace.launches,
                      fused_mlp.bwd_workspace.handover_launches)
    before = counts()
    ws, masks = fused_mlp.residual_buffers(packed, n, pts.device)
    out = fused_mlp.forward_residuals(packed, pts, dirs, ws, masks)
    fused_mlp.bwd_workspace(packed, pts, dirs, g, ws, masks)
    again = torch.empty_like(ws)
    fused_mlp.bwd_workspace(packed, pts, dirs, g, again)
    want = fused_mlp._launch(packed, pts, dirs)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 2,
                        before[3] + 1)
    assert torch.equal(out, want)
    assert torch.equal(ws.view(torch.int16), again.view(torch.int16))
    # the mask images against the stored activations' signs, real points
    rows_s = fused_mlp.ws_rows(n // scenes, packed.handover.rows)
    image = fused_mlp._mask_images(packed, masks, rows_s).cpu()
    tiles_s = rows_s // packed.handover.rows
    acts = {name: fused_mlp.ws_matrix(packed, ws, m).float().cpu()
            for m, (name, _, _) in enumerate(packed.ws_mats)}
    names = [f"h{i}" for i in range(depth)] + (["v"] if vdirs else [])
    for slot, off, c0, nn in fused_mlp._mask_passes(packed):
        on = acts[names[slot]]
        on = (on[0] + on[1] if hi_lo else on[0])[:, c0:c0 + nn] > 0
        for s in range(scenes):
            blk = image[s * tiles_s:(s + 1) * tiles_s,
                        off:off + nn * 2 * fused_mlp.mask_entry_bytes(
                            packed.handover.rows)]
            got = fused_mlp.mask_decode(blk, packed.handover.rows,
                                        nn).view(rows_s, nn)
            real = slice(s * rows_s, s * rows_s + n // scenes)
            assert torch.equal(got[:n // scenes], on[real]), (slot, s)
    a = fused_mlp._launch_bwd(packed, pts, dirs, g, (ws, masks))
    b = fused_mlp._launch_bwd(packed, pts, dirs, g)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_hands_over_only_in_training_on_gpu():
    """Through fused_nerf_mlp: a call under autograd whose parameters need
    a gradient writes its residuals and its backward's phase 1 takes them
    (gradients bit-equal to the backward's own); the same call under
    no_grad, or past one chunk, does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True)
    rng = np.random.default_rng(6)
    n = 5000
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3))
                           .astype(np.float32)).cuda()
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    dirs = positional_encoding(d, 4).cuda()
    counts = lambda: (fused_mlp.fused_nerf_mlp.residual_launches,
                      fused_mlp.bwd_workspace.handover_launches)
    before = counts()
    with torch.no_grad():
        fused_mlp.fused_nerf_mlp(packed, pts, dirs, cfg)
    assert counts() == before
    out = fused_mlp.fused_nerf_mlp(packed, pts, dirs, cfg)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    want = fused_mlp.fused_nerf_mlp_bwd(packed, pts, dirs, 2 * out.detach(),
                                        cfg)
    for name, p in net.named_parameters():
        assert torch.equal(p.grad, want[name]), name
    assert not fused_mlp.hands_over(packed, fused_mlp.BWD_CHUNK_ROWS + 1,
                                    True)
