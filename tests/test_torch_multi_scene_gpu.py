"""The fused MLP kernels over a scene axis (one launch for S nets, scene-
major points) against S single-scene launches and the stacked plain
versions, and the launch counts of a multi-scene step, on a GPU.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_multi_scene_gpu.py --noconftest -q

Without a GPU every case skips. chip_smoke.py (phase 11) repeats the check
at the multi-scene step's full size.
"""

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp as fm
from nerfmlp_torch.ops.encoding import positional_encoding

S = 3


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _inputs(n, seed, vdirs):
    """Points in the scene box and encoded unit directions (as
    tests/test_torch_fused_mlp_gpu.py takes them: far-out points and a
    random normal cotangent cancel so much that the summation order alone
    moves a leaf by ~4%)."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    dirs = positional_encoding(d, 4).cuda() if vdirs else None
    return pts.cuda(), dirs


def _nets(cfg):
    return [init_model(cfg.model_config(), seed=10 + s, device="cuda")
            for s in range(S)]


CASES = [(True, "bfloat16"), (False, "bfloat16"), (True, "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("use_viewdirs, dtype", CASES)
@pytest.mark.parametrize("n_s", [1000, 300])   # not a multiple of a tile
def test_stacked_forward_equals_per_scene_launches(use_viewdirs, dtype, n_s):
    _need_gpu()
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, use_viewdirs=use_viewdirs)
    hi_lo = dtype == "float32"
    nets = _nets(cfg)
    pts, dirs = _inputs(S * n_s, 0, use_viewdirs)
    stack = fm.pack_params_stack(nets, cfg.pos_enc_L, use_viewdirs, hi_lo)
    before = fm.fused_nerf_mlp.launches
    with torch.no_grad():
        got = fm.fused_nerf_mlp(stack, pts, dirs, cfg)
        assert fm.fused_nerf_mlp.launches == before + 1
        solo = torch.cat([fm.fused_nerf_mlp(
            fm.pack_params(net, cfg.pos_enc_L, use_viewdirs, hi_lo),
            pts[s * n_s:(s + 1) * n_s],
            None if dirs is None else dirs[s * n_s:(s + 1) * n_s], cfg)
            for s, net in enumerate(nets)])
    want = fm.fused_nerf_mlp_stack_plain(nets, pts, dirs, cfg.pos_enc_L,
                                         hi_lo=hi_lo)
    torch.cuda.synchronize()
    assert torch.equal(got, solo)
    tol = 1e-4 if hi_lo else 1e-2
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("use_viewdirs, dtype", CASES)
@pytest.mark.parametrize("n_s, chunk", [(1000, fm.BWD_CHUNK_ROWS),
                                        (700, 256)])   # 3 chunks
def test_stacked_backward_equals_per_scene_launches(use_viewdirs, dtype, n_s,
                                                    chunk, monkeypatch):
    """Each scene's gradient from one launch of each backward kernel (per
    chunk) equals its own single-scene backward bit for bit, and (bf16)
    the stacked plain backward at the single-scene bar; a cotangent of an
    MSE loss. hi_lo is held to its plain version at 65,536 points a scene
    by chip_smoke.py (its bar needs the sums of many points)."""
    _need_gpu()
    monkeypatch.setattr(fm, "BWD_CHUNK_ROWS", chunk)
    monkeypatch.setattr(fm, "BWD_MIN_SPLIT_ROWS", 128)  # several splits
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, use_viewdirs=use_viewdirs)
    hi_lo = dtype == "float32"
    nets = _nets(cfg)
    pts, dirs = _inputs(S * n_s, 1, use_viewdirs)
    raw = fm.fused_nerf_mlp_stack_plain(nets, pts, dirs, cfg.pos_enc_L,
                                        hi_lo=hi_lo)
    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=tuple(raw.shape)).astype(np.float32)).cuda()
    g = 2.0 / (n_s * raw.shape[1]) * (raw - target)
    stack = fm.pack_params_stack(nets, cfg.pos_enc_L, use_viewdirs, hi_lo)
    counts = lambda: (fm.bwd_workspace.launches, fm.weight_grads.launches,
                      fm.reduce_partials.launches)
    before = counts()
    flat = fm._launch_bwd(stack, pts, dirs, g)
    chunks = -(-n_s // chunk)
    assert counts() == tuple(b + k for b, k in zip(before,
                                                   (chunks, chunks, 1)))
    assert torch.equal(flat, fm._launch_bwd(stack, pts, dirs, g))
    for s, net in enumerate(nets):
        sl = slice(s * n_s, (s + 1) * n_s)
        one = fm._launch_bwd(
            fm.pack_params(net, cfg.pos_enc_L, use_viewdirs, hi_lo),
            pts[sl], None if dirs is None else dirs[sl], g[sl])
        assert torch.equal(flat[s], one), f"scene {s}"
    if hi_lo:
        return
    got = fm.unpack_grads(stack, flat)
    want = fm.fused_nerf_mlp_bwd_stack_plain(nets, pts, dirs, g,
                                             cfg.pos_enc_L, hi_lo=hi_lo)
    tol = 1e-2
    for gs, ws in zip(got, want):
        for name in ws:
            err = float((gs[name] - ws[name]).abs().max())
            assert err / max(float(ws[name].abs().max()), 1e-12) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("occupancy", [False, True])
def test_multi_scene_step_launches_each_kernel_once_per_call(occupancy):
    """A dense step: 2 launches of each kernel whatever S; with the grid
    (hierarchical), 2 queries a step and 1 forward per refresh."""
    _need_gpu()
    from nerfmlp_torch.ops import occupancy as occ
    from nerfmlp_torch.parallel import multi_scene as ms

    rc = RenderConfig(depth=4, width=64, N_samples=16, N_importance=16,
                      near=2.0, far=6.0, compute_dtype="bfloat16",
                      use_kernel=True, use_occupancy=occupancy,
                      aabb=(-1.5,) * 3 + (1.5,) * 3, occ_grid_size=16,
                      occ_dense_samples=32)
    tc = TrainConfig(batch_size=128)
    state = ms.create_multi_scene_state(S, rc, tc, device="cuda")
    rng = np.random.default_rng(0)
    b = rng.normal(size=(S, 128, 9)).astype(np.float32)
    b[..., 5] = -1.0
    b[..., 6:9] = np.abs(b[..., 6:9]) % 1.0
    batch = torch.from_numpy(b).cuda()
    extra = ()
    counters = (fm.fused_nerf_mlp, fm.bwd_workspace, fm.weight_grads,
                fm.reduce_partials)
    before = tuple(c.launches for c in counters)
    if occupancy:
        gens = [torch.Generator(device="cuda").manual_seed(s)
                for s in range(S)]
        grids = ms.make_multi_scene_grid_update(rc)(
            occ.create_multi_scene_grids(S, rc, device="cuda"), state.params,
            gens, 1.0)
        assert grids.density.shape == (S, 16, 16, 16)
        extra = (grids,)
    m = ms.make_multi_scene_step(rc, tc)(state, batch, *extra)
    torch.cuda.synchronize()
    assert m["loss"].shape == (S,) and torch.isfinite(m["loss"]).all()
    got = tuple(c.launches - b0 for c, b0 in zip(counters, before))
    assert got == ((3 if occupancy else 2), 2, 2, 2)
