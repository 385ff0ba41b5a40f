"""The port's fused MLP backward (nerfmlp_torch/ops/fused_mlp.py) against
the JAX package's Pallas backward, which runs here in interpret mode.

The CUDA kernel cannot run on the CPU; its arithmetic is held here two
ways: the plain backward (through the autograd Function, as CPU tensors
take it) against ``jax.grad`` through the Pallas kernel, and the backward
program the kernel executes (buffers, operations, per-block partial slots
and their reduction) interpreted in PyTorch against the plain backward.
The kernel itself is held against the plain version on a GPU by
tests/test_torch_fused_mlp_gpu.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.ops.pallas_mlp import fused_nerf_mlp as jax_fused

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import params_from_state_dict
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp
from nerfmlp_torch.ops.encoding import positional_encoding

from test_torch_fused_mlp import ARCH, _inputs, _nets

# Per-leaf max |port - JAX| / max |JAX|. Both sides round at the same
# points, so only fp32 summation order differs, and the rare bf16 rounding
# or ReLU mask it flips. Measured: 5.2e-7 (view head), 3.7e-7 (ragged),
# 9.5e-5 (no view head: one flip), 2.3e-6 (hi_lo) — under the 5e-3 bar
# that tests/test_pallas.py holds the Pallas kernel to against XLA.
BF16_TOL = 1e-3
HI_LO_TOL = 1e-4


def _loss_jax(raw):
    return jnp.mean(jax.nn.sigmoid(raw[:, :3]) ** 2) + jnp.mean(
        jax.nn.relu(raw[:, 3]) * 1e-2)


def _loss_torch(raw):
    return (torch.mean(torch.sigmoid(raw[:, :3]) ** 2)
            + torch.mean(torch.relu(raw[:, 3]) * 1e-2))


@pytest.mark.parametrize("case", ["viewdirs", "no_viewdirs", "ragged",
                                  "hi_lo"])
def test_plain_backward_matches_jax_kernel(case):
    """jax.grad through the Pallas backward (interpret mode) vs the port's
    autograd Function on CPU tensors (the plain backward), same weights."""
    vdirs = case != "no_viewdirs"
    hi_lo = case == "hi_lo"
    n = 300 if case == "ragged" else 256
    params, net, cfg = _nets(use_viewdirs=vdirs)
    pts, dirs = _inputs(n, seed=4)
    dt = dict(compute_dtype="float32", fp32_precision="high") if hi_lo \
        else dict(compute_dtype="bfloat16")
    jcfg = JaxRenderConfig(use_viewdirs=vdirs, use_pallas=True, **dt, **ARCH)
    jd = jnp.asarray(dirs) if vdirs else None
    want = jax.grad(lambda p: _loss_jax(
        jax_fused(p, jnp.asarray(pts), jd, jcfg, tile=128)))(params)

    cfg = dataclasses.replace(cfg, use_kernel=True, **dt)
    out = fused_mlp.fused_nerf_mlp(
        net, torch.from_numpy(pts), torch.from_numpy(dirs) if vdirs else None,
        cfg)
    _loss_torch(out[:, :4] if vdirs else out).backward()
    got = params_from_state_dict(
        {name: p.grad for name, p in net.named_parameters()},
        cfg.model_config())
    tol = HI_LO_TOL if hi_lo else BF16_TOL
    for name in want:
        for leaf in ("kernel", "bias"):
            a, b = np.asarray(got[name][leaf]), np.asarray(want[name][leaf])
            assert a.shape == b.shape, (name, leaf)
            scale = max(np.abs(b).max(), 1e-8)
            np.testing.assert_allclose(a / scale, b / scale, atol=tol,
                                       err_msg=f"{name}/{leaf}")


def test_points_and_dirs_get_zero_grads():
    """The backward returns zero cotangents for points and dirs, as the
    Pallas backward does (tests/test_pallas.py:119-144)."""
    _, net, cfg = _nets()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    pts, dirs = _inputs(32)
    pts = torch.from_numpy(pts).requires_grad_()
    dirs = torch.from_numpy(dirs).requires_grad_()
    (fused_mlp.fused_nerf_mlp(net, pts, dirs, cfg) ** 2).sum().backward()
    assert torch.equal(pts.grad, torch.zeros_like(pts))
    assert torch.equal(dirs.grad, torch.zeros_like(dirs))
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in net.parameters())


def test_two_calls_on_one_net_sum_their_grads():
    """The shared net is queried twice per step (coarse, then the fine
    depths); autograd sums the two backward calls."""
    _, net, cfg = _nets()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    (p1, d1), (p2, d2) = _inputs(64, seed=1), _inputs(96, seed=2)
    t = torch.from_numpy
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True)
    loss = (fused_mlp.fused_nerf_mlp(packed, t(p1), t(d1), cfg).sum()
            + (fused_mlp.fused_nerf_mlp(packed, t(p2), t(d2), cfg) ** 2).sum())
    loss.backward()
    g1 = fused_mlp.fused_nerf_mlp_bwd_plain(net, t(p1), t(d1),
                                            torch.ones(64, 4), 10)
    out2 = fused_mlp.fused_nerf_mlp_plain(net, t(p2), t(d2), 10)
    g2 = fused_mlp.fused_nerf_mlp_bwd_plain(net, t(p2), t(d2), 2 * out2, 10)
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, g1[name] + g2[name], rtol=1e-5,
                                   atol=1e-6)


def _run_bwd_program(packed, pts, dirs, g, grid):
    """What the CUDA backward does with a packed net, step for step, in
    PyTorch: tiles of BWD_ROWS rows walked in contiguous ranges by ``grid``
    blocks, each with its own partial slot (zeroed by its first tile), the
    program's buffers, operations and epilogues, the (hi, lo) products in
    hi_lo mode, rows past n zero — then the slots summed in order."""
    prog = [int(v) for v in packed.bwd_program]
    (n_ops, n_bufs, n_freqs, enc_dim, dirs_dim, hi_lo, xb, db, g_cols, grb,
     gr_cols, gsb) = prog[:12]
    table = prog[fused_mlp.BWD_HEADER_INTS:fused_mlp.BWD_OPS_BASE]
    ops = [prog[fused_mlp.BWD_OPS_BASE + 12 * i:
                fused_mlp.BWD_OPS_BASE + 12 * (i + 1)] for i in range(n_ops)]
    rows = fused_mlp.BWD_ROWS
    bf = lambda t: t.to(torch.bfloat16).float()
    act = (lambda t: t) if hi_lo else bf
    w = packed.weights.float()
    bias = packed.biases
    n = pts.shape[0]
    tiles = -(-n // rows)
    stride = -(-packed.grad_total // 64) * 64
    part = torch.zeros(grid, stride)

    def split(t):
        hi = bf(t)
        return hi, bf(t - hi)

    def mm(a, b):  # a @ b, three products in hi_lo mode
        if not hi_lo:
            return a @ b
        (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
        return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo

    def block(off, k, cols):  # a packed (k, cols) weight, hi + lo
        size = k * cols
        blk = w[off:off + size].reshape(k, cols)
        return blk + (w[off + size:off + 2 * size].reshape(k, cols)
                      if hi_lo else 0)

    def rows_of(t, r0):
        out = torch.zeros(rows, t.shape[1])
        m = min(rows, n - r0)
        out[:m] = t[r0:r0 + m]
        return out

    enc = positional_encoding(pts, n_freqs)
    for blk_i in range(grid):
        for t in range(blk_i * tiles // grid, (blk_i + 1) * tiles // grid):
            r0 = t * rows
            bufs = [torch.zeros(rows, table[2 * i + 1]) for i in range(n_bufs)]
            bufs[xb][:, :enc_dim] = act(rows_of(enc, r0))
            if db >= 0:
                bufs[db][:, :dirs_dim] = act(rows_of(dirs, r0))
            gt = rows_of(g, r0)
            bufs[grb][:, :gr_cols] = act(gt[:, :gr_cols])
            if gsb >= 0:
                bufs[gsb][:, :g_cols - gr_cols] = act(gt[:, gr_cols:])
            p = part[blk_i]
            for (kind, sa, wa, ka, sb, wb, kb, off, nn, flag, dst, _) in ops:
                if kind in (0, 1):
                    acc = 0
                    for s, wo, k in ((sa, wa, ka), (sb, wb, kb)):
                        if k:
                            wt = (block(wo, k, nn) if kind == 0
                                  else block(wo, nn, k).t())
                            acc = acc + mm(bufs[s][:, :k], wt)
                    if kind == 0:
                        acc = acc + bias[off:off + nn]
                        if flag:
                            acc = torch.relu(acc)
                    elif flag >= 0:
                        acc = torch.where(bufs[flag][:, :nn] > 0, acc, 0.0)
                    bufs[dst][:, :nn] = act(acc)
                elif kind == 2:
                    p[off:off + ka * nn] += mm(bufs[sa][:, :ka].t(),
                                               bufs[sb][:, :nn]).reshape(-1)
                else:
                    p[off:off + nn] += bufs[sa][:, :nn].sum(0)
    flat = fused_mlp.reduce_partials(part, packed.grad_total)
    return fused_mlp.unpack_grads(packed, flat)


@pytest.mark.parametrize("arch", [
    dict(depth=6, width=64, use_viewdirs=True),
    dict(depth=6, width=40, use_viewdirs=False),   # padded to 48
    dict(depth=8, width=32, use_viewdirs=True),
    dict(depth=6, width=64, use_viewdirs=True, hi_lo=True),
    dict(depth=6, width=40, use_viewdirs=False, hi_lo=True),
])
def test_bwd_program_matches_plain(arch):
    """The backward program, packed layout and partial-slot reduction the
    kernel executes compute the plain backward (padding adds zero; rows
    past n contribute nothing; 3 blocks over 5 tiles, ragged)."""
    arch = dict(arch)
    hi_lo = arch.pop("hi_lo", False)
    vdirs = arch["use_viewdirs"]
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True, **arch)
    net = init_model(cfg.model_config(), seed=3, device="cpu")
    n = 4 * fused_mlp.BWD_ROWS + 37
    pts, dirs = _inputs(n, seed=5)
    pts, dirs = torch.from_numpy(pts), torch.from_numpy(dirs)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(n, 4 if vdirs else net.cfg.output_ch)).astype(np.float32))
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    ops, bufs = fused_mlp.backward_counts(net.cfg, vdirs)
    assert packed.bwd_program[:2].tolist() == [ops, bufs]
    got = _run_bwd_program(packed, pts, dirs if vdirs else None, g, grid=3)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(
        net, pts, dirs if vdirs else None, g, cfg.pos_enc_L, hi_lo=hi_lo)
    assert set(got) == set(want) == {n for n, _ in net.named_parameters()}
    for name in want:
        scale = max(float(want[name].abs().max()), 1e-8)
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   want[name].numpy() / scale,
                                   atol=1e-4 if not hi_lo else 1e-5,
                                   err_msg=name)


def test_reduce_partials_sums_rows_in_order():
    part = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 70)).astype(np.float32))
    want = part[0, :60] + part[1, :60] + part[2, :60] + part[3, :60] \
        + part[4, :60]
    before = fused_mlp.reduce_partials.launches
    got = fused_mlp.reduce_partials(part, 60)
    assert torch.equal(got, want)
    assert fused_mlp.reduce_partials.launches == before


def test_cpu_backward_takes_the_plain_version():
    _, net, cfg = _nets()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    pts, dirs = (torch.from_numpy(a) for a in _inputs(40))
    g = torch.ones(40, 4)
    before = fused_mlp.fused_nerf_mlp_bwd.launches
    got = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(net, pts, dirs, g, 10)
    for name in want:
        assert torch.equal(got[name], want[name])
    assert fused_mlp.fused_nerf_mlp_bwd.launches == before


def test_backward_budget():
    """8x256 + view head: 10 recomputed layers, 12 head and 24 trunk
    operations, 16 buffers — within the program's limits; the scratch
    holds every activation and cotangent of a 128-row tile."""
    mc = RenderConfig().model_config()
    ops, bufs = fused_mlp.backward_counts(mc, True)
    assert (ops, bufs) == (10 + 12 + 24, 16)
    assert fused_mlp.backward_fits(mc, True)
    assert fused_mlp.backward_fits(mc, True, hi_lo=True)
    # 64 + 32 + 8 x 256 + 256 + 128 + 16 + 16 + 2 x 256 columns, bf16.
    assert fused_mlp.bwd_scratch_bytes(mc, True) == 128 * 3072 * 2
    assert fused_mlp.BWD_SMEM <= 48 * 1024
    deep = RenderConfig(depth=40).model_config()
    assert not fused_mlp.backward_fits(deep, True)
    from nerfmlp_torch.ops.render import uses_kernel

    assert not uses_kernel(RenderConfig(depth=40, use_kernel=True,
                                        compute_dtype="bfloat16"))
