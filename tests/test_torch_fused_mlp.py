"""The port's fused MLP (nerfmlp_torch/ops/fused_mlp.py) against the JAX
package's Pallas forward, which runs here in interpret mode.

The CUDA kernel cannot run on the CPU; its arithmetic is held here two
ways: the plain version against JAX's kernel, and the packed layout and
layer program (what the kernel reads) interpreted in PyTorch against the
plain version. The kernel itself is held against the plain version on a
GPU by tests/test_torch_fused_mlp_gpu.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.models.mlp import init_model as jax_init_model
from nerfmlp_tpu.ops.encoding import positional_encoding as jax_encoding
from nerfmlp_tpu.ops.pallas_mlp import fused_nerf_mlp as jax_fused

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.convert import model_from_params
from nerfmlp_torch.ops import fused_mlp
from nerfmlp_torch.ops.encoding import positional_encoding

ARCH = dict(depth=6, width=64)  # depth 6: the skip before layer 5 exists


def _nets(use_viewdirs=True, seed=0, **arch):
    kw = dict(ARCH, **arch)
    jcfg = JaxRenderConfig(use_viewdirs=use_viewdirs, **kw)
    params = jax_init_model(jax.random.PRNGKey(seed), jcfg.model_config())
    cfg = RenderConfig(use_viewdirs=use_viewdirs, **kw)
    net = model_from_params(jax.tree.map(np.asarray, params),
                            cfg.model_config())
    return params, net, cfg


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, np.array(jax_encoding(jnp.asarray(dirs), 4))


@pytest.mark.parametrize("case", ["viewdirs", "no_viewdirs", "ragged"])
def test_plain_matches_jax_kernel(case):
    """bf16 plain version vs the Pallas forward (interpret mode): the
    same rounding points, so agreement to fp32 summation order."""
    vdirs = case != "no_viewdirs"
    n = 300 if case == "ragged" else 256  # 300: not a multiple of any tile
    params, net, cfg = _nets(use_viewdirs=vdirs)
    pts, dirs = _inputs(n)
    jcfg = JaxRenderConfig(use_viewdirs=vdirs, compute_dtype="bfloat16",
                           use_pallas=True, **ARCH)
    want = np.asarray(jax_fused(params, jnp.asarray(pts),
                                jnp.asarray(dirs) if vdirs else None, jcfg,
                                tile=128))
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    got = fused_mlp.fused_nerf_mlp(
        net, torch.from_numpy(pts),
        torch.from_numpy(dirs) if vdirs else None, cfg).detach().numpy()
    assert got.shape == want.shape == (n, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_plain_hi_lo_matches_jax_kernel():
    """fp32_precision='high': three bf16 products per matmul in both."""
    params, net, cfg = _nets()
    pts, dirs = _inputs(256, seed=1)
    jcfg = JaxRenderConfig(compute_dtype="float32", fp32_precision="high",
                           use_pallas=True, **ARCH)
    want = np.asarray(jax_fused(params, jnp.asarray(pts), jnp.asarray(dirs),
                                jcfg, tile=128))
    cfg = dataclasses.replace(cfg, fp32_precision="high", use_kernel=True)
    got = fused_mlp.fused_nerf_mlp(net, torch.from_numpy(pts),
                                   torch.from_numpy(dirs), cfg).detach().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


def _run_program(packed, pts, dirs):
    """What the CUDA kernel does with a packed net, step for step, in
    PyTorch: its buffers, layer records, padding, epilogues and, in hi_lo
    mode, the (hi, lo) splits and three products."""
    prog = [int(v) for v in packed.program]
    n_layers, n_freqs, enc_dim, dirs_dim, out_w, hi_lo = prog[:6]
    cols = prog[6:10]
    n = pts.shape[0]
    bf = lambda t: t.to(torch.bfloat16).float()
    act = (lambda t: t) if hi_lo else bf   # activations: fp32 or bf16
    bufs = [torch.zeros(n, max(c, 1)) for c in cols]
    bufs[0][:, :enc_dim] = act(positional_encoding(pts, n_freqs))
    if dirs is not None:
        bufs[1][:, :dirs_dim] = act(dirs)
    w = packed.weights.float()
    b = packed.biases
    out = torch.zeros(n, out_w)

    def matmul(a, off, k, cols_out):
        size = k * cols_out
        w_hi = w[off:off + size].reshape(k, cols_out)
        if not hi_lo:
            return a @ w_hi
        w_lo = w[off + size:off + 2 * size].reshape(k, cols_out)
        a_hi = bf(a)
        a_lo = bf(a - a_hi)
        return a_hi @ w_hi + a_lo @ w_hi + a_hi @ w_lo

    for li in range(n_layers):
        (src_a, w_a, k_a, src_b, w_b, k_b, b_off, cols_out, mode, dst,
         n_real) = prog[22 + 11 * li: 33 + 11 * li]
        acc = matmul(bufs[src_a][:, :k_a], w_a, k_a, cols_out)
        if k_b:
            acc = acc + matmul(bufs[src_b][:, :k_b], w_b, k_b, cols_out)
        acc = acc + b[b_off:b_off + cols_out]
        if mode == 2:
            out[:, dst:dst + n_real] = acc[:, :n_real]
        else:
            bufs[dst][:, :cols_out] = act(torch.relu(acc) if mode == 0
                                          else acc)
    return out


@pytest.mark.parametrize("arch", [
    dict(depth=6, width=64, use_viewdirs=True),
    dict(depth=6, width=40, use_viewdirs=False),   # padded to 48
    dict(depth=8, width=32, use_viewdirs=True),
    dict(depth=6, width=64, use_viewdirs=True, hi_lo=True),
    dict(depth=6, width=40, use_viewdirs=False, hi_lo=True),
])
def test_packed_program_matches_plain(arch):
    """The weight layout and layer program the kernel executes compute the
    plain version's function (padding adds exactly zero)."""
    arch = dict(arch)
    hi_lo = arch.pop("hi_lo", False)
    vdirs = arch["use_viewdirs"]
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True, **arch)
    from nerfmlp_torch.models.mlp import init_model

    net = init_model(cfg.model_config(), seed=3, device="cpu")
    pts, dirs = _inputs(200, seed=2)
    pts, dirs = torch.from_numpy(pts), torch.from_numpy(dirs)
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    assert packed.weights.dtype == torch.bfloat16
    assert packed.program[0] == cfg.depth + (4 if vdirs else 1)
    got = _run_program(packed, pts, dirs if vdirs else None)
    want = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs if vdirs else None,
                                          cfg.pos_enc_L, torch.bfloat16,
                                          hi_lo=hi_lo)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    _, net, cfg = _nets()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    pts, dirs = _inputs(64)
    before = fused_mlp.fused_nerf_mlp.launches
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True)
    a = fused_mlp.fused_nerf_mlp(packed, torch.from_numpy(pts),
                                 torch.from_numpy(dirs), cfg)
    b = fused_mlp.fused_nerf_mlp_plain(net, torch.from_numpy(pts),
                                       torch.from_numpy(dirs), cfg.pos_enc_L)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_mlp.fused_nerf_mlp.launches == before


def test_architecture_mismatch_raises():
    _, net, cfg = _nets()
    pts, dirs = _inputs(8)
    wrong = dataclasses.replace(cfg, width=32)
    with pytest.raises(NotImplementedError, match="architecture"):
        fused_mlp.fused_nerf_mlp(net, torch.from_numpy(pts),
                                 torch.from_numpy(dirs), wrong)


def test_hopper_budget():
    mc = RenderConfig().model_config()
    # 8x256 + view head: 2 bf16 activation buffers + encodings + a weight
    # slab + the epilogue stage = 107,008 B, so two blocks share an SM.
    assert fused_mlp.smem_bytes(mc, True) == 107_008
    assert fused_mlp.kernel_fits(mc, True)
    # hi_lo adds a lo plane to every activation buffer and to the slab:
    # 205,824 B, one block per SM.
    assert fused_mlp.smem_bytes(mc, True, hi_lo=True) == 205_824
    assert fused_mlp.kernel_fits(mc, True, hi_lo=True)
    assert not fused_mlp.kernel_fits(
        RenderConfig(width=384).model_config(), True, hi_lo=True)
    assert fused_mlp.kernel_fits(RenderConfig(width=512).model_config(), True)
    assert not fused_mlp.kernel_fits(
        RenderConfig(width=1024).model_config(), True)
