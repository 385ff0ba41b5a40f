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


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets(use_viewdirs=True, seed=0, **arch):
    kw = dict(ARCH, **arch)
    jcfg = JaxRenderConfig(use_viewdirs=use_viewdirs, **kw)
    params = jax_init_model(jax.random.PRNGKey(seed), jcfg.model_config())
    cfg = RenderConfig(use_viewdirs=use_viewdirs, **kw)
    net = model_from_params(jax.tree.map(np.asarray, params),
                            cfg.model_config(), device="cpu")
    return params, net, cfg


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, np.array(jax_encoding(jnp.asarray(dirs), 4))


# Deep nets past the old tables (CLI shapes), 64 points.
DEEP = {"deep-30x32": dict(depth=30, width=32),
        "deep-31x16": dict(depth=31, width=16)}


@pytest.mark.parametrize("case", [
    "viewdirs", "no_viewdirs", "ragged", "deep-30x32", "deep-31x16",
    "deep-30x32-hi_lo", "deep-31x16-hi_lo"])
def test_plain_matches_jax_kernel(case):
    """bf16 plain version vs the Pallas forward (interpret mode): the
    same rounding points, so agreement to fp32 summation order. The deep
    hi_lo cases at test_plain_hi_lo_matches_jax_kernel's bar."""
    vdirs = case != "no_viewdirs"
    hi_lo = case.endswith("hi_lo")
    deep = DEEP.get(case.replace("-hi_lo", ""))
    n = 300 if case == "ragged" else 64 if deep else 256  # 300: not a
    arch = deep or ARCH                                   # multiple of a tile
    params, net, cfg = _nets(use_viewdirs=vdirs, **arch)
    pts, dirs = _inputs(n)
    dt = dict(compute_dtype="float32", fp32_precision="high") if hi_lo \
        else dict(compute_dtype="bfloat16")
    jcfg = JaxRenderConfig(use_viewdirs=vdirs, use_pallas=True, **dt, **arch)
    want = np.asarray(jax_fused(params, jnp.asarray(pts),
                                jnp.asarray(dirs) if vdirs else None, jcfg,
                                tile=128))
    cfg = dataclasses.replace(cfg, use_kernel=True, **dt)
    got = fused_mlp.fused_nerf_mlp(
        net, torch.from_numpy(pts),
        torch.from_numpy(dirs) if vdirs else None, cfg).detach().numpy()
    assert got.shape == want.shape == (n, 4)
    if hi_lo:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)
    else:
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
    PyTorch: tiles of the program's row count, each encoded into the
    kernel's shared-memory buffers (one flat array laid out as the kernel
    lays them out, unwritten slots NaN so that a read of one shows); then
    the program's operations, each a pass of at most FWD_MAX_N columns over
    one layer, with its padding, epilogue and, in hi_lo mode, the (hi, lo)
    planes and three products; the heads' real columns written from the
    epilogue to the output, rows at or past n masked. The weight ring is
    not modelled beyond the room of a stage."""
    hdr = fused_mlp.fwd_header(packed)
    prog = [int(v) for v in packed.program]
    base, ops_base = fused_mlp.FWD_HEADER_INTS, fused_mlp.FWD_OPS_BASE
    bufs = [prog[base + 3 * i: base + 3 * i + 3]
            for i in range(fused_mlp.FWD_MAX_BUFS)]
    ops = [prog[ops_base + fused_mlp.FWD_OP_INTS * i:
                ops_base + fused_mlp.FWD_OP_INTS * (i + 1)]
           for i in range(hdr["n_ops"])]
    rows, hi_lo = hdr["rows"], bool(hdr["hi_lo"])
    planes = 2 if hi_lo else 1
    slot = hdr["stage_elems"]
    assert hdr["stages"] >= 2 and hdr["smem"] <= fused_mlp.SMEM_LIMIT
    # the kernel copies the whole program into shared memory, ahead of the
    # buffers
    assert hdr["prog_len"] == len(prog)
    assert 4 * hdr["prog_len"] <= min(off for off, _, c in bufs if c)
    assert all(off + rows * ld * 2 * planes <= hdr["ring_off"]
               for off, ld, cols in bufs if cols)
    bf = lambda t: t.to(torch.bfloat16).float()
    w = packed.weights.float()
    b = packed.biases
    n = pts.shape[0]
    smem = torch.full((hdr["ring_off"] // 2,), float("nan"))

    def buf(bi, plane=0):
        off, ld, cols = bufs[bi]
        at = off // 2 + plane * rows * ld
        return smem[at: at + rows * ld].view(rows, ld)[:, :cols]

    def put(bi, col, v):   # a value into buffer bi's planes from column col
        hi = bf(v)
        buf(bi, 0)[:, col:col + v.shape[1]] = hi
        if hi_lo:
            buf(bi, 1)[:, col:col + v.shape[1]] = bf(v - hi)

    def block(off, k, nn, ld):   # columns of a packed (k, ld) weight's planes
        return [w.as_strided((k, nn), (ld, 1), off + p * k * ld)
                for p in range(planes)]

    def mm(a, wt):   # planes @ planes: hi*hi (+ lo*hi + hi*lo)
        out = a[0] @ wt[0]
        return out + a[1] @ wt[0] + a[0] @ wt[1] if hi_lo else out

    def tile(t, r0, cols):   # rows r0.. of t, zero past n and past its width
        out = torch.zeros(rows, cols)
        m = max(0, min(rows, t.shape[0] - r0))
        out[:m, :t.shape[1]] = t[r0:r0 + m]
        return out

    enc = positional_encoding(pts, hdr["n_freqs"])
    out = torch.full((n, hdr["out_w"]), float("nan"))
    for r0 in range(0, n, rows):
        put(0, 0, tile(enc, r0, bufs[0][2]))
        if hdr["dirs_dim"]:
            put(1, 0, tile(dirs, r0, bufs[1][2]))
        for (sa, wa, ka, sb, wb, kb, bo, nn, wld, mode, dst, col, n_real,
             kr, *_) in ops:
            assert nn <= fused_mlp.FWD_MAX_N and nn % 16 == 0
            # a stage of kr weight rows fits one slot of the ring
            assert kr % 16 == 0 and kr * (nn + fused_mlp.PAD) <= slot
            acc = mm([buf(sa, p)[:, :ka] for p in range(planes)],
                     block(wa, ka, nn, wld))
            if kb:
                acc = acc + mm([buf(sb, p)[:, :kb] for p in range(planes)],
                               block(wb, kb, nn, wld))
            acc = acc + b[bo:bo + nn]
            if mode == 2:
                m = min(rows, n - r0)
                out[r0:r0 + m, dst:dst + n_real] = acc[:m, :n_real]
            else:
                put(dst, col, torch.relu(acc) if mode == 0 else acc)
    return out


@pytest.mark.parametrize("arch, n", [
    (dict(depth=6, width=64, use_viewdirs=True), 200),
    (dict(depth=6, width=40, use_viewdirs=False), 200),   # padded to 48
    (dict(depth=8, width=32, use_viewdirs=True), 200),
    (dict(depth=6, width=64, use_viewdirs=True, hi_lo=True), 200),
    (dict(depth=6, width=40, use_viewdirs=False, hi_lo=True), 200),
    # wider than one 256-column pass: trunk and bottleneck in two passes
    (dict(depth=4, width=288, use_viewdirs=True), 200),
    (dict(depth=4, width=288, use_viewdirs=True, hi_lo=True), 200),
    (dict(depth=2, width=512, use_viewdirs=True), 150),   # 64-point tiles
    # hi_lo past width 320: 32-point tiles, two planes, two passes a layer
    (dict(depth=2, width=384, use_viewdirs=True, hi_lo=True), 200),
    # ragged: one row past two 128-point tiles
    (dict(depth=6, width=64, use_viewdirs=True), 257),
    # deeper than the old 48-layer bound; 16 wide, 64-point tiles in hi_lo
    (dict(depth=54, width=64, use_viewdirs=True), 150),
    (dict(depth=200, width=16, use_viewdirs=True, hi_lo=True), 100),
])
def test_packed_program_matches_plain(arch, n):
    """The weight layout and program the kernel executes — tiles, column
    passes, buffers, epilogues — compute the plain version's function
    (padding adds exactly zero; rows past n are never written)."""
    arch = dict(arch)
    hi_lo = arch.pop("hi_lo", False)
    vdirs = arch["use_viewdirs"]
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True, **arch)
    from nerfmlp_torch.models.mlp import init_model

    net = init_model(cfg.model_config(), seed=3, device="cpu")
    pts, dirs = _inputs(n, seed=2)
    pts, dirs = torch.from_numpy(pts), torch.from_numpy(dirs)
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    assert packed.weights.dtype == torch.bfloat16
    hdr = fused_mlp.fwd_header(packed)
    layers = cfg.depth + (4 if vdirs else 1)
    assert hdr["n_ops"] == fused_mlp.forward_ops(net.cfg, vdirs) >= layers
    assert (hdr["n_ops"] == layers) is (cfg.width <= fused_mlp.FWD_MAX_N)
    assert hdr["rows"] == (32 if hi_lo and cfg.width > 320 else
                           64 if hi_lo or cfg.width > 288 else 128)
    assert n % hdr["rows"]
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
    """The forward's shared memory per block: its program, the encoded
    points and dirs, two ping-pong activation buffers and as many weight
    stages (up to 4) as fit Hopper's 232,448 B."""
    mc = RenderConfig().model_config()
    # 8x256 + view head: 128-point tiles, 32-row weight stages.
    # 896 (program) + 18,432 (x) + 10,240 (dirs) + 2 x 67,584 + 4 x 16,896.
    lay = fused_mlp._fwd_layout(mc, True, False)
    assert (lay.rows, lay.ksub, lay.stages) == (128, 2, 4)
    assert fused_mlp.smem_bytes(mc, True) == 232_320
    assert fused_mlp.kernel_fits(mc, True)
    # Rows per stage: 32 for a 256-column layer, 48 for the 128-column view
    # layer; the sigma (256 x 16) and rgb (128 x 16) heads in one stage.
    assert [fused_mlp._stage_rows(lay, n, k) for n, k in (
        (256, 256), (128, 256), (16, 256), (16, 128))] == [32, 48, 256, 128]
    # hi_lo: 64-point tiles of two planes, 16-row stages of two planes.
    lay = fused_mlp._fwd_layout(mc, True, True)
    assert (lay.rows, lay.ksub, lay.stages) == (64, 1, 4)
    assert fused_mlp.smem_bytes(mc, True, hi_lo=True) == 232_320
    assert fused_mlp.kernel_fits(mc, True, hi_lo=True)
    # hi_lo past width 320: 32-point tiles, up to width 688; at 704 two
    # planes of the 32-point buffers leave room for one stage.
    for width, fits in ((384, True), (576, True), (688, True), (704, False)):
        wide = RenderConfig(width=width).model_config()
        assert fused_mlp._fwd_layout(wide, True, True).rows == 32
        assert fused_mlp.kernel_fits(wide, True, hi_lo=True) is fits
    assert "1 weight stage(s)" in fused_mlp.forward_misfit(
        RenderConfig(width=704).model_config(), True, hi_lo=True)
    # Width 512: 64-point tiles, every layer in two 256-column passes.
    wide = RenderConfig(width=512).model_config()
    assert fused_mlp._fwd_layout(wide, True, False).rows == 64
    assert fused_mlp.forward_ops(wide, True) == 8 * 2 + 1 + 2 + 1 + 1
    assert fused_mlp.kernel_fits(wide, True)
    assert not fused_mlp.kernel_fits(
        RenderConfig(width=1024).model_config(), True)
    # Depth is bounded by the program's bytes alone (64 a layer): 48 layers
    # and more fit; 866 (55,808 B of program) at 64-point tiles.
    for depth in (48, 866):
        assert fused_mlp.kernel_fits(
            RenderConfig(depth=depth).model_config(), True)
    assert fused_mlp._fwd_layout(RenderConfig(depth=866).model_config(),
                                 True, False).rows == 64
