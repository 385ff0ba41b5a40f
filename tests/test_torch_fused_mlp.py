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


# Deep nets past the old tables and shallow nets past the forward's
# 64-point (bf16) and 32-point (hi_lo) tiles (CLI shapes), 64 points.
DEEP = {"deep-30x32": dict(depth=30, width=32),
        "deep-31x16": dict(depth=31, width=16),
        "shallow-1x784": dict(depth=1, width=784),
        "shallow-1x720": dict(depth=1, width=720)}


@pytest.mark.parametrize("case", [
    "viewdirs", "no_viewdirs", "ragged", "deep-30x32", "deep-31x16",
    "deep-30x32-hi_lo", "deep-31x16-hi_lo", "shallow-1x784",
    "shallow-1x720-hi_lo"])
def test_plain_matches_jax_kernel(case):
    """bf16 plain version vs the Pallas forward (interpret mode): the
    same rounding points, so agreement to fp32 summation order. The deep
    and shallow hi_lo cases at test_plain_hi_lo_matches_jax_kernel's
    bar."""
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


def fragment_lanes(rows, nn):
    """(point, feature) of bit i of entry e of a pass's mask block, (2 nn,
    rows / 2) each: lane l of the warp tile of features 16 v.. holds entry
    32 v + l, its bit i the element i = 4 j + 2 h + e' of its wgmma
    accumulator fragment: feature 16 v + l / 4 + 8 h, point 8 j + 2 (l %
    4) + e' (mlp_tile.cuh's Wgmma)."""
    e = np.arange(nn // 16 * 32)[:, None]
    i = np.arange(rows // 2)[None, :]
    lane = e % 32
    return (8 * (i // 4) + 2 * (lane % 4) + i % 2,
            16 * (e // 32) + lane // 4 + 8 * ((i // 2) % 2))


def fragment_bits(on):
    """A pass's ReLU bits (rows, nn) -> its mask block's bytes: each entry
    its bits little-endian in max(1, rows / 16) bytes."""
    rows, nn = on.shape
    pt, feat = fragment_lanes(rows, nn)
    bits = on.numpy()[pt, feat].astype(np.uint8)
    out = np.zeros((bits.shape[0], max(1, rows // 16)), np.uint8)
    for b in range(rows // 2):
        out[:, b // 8] |= bits[:, b] << (b % 8)
    return torch.from_numpy(out.reshape(-1))


def fragment_mask(blk, rows, nn):
    """:func:`fragment_bits`' inverse: a mask block's bytes -> (rows, nn)
    bool."""
    pt, feat = fragment_lanes(rows, nn)
    b = blk.numpy().reshape(pt.shape[0], -1)
    on = np.zeros((rows, nn), bool)
    for i in range(rows // 2):
        on[pt[:, i], feat[:, i]] = (b[:, i // 8] >> (i % 8)) & 1
    return torch.from_numpy(on)


def _run_program(packed, pts, dirs, res=None):
    """What the CUDA kernel does with a packed net, step for step, in
    PyTorch: tiles of the program's row count, each encoded into the
    kernel's shared-memory buffers (one flat array laid out as the kernel
    lays them out: whole 128-byte swizzled atoms at 1024-byte offsets,
    ``act_index``; unwritten slots NaN so that a read of one shows); then
    the program's operations, each a pass of at most FWD_MAX_N columns over
    one layer, its weights read back from the strip image
    (``block_from_image``), with its padding, epilogue and, in hi_lo mode,
    the (hi, lo) planes and three products; the heads' real columns written
    from the epilogue to the output, rows at or past n masked. Each
    operation's ring stage is checked to fit a slot; the ring itself is
    not modelled. ``res`` = (workspace, mask images): the training forward
    also writes its residuals as the handover's table says
    (``packed.handover.res``), over tiles up to ``ws_rows(n, rows)``: the
    encoded points and dirs, and each operation's pass into its workspace
    matrix (fp32-held bf16 values in the strip layout, ``ws_index``), each
    ReLU pass's bits (the stored value > 0) into its block of the tile's
    image (``fragment_bits``)."""
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
    slot = hdr["slot"] // planes   # a stage's bytes of one plane
    assert hdr["stages"] >= 2 and hdr["smem"] <= fused_mlp.SMEM_LIMIT
    assert rows in fused_mlp.FWD_TRIES[hi_lo]
    # the kernel copies the whole program into shared memory; then the
    # ring's barriers and the zero block, the buffers, the ring
    assert hdr["prog_len"] == len(prog)
    assert 4 * hdr["prog_len"] <= hdr["bar_off"]
    used = [(off, cols) for off, cols, _ in bufs if cols]
    assert (hdr["bar_off"] + fused_mlp.MAX_STAGES * fused_mlp.BARRIER_BYTES
            + fused_mlp.ZERO_BYTES <= min(off for off, _ in used))
    assert all(off % 1024 == 0 and cols % 64 == 0 for off, cols in used)
    assert all(off + rows * cols * 2 * planes <= hdr["ring_off"]
               for off, cols in used)
    assert hdr["ring_off"] % 1024 == 0 and slot % 1024 == 0
    assert hdr["ring_off"] + hdr["stages"] * hdr["slot"] == hdr["smem"]
    bf = lambda t: t.to(torch.bfloat16).float()
    w = packed.weights.float()
    b = packed.biases
    n = pts.shape[0]
    smem = torch.full((hdr["ring_off"] // 2,), float("nan"))

    def at(bi, col, cols):   # element offsets of buffer bi's columns col..
        off, bcols, c0 = bufs[bi]
        assert c0 + col + cols <= bcols
        return off // 2 + fused_mlp.act_index(rows, cols, c0 + col)

    def read(bi, k):   # buffer bi's first k columns, each plane
        off, bcols, _ = bufs[bi]
        idx = at(bi, 0, k)
        return [smem[idx + p * rows * bcols] for p in range(planes)]

    def put(bi, col, v):   # a value into buffer bi's planes from column col
        off, bcols, _ = bufs[bi]
        idx = at(bi, col, v.shape[1])
        hi = bf(v)
        smem[idx] = hi
        if hi_lo:
            smem[idx + rows * bcols] = bf(v - hi)

    def block(off, k, ld, col, nn):   # columns col.. of a (k, ld) block
        # copied column-major, the layout of the plain version's w.t(): the
        # same BLAS path sums in the same order, so the bf16 roundings of a
        # wide net's activations agree (the kernel's own order is held on
        # the card)
        return [fused_mlp.block_from_image(w[off + p * k * ld:
                                             off + (p + 1) * k * ld], k, ld)
                [:, col:col + nn].t().contiguous().t() for p in range(planes)]

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
    xk = fused_mlp._pad16(hdr["enc_dim"])
    dk = fused_mlp._pad16(hdr["dirs_dim"])
    end, table = n, [(-1, 0, -1)] * len(ops)
    if res is not None:
        ws, image = res
        ho = packed.handover
        assert ho.rows == rows
        r = [int(v) for v in ho.res]
        assert len(r) == 4 + 4 * len(ops)
        table = [tuple(r[4 + 4 * i: 7 + 4 * i]) for i in range(len(ops))]
        end = fused_mlp.ws_rows(n, rows)
        cap = ws.numel() // packed.ws_cols
        assert image.shape == (cap // rows, ho.mask_bytes)

    def save(off, cols, r0, bi, col, nn):   # a pass into its matrix
        idx = fused_mlp.ws_index(cap, cols)[r0:r0 + rows, col:col + nn]
        for p in range(planes):
            ws[cap * (off + p * cols) + idx] = smem[at(bi, col, nn)
                                                    + p * rows * bufs[bi][1]]

    for r0 in range(0, end, rows):
        put(0, 0, tile(enc, r0, xk))
        if hdr["dirs_dim"]:
            put(1, 0, tile(dirs, r0, dk))
        if res is not None:
            save(r[0], r[1], r0, 0, 0, r[1])
            if r[2] >= 0:
                save(r[2], r[3], r0, 1, 0, r[3])
        for (kind, sa, wa, ka, sb, wb, kb, nn, col, wld, kr, dst, bo, mode,
             n_real, _), (m, m_cols, mask) in zip(ops, table):
            assert kind == 0 and col % fused_mlp.FWD_MAX_N == 0
            assert nn <= fused_mlp.FWD_MAX_N and nn % 16 == 0
            # a stage of kr weight rows (at most 64: four k-steps) fits a
            # slot of the ring, with what a 64-row tile reads past it
            shape = fused_mlp.OpShape(kind, ka, kb, wld, col, nn)
            assert kr % 16 == 0 and 16 <= kr <= 64
            assert fused_mlp._touch(shape, kr) <= slot
            acc = mm(read(sa, ka), block(wa, ka, wld, col, nn))
            if kb:
                acc = acc + mm(read(sb, kb), block(wb, kb, wld, col, nn))
            acc = acc + b[bo:bo + nn]
            if mode == 2:
                assert m < 0 and mask < 0
                k = max(0, min(rows, n - r0))
                out[r0:r0 + k, dst:dst + n_real] = acc[:k, :n_real]
                continue
            put(dst, col, torch.relu(acc) if mode == 0 else acc)
            if m >= 0:
                save(m, m_cols, r0, dst, col, nn)
            assert (mask >= 0) == (res is not None and mode == 0)
            if mask >= 0:
                on = (torch.relu(acc) > 0 if hi_lo
                      else bf(torch.relu(acc)) > 0)
                bits = fragment_bits(on)
                image[r0 // rows, mask:mask + bits.numel()] = bits
    return out


@pytest.mark.parametrize("arch, n, rows", [
    (dict(depth=6, width=64, use_viewdirs=True), 200, (128, 1)),
    (dict(depth=6, width=40, use_viewdirs=False), 200, (128, 1)),  # pad 48
    (dict(depth=8, width=32, use_viewdirs=True), 200, (128, 1)),
    (dict(depth=6, width=64, use_viewdirs=True, hi_lo=True), 200, (64, 1)),
    (dict(depth=6, width=40, use_viewdirs=False, hi_lo=True), 200, (64, 1)),
    # wider than one 256-column pass: trunk and bottleneck in two passes
    (dict(depth=4, width=288, use_viewdirs=True), 200, (128, 1)),
    (dict(depth=4, width=288, use_viewdirs=True, hi_lo=True), 200, (64, 1)),
    (dict(depth=2, width=512, use_viewdirs=True), 150, (64, 1)),
    # hi_lo past width 256: 32-point tiles, two planes, two passes a layer
    (dict(depth=2, width=384, use_viewdirs=True, hi_lo=True), 200, (32, 1)),
    # ragged: one row past two 128-point tiles
    (dict(depth=6, width=64, use_viewdirs=True), 257, (128, 1)),
    # deep; 16 wide, 64-point tiles in hi_lo
    (dict(depth=54, width=64, use_viewdirs=True), 150, (128, 1)),
    (dict(depth=200, width=16, use_viewdirs=True, hi_lo=True), 100, (64, 1)),
    # the shallow wide nets: 32- and 16-point tiles, ragged in n
    (dict(depth=2, width=1024, use_viewdirs=True), 40, (32, 1)),
    (dict(depth=1, width=1696, use_viewdirs=True), 40, (16, 1)),
    (dict(depth=1, width=1472, use_viewdirs=True, hi_lo=True), 40, (16, 1)),
])
def test_packed_program_matches_plain(arch, n, rows):
    """The weight layout and program the kernel executes — tiles (``rows``:
    points a tile, one CTA a tile), column passes, buffers, epilogues —
    compute the plain version's function (padding adds exactly zero; rows
    past n are never written)."""
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
    assert (hdr["rows"], 1) == rows
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
    """The forward's shared memory per block: its program, the ring's
    barriers and zero block, the encoded points and dirs (whole 64-column
    swizzled atoms), one activation buffer written in place (two where a
    layer takes more than one pass) and as many weight stages (up to 8) as
    fit Hopper's 232,448 B."""
    mc = RenderConfig().model_config()
    # 8x256 + view head: 128-point tiles, four stages of 64 rows.
    # 896 (program) + 128 + 128 (barriers, zeros; atoms from 2,048) +
    # 16,384 (x) + 16,384 (dirs) + 65,536 (in place) + 4 x 32,768.
    lay = fused_mlp._fwd_layout(mc, True, False)
    assert (lay.rows, lay.kr, lay.stages) == (128, 64, 4)
    assert fused_mlp.smem_bytes(mc, True) == 231_424 == (
        2048 + 16384 + 16384 + 65536 + 4 * 32768)
    assert fused_mlp.kernel_fits(mc, True)
    # Rows per stage: 64 for the 256- and 128-column layers and for the
    # sigma (256 x 16) and rgb (128 x 16) heads: a stage is at most four
    # k-steps.
    assert [fused_mlp.stage_rows(fused_mlp.OpShape(0, k, 0, wld, 0, n),
                                 lay.slot) for k, wld, n in (
        (256, 256, 256), (256, 128, 128), (256, 16, 16), (128, 16, 16))
    ] == [64, 64, 64, 64]
    # hi_lo: 64-point tiles of two planes, two stages of 64 rows.
    lay = fused_mlp._fwd_layout(mc, True, True)
    assert (lay.rows, lay.kr, lay.stages) == (64, 64, 2)
    assert fused_mlp.smem_bytes(mc, True, hi_lo=True) == 231_424
    assert fused_mlp.kernel_fits(mc, True, hi_lo=True)
    # Depth 8, by width (the largest tile that holds two stages): bf16
    # 128-point tiles up to 320, 64 to 768, 32 to 1536, 16 to 3136; hi_lo
    # 64 to 320, 32 to 704, 16 to 1408, each alone. Past those, no two
    # stages fit.
    for width, hi_lo, tile in ((320, False, 128), (336, False, 64),
                               (768, False, 64), (784, False, 32),
                               (1536, False, 32), (1552, False, 16),
                               (3136, False, 16), (320, True, 64),
                               (336, True, 32), (704, True, 32),
                               (720, True, 16), (1408, True, 16)):
        wide = RenderConfig(width=width).model_config()
        lay = fused_mlp._fwd_layout(wide, True, hi_lo)
        assert lay.rows == tile, (width, hi_lo)
        assert fused_mlp.kernel_fits(wide, True, hi_lo=hi_lo)
    for width, hi_lo in ((3152, False), (1424, True)):
        wide = RenderConfig(width=width).model_config()
        assert not fused_mlp.kernel_fits(wide, True, hi_lo=hi_lo)
        assert fused_mlp.forward_misfit(wide, True, hi_lo).startswith(
            "the forward's buffers of 16-point tiles leave room for 1")
    # Width 512: 64-point tiles, every layer in two 256-column passes.
    wide = RenderConfig(width=512).model_config()
    assert fused_mlp._fwd_layout(wide, True, False).rows == 64
    assert fused_mlp.forward_ops(wide, True) == 8 * 2 + 1 + 2 + 1 + 1
    # Depth is bounded by the program's bytes alone (64 a layer): 48 layers
    # and more fit; 866 (55,808 B of program) at 128-point tiles.
    for depth in (48, 866):
        deep = RenderConfig(depth=depth).model_config()
        assert fused_mlp.kernel_fits(deep, True)
        assert fused_mlp._fwd_layout(deep, True, False).rows == 128


@pytest.mark.parametrize("depth, width, hi_lo", [
    (8, 256, False), (8, 256, True), (3, 200, False), (1, 1696, False),
    (1, 1472, True), (2, 40, False)])
def test_weight_image_unswizzles_to_every_block(depth, width, hi_lo):
    """Every block of a packed net, read back from the strip image (the
    128-byte swizzled atoms of whole 64-column strips, core matrices of a
    narrower last one), is exactly the block of the net's weights: the
    (in, out) transpose, zero padded, in bf16 (in hi_lo its (hi, lo)
    pair). The image holds nothing else."""
    cfg = RenderConfig(depth=depth, width=width)
    from nerfmlp_torch.models.mlp import init_model

    net = init_model(cfg.model_config(), seed=4, device="cpu")
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True, hi_lo)
    params = dict(net.named_parameters())
    planes = 2 if hi_lo else 1
    w = packed.weights.float()
    at = 0
    for name, in0, k, n, _, kp, np_ in packed.grad_blocks:
        blk = torch.zeros(kp, np_)
        blk[:k, :n] = params[name].detach().float()[:, in0:in0 + k].t()
        hi = blk.to(torch.bfloat16).float()
        want = [hi, (blk - hi).to(torch.bfloat16).float()][:planes]
        for plane in want:
            got = fused_mlp.block_from_image(w[at:at + kp * np_], kp, np_)
            assert torch.equal(got, plane), name
            at += kp * np_
    assert at == w.numel()


@pytest.mark.parametrize("k, n", [(64, 256), (16, 16), (48, 208), (32, 1696)])
def test_strip_image_round_trips(k, n):
    """strip_image lays a block out once, every element in its own place,
    and block_from_image reads it back exactly."""
    blk = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    img = fused_mlp.strip_image(blk)
    assert sorted(img.tolist()) == list(range(k * n))
    assert torch.equal(fused_mlp.block_from_image(img, k, n), blk)
