"""The port's fused MLP backward (nerfmlp_torch/ops/fused_mlp.py) against
the JAX package's Pallas backward, which runs here in interpret mode.

The CUDA kernels cannot run on the CPU; their arithmetic is held here two
ways: the plain backward (through the autograd Function, as CPU tensors
take it) against ``jax.grad`` through the Pallas kernel, and the schedule
the kernels execute (phase 1's program over shared-memory buffers and its
workspace, phase 2's jobs over splits and chunks, the reduction's slot
order) interpreted in PyTorch against the plain backward.
The kernels themselves are held against the plain versions on a GPU by
tests/test_torch_fused_mlp_gpu.py and chip_smoke.py.
"""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import ModelConfig as JaxModelConfig
from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.ops.pallas_mlp import backward_fits_vmem
from nerfmlp_tpu.ops.pallas_mlp import fused_nerf_mlp as jax_fused

from nerfmlp_torch.config import ModelConfig, RenderConfig
from nerfmlp_torch.models.convert import params_from_state_dict
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp
from nerfmlp_torch.ops.encoding import positional_encoding
from nerfmlp_torch.ops.render import prepare_params, uses_kernel

from test_torch_fused_mlp import ARCH, _inputs, _nets

# Per-leaf max |port - JAX| / max |JAX|. Both sides round at the same
# points, so only fp32 summation order differs, and the rare bf16 rounding
# or ReLU mask it flips. Measured: 5.2e-7 (view head), 3.7e-7 (ragged),
# 9.5e-5 (no view head: one flip), 2.3e-6 (hi_lo) — under the 5e-3 bar
# that tests/test_pallas.py holds the Pallas kernel to against XLA.
BF16_TOL = 1e-3
HI_LO_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_jax(raw):
    return jnp.mean(jax.nn.sigmoid(raw[:, :3]) ** 2) + jnp.mean(
        jax.nn.relu(raw[:, 3]) * 1e-2)


def _loss_torch(raw):
    return (torch.mean(torch.sigmoid(raw[:, :3]) ** 2)
            + torch.mean(torch.relu(raw[:, 3]) * 1e-2))


# Nets wider than one 256-column pass (CLI shapes: bottleneck = width,
# view head = width / 2), three layers deep to keep interpret mode short;
# nets deeper than the old tables (96 phase-1 operations, 64 workspace
# matrices) and shallow nets past the forward's 64-point (bf16) and
# 32-point (hi_lo) tiles at 64 points.
WIDE = {"wide-3x384": dict(depth=3, width=384),
        "wide-3x288": dict(depth=3, width=288),
        "deep-30x32": dict(depth=30, width=32),
        "deep-31x16": dict(depth=31, width=16),
        "shallow-1x784": dict(depth=1, width=784),
        "shallow-1x720": dict(depth=1, width=720)}


@pytest.mark.parametrize("case", [
    "viewdirs", "no_viewdirs", "ragged", "hi_lo",
    "wide-3x384", "wide-3x384-hi_lo", "wide-3x288", "wide-3x288-hi_lo",
    "deep-30x32", "deep-30x32-hi_lo", "deep-31x16", "deep-31x16-hi_lo",
    "shallow-1x784", "shallow-1x720-hi_lo"])
def test_plain_backward_matches_jax_kernel(case):
    """jax.grad through the Pallas backward (interpret mode) vs the port's
    autograd Function on CPU tensors (the plain backward), same weights."""
    vdirs = case != "no_viewdirs"
    hi_lo = case.endswith("hi_lo")
    n = (300 if case == "ragged" else
         64 if "deep" in case or "shallow" in case else 256)
    arch = WIDE.get(case.replace("-hi_lo", ""), ARCH)
    params, net, cfg = _nets(use_viewdirs=vdirs, **arch)
    pts, dirs = _inputs(n, seed=4)
    dt = dict(compute_dtype="float32", fp32_precision="high") if hi_lo \
        else dict(compute_dtype="bfloat16")
    jcfg = JaxRenderConfig(use_viewdirs=vdirs, use_pallas=True, **dt, **arch)
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


def _run_bwd_program(packed, pts, dirs, g, chunk_rows):
    """What the CUDA backward does with a packed net, step for step, in
    PyTorch: the call walked in chunks of at most ``chunk_rows`` points. In
    each chunk, phase 1 walks tiles of the program's ``rows`` points over
    the chunk's workspace rows (``ws_rows``: past n, zero points): the
    program's shared-memory buffers (one flat array of whole 128-byte
    swizzled atoms, ``act_index``, so buffers laid in one another's atoms
    share storage), its mask blocks (each a pass's bits, inside the mask
    region and apart from the others), operations (each a pass of at most
    ``BWD_MAX_N`` output columns from column ``col`` on, over the whole K
    of its operands, its weights read back from the strip image, its ring
    stage checked to fit a slot) and epilogues, the (hi, lo) planes and
    three products in hi_lo mode, rows past n zero, each pass's columns
    copied into its workspace matrix. The matrix and operation tables are
    read at the header's bases. Then phase 2 runs every job over every
    split of the chunk's rows into that chunk's partial slots, and the
    slots are summed in (chunk, split) order."""
    prog = packed.bwd_program.tolist()
    hdr = dict(zip(fused_mlp._BWD_HEADER, prog))
    hi_lo = packed.hi_lo
    planes = 2 if hi_lo else 1
    bufs = [prog[fused_mlp.BWD_HEADER_INTS + 3 * i:
                 fused_mlp.BWD_HEADER_INTS + 3 * i + 3]
            for i in range(fused_mlp.BWD_MAX_BUFS)]
    mats = [prog[hdr["mats_base"] + 2 * i: hdr["mats_base"] + 2 * i + 2]
            for i in range(hdr["n_mats"])]
    ops = [prog[hdr["ops_base"] + 16 * i: hdr["ops_base"] + 16 * (i + 1)]
           for i in range(hdr["n_ops"])]
    assert hdr["mats_base"] == fused_mlp.BWD_TABLES_BASE
    assert hdr["ops_base"] == hdr["mats_base"] + 2 * hdr["n_mats"]
    assert hdr["jobs_off"] == hdr["ops_base"] + 16 * hdr["n_ops"]
    jobs = np.asarray(prog[hdr["jobs_off"]:]).reshape(hdr["n_jobs"], 10)
    rows = hdr["rows"]
    assert rows == packed.bwd_rows and hdr["stages"] >= 2
    assert hdr["cluster"] == packed.bwd_cluster == 1
    assert hdr["smem"] <= fused_mlp.SMEM_LIMIT
    slot = hdr["slot"] // planes
    # phase 1 copies the whole program, or its header and buffer table,
    # into shared memory ahead of the ring's barriers, zero block and
    # buffers (whole atoms at 1024-byte offsets)
    assert hdr["prog_len"] in (hdr["jobs_off"], fused_mlp.BWD_TABLES_BASE)
    assert 4 * hdr["prog_len"] <= hdr["bar_off"]
    used = [(off, cols, c0) for off, cols, c0 in bufs if cols]
    assert (hdr["bar_off"] + fused_mlp.MAX_STAGES * fused_mlp.BARRIER_BYTES
            + fused_mlp.ZERO_BYTES <= min(off for off, _, _ in used))
    assert all(off % 1024 == 0 and cols % 64 == 0 and c0 < cols
               for off, cols, c0 in used)
    assert all(off + rows * cols * 2 * planes <= hdr["mask_off"]
               for off, cols, _ in used)
    assert hdr["ring_off"] + hdr["stages"] * hdr["slot"] == hdr["smem"]
    # the mask blocks: each a pass's entries, inside the region, none
    # overlapping another
    entry = fused_mlp.mask_entry_bytes(rows)
    blocks = sorted({(o[14], o[7]) for o in ops if o[14] >= 0})
    ends = [off + nn * 2 * entry for off, nn in blocks]
    assert all(e <= b for e, (b, _) in zip(ends, blocks[1:]))
    assert not blocks or hdr["mask_off"] + ends[-1] <= hdr["ring_off"]
    assert {(o[13], o[7]) for o in ops if o[13] >= 0} <= set(blocks)
    bf = lambda t: t.to(torch.bfloat16).float()
    w = packed.weights.float()
    n = pts.shape[0]
    enc = positional_encoding(pts, hdr["n_freqs"])
    smem = torch.zeros(hdr["mask_off"] // 2)   # bf16 slots, by element

    def at(b, col, cols):   # element offsets of buffer b's columns col..
        off, bcols, c0 = bufs[b]
        assert c0 + col + cols <= bcols
        return off // 2 + fused_mlp.act_index(rows, cols, c0 + col)

    def buf(b, cols, col=0, plane=0):
        return smem[at(b, col, cols) + plane * rows * bufs[b][1]]

    def block(off, k, ld):   # a (k, ld) weight block's planes
        return [fused_mlp.block_from_image(w[off + p * k * ld:
                                             off + (p + 1) * k * ld], k, ld)
                for p in range(planes)]

    def mm(a, b):   # planes @ planes: hi*hi (+ hi*lo + lo*hi)
        out = a[0] @ b[0]
        return out + a[0] @ b[1] + a[1] @ b[0] if hi_lo else out

    def put(b, v, col=0):   # a value into buffer b's planes from column col
        idx = at(b, col, v.shape[1])
        hi = bf(v)
        smem[idx] = hi
        if hi_lo:
            smem[idx + rows * bufs[b][1]] = bf(v - hi)

    def tile_of(t, r0):
        out = torch.zeros(rows, t.shape[1])
        m = max(0, min(rows, t.shape[0] - r0))
        out[:m] = t[r0:r0 + m]
        return out

    chunks = [(c0, min(chunk_rows, n - c0)) for c0 in range(0, n, chunk_rows)]
    cap = fused_mlp.ws_rows(min(n, chunk_rows), rows)
    slots = []
    for c0, r in chunks:
        ws = torch.zeros(cap * hdr["ws_cols"])

        def mat(m, plane=0):
            col, cols = mats[m]
            at_ = cap * (col + plane * cols)
            return ws[at_: at_ + cap * cols].view(cap, cols)

        def save(b, m, r0, col=0, nn=None):   # columns of buffer b
            for plane in range(planes):
                dst = mat(m, plane)
                end = dst.shape[1] if nn is None else col + nn
                dst[r0:r0 + rows, col:end] = buf(b, end - col, col, plane)

        c_g = g[c0:c0 + r]
        c_enc = enc[c0:c0 + r]
        c_dirs = None if dirs is None else dirs[c0:c0 + r]
        masks = {}
        r_pad = fused_mlp.ws_rows(r, rows)
        for r0 in range(0, r_pad, rows):
            put(hdr["x_buf"], tile_of(c_enc, r0))
            save(hdr["x_buf"], hdr["x_mat"], r0)
            if hdr["d_buf"] >= 0:
                put(hdr["d_buf"], tile_of(c_dirs, r0))
                save(hdr["d_buf"], hdr["d_mat"], r0)
            for (kind, sa, wa, ka, sb, wb, kb, nn, col, wld, kr, dst, bias,
                 mask_in, mask_out, m) in ops:
                if kind == 2:   # the cotangent, split at gr_cols
                    gt = tile_of(c_g, r0)
                    put(hdr["gr_buf"], gt[:, :hdr["gr_cols"]])
                    save(hdr["gr_buf"], hdr["gr_mat"], r0)
                    if hdr["gs_buf"] >= 0:
                        put(hdr["gs_buf"], gt[:, hdr["gr_cols"]:])
                        save(hdr["gs_buf"], hdr["gs_mat"], r0)
                    continue
                assert 0 < nn <= fused_mlp.BWD_MAX_N and nn % 16 == 0
                # a stage (forward: at most 64 weight rows; dX: a 64-column
                # strip and a multiple of 64 of its rows) fits a slot, with
                # what a 64-row tile reads past it
                shape = fused_mlp.OpShape(kind, ka, kb, wld, col, nn)
                assert kr % (16 if kind == 0 else 64) == 0
                assert kind != 0 or kr <= 64
                assert fused_mlp._touch(shape, kr) <= slot
                acc = 0
                for src, wo, k in ((sa, wa, ka), (sb, wb, kb)):
                    if k:
                        a = [buf(src, k, 0, p) for p in range(planes)]
                        # forward: columns col.. of the (k, wld) block;
                        # dX: rows col.. of the (wld, k) block, transposed;
                        # each copied in the memory order of the plain
                        # version's operand (w.t() of an (out, in) weight,
                        # and the weight itself), so that the same BLAS
                        # path sums in the same order and a wide net's
                        # bf16 roundings agree (the kernels' own order is
                        # held on the card)
                        wt = ([t[:, col:col + nn].t().contiguous().t()
                               for t in block(wo, k, wld)] if kind == 0
                              else [t[col:col + nn].t().contiguous()
                                    for t in block(wo, wld, k)])
                        acc = acc + mm(a, wt)
                if kind == 0:
                    acc = acc + packed.biases[bias:bias + nn]
                    if mask_out >= 0:
                        acc = torch.relu(acc)
                        masks[mask_out] = acc > 0 if hi_lo else bf(acc) > 0
                elif mask_in >= 0:
                    acc = torch.where(masks[mask_in], acc, 0.0)
                put(dst, acc, col)
                save(dst, m, r0, col, nn)
        # Phase 2 over the chunk's workspace rows.
        splits, split_rows = fused_mlp.bwd_splits(r_pad)
        for s in range(splits):
            s0, s1 = s * split_rows, min(r_pad, (s + 1) * split_rows)
            part = torch.zeros(fused_mlp.part_stride(packed.grad_total))
            for am, k0, kc, ym, n0, nc, off, ld, db, _ in jobs.tolist():
                a = [mat(am, p)[s0:s1, k0:k0 + kc] for p in range(planes)]
                y = [mat(ym, p)[s0:s1, n0:n0 + nc] for p in range(planes)]
                prod = mm([t.t() for t in a], y)
                tile = part[off + k0 * ld: off + (k0 + kc) * ld].view(kc, ld)
                tile[:, n0:n0 + nc] = prod
                if db >= 0:
                    part[db + n0: db + n0 + nc] = sum(y).sum(0)
            slots.append(part)
    flat = slots[0][:packed.grad_total].clone()
    for part in slots[1:]:
        flat += part[:packed.grad_total]
    return fused_mlp.unpack_grads(packed, flat)


@pytest.mark.parametrize("arch, n, chunk, min_split", [
    (dict(depth=6, width=64, use_viewdirs=True), 549, 256, 2048),
    (dict(depth=6, width=40, use_viewdirs=False), 549, 256, 2048),  # pad 48
    (dict(depth=8, width=32, use_viewdirs=True), 549, 256, 2048),
    (dict(depth=6, width=64, use_viewdirs=True, hi_lo=True), 549, 256, 2048),
    (dict(depth=6, width=40, use_viewdirs=False, hi_lo=True), 549, 256, 2048),
    # rows not a multiple of the tile or the chunk, phase 2 in 9 splits
    (dict(depth=6, width=64, use_viewdirs=True), 1100, 1200, 128),
    # fewer rows than one tile
    (dict(depth=6, width=64, use_viewdirs=True), 50, 256, 2048),
    # more than one chunk, each in several splits
    (dict(depth=6, width=64, use_viewdirs=True), 700, 192, 64),
    # wider than one 256-column pass: every layer in two or three passes,
    # each with its own mask block; 128-, 64-, 32- and 16-point tiles
    (dict(depth=3, width=288, use_viewdirs=True), 150, 256, 2048),
    (dict(depth=2, width=512, use_viewdirs=True), 150, 256, 2048),
    (dict(depth=3, width=384, use_viewdirs=True, hi_lo=True), 100, 256,
     2048),
    (dict(depth=8, width=576, use_viewdirs=False), 70, 256, 2048),
    (dict(depth=8, width=608, use_viewdirs=True, hi_lo=True), 40, 256,
     2048),
    # deeper than the old tables (64 workspace matrices, 96 operations):
    # 68 matrices at 64-point tiles, 111 operations at 32-point tiles, a
    # whole 256-column mask block per pass
    (dict(depth=30, width=256, use_viewdirs=True), 100, 256, 2048),
    (dict(depth=26, width=384, use_viewdirs=True), 40, 256, 2048),
    # masks sized by the layer's columns: 16-wide layers at 128-, 64- and
    # 32-point tiles; 866x16 keeps its tables in device memory
    (dict(depth=40, width=16, use_viewdirs=True), 150, 256, 2048),
    (dict(depth=200, width=16, use_viewdirs=True), 100, 256, 2048),
    (dict(depth=866, width=16, use_viewdirs=True), 40, 256, 2048),
    (dict(depth=60, width=64, use_viewdirs=True, hi_lo=True), 70, 256,
     2048),
    (dict(depth=600, width=16, use_viewdirs=True, hi_lo=True), 40, 256,
     2048),
    # 32-point tiles, ragged in a 64-row phase-2 stage: the tiles past n
    # fill the stage
    (dict(depth=8, width=640, use_viewdirs=True), 96, 256, 2048),
    # the shallow wide nets at depth 1: bf16 16-point tiles; hi_lo 16-point
    # tiles of 128-column passes (a 256-column stage of two planes does
    # not fit twice); n not a multiple of 64
    (dict(depth=1, width=1696, use_viewdirs=True), 40, 256, 2048),
    (dict(depth=1, width=1472, use_viewdirs=True, hi_lo=True), 40, 256,
     2048),
])
def test_bwd_program_matches_plain(arch, n, chunk, min_split, monkeypatch):
    """The backward program, packed layout, workspace, job list, splits,
    chunks and slot order the kernels execute compute the plain backward
    (padding adds zero; rows past n contribute nothing)."""
    arch = dict(arch)
    hi_lo = arch.pop("hi_lo", False)
    vdirs = arch["use_viewdirs"]
    monkeypatch.setattr(fused_mlp, "BWD_MIN_SPLIT_ROWS", min_split)
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True, **arch)
    net = init_model(cfg.model_config(), seed=3, device="cpu")
    pts, dirs = _inputs(n, seed=5)
    pts, dirs = torch.from_numpy(pts), torch.from_numpy(dirs)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(n, 4 if vdirs else net.cfg.output_ch)).astype(np.float32))
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    ops, mats = fused_mlp.backward_counts(net.cfg, vdirs, hi_lo)
    assert int(packed.bwd_program[0]) == ops
    assert len(packed.ws_mats) == mats
    assert fused_mlp.backward_fits(net.cfg, vdirs, hi_lo)
    lay = fused_mlp._bwd_layout(net.cfg, vdirs, hi_lo)
    # the mask blocks, one per pass of each ReLU layer, one after another,
    # each the pass's bits at this tile
    entry = fused_mlp.mask_entry_bytes(lay.rows)
    sizes = [-(-min(256, fused_mlp._pad16(c) - c0) * 2 * entry // 16) * 16
             for c in [cfg.width] * cfg.depth + ([net.cfg.view_width]
                                                 if vdirs else [])
             for c0 in range(0, fused_mlp._pad16(c), 256)]
    assert [b for slot in lay.masks for b in slot] == [
        sum(sizes[:i]) for i in range(len(sizes))]
    got = _run_bwd_program(packed, pts, dirs if vdirs else None, g, chunk)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(
        net, pts, dirs if vdirs else None, g, cfg.pos_enc_L, hi_lo=hi_lo)
    assert set(got) == set(want) == {n for n, _ in net.named_parameters()}
    for name in want:
        scale = max(float(want[name].abs().max()), 1e-8)
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   want[name].numpy() / scale,
                                   atol=1e-4 if not hi_lo else 1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("vdirs, hi_lo", [(True, False), (False, True)])
def test_wrappers_on_cpu_take_the_plain_phases(vdirs, hi_lo, monkeypatch):
    """The chunked path through the three wrappers on CPU tensors (each
    phase's plain version, no launch) gives the plain backward, and the
    plain phase 1 fills the interpreter's workspace layout."""
    monkeypatch.setattr(fused_mlp, "BWD_MIN_SPLIT_ROWS", 64)
    monkeypatch.setattr(fused_mlp, "BWD_CHUNK_ROWS", 200)   # two chunks
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True, depth=6,
                       width=64, use_viewdirs=vdirs)
    net = init_model(cfg.model_config(), seed=4, device="cpu")
    n = 333
    pts, dirs = (torch.from_numpy(a) for a in _inputs(n, seed=7))
    dirs = dirs if vdirs else None
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=(n, 4 if vdirs else net.cfg.output_ch)).astype(np.float32))
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    before = (fused_mlp.bwd_workspace.launches,
              fused_mlp.weight_grads.launches,
              fused_mlp.reduce_partials.launches)
    got = fused_mlp.unpack_grads(
        packed, fused_mlp._launch_bwd(packed, pts, dirs, g))
    assert (fused_mlp.bwd_workspace.launches,
            fused_mlp.weight_grads.launches,
            fused_mlp.reduce_partials.launches) == before
    want = fused_mlp.fused_nerf_mlp_bwd_plain(net, pts, dirs, g,
                                              cfg.pos_enc_L, hi_lo=hi_lo)
    for name in want:
        scale = max(float(want[name].abs().max()), 1e-8)
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   want[name].numpy() / scale,
                                   atol=1e-4 if not hi_lo else 1e-5,
                                   err_msg=name)


def test_reduce_partials_sums_rows_in_order():
    """Slots of the real width (the 8x256 gradient) summed in slot order:
    (chunks x splits) slots of part_stride(total) floats."""
    packed = fused_mlp.pack_params(
        init_model(RenderConfig().model_config(), seed=0, device="cpu"), 10,
        True)
    total = packed.grad_total
    part = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2 * 3, fused_mlp.part_stride(total))).astype(np.float32))
    want = part[0, :total].clone()
    for s in range(1, part.shape[0]):
        want = want + part[s, :total]
    before = fused_mlp.reduce_partials.launches
    got = fused_mlp.reduce_partials(part, total)
    assert torch.equal(got, want)
    assert fused_mlp.reduce_partials.launches == before


def test_cpu_backward_takes_the_plain_version():
    _, net, cfg = _nets()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernel=True)
    pts, dirs = (torch.from_numpy(a) for a in _inputs(40))
    g = torch.ones(40, 4)
    counts = lambda: (fused_mlp.bwd_workspace.launches,
                      fused_mlp.weight_grads.launches,
                      fused_mlp.reduce_partials.launches)
    before = counts()
    got = fused_mlp.fused_nerf_mlp_bwd(net, pts, dirs, g, cfg)
    want = fused_mlp.fused_nerf_mlp_bwd_plain(net, pts, dirs, g, 10)
    for name in want:
        assert torch.equal(got[name], want[name])
    assert counts() == before


def test_backward_budget():
    """8x256 + view head: 10 recomputed layers, the cotangent's load and
    10 dX operations; 24 workspace matrices, 9,984 B per point (4,992 bf16
    columns); phase 1's shared memory within Hopper's 227 KB with five
    weight stages of 128-point tiles (three of 64-point tiles in hi_lo). A
    layer wider than 256 columns takes one operation per column pass and
    smaller tiles, in clusters; a net too deep for phase 1's masks does
    not fit, and says so."""
    mc = RenderConfig().model_config()
    ops, mats = fused_mlp.backward_counts(mc, True)
    assert (ops, mats) == (10 + 1 + 10, 24)
    assert fused_mlp.backward_fits(mc, True)
    assert fused_mlp.backward_fits(mc, True, hi_lo=True)
    # 64 + 32 + 8 x 256 + 256 + 128 + 16 + 16 + 128 + 256 + 8 x 256.
    assert fused_mlp.bwd_scratch_bytes(mc, True) == 4992 * 2
    assert fused_mlp.bwd_scratch_bytes(mc, True, hi_lo=True) == 4992 * 4
    for hi_lo, rows, stages in ((False, 128, 5), (True, 64, 3)):
        layout = fused_mlp._bwd_layout(mc, True, hi_lo)
        assert (layout.rows, layout.cluster, layout.kr, layout.stages) == (
            rows, 1, 32, stages)
        assert fused_mlp.bwd_smem_bytes(mc, True, hi_lo) <= fused_mlp.SMEM_LIMIT
    # 8x640: every layer in three passes (the view head's 320 in two);
    # 24,576 B of workspace per point, 32-point tiles.
    # 8x576 hi_lo: 44,288 B, 16-point tiles.
    wide = RenderConfig(width=640).model_config()
    assert fused_mlp.backward_counts(wide, True) == (
        8 * 3 + 3 + 2 + 1 + 2 + 3 + 3 + 7 * 3, 24)
    assert fused_mlp.bwd_scratch_bytes(wide, True) == 24_576
    lay = fused_mlp._bwd_layout(wide, True, False)
    assert (lay.rows, lay.cluster) == (32, 1)
    assert fused_mlp.backward_fits(wide, True)
    hi = RenderConfig(width=576).model_config()
    assert fused_mlp.bwd_scratch_bytes(hi, True, hi_lo=True) == 44_288
    lay = fused_mlp._bwd_layout(hi, True, True)
    assert (lay.rows, lay.cluster) == (16, 1)
    assert fused_mlp.backward_fits(hi, True, hi_lo=True)
    # Depth is bounded by phase 1's masks and tables: 100x256 (205
    # operations, 208 matrices) fits at 32-point tiles; 400x256's masks
    # (401 blocks of 1 KB at 16 points) leave no room at any tile, down to
    # the last tried, 16 points.
    assert fused_mlp.backward_counts(RenderConfig(depth=100).model_config(),
                                     True) == (205, 208)
    assert fused_mlp._bwd_layout(RenderConfig(depth=100).model_config(),
                                 True, False).rows == 32
    assert uses_kernel(RenderConfig(depth=100, use_kernel=True,
                                    compute_dtype="bfloat16"), backward=True)
    deep = RenderConfig(depth=400).model_config()
    assert not fused_mlp.backward_fits(deep, True)
    assert ("phase 1's buffers and masks of 16-point tiles"
            in fused_mlp.backward_misfit(deep, True))
    assert not uses_kernel(RenderConfig(depth=400, use_kernel=True,
                                        compute_dtype="bfloat16"),
                           backward=True)
    assert fused_mlp.backward_fits(RenderConfig(width=384).model_config(),
                                   True)
    # Narrow layers take mask blocks of their own columns: at 866x16 one
    # 32-point tile's 16 columns (32 lanes x 2-byte entries, 64 B) a layer,
    # the tables in shared memory beside them.
    lay = fused_mlp._bwd_layout(RenderConfig(depth=866, width=16)
                                .model_config(), True, False)
    assert (lay.rows, lay.cluster) == (32, 1)
    assert lay.prog_ints > fused_mlp.BWD_TABLES_BASE
    assert lay.masks[-1] == (866 * 64,)


# (depth, width, hi_lo): the forward's (points a tile, CTAs a cluster, weight
# rows a stage, stages, bytes) and phase 1's (points a tile, CTAs a cluster,
# tables in shared memory, weight rows a stage, stages, bytes); CLI shapes.
LAYOUTS = [
    (8, 256, False, (128, 1, 64, 4, 231_424), (128, 1, True, 32, 5, 217_088)),
    (8, 256, True, (64, 1, 64, 2, 231_424), (64, 1, True, 32, 3, 216_064)),
    (8, 512, False, (64, 1, 64, 2, 215_040), (32, 1, True, 64, 4, 226_304)),
    (8, 640, False, (64, 1, 32, 3, 232_448), (32, 1, True, 64, 3, 216_064)),
    (8, 384, True, (32, 1, 32, 3, 215_040), (32, 1, True, 32, 3, 230_400)),
    (32, 256, False, (128, 1, 64, 4, 232_448), (64, 1, True, 64, 3, 220_160)),
    (866, 16, False, (128, 1, 64, 8, 130_048), (32, 1, True, 64, 8, 219_136)),
    (1, 1696, False, (16, 1, 64, 3, 215_040), (16, 1, True, 64, 3, 221_184)),
    (2, 1312, False, (32, 1, 32, 3, 231_424), (16, 1, True, 64, 4, 232_448)),
    (5, 864, False, (32, 1, 64, 3, 224_256), (32, 1, True, 32, 5, 228_352)),
    (2, 1024, False, (32, 1, 64, 2, 206_848), (32, 1, True, 32, 4, 218_112)),
    (1, 1472, True, (16, 1, 16, 2, 231_424), (8, 1, False, 32, 3, 202_752)),
    (3, 960, True, (16, 1, 32, 3, 231_424), (16, 1, True, 32, 2, 206_848)),
    (5, 752, True, (16, 1, 32, 3, 206_848), (16, 1, True, 32, 3, 218_112)),
]


@pytest.mark.filterwarnings("ignore:netdepth=5")
@pytest.mark.parametrize("depth, width, hi_lo, fwd, bwd", LAYOUTS,
                         ids=[f"{d}x{w}{'-hi_lo' if h else ''}"
                              for d, w, h, _, _ in LAYOUTS])
def test_layouts_pinned(depth, width, hi_lo, fwd, bwd):
    """Each net's forward and phase-1 layout, as the measured rules pick
    them (_fwd_pick, _bwd_pick): tiles of 128 to 16 points (and, for phase
    1 at hi_lo 1x1424-1472, 8), each in a cluster of one CTA; rings of two
    to eight stages."""
    mc = RenderConfig(depth=depth, width=width).model_config()
    f = fused_mlp._fwd_layout(mc, True, hi_lo)
    b = fused_mlp._bwd_layout(mc, True, hi_lo)
    assert (f.rows, f.cluster, f.kr, f.stages, f.smem) == fwd
    assert (b.rows, b.cluster, b.prog_ints > fused_mlp.BWD_TABLES_BASE,
            b.kr, b.stages, b.smem) == bwd
    assert fused_mlp.kernel_fits(mc, True, hi_lo)
    assert fused_mlp.backward_fits(mc, True, hi_lo)


def test_every_layout_has_its_kernel():
    """Every tile the layouts try is a kernel the CUDA sources build and
    dispatch: the forward's (mode, points) and phase 1's (mode, points,
    tables in shared memory), each in a cluster of one CTA, and in a
    multicast cluster of 64 / T CTAs the entry points take (the
    ablation's); a layout with no kernel would only fail on the card."""
    csrc = os.path.join(os.path.dirname(fused_mlp.__file__), os.pardir,
                        "csrc")
    with open(os.path.join(csrc, "fused_mlp_fwd.cu")) as f:
        fwd_src = f.read()
    with open(os.path.join(csrc, "fused_mlp_bwd.cu")) as f:
        bwd_src = f.read()
    name = lambda flag: "true" if flag else "false"
    for hi_lo, tries in fused_mlp.FWD_TRIES.items():
        for rows, cluster in tries:
            assert cluster == 1 and max(1, 64 // rows) in (1, 2, 4)
            assert f"  FWD({name(hi_lo)}, {rows})\n" in fwd_src, (hi_lo, rows)
    for hi_lo, tries in fused_mlp.BWD_TRIES.items():
        built = (fused_mlp.TILE_ROWS_HI_LO if hi_lo
                 else fused_mlp.TILE_ROWS)
        for rows, cluster, shared in tries:
            assert rows in built and cluster == 1
            assert max(1, 64 // rows) in (1, 2, 4, 8)
            assert (f"  PHASE1({name(hi_lo)}, {rows}, {name(shared)})\n"
                    in bwd_src), (hi_lo, rows, shared)


@pytest.mark.parametrize("n_scenes, tiles, cluster", [
    (1, 1024, 1), (1, 4096, 2), (2, 13, 4), (3, 7, 8), (1, 1, 4),
    (4, 10, 2)])
def test_tile_groups_cover_every_tile(n_scenes, tiles, cluster):
    """The kernels' walk (tile_groups): every tile of every scene in
    exactly one group, each group within one scene, and only a scene's
    last group padded, with empty tiles."""
    groups = fused_mlp.tile_groups(n_scenes, tiles, cluster)
    seen = [(scene, t) for scene, ts in groups for t in ts if t is not None]
    assert sorted(seen) == [(s, t) for s in range(n_scenes)
                            for t in range(tiles)]
    for i, (scene, ts) in enumerate(groups):
        assert len(ts) == cluster
        last = i + 1 == len(groups) or groups[i + 1][0] != scene
        assert all(t is not None for t in ts) or last
        assert ts[0] is not None   # no group is all padding


@pytest.mark.filterwarnings("ignore:netdepth=5")
@pytest.mark.parametrize("depth, width", [
    (8, 256), (8, 640), (866, 16), (2, 1024), (1, 1696), (1, 1472), (5, 752),
    (3, 200)])
def test_every_try_fits_shared_memory(depth, width):
    """Every layout the tries give a net, at every stage size and in its
    multicast cluster too, fits Hopper's shared memory wherever it holds a
    stage; the one taken holds two at least; each operation's stage fits
    a slot."""
    mc = RenderConfig(depth=depth, width=width).model_config()
    for hi_lo in (False, True):
        for tries, layout, at in (
                (fused_mlp.FWD_TRIES, fused_mlp._fwd_layout,
                 fused_mlp._fwd_layout_at),
                (fused_mlp.BWD_TRIES, fused_mlp._bwd_layout,
                 fused_mlp._bwd_layout_at)):
            chosen = layout(mc, True, hi_lo)
            for entry in tries[hi_lo]:
                with mock.patch.dict(tries, {hi_lo: (entry,)}):
                    layout.cache_clear()
                    lay = layout(mc, True, hi_lo)
                assert lay.cluster == 1
                for cluster in (1, max(1, 64 // entry[0])):
                    for kr in fused_mlp.STAGE_ROWS:
                        lay = at(mc, True, hi_lo, entry[0], cluster,
                                 *entry[2:], kr)
                        if lay.stages >= 1:
                            assert lay.smem <= fused_mlp.SMEM_LIMIT, entry
            layout.cache_clear()
            shapes = (fused_mlp._fwd_shapes(mc, True)
                      if layout is fused_mlp._fwd_layout
                      else fused_mlp._bwd_shapes(mc, True))
            if chosen.stages >= 2:
                slot = chosen.slot // (2 if hi_lo else 1)
                for op in shapes:
                    if op.kind != fused_mlp._LOAD_G:
                        rows = fused_mlp.stage_rows(op, slot)
                        assert fused_mlp._touch(op, rows) <= slot


@pytest.mark.parametrize("width, serve, train", [
    (256, True, True),
    (384, True, True),     # column passes of 256
    (512, True, True),
    (704, True, True),     # where the JAX gate stops at depth 8
    (768, True, True),
    (1024, True, True),    # 32-point forward tiles
    (2944, True, True),    # 16-point tiles, both passes
    (2960, True, False),   # past phase 1's 16-point tiles
    (3216, False, False),  # past the forward's 16-point tiles
])
def test_kernel_gates_of_serving_and_training(width, serve, train):
    """A net goes to the forward kernel when it fits the forward's budget;
    it trains through the kernels only when the backward's fits too, and
    otherwise takes the module path for both passes of training; a net
    past the kernels is refused by name. Only a net that goes to the
    kernels is packed."""
    cfg = RenderConfig(width=width, use_kernel=True, compute_dtype="bfloat16",
                       depth=2)
    assert uses_kernel(cfg) is serve
    assert uses_kernel(cfg, backward=True) is train
    mc = cfg.model_config()
    why = (fused_mlp.forward_misfit(mc, True)
           or fused_mlp.backward_misfit(mc, True))
    assert (why is None) is train
    if not train:
        assert why.startswith("the forward's buffers of 16-point tiles" if
                              not serve else "phase 1's buffers and masks of "
                              "16-point tiles"), why
    net = init_model(cfg.model_config(), seed=0, device="cpu")
    for backward, packed in ((False, serve), (True, train)):
        got = prepare_params({"coarse": net}, cfg, backward)["coarse"]
        assert isinstance(got, fused_mlp.PackedMLP) is packed


# tests/test_pallas_generic.py's ARCHS: (depth, width, skips), bottleneck =
# width, view head = width / 2; depth 8 at every CLI width from 16 to
# 1024 in steps of 16, of which JAX admits 43 in bf16 (up to 688) and 38 in
# hi_lo (up to 608); deep nets at the CLI's skip, depths 9-60 in steps of 3
# and up to 866 at widths 16-400, where JAX admits 129 / 115; and the
# shallow wide nets, depths 1-5 at widths 704-1712, where JAX admits 157 /
# 108 (on 32- and 16-point forward tiles from 784 bf16 / 720 hi_lo). The
# port refuses none of them.
GATE_CASES = [
    pytest.param([(8, w, (5,)) for w in range(16, 1025, 16)], (43, 38),
                 (0, 0), id="cli-depth-8"),
    *[pytest.param([(d, w, s)], (1, 1), (0, 0), id=f"{d}x{w}-skips{s}")
      for d, w, s in [(4, 128, ()), (6, 256, (5,)), (10, 256, (5,)),
                      (8, 384, (5,)), (8, 256, (3, 6)), (3, 200, (0, 2))]],
    pytest.param([(d, w, (4,)) for d in [*range(9, 61, 3), 64, 100, 128, 177,
                                         400, 509, 600, 866]
                  for w in (16, 64, 128, 192, 256, 320, 384, 400)],
                 (129, 115), (0, 0), id="deep"),
    pytest.param([(d, w, (4,)) for d in range(1, 6)
                  for w in range(704, 1713, 16)], (157, 108), (0, 0),
                 id="shallow-wide"),
]


@pytest.mark.parametrize("hi_lo", [False, True], ids=["bf16", "hi_lo"])
@pytest.mark.parametrize("archs, admits, refused", GATE_CASES)
def test_gates_cover_jax(archs, admits, refused, hi_lo):
    """Every net the JAX package sends through its Pallas kernels
    (``backward_fits_vmem``, its render gate) goes through the port's
    kernels for both passes; the CLI's architectures also by
    ``uses_kernel``, and every shallow wide net by ``uses_kernel`` at the
    CLI's shape of its depth and width (no skip: the skip before layer 4
    is absent at depth 1-4 and dropped by the CLI at depth 5). ``refused``
    counts the admitted nets the port's gates refuse: none."""
    admitted = shut_out = 0
    for depth, width, skips in archs:
        jmc = JaxModelConfig(depth=depth, width=width, skips=skips,
                             bottleneck_ch=width, view_width=width // 2)
        if not backward_fits_vmem(jmc, hi_lo):
            continue
        admitted += 1
        mc = ModelConfig(depth=depth, width=width, skips=skips,
                         bottleneck_ch=width, view_width=width // 2)
        cfg = RenderConfig(depth=depth, width=width, use_kernel=True,
                           compute_dtype="float32" if hi_lo else "bfloat16",
                           fp32_precision="high")
        why = (fused_mlp.forward_misfit(mc, True, hi_lo)
               or fused_mlp.backward_misfit(mc, True, hi_lo))
        if why is not None:
            shut_out += 1
        assert fused_mlp.kernel_fits(mc, True, hi_lo), (depth, width, why)
        assert fused_mlp.backward_fits(mc, True, hi_lo), (depth, width, why)
        if cfg.model_config() == mc or (depth <= 5 and width >= 704):
            # an architecture the CLI can ask for
            assert uses_kernel(cfg) and uses_kernel(cfg, backward=True)
    assert (admitted, shut_out) == (admits[hi_lo], refused[hi_lo])


def test_bwd_memory_refused_by_name():
    """A backward call's bytes, and the refusal past the card: 147x128 hi_lo
    (the widest workspace a point JAX admits, 152,576 B) cuts its chunks to
    53,248 points (8,124,366,848 B of workspace, within the 8 GiB budget);
    131,072 points then take three chunks, with 26 + 26 + 12 partial slots
    of its gradient. A stack of scenes takes that once per scene, and on
    an 80 GB card (40 GB a call) the fifth scene is refused."""
    cfg = RenderConfig(depth=147, width=128)
    mc = cfg.model_config()
    assert fused_mlp.bwd_scratch_bytes(mc, True, True) == 152_576
    assert fused_mlp.bwd_chunk_rows(mc, True, True) == 53_248
    assert fused_mlp.bwd_chunk_rows(RenderConfig().model_config(),
                                    True) == fused_mlp.BWD_CHUNK_ROWS
    net = init_model(mc, seed=0, device="cpu")
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True, True)
    n_s = 131_072
    splits = [fused_mlp.bwd_splits(r)[0] for r in (53_248, 53_248, 24_576)]
    assert splits == [26, 26, 12]
    one = (53_248 * packed.ws_cols * 2
           + sum(splits) * fused_mlp.part_stride(packed.grad_total) * 4)
    assert fused_mlp.bwd_call_bytes(packed, n_s) == one
    card = 80 * 10 ** 9
    for scenes in (1, 4, 5):
        stack = fused_mlp.pack_params_stack([net] * scenes, cfg.pos_enc_L,
                                            True, True)
        assert fused_mlp.bwd_call_bytes(stack, n_s) == scenes * one
        if scenes < 5:
            assert fused_mlp.check_bwd_memory(stack, n_s, card) == scenes * one
        else:
            with pytest.raises(ValueError, match=(
                    r"depth 147 width 128 \+view head hi_lo: a backward call "
                    r"over 5 scene\(s\) of 131072 points needs .* at most 4 "
                    r"scene\(s\) of 131072 points fit")):
                fused_mlp.check_bwd_memory(stack, n_s, card)
