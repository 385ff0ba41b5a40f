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
# matrices) at 64 points.
WIDE = {"wide-3x384": dict(depth=3, width=384),
        "wide-3x288": dict(depth=3, width=288),
        "deep-30x32": dict(depth=30, width=32),
        "deep-31x16": dict(depth=31, width=16)}


@pytest.mark.parametrize("case", [
    "viewdirs", "no_viewdirs", "ragged", "hi_lo",
    "wide-3x384", "wide-3x384-hi_lo", "wide-3x288", "wide-3x288-hi_lo",
    "deep-30x32", "deep-30x32-hi_lo", "deep-31x16", "deep-31x16-hi_lo"])
def test_plain_backward_matches_jax_kernel(case):
    """jax.grad through the Pallas backward (interpret mode) vs the port's
    autograd Function on CPU tensors (the plain backward), same weights."""
    vdirs = case != "no_viewdirs"
    hi_lo = case.endswith("hi_lo")
    n = 300 if case == "ragged" else 64 if "deep" in case else 256
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


def _mask_bits(rows, word0, groups, nn):
    """Where phase 1 keeps the ReLU bits of a column pass of nn columns at
    tiles of ``rows`` points, as bit indices from the mask region's start,
    (rows, nn): mlp_tile.cuh's WarpGrid gives row r and column c to warp
    (row group, column group) and lane, as bit 4 nt + 2 hh + e of its word
    for m16 tile mt, and the block of ``groups`` column groups from word
    ``word0`` keeps that word at ((mt * row groups + row group) * groups +
    column group) * 32 + lane (fused_mlp_bwd.cu's Field notes)."""
    m16, wn, _, row_groups = fused_mlp._warp_grid(rows)
    r = torch.arange(rows)[:, None]
    c = torch.arange(nn)[None, :]
    r16, ci = r % 16, c % wn
    assert bool((c // wn < groups).all())
    lane = (r16 % 8) * 4 + (ci % 8) // 2
    word = word0 + ((((r % (16 * m16)) // 16) * row_groups + r // (16 * m16))
                    * groups + c // wn) * 32 + lane
    return word * (wn // 16) * 8 + 4 * (ci // 8) + 2 * (r16 // 8) + ci % 2


def _run_bwd_program(packed, pts, dirs, g, chunk_rows):
    """What the CUDA backward does with a packed net, step for step, in
    PyTorch: the call walked in chunks of at most ``chunk_rows`` points. In
    each chunk, phase 1 walks tiles of the program's ``rows`` points over
    the chunk's workspace rows (``ws_rows``: past n, zero points): the
    program's shared-memory buffers (one flat array, so buffers laid over
    each other share storage), its mask blocks (the bits at the places the
    kernel's threads keep them, each block inside the mask region and
    apart from the others), operations (each a pass of at most
    ``BWD_MAX_N`` output columns from column ``col`` on, over the whole K
    of its operands) and epilogues, the (hi, lo) planes and three products
    in hi_lo mode, rows past n zero, each pass's columns copied into its
    workspace matrix. The matrix and operation tables are read at the
    header's bases. Then phase 2 runs every job over every split of the
    chunk's rows into that chunk's partial slots, and the slots are summed
    in (chunk, split) order."""
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
    assert hdr["smem"] <= fused_mlp.SMEM_LIMIT
    # phase 1 copies the whole program, or its header and buffer table,
    # into shared memory ahead of the buffers
    assert hdr["prog_len"] in (hdr["jobs_off"], fused_mlp.BWD_TABLES_BASE)
    assert 4 * hdr["prog_len"] <= min(off for off, _, c in bufs if c)
    # the mask blocks: each inside the region, none overlapping another
    m16, wn, _, row_groups = fused_mlp._warp_grid(rows)
    region = 8 * (hdr["ring_off"] - hdr["mask_off"])
    blocks = sorted({(o[12], o[15]) for o in ops if o[12] >= 0})
    ends = [w0 + 32 * row_groups * cg * m16 for w0, cg in blocks]
    assert all(e <= w1 for e, (w1, _) in zip(ends, blocks[1:]))
    assert not blocks or ends[-1] * (wn // 16) * 8 <= region
    assert {(o[9], o[15]) for o in ops if o[9] >= 0} <= set(blocks)
    bf = lambda t: t.to(torch.bfloat16).float()
    w = packed.weights.float()
    n = pts.shape[0]
    enc = positional_encoding(pts, hdr["n_freqs"])
    smem = torch.zeros(hdr["smem"] // 2)   # bf16 slots, by element

    def buf(b, plane=0):
        off, ld, cols = bufs[b]
        at = off // 2 + plane * rows * ld
        return smem[at: at + rows * ld].view(rows, ld)[:, :cols]

    def block(off, k, nn, ld, lo):   # a (k, nn) weight slice's planes
        return [w.as_strided((k, nn), (ld, 1), off + p * lo)
                for p in range(planes)]

    def mm(a, b):   # planes @ planes: hi*hi (+ hi*lo + lo*hi)
        out = a[0] @ b[0]
        return out + a[0] @ b[1] + a[1] @ b[0] if hi_lo else out

    def put(b, v, col=0):   # a value into buffer b's planes from column col
        hi = bf(v)
        buf(b, 0)[:, col:col + v.shape[1]] = hi
        if hi_lo:
            buf(b, 1)[:, col:col + v.shape[1]] = bf(v - hi)

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
            at = cap * (col + plane * cols)
            return ws[at: at + cap * cols].view(cap, cols)

        def save(b, m, r0, col=0, nn=None):   # columns of buffer b
            for plane in range(planes):
                dst = mat(m, plane)
                end = dst.shape[1] if nn is None else col + nn
                dst[r0:r0 + rows, col:end] = buf(b, plane)[:, col:end]

        c_pts, c_g = pts[c0:c0 + r], g[c0:c0 + r]
        c_enc = enc[c0:c0 + r]
        c_dirs = None if dirs is None else dirs[c0:c0 + r]
        masks = torch.zeros(region, dtype=torch.bool)
        r_pad = fused_mlp.ws_rows(r, rows)
        for r0 in range(0, r_pad, rows):
            put(hdr["x_buf"], tile_of(c_enc, r0))
            save(hdr["x_buf"], hdr["x_mat"], r0)
            if hdr["d_buf"] >= 0:
                put(hdr["d_buf"], tile_of(c_dirs, r0))
                save(hdr["d_buf"], hdr["d_mat"], r0)
            for (kind, sa, wa, ka, sb, wb, kb, bias, nn, mask_in, dst, m,
                 mask_out, col, wld, mask_cg) in ops:
                if kind == 2:   # the cotangent, split at gr_cols
                    gt = tile_of(c_g, r0)
                    put(hdr["gr_buf"], gt[:, :hdr["gr_cols"]])
                    save(hdr["gr_buf"], hdr["gr_mat"], r0)
                    if hdr["gs_buf"] >= 0:
                        put(hdr["gs_buf"], gt[:, hdr["gr_cols"]:])
                        save(hdr["gs_buf"], hdr["gs_mat"], r0)
                    continue
                assert 0 < nn <= fused_mlp.BWD_MAX_N and nn % 16 == 0
                # a slab of 16 rows (forward) or nn rows (dX) fits a stage
                assert 16 * (nn + fused_mlp.PAD) <= hdr["stage_elems"]
                acc = 0
                for src, wo, k in ((sa, wa, ka), (sb, wb, kb)):
                    if k:
                        a = [buf(src, p)[:, :k] for p in range(planes)]
                        # forward: columns col.. of the (k, wld) block;
                        # dX: rows col.. of the (wld, k) block, transposed
                        wt = (block(wo, k, nn, wld, k * wld) if kind == 0
                              else [t.t() for t in
                                    block(wo, nn, k, k, k * wld)])
                        acc = acc + mm(a, wt)
                if kind == 0:
                    acc = acc + packed.biases[bias:bias + nn]
                    if mask_out >= 0:
                        acc = torch.relu(acc)
                        at = _mask_bits(rows, mask_out, mask_cg, nn)
                        assert len(at.unique()) == at.numel()
                        masks[at] = acc > 0 if hi_lo else bf(acc) > 0
                elif mask_in >= 0:
                    acc = torch.where(masks[_mask_bits(rows, mask_in, mask_cg,
                                                       nn)], acc, 0.0)
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
    ops, mats = fused_mlp.backward_counts(net.cfg, vdirs)
    assert int(packed.bwd_program[0]) == ops
    assert len(packed.ws_mats) == mats
    assert fused_mlp.backward_fits(net.cfg, vdirs, hi_lo)
    if cfg.width >= fused_mlp.BWD_MAX_N:
        # one whole grid's block per pass, numbered in order: the layout
        # of nets this wide before narrow passes were sized
        lay = fused_mlp._bwd_layout(net.cfg, vdirs, hi_lo)
        m16 = fused_mlp._warp_grid(lay.rows)[0]
        blocks = [b for slot in lay.masks for b in slot]
        assert blocks == [(512 * m16 * k, 256 // fused_mlp._warp_grid(
            lay.rows)[1]) for k in range(len(blocks))]
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
    columns); phase 1's shared memory within Hopper's 227 KB with three
    weight stages of 128-point tiles (two of 64-point tiles in hi_lo). A
    layer wider than 256 columns takes one operation per column pass and
    smaller tiles; a net too deep for the program table does not fit, and
    says so."""
    mc = RenderConfig().model_config()
    ops, mats = fused_mlp.backward_counts(mc, True)
    assert (ops, mats) == (10 + 1 + 10, 24)
    assert fused_mlp.backward_fits(mc, True)
    assert fused_mlp.backward_fits(mc, True, hi_lo=True)
    # 64 + 32 + 8 x 256 + 256 + 128 + 16 + 16 + 128 + 256 + 8 x 256.
    assert fused_mlp.bwd_scratch_bytes(mc, True) == 4992 * 2
    assert fused_mlp.bwd_scratch_bytes(mc, True, hi_lo=True) == 4992 * 4
    for hi_lo, rows, stages in ((False, 128, 3), (True, 64, 2)):
        layout = fused_mlp._bwd_layout(mc, True, hi_lo)
        assert (layout.rows, layout.stages) == (rows, stages)
        assert fused_mlp.bwd_smem_bytes(mc, True, hi_lo) <= fused_mlp.SMEM_LIMIT
    # 8x640: every layer in three passes (the view head's 320 in two);
    # 24,576 B of workspace per point. 8x576 hi_lo: 44,288 B.
    wide = RenderConfig(width=640).model_config()
    assert fused_mlp.backward_counts(wide, True) == (
        8 * 3 + 3 + 2 + 1 + 2 + 3 + 3 + 7 * 3, 24)
    assert fused_mlp.bwd_scratch_bytes(wide, True) == 24_576
    assert fused_mlp._bwd_layout(wide, True, False).rows == 32
    assert fused_mlp.backward_fits(wide, True)
    hi = RenderConfig(width=576).model_config()
    assert fused_mlp.bwd_scratch_bytes(hi, True, hi_lo=True) == 44_288
    assert fused_mlp._bwd_layout(hi, True, True).rows == 32
    assert fused_mlp.backward_fits(hi, True, hi_lo=True)
    # Depth is bounded by phase 1's masks alone: 100x256 (205 operations,
    # 208 matrices, past the old tables' 96 and 64) fits at 32-point tiles;
    # 400x256's masks (401 blocks of 1 KB) leave no room at any tile.
    assert fused_mlp.backward_counts(RenderConfig(depth=100).model_config(),
                                     True) == (205, 208)
    assert uses_kernel(RenderConfig(depth=100, use_kernel=True,
                                    compute_dtype="bfloat16"), backward=True)
    deep = RenderConfig(depth=400).model_config()
    assert not fused_mlp.backward_fits(deep, True)
    assert ("phase 1's buffers and masks of 32-point tiles"
            in fused_mlp.backward_misfit(deep, True))
    assert not uses_kernel(RenderConfig(depth=400, use_kernel=True,
                                        compute_dtype="bfloat16"),
                           backward=True)
    assert fused_mlp.backward_fits(RenderConfig(width=384).model_config(),
                                   True)
    # Narrow layers take blocks of the warp columns they reach: at 866x16
    # one 32-point tile's 16 columns (2 warps x 32 lanes x 16-bit words,
    # 128 B) a layer; the tables (125 KB) stay in device memory.
    lay = fused_mlp._bwd_layout(RenderConfig(depth=866, width=16)
                                .model_config(), True, False)
    assert (lay.rows, lay.prog_ints) == (32, fused_mlp.BWD_TABLES_BASE)
    assert lay.ring_off - lay.mask_off == 867 * 128


@pytest.mark.parametrize("width, serve, train", [
    (256, True, True),
    (384, True, True),     # column passes of phase 1's 256-column grid
    (512, True, True),
    (704, True, True),     # where the JAX gate stops at depth 8
    (768, True, True),
    (1024, False, False),  # past the forward's shared memory
])
def test_kernel_gates_of_serving_and_training(width, serve, train):
    """A net goes to the forward kernel when it fits the forward's budget;
    it trains through the kernels only when the backward's fits too, and
    otherwise takes the module path for both passes of training. Only a
    net that goes to the kernels is packed."""
    cfg = RenderConfig(width=width, use_kernel=True, compute_dtype="bfloat16",
                       depth=2)
    assert uses_kernel(cfg) is serve
    assert uses_kernel(cfg, backward=True) is train
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
# 108 and the port's forward refuses 132 / 103 (below).
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
                  for w in range(704, 1713, 16)], (157, 108), (132, 103),
                 id="shallow-wide"),
]


@pytest.mark.parametrize("hi_lo", [False, True], ids=["bf16", "hi_lo"])
@pytest.mark.parametrize("archs, admits, refused", GATE_CASES)
def test_gates_cover_jax(archs, admits, refused, hi_lo):
    """Every net the JAX package sends through its Pallas kernels
    (``backward_fits_vmem``, its render gate) goes through the port's
    kernels for both passes; the CLI's architectures also by
    ``uses_kernel``. The one exception, not yet ported: shallow nets 720
    or more wide, whose buffers the forward's smallest tile cannot hold
    beside two weight stages (at depth 1 near the widest, phase 1's
    neither); each is refused by name."""
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
        why = fused_mlp.forward_misfit(mc, True, hi_lo)
        if why is not None and depth <= 5 and width >= 720:
            shut_out += 1
            assert why.startswith("the forward's buffers of"), why
            bwd = fused_mlp.backward_misfit(mc, True, hi_lo)
            assert bwd is None or (depth == 1 and bwd.startswith(
                "phase 1's buffers and masks")), (depth, width, bwd)
            assert not uses_kernel(cfg)
            continue
        assert fused_mlp.kernel_fits(mc, True, hi_lo), (depth, width, why)
        assert fused_mlp.backward_fits(mc, True, hi_lo), (
            depth, width, fused_mlp.backward_misfit(mc, True, hi_lo))
        if cfg.model_config() == mc:   # an architecture the CLI can ask for
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
