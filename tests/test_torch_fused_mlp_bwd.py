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

from nerfmlp_tpu.config import RenderConfig as JaxRenderConfig
from nerfmlp_tpu.ops.pallas_mlp import fused_nerf_mlp as jax_fused

from nerfmlp_torch.config import RenderConfig
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


def _run_bwd_program(packed, pts, dirs, g, chunk_rows):
    """What the CUDA backward does with a packed net, step for step, in
    PyTorch: the call walked in chunks of at most ``chunk_rows`` points. In
    each chunk, phase 1 walks tiles of ``bwd_tile_rows`` points: the
    program's shared-memory buffers (one flat array, so buffers laid over
    each other share storage), its mask slots, operations and epilogues,
    the (hi, lo) planes and three products in hi_lo mode, rows past n zero,
    each result copied into its workspace matrix. Then phase 2 runs every
    job over every split of the chunk's rows into that chunk's partial
    slots, and the slots are summed in (chunk, split) order."""
    prog = packed.bwd_program.tolist()
    hdr = dict(zip(fused_mlp._BWD_HEADER, prog))
    hi_lo = packed.hi_lo
    planes = 2 if hi_lo else 1
    bufs = [prog[fused_mlp.BWD_HEADER_INTS + 3 * i:
                 fused_mlp.BWD_HEADER_INTS + 3 * i + 3]
            for i in range(fused_mlp.BWD_MAX_BUFS)]
    mats = [prog[fused_mlp.BWD_MATS_BASE + 2 * i:
                 fused_mlp.BWD_MATS_BASE + 2 * i + 2]
            for i in range(fused_mlp.BWD_MAX_MATS)]
    ops = [prog[fused_mlp.BWD_OPS_BASE + 16 * i:
                fused_mlp.BWD_OPS_BASE + 16 * (i + 1)]
           for i in range(hdr["n_ops"])]
    jobs = np.asarray(prog[hdr["jobs_off"]:]).reshape(hdr["n_jobs"], 10)
    rows = fused_mlp.bwd_tile_rows(hi_lo)
    bf = lambda t: t.to(torch.bfloat16).float()
    w = packed.weights.float()
    n = pts.shape[0]
    enc = positional_encoding(pts, hdr["n_freqs"])
    smem = torch.zeros(hdr["smem"] // 2)   # bf16 slots, by element

    def buf(b, plane=0):
        off, ld, cols = bufs[b]
        at = off // 2 + plane * rows * ld
        return smem[at: at + rows * ld].view(rows, ld)[:, :cols]

    def block(off, k, cols):   # a packed (k, cols) weight's planes
        size = k * cols
        return [w[off + p * size: off + (p + 1) * size].view(k, cols)
                for p in range(planes)]

    def mm(a, b):   # planes @ planes: hi*hi (+ lo*hi + hi*lo)
        out = a[0] @ b[0]
        return out + a[1] @ b[0] + a[0] @ b[1] if hi_lo else out

    def put(b, v):   # a value into buffer b's planes, from column 0
        hi = bf(v)
        buf(b, 0)[:, :v.shape[1]] = hi
        if hi_lo:
            buf(b, 1)[:, :v.shape[1]] = bf(v - hi)

    def tile_of(t, r0):
        out = torch.zeros(rows, t.shape[1])
        m = max(0, min(rows, t.shape[0] - r0))
        out[:m] = t[r0:r0 + m]
        return out

    chunks = [(c0, min(chunk_rows, n - c0)) for c0 in range(0, n, chunk_rows)]
    cap = -(-min(n, chunk_rows) // rows) * rows
    slots = []
    for c0, r in chunks:
        ws = torch.zeros(cap * hdr["ws_cols"])

        def mat(m, plane=0):
            col, cols = mats[m]
            at = cap * (col + plane * cols)
            return ws[at: at + cap * cols].view(cap, cols)

        def save(b, m, r0):   # the matrix's columns of buffer b
            for plane in range(planes):
                dst = mat(m, plane)
                dst[r0:r0 + rows] = buf(b, plane)[:, :dst.shape[1]]

        c_pts, c_g = pts[c0:c0 + r], g[c0:c0 + r]
        c_enc = enc[c0:c0 + r]
        c_dirs = None if dirs is None else dirs[c0:c0 + r]
        masks = {}
        for r0 in range(0, r, rows):
            put(hdr["x_buf"], tile_of(c_enc, r0))
            save(hdr["x_buf"], hdr["x_mat"], r0)
            if hdr["d_buf"] >= 0:
                put(hdr["d_buf"], tile_of(c_dirs, r0))
                save(hdr["d_buf"], hdr["d_mat"], r0)
            for (kind, sa, wa, ka, sb, wb, kb, bias, nn, mask_in, dst, m,
                 mask_out, *_) in ops:
                if kind == 2:   # the cotangent, split at gr_cols
                    gt = tile_of(c_g, r0)
                    put(hdr["gr_buf"], gt[:, :hdr["gr_cols"]])
                    save(hdr["gr_buf"], hdr["gr_mat"], r0)
                    if hdr["gs_buf"] >= 0:
                        put(hdr["gs_buf"], gt[:, hdr["gr_cols"]:])
                        save(hdr["gs_buf"], hdr["gs_mat"], r0)
                    continue
                acc = 0
                for src, wo, k in ((sa, wa, ka), (sb, wb, kb)):
                    if k:
                        a = [buf(src, p)[:, :k] for p in range(planes)]
                        wt = (block(wo, k, nn) if kind == 0
                              else [t.t() for t in block(wo, nn, k)])
                        acc = acc + mm(a, wt)
                if kind == 0:
                    acc = acc + packed.biases[bias:bias + nn]
                    if mask_out >= 0:
                        acc = torch.relu(acc)
                        masks[mask_out] = acc > 0 if hi_lo else bf(acc) > 0
                elif mask_in >= 0:
                    acc = torch.where(masks[mask_in], acc, 0.0)
                put(dst, acc)
                save(dst, m, r0)
        # Phase 2 over the chunk's rows, rounded up to the tile.
        r_pad = -(-r // rows) * rows
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
    weight stages (two in hi_lo); a net too deep for the program table, or
    too wide for the warp grid, does not fit."""
    mc = RenderConfig().model_config()
    ops, mats = fused_mlp.backward_counts(mc, True)
    assert (ops, mats) == (10 + 1 + 10, 24)
    assert fused_mlp.backward_fits(mc, True)
    assert fused_mlp.backward_fits(mc, True, hi_lo=True)
    # 64 + 32 + 8 x 256 + 256 + 128 + 16 + 16 + 128 + 256 + 8 x 256.
    assert fused_mlp.bwd_scratch_bytes(mc, True) == 4992 * 2
    assert fused_mlp.bwd_scratch_bytes(mc, True, hi_lo=True) == 4992 * 4
    for hi_lo, stages in ((False, 3), (True, 2)):
        layout = fused_mlp._bwd_smem_layout(mc, True, hi_lo)
        assert layout[-2] == stages
        assert fused_mlp.bwd_smem_bytes(mc, True, hi_lo) <= fused_mlp.SMEM_LIMIT
    deep = RenderConfig(depth=100).model_config()
    assert not fused_mlp.backward_fits(deep, True)
    assert not fused_mlp.backward_fits(RenderConfig(width=384).model_config(),
                                       True)
    assert not uses_kernel(RenderConfig(depth=100, use_kernel=True,
                                        compute_dtype="bfloat16"))


@pytest.mark.parametrize("width, serve, train", [
    (256, True, True),
    (384, True, False),    # wider than phase 1's warp grid
    (512, True, False),
    (1024, False, False),  # past the forward's shared memory too
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
