#!/usr/bin/env python3
"""Drive the PyTorch port (nerfmlp_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the port from csrc/ (nvcc, in parallel);
  2. hold the fused MLP kernel against its plain PyTorch version at the
     serving path's shapes (8x256 + view head, 262,144 and 524,288 points
     from real rays of a serving pose), in hi_lo mode (fp32 'high') at the
     first shape, at one generic architecture (depth 6, width 128, no
     view head) and at width 512 with the view head (two 256-column
     passes per layer) at both shapes; time both versions, and beside
     them the module path (use_kernel=False) at the same shapes;
  3. serve 400x400 frames (64+128 samples, shared net, bf16, kernel on)
     over HTTP from RenderServer on 127.0.0.1 — png, npy and json — and
     check the kernel launches per frame, the images, and the frame
     against the same frame rendered with use_kernel=False on the card;
     then profile one frame;
  4. hold the forward kernel and the backward's three kernels (phase 1:
     recompute + dX into a workspace; phase 2: dW and db partials; their
     reduction) against their plain versions at the flagship train step's
     shapes (1024 rays of a pose x 64 / 128 samples, a cotangent from a
     seeded MSE loss), each alone and the backward as a whole, and time
     each; the backward also in hi_lo mode, beside the bf16 kernels as a
     control, and at the generic architecture; repeat runs must give the
     same bits;
  5. train the flagship recipe (8x256, batch 1024, 64+128 samples, bf16,
     perturb) for 300 steps through the Trainer on a 64x64 synthetic scene
     made here, with the kernels and with use_kernel=False: the loss must
     fall, held-out PSNR reach 20 dB and agree within 1 dB, and each step
     launch each of the four kernels twice; time the runs and profile one
     step.
Then it prints the kernels' JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Weights are random, from a seed.
It exits non-zero, printing no result, without a CUDA device.
"""

import dataclasses
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_MEM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
SEED = 0
H = W = 400
FOCAL = 555.5555          # the Blender scenes' focal at 400x400
TILE = 4096
SERVE_POSE = (30.0, -30.0, 4.0)  # theta, phi, radius
TRAIN_RAYS = 1024         # the flagship train step's batch
TRAIN_STEPS = 300
TRAIN_WH = 64             # the synthetic training scene's image size
PSNR_MIN = 20.0           # held-out PSNR after TRAIN_STEPS steps, dB
PSNR_GAP = 1.0            # ... and its distance from use_kernel=False
KERNEL_TOL = 1e-2         # max |kernel - plain| / max |plain|, bf16: a
#                           bf16 rounding that flips cascades through 8 layers
HI_LO_TOL = 1e-4          # the same in hi_lo mode: fp32-grade activations,
#                           only the fp32 summation order differs
HI_LO_BWD_TOL = 1e-3      # the backward in hi_lo mode. Its activations
#                           carry bf16x3 noise, so the ReLU masks of the
#                           pre-activations nearest 0 flip between any two
#                           summation orders; the bar sits between the
#                           hi_lo reading (1.6e-4) and the bf16 kernel's
#                           distance from the same reference (6.0e-3), a
#                           control that check_backward asserts is above it
PHASE1_TOL = 3e-2         # the backward's phase-1 workspace vs its plain
#                           version, relative L2 per matrix: a ReLU mask
#                           that flips at a pre-activation within rounding
#                           of 0 zeroes (or keeps) a whole cotangent value,
#                           and the flip cascades down the dX chain; the
#                           gradients it feeds are held at KERNEL_TOL
PHASE2_TOL = 1e-4         # phase 2's partials vs the plain products on the
#                           same workspace: fp32 summation order only
SPIN_CYCLES = 4_000_000   # the GPU spin ahead of each timed call
FRAME_TOL = 3e-3          # served rgb vs the use_kernel=False frame
FRAME_MAX = 1e-2          # ... at the few discontinuous fine-pass pixels


def cuda_ms(fn, iters, warmup=2, spin=True):
    """Median milliseconds of ``fn`` by CUDA events, after warm-up. A GPU
    spin (~2 ms) ahead of the start event lets the host enqueue ``fn``
    before the device reaches it, so the device's time is timed, not the
    host's path to the launch. With ``spin=False`` the host's Python and
    launch path from the start event on is timed as well."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slice_config():
    from nerfmlp_torch.config import RenderConfig

    return RenderConfig(N_samples=64, N_importance=128, near=2.0, far=6.0,
                        white_bkgd=True, perturb=False, raw_noise_std=0.0,
                        compute_dtype="bfloat16", use_kernel=True)


def phase_build():
    from nerfmlp_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s "
          f"-> {_build.build_dir()}")
    for name, path in paths.items():
        with open(path + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")


def serving_points(n_samples, cfg, n_rays=TILE):
    """Points and encoded view directions of ``n_rays`` rays through the
    centre of the serving pose's image, ``n_samples`` evenly spaced depths
    per ray."""
    import torch

    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.render_path import rays_for_pose_device

    o, d, _ = rays_for_pose_device(pose_spherical(*SERVE_POSE), H, W, FOCAL,
                                   cfg, device="cuda")
    mid = (H * W - n_rays) // 2
    o, d = o[mid:mid + n_rays], d[mid:mid + n_rays]
    z = torch.linspace(cfg.near, cfg.far, n_samples, device="cuda")
    pts = (o[:, None, :] + d[:, None, :] * z[None, :, None]).reshape(-1, 3)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dirs = positional_encoding(vd, cfg.dir_enc_L)
    dirs = dirs[:, None, :].expand(n_rays, n_samples, dirs.shape[-1])
    return pts.contiguous(), dirs.reshape(n_rays * n_samples, -1)


def check_kernel(net, cfg, pts, dirs, label, time_it, hi_lo=False):
    """Kernel vs plain on the same inputs; returns a result record.
    ``hi_lo``: fp32_precision="high", three bf16 products per matmul. With
    ``time_it`` the module path that use_kernel=False takes for the same
    call (encoding + the nn.Linear net, bf16; fp32 for hi_lo) is timed
    too, as the kernel's yardstick: no single PyTorch call computes this
    function."""
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops.encoding import positional_encoding

    vdirs = dirs is not None
    tol = HI_LO_TOL if hi_lo else KERNEL_TOL
    if hi_lo:
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  fp32_precision="high")
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)

    def plain():
        return fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                              torch.bfloat16, hi_lo)

    with torch.no_grad():   # the serving path: no autograd record
        got = fused_mlp.fused_nerf_mlp(packed, pts, dirs, cfg)
    want = plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SystemExit(f"[kernel] {label}: bad output {tuple(got.shape)}")
    err = float((got - want).abs().max())
    norm = err / max(float(want.abs().max()), 1e-12)
    n = pts.shape[0]
    macs = sum(p.numel() for name, p in net.named_parameters()
               if name.endswith("weight"))
    flops = 2.0 * macs * n * (3 if hi_lo else 1)   # bf16 tensor-core work
    nbytes = (pts.numel() * 4 + (dirs.numel() * (4 if hi_lo else 2)
                                 if vdirs else 0)
              + packed.weights.numel() * 2 + packed.biases.numel() * 4
              + got.numel() * 4)
    rec = {"label": label, "n": n, "max_abs_err": err, "norm_err": norm,
           "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS,
                                 nbytes / PEAK_MEM_BYTES),
           "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                        >= nbytes / PEAK_MEM_BYTES else "bytes")}
    if time_it:
        with torch.no_grad():
            for key, spin in (("ms", True), ("ms_no_spin", False)):
                rec[key] = cuda_ms(lambda: fused_mlp.fused_nerf_mlp(
                    packed, pts, dirs, cfg), iters=10, spin=spin)
        rec["plain_ms"] = cuda_ms(plain, iters=3)
        dt = torch.float32 if hi_lo else torch.bfloat16
        with torch.no_grad():
            rec["module_ms"] = cuda_ms(lambda: net(
                positional_encoding(pts, cfg.pos_enc_L), dirs,
                compute_dtype=dt).float(), iters=5)
        rec["tflops"] = flops / rec["ms"] / 1e9
    print(f"[kernel] {label}: n={n} max|err|={err:.3e} "
          f"normalised={norm:.3e} (tol {tol})"
          + (f" kernel {rec['ms']:.3f} ms ({rec['tflops']:.1f} TFLOP/s; "
             f"{rec['ms_no_spin']:.3f} ms without the spin) plain "
             f"{rec['plain_ms']:.3f} ms, module path (use_kernel=False, "
             f"{'fp32' if hi_lo else 'bf16'}) {rec['module_ms']:.3f} ms"
             if time_it else "")
          + f" bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    if not norm <= tol:
        raise SystemExit(f"[kernel] {label}: kernel disagrees with plain")
    return rec


def phase_kernel(net):
    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops.fused_mlp import _fwd_layout, kernel_fits

    cfg = slice_config()
    wide = dataclasses.replace(cfg, width=512)
    for c in (cfg, wide):
        mc = c.model_config()
        for hi_lo in (False, True):
            lay = _fwd_layout(mc, True, hi_lo)
            print(f"[kernel] 8x{c.width}{' hi_lo' if hi_lo else ''} budget: "
                  f"{lay.rows}-point tiles, {lay.stages} weight stages of "
                  f"{16 * lay.ksub} rows, {lay.smem} B shared memory, "
                  f"fits={kernel_fits(mc, True, hi_lo)}")
    recs = []
    for n_samples, label in ((cfg.N_samples, "coarse"),
                             (cfg.N_importance, "fine")):
        pts, dirs = serving_points(n_samples, cfg)
        recs.append(check_kernel(net, cfg, pts, dirs, label, time_it=True))
    pts, dirs = serving_points(cfg.N_samples, cfg)
    check_kernel(net, cfg, pts, dirs, "coarse hi_lo", time_it=True,
                 hi_lo=True)
    generic = dataclasses.replace(cfg, depth=6, width=128, use_viewdirs=False)
    gnet = init_model(generic.model_config(), seed=SEED + 1, device="cuda")
    pts, _ = serving_points(cfg.N_samples, cfg)
    check_kernel(gnet, generic, pts, None, "generic 6x128 no-viewdirs",
                 time_it=False)
    wnet = init_model(wide.model_config(), seed=SEED + 2, device="cuda")
    for n_samples, label in ((cfg.N_samples, "coarse"),
                             (cfg.N_importance, "fine")):
        pts, dirs = serving_points(n_samples, cfg)
        check_kernel(wnet, wide, pts, dirs, f"wide 8x512 {label}",
                     time_it=True)
    return recs


def bwd_macs(net, vdirs):
    """MACs per point of the backward: the recomputed forward, dX (none
    for layer 0, the skip's encoded block or the dirs block) and dW."""
    mc = net.cfg
    fwd = sum(p.numel() for name, p in net.named_parameters()
              if name.endswith("weight"))
    no_dx = mc.input_ch * mc.width * (1 + len(mc.skips))
    if vdirs:
        no_dx += mc.input_ch_views * mc.view_width
    return fwd + (fwd - no_dx) + fwd


def phase1_macs(net, vdirs):
    """MACs per point of the backward's phase 1: the recomputed forward
    without the output heads, and dX. Phase 2 does the other fwd (dW)."""
    mc = net.cfg
    fwd = sum(p.numel() for name, p in net.named_parameters()
              if name.endswith("weight"))
    heads = (mc.view_width * 3 + mc.width) if vdirs else (
        mc.width * mc.output_ch)
    return bwd_macs(net, vdirs) - fwd - heads


def bound(flops, nbytes):
    """(least ms, what bounds it) at the bf16 peak and the HBM rate."""
    ops, mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_MEM_BYTES
    return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"


def check_backward(net, cfg, pts, dirs, label, time_it, hi_lo=False):
    """The backward (both phases + reduction) vs the plain backward on the
    same inputs and a cotangent from a seeded loss, per parameter (max
    |err| / max |plain|); a repeat run must give the same bits. In hi_lo
    mode the bf16 kernels' gradients are held against the same hi_lo
    reference as a control, which must land above the bar: the bar then
    tells hi_lo from bf16. With ``time_it``, each kernel is also held
    against its own plain version and timed (check_phases), and the whole
    backward is timed with and without the spin. Returns (the
    whole backward's record, the kernels' records or None)."""
    import torch

    from nerfmlp_torch.ops import fused_mlp

    vdirs = dirs is not None
    tol = HI_LO_BWD_TOL if hi_lo else KERNEL_TOL
    if hi_lo:
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  fp32_precision="high")
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    raw = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                         torch.bfloat16, hi_lo)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    target = torch.rand(raw.shape, device="cuda", generator=gen)
    g = (2.0 / raw.numel()) * (raw - target)   # d mean((raw - target)^2)

    def plain():
        return fused_mlp.fused_nerf_mlp_bwd_plain(
            net, pts, dirs, g, cfg.pos_enc_L, torch.bfloat16, hi_lo)

    def compare(got, want):
        """(max abs error, worst normalised error, its parameter)."""
        err, worst = 0.0, (0.0, "")
        for name, p in net.named_parameters():
            e = float((got[name] - want[name]).abs().max())
            err = max(err, e)
            worst = max(worst,
                        (e / max(float(want[name].abs().max()), 1e-12), name))
        return err, worst[0], worst[1]

    flat = fused_mlp._launch_bwd(packed, pts, dirs, g)
    again = fused_mlp._launch_bwd(packed, pts, dirs, g)
    got = fused_mlp.unpack_grads(packed, flat)
    torch.cuda.synchronize()
    if not torch.equal(flat, again):
        raise SystemExit(f"[backward] {label}: two runs differ")
    for name, p in net.named_parameters():
        if got[name].shape != p.shape or not torch.isfinite(got[name]).all():
            raise SystemExit(f"[backward] {label}: bad gradient for {name}")
    want = plain()
    err, norm, leaf = compare(got, want)
    control = None
    if hi_lo:
        bf16 = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, False)
        _, control, cleaf = compare(fused_mlp.unpack_grads(
            bf16, fused_mlp._launch_bwd(bf16, pts, dirs, g)), want)
        print(f"[backward] {label}: control, the bf16 kernels vs the same "
              f"hi_lo plain backward: normalised {control:.3e} ({cleaf})")
    n = pts.shape[0]
    flops = 2.0 * bwd_macs(net, vdirs) * n * (3 if hi_lo else 1)
    nbytes = (pts.numel() * 4 + g.numel() * 4
              + (dirs.numel() * (4 if hi_lo else 2) if vdirs else 0)
              + packed.weights.numel() * 2 + packed.biases.numel() * 4
              + packed.grad_total * 4)
    rec = {"label": label, "n": n, "max_abs_err": err, "norm_err": norm,
           "control_norm_err": control}
    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
    phases = None
    if time_it:
        for key, spin in (("ms", True), ("ms_no_spin", False)):
            rec[key] = cuda_ms(lambda: fused_mlp._launch_bwd(
                packed, pts, dirs, g), iters=10, spin=spin)
        rec["plain_ms"] = cuda_ms(plain, iters=3)
        rec["tflops"] = flops / rec["ms"] / 1e9
        phases = check_phases(net, packed, pts, dirs, g, label)
        rec["floor_ms"] = sum(r["bound_ms"] for r in phases.values())
    print(f"[backward] {label}: n={n} max|err|={err:.3e} "
          f"normalised={norm:.3e} ({leaf}; tol {tol}), repeat bit-identical"
          + (f" kernels {rec['ms']:.3f} ms ({rec['tflops']:.1f} TFLOP/s; "
             f"{rec['ms_no_spin']:.3f} ms without the spin) plain "
             f"{rec['plain_ms']:.3f} ms; design floor {rec['floor_ms']:.3f} "
             f"ms" if time_it else "")
          + f" bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    if not norm <= tol:
        raise SystemExit(f"[backward] {label}: kernels disagree with plain")
    if control is not None and not control > tol:
        raise SystemExit(f"[backward] {label}: the bar does not tell hi_lo "
                         f"from bf16")
    return rec, phases


def check_phases(net, packed, pts, dirs, g, label):
    """Each kernel of the backward alone, against its plain version on the
    same inputs, and timed: phase 1's workspace (per matrix, relative L2
    over the n rows), phase 2's partials on that workspace, the reduction
    of those partials (bit-identical; beside part.sum(0), the library call
    for the same function). Returns {"phase1", "phase2", "reduce"}
    records, each with its bound from this run's shapes."""
    import torch

    from nerfmlp_torch.ops import fused_mlp as fm

    n = pts.shape[0]
    tile = fm.bwd_tile_rows(packed.hi_lo)
    rows = -(-n // tile) * tile
    ws = torch.empty(rows * packed.ws_cols, device="cuda",
                     dtype=torch.bfloat16)
    fm.bwd_workspace(packed, pts, dirs, g, ws)
    want_ws = fm.bwd_workspace_plain(packed, pts, dirs, g, rows)
    err1, worst = 0.0, (0.0, "")
    for m, (name, _, _) in enumerate(packed.ws_mats):
        a = fm.ws_matrix(packed, ws, m)[0, :n].float()
        b = fm.ws_matrix(packed, want_ws, m)[0, :n].float()
        err1 = max(err1, float((a - b).abs().max()))
        worst = max(worst, (float((a - b).norm() / b.norm().clamp_min(1e-30)),
                            name))
    splits, split_rows = fm.bwd_splits(rows)
    total = packed.grad_total
    part = torch.empty((splits, fm.part_stride(total)), device="cuda")
    fm.weight_grads(packed, ws, rows, split_rows, part)
    want_part = fm.weight_grads_plain(packed, ws, rows, split_rows)
    err2 = float((part[:, :total] - want_part[:, :total]).abs().max())
    norm2 = err2 / float(want_part[:, :total].abs().max())
    red = fm.reduce_partials(part, total)
    err3 = float((red - fm.reduce_partials_plain(part, total)).abs().max())
    torch.cuda.synchronize()
    recs = {
        "phase1": {"max_abs_err": err1, "rel_l2": worst[0],
                   "ms": cuda_ms(lambda: fm.bwd_workspace(
                       packed, pts, dirs, g, ws), iters=10),
                   "plain_ms": cuda_ms(lambda: fm.bwd_workspace_plain(
                       packed, pts, dirs, g, rows), iters=3)},
        "phase2": {"max_abs_err": err2, "norm_err": norm2,
                   "ms": cuda_ms(lambda: fm.weight_grads(
                       packed, ws, rows, split_rows, part), iters=10),
                   "plain_ms": cuda_ms(lambda: fm.weight_grads_plain(
                       packed, ws, rows, split_rows), iters=3)},
        "reduce": {"max_abs_err": err3,
                   "ms": cuda_ms(lambda: fm.reduce_partials(part, total),
                                 iters=10),
                   "plain_ms": cuda_ms(lambda: fm.reduce_partials_plain(
                       part, total), iters=3),
                   "library_ms": cuda_ms(lambda: part[:, :total].sum(0),
                                         iters=10)},
    }
    ws_bytes = rows * packed.ws_cols * 2
    in_bytes = (pts.numel() * 4 + g.numel() * 4
                + (dirs.numel() * 2 if dirs is not None else 0)
                + packed.weights.numel() * 2 + packed.biases.numel() * 4)
    dw_macs = sum(p.numel() for name, p in net.named_parameters()
                  if name.endswith("weight"))
    for key, flops, nbytes in (
            ("phase1", 2.0 * phase1_macs(net, dirs is not None) * n,
             in_bytes + ws_bytes),
            ("phase2", 2.0 * dw_macs * n, ws_bytes + splits * total * 4),
            ("reduce", 0.0, (splits + 1) * total * 4)):
        recs[key]["bound_ms"], recs[key]["bound_by"] = bound(flops, nbytes)
        recs[key]["library_ms"] = recs[key].get("library_ms")
    r1, r2, r3 = recs["phase1"], recs["phase2"], recs["reduce"]
    print(f"[backward] {label} phase 1 (recompute + dX -> {ws_bytes} B "
          f"workspace): rel-L2 {r1['rel_l2']:.3e} ({worst[1]}; tol "
          f"{PHASE1_TOL}) kernel {r1['ms']:.3f} ms plain {r1['plain_ms']:.3f} "
          f"ms bound {r1['bound_ms']:.3f} ms ({r1['bound_by']})")
    print(f"[backward] {label} phase 2 (dW, db: {len(packed.bwd_jobs)} jobs x "
          f"{splits} splits of {split_rows} rows): normalised "
          f"{norm2:.3e} (tol {PHASE2_TOL}) kernel {r2['ms']:.3f} ms plain "
          f"{r2['plain_ms']:.3f} ms bound {r2['bound_ms']:.3f} ms "
          f"({r2['bound_by']})")
    print(f"[reduce] {label}: {splits} slots x {total} floats: max|err| "
          f"{err3:.3e} kernel {r3['ms']:.4f} ms plain {r3['plain_ms']:.4f} "
          f"ms part.sum(0) {r3['library_ms']:.4f} ms bound "
          f"{r3['bound_ms']:.4f} ms (bytes; {100 * r3['bound_ms'] / r3['ms']:.0f}"
          f"% of it)")
    if not (worst[0] <= PHASE1_TOL and norm2 <= PHASE2_TOL and err3 == 0.0):
        raise SystemExit(f"[backward] {label}: a kernel of the backward "
                         f"disagrees with its plain version")
    return recs


def phase_backward(net):
    """The forward and backward kernels at the flagship train step's
    shapes: 1024 rays of a pose x 64 coarse / 128 fine samples, bf16, each
    backward kernel also alone; the backward in hi_lo at the first and at
    the generic 6x128 no-viewdirs net; and, for context, autograd through
    the bf16 module on the fine call's shape. Returns (forward records,
    backward records, the fine call's kernel records, the coarse call's)."""
    import torch

    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops.encoding import positional_encoding

    t0 = time.perf_counter()
    cfg = slice_config()
    mc = cfg.model_config()
    print(f"[backward] 8x256 budget: {fused_mlp.backward_counts(mc, True)} "
          f"(phase-1 operations, workspace matrices), "
          f"{fused_mlp.bwd_smem_bytes(mc, True)} B shared memory per block, "
          f"{fused_mlp.bwd_scratch_bytes(mc, True)} B workspace per point, "
          f"fits={fused_mlp.backward_fits(mc, True)}")
    fwds, recs, phases = [], [], []
    for n_samples, label in ((cfg.N_samples, "coarse"),
                             (cfg.N_importance, "fine")):
        pts, dirs = serving_points(n_samples, cfg, n_rays=TRAIN_RAYS)
        fwds.append(check_kernel(net, cfg, pts, dirs, f"train {label}",
                                 time_it=True))
        rec, ph = check_backward(net, cfg, pts, dirs, label, time_it=True)
        recs.append(rec)
        phases.append(ph)
    pts, dirs = serving_points(cfg.N_samples, cfg, n_rays=TRAIN_RAYS)
    check_backward(net, cfg, pts, dirs, "coarse hi_lo", time_it=False,
                   hi_lo=True)
    generic = dataclasses.replace(cfg, depth=6, width=128, use_viewdirs=False)
    gnet = init_model(generic.model_config(), seed=SEED + 1, device="cuda")
    check_backward(gnet, generic, pts, None, "generic 6x128 no-viewdirs",
                   time_it=False)

    pts, dirs = serving_points(cfg.N_importance, cfg, n_rays=TRAIN_RAYS)
    enc = positional_encoding(pts, cfg.pos_enc_L)
    out = net(enc, dirs, compute_dtype=torch.bfloat16)
    g = torch.ones_like(out)
    ms = cuda_ms(lambda: torch.autograd.grad(out, list(net.parameters()), g,
                                             retain_graph=True), iters=10)
    recs[1]["module_autograd_ms"] = ms
    print(f"[backward] context: autograd through the bf16 module, fine "
          f"call: {ms:.3f} ms (backward only)")
    print(f"[backward] phase took {time.perf_counter() - t0:.1f} s")
    return fwds, recs, phases[1], phases[0]


def train_configs(near, far):
    """The flagship recipe: 8x256, batch 1024, 64+128 samples, shared net,
    bf16 through the kernels, perturb on; 300 steps, no validation inside
    the run (it is rendered after)."""
    from nerfmlp_torch.config import RenderConfig, TrainConfig

    rc = RenderConfig(N_samples=64, N_importance=128, near=near, far=far,
                      white_bkgd=True, perturb=True, raw_noise_std=0.0,
                      compute_dtype="bfloat16", use_kernel=True)
    tc = TrainConfig(batch_size=TRAIN_RAYS, iters=TRAIN_STEPS, seed=SEED,
                     quick_val_interval=0, full_val_interval=0,
                     log_interval=100, ckpt_interval=0)
    return rc, tc


def train_once(rc, tc, train_ds, val_ds, save_dir):
    """Train through the Trainer; returns losses per step, wall seconds of
    the synchronised run, held-out PSNR and the Trainer."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.train.loop import Trainer

    trainer = Trainer(rc, tc, train_ds, save_dir=save_dir, device="cuda",
                      verbose=False)
    losses = []
    step_fn = trainer.step_fn

    def recorded(state, batch):
        m = step_fn(state, batch)
        losses.append(m["loss"])
        return m

    trainer.step_fn = recorded
    torch.cuda.synchronize()
    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer.step_fn = step_fn
    launches = tuple(c.launches for c in counters)
    val = trainer._validate(val_ds)
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not np.isfinite(val["psnr"]):
        raise SystemExit("[train] non-finite loss or PSNR")
    return losses, wall, val, launches, trainer


def profile_step(trainer):
    """One profiled train step: the kernels' device ms, the rest of the
    device time, and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.pool.batch(trainer.state.step)
    trainer.step_fn(trainer.state, batch)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy = sum(ms for _, ms in rows)
    kern = {name: sum(ms for k, ms in rows if name in k)
            for name in ("fused_mlp_fwd_kernel", "bwd_phase1_kernel",
                         "bwd_phase2_kernel", "reduce_partials_kernel")}
    print(f"[profile] train step wall {wall:.2f} ms, device busy {busy:.2f} "
          f"ms (idle {100 * (1 - busy / wall):.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in kern.items())
          + f", rest {busy - sum(kern.values()):.3f} ms")
    for key, ms in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {key[:70]}")


def phase_train():
    """Train the flagship recipe through the Trainer on a synthetic scene
    made here, with the kernels and with use_kernel=False; check the loss
    falls, held-out PSNR, the two runs' agreement and the kernel launches
    per step; time and profile the step. Returns the kernel run's launches
    (forward, backward phase 1, phase 2, reduction)."""
    import numpy as np

    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_scene

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke")
    scene = os.path.join(root, "scene")
    make_synthetic_scene(scene, n_train=8, n_val=2, n_test=0,
                         img_wh=(TRAIN_WH, TRAIN_WH), seed=SEED)
    train_ds = BlenderDataset(scene, "train", img_wh=(TRAIN_WH, TRAIN_WH))
    val_ds = BlenderDataset(scene, "val", img_wh=(TRAIN_WH, TRAIN_WH))
    rc, tc = train_configs(*train_ds.dynamic_near_far())
    print(f"[train] scene {TRAIN_WH}x{TRAIN_WH}, 8 train / 2 val views in "
          f"{time.perf_counter() - t0:.1f} s; {TRAIN_STEPS} steps of "
          f"{TRAIN_RAYS} rays, {rc.N_samples}+{rc.N_importance} samples, "
          f"bf16")
    runs = {}
    for name, cfg in (("kernel", rc),
                      ("plain", dataclasses.replace(rc, use_kernel=False))):
        losses, wall, val, launches, trainer = train_once(
            cfg, tc, train_ds, val_ds, os.path.join(root, name))
        times = trainer.history["iteration_times"][10:]
        first, last = losses[:20].mean(), losses[-20:].mean()
        print(f"[train] {name}: loss {first:.5f} -> {last:.5f} (mean of "
              f"first / last 20 steps), held-out PSNR {val['psnr']:.2f} dB, "
              f"SSIM {val['ssim']:.4f}; {1e3 * wall / TRAIN_STEPS:.2f} ms "
              f"per step ({TRAIN_RAYS * TRAIN_STEPS / wall:.0f} rays/s, "
              f"synchronised), host median {1e3 * np.median(times):.2f} ms")
        if not last < 0.5 * first:
            raise SystemExit(f"[train] {name}: the loss did not fall")
        runs[name] = (val, launches, trainer, wall)
    val, launches, trainer, wall = runs["kernel"]
    want = (2 * TRAIN_STEPS,) * 4
    print(f"[train] kernel launches over {TRAIN_STEPS} steps: forward "
          f"{launches[0]}, backward phase 1 {launches[1]}, phase 2 "
          f"{launches[2]}, reduction {launches[3]} (want {want[0]} each: "
          f"coarse + fine query per step); plain run: {runs['plain'][1]}")
    if launches != want or runs["plain"][1] != (0, 0, 0, 0):
        raise SystemExit("[train] the train steps did not go through the "
                         "kernels as expected")
    gap = abs(val["psnr"] - runs["plain"][0]["psnr"])
    print(f"[train] held-out PSNR kernel {val['psnr']:.2f} dB vs "
          f"use_kernel=False {runs['plain'][0]['psnr']:.2f} dB (gap "
          f"{gap:.2f} dB, limit {PSNR_GAP} dB; floor {PSNR_MIN} dB)")
    if not (val["psnr"] >= PSNR_MIN and gap <= PSNR_GAP):
        raise SystemExit("[train] held-out PSNR below the floor or off the "
                         "plain path")
    profile_step(trainer)
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    return launches


def _png_pixels(body):
    """(H, W, 3) uint8 from the server's PNG (8-bit RGB, filter 0)."""
    import numpy as np

    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit("[serve] /render png reply is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(body):
        (length,) = struct.unpack(">I", body[pos:pos + 4])
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", data[:8])
        elif tag == b"IDAT":
            idat += data
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        raise SystemExit("[serve] unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


def phase_serve(net):
    import numpy as np
    import torch

    from nerfmlp_torch.ops.fused_mlp import fused_nerf_mlp
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.render_path import rays_for_pose_device
    from nerfmlp_torch.serve import RenderServer, RenderService

    cfg = slice_config()
    svc = RenderService({"coarse": net}, cfg, H, W, FOCAL, tile=TILE,
                        device="cuda", log=lambda m: print(f"[serve] {m}"))
    svc.warmup()
    server = RenderServer(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    cam = dict(zip(("theta", "phi", "radius"), SERVE_POSE))

    def post(req):
        r = urllib.request.Request(url + "/render", method="POST",
                                   data=json.dumps(req).encode())
        with urllib.request.urlopen(r, timeout=300) as resp:
            return resp.status, resp.read()

    try:
        fused_nerf_mlp.launches = 0
        replies = [post({**cam, "format": f, **extra}) for f, extra in (
            ("png", {}), ("npy", {}),
            ("json", {"maps": ["rgb_map", "depth_map"]}))]
        launches = fused_nerf_mlp.launches
        with urllib.request.urlopen(url + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if any(status != 200 for status, _ in replies):
        raise SystemExit(f"[serve] HTTP status {[s for s, _ in replies]}")
    n_tiles = -(-H * W // TILE)
    want = 2 * n_tiles * len(replies)
    print(f"[serve] {len(replies)} frames: {launches} kernel launches "
          f"(want {want} = 2 x {n_tiles} tiles per frame)")
    if launches != want:
        raise SystemExit("[serve] the served frames did not go through the "
                         "kernel as expected")
    png = _png_pixels(replies[0][1])
    rgb = np.load(io.BytesIO(replies[1][1]))
    maps = json.loads(replies[2][1])
    depth = np.asarray(maps["depth_map"], np.float32)
    ok = (png.shape == (H, W, 3) and rgb.shape == (H, W, 3)
          and depth.shape == (H, W) and np.isfinite(rgb).all()
          and np.isfinite(depth).all()
          and np.array_equal(png, (rgb * 255).round().astype(np.uint8))
          and np.allclose(np.asarray(maps["rgb_map"], np.float32), rgb))
    if not ok:
        raise SystemExit("[serve] images are not finite, of the right shape "
                         "and consistent across formats")
    lat = health["latency"]
    print(f"[serve] frame latency p50 {lat['p50_ms']} ms, max "
          f"{lat['max_ms']} ms over {lat['n']} frames "
          f"(warmup {health['warmup_s']} s)")

    # The same frame through the kernel and through use_kernel=False (the
    # bf16 module path), rendered directly with the function the service
    # runs. The coarse map is the kernel's output composited once; the fine
    # map adds importance sampling, which is discontinuous in the coarse
    # weights at a few pixels (an empty last bin moves the u = 1 sample by
    # a bin; a last sample's sigma near 0 flips its 1e10 interval between
    # opaque and clear), so it is held at FRAME_TOL for 99.9% of pixels.
    maps = ("rgb_map", "rgb_map_coarse")
    o, d, _ = rays_for_pose_device(pose_spherical(*SERVE_POSE), H, W, FOCAL,
                                   cfg, device="cuda")
    frames = {}
    for name, c in (("kernel", cfg),
                    ("plain", dataclasses.replace(cfg, use_kernel=False))):
        params = prepare_params({"coarse": net}, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image_maps(params, o, d, H, W, c, tile=TILE, maps=maps)
        frames[name] = {k: np.clip(v.cpu().numpy(), 0.0, 1.0)
                        for k, v in out.items()}
        print(f"[serve] {name} frame rendered directly in "
              f"{time.perf_counter() - t0:.3f} s")
    if not np.array_equal(frames["kernel"]["rgb_map"], rgb):
        raise SystemExit("[serve] the served frame differs from a direct "
                         "render through the kernel")
    coarse = np.abs(frames["kernel"]["rgb_map_coarse"]
                    - frames["plain"]["rgb_map_coarse"])
    fine = np.abs(frames["kernel"]["rgb_map"] - frames["plain"]["rgb_map"])
    p999 = float(np.quantile(fine, 0.999))
    print(f"[serve] kernel vs use_kernel=False: coarse rgb max|err| "
          f"{coarse.max():.3e}; fine rgb max|err| {fine.max():.3e}, 99.9th "
          f"percentile {p999:.3e}, {int((fine > FRAME_TOL).sum())} of "
          f"{fine.size} values above {FRAME_TOL}")
    if not (coarse.max() <= FRAME_TOL and p999 <= FRAME_TOL
            and fine.max() <= FRAME_MAX):
        raise SystemExit("[serve] served frame disagrees with the plain path")
    profile_frame(prepare_params({"coarse": net}, cfg), o, d, cfg)
    return launches


def device_rows(prof):
    """(name, device ms) of the kernels the profiler saw on the card —
    the device events only, so a CPU-side op that launched a kernel (an
    autograd Function, aten::sort) does not count its kernel twice."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def profile_frame(params, o, d, cfg):
    """Where one served frame's time goes: wall clock, device busy time,
    and the device time of the heaviest operations, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerfmlp_torch.ops.render import render_image_maps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_image_maps(params, o, d, H, W, cfg, tile=TILE)["rgb_map"].cpu()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = sorted(device_rows(prof), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    print(f"[profile] frame wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {100 * (1 - busy / wall):.1f}%)")
    for key, ms in rows[:5]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {key[:70]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nerfmlp_torch.models.mlp import init_model

    from nerfmlp_torch import use_true_fp32

    use_true_fp32()
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    phase_build()
    net = init_model(slice_config().model_config(), seed=SEED, device="cuda")
    coarse, fine = phase_kernel(net)
    fwd_train, bwds, ph_fine, ph_coarse = phase_backward(net)
    serve_launches = phase_serve(net)
    fwd_launches, *bwd_launches = phase_train()

    # The forward runs on both paths, at different shapes: one record per
    # path, each with that path's launches and its fine call's times, and
    # module_ms, the use_kernel=False module path's time for the same call
    # (its yardstick; no single PyTorch call computes the function, so
    # library_ms is null). The backward's three kernels: the fine call's
    # times, the launches of the training run. The whole backward (all
    # three) is printed beside them.
    kernels = [{
        "name": "fused_mlp_fwd",
        "path": "serve",
        "route": "cuda",
        "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
        "launches": serve_launches,
        "max_abs_err": max(coarse["max_abs_err"], fine["max_abs_err"]),
        "ms": fine["ms"],
        "plain_ms": fine["plain_ms"],
        "module_ms": fine["module_ms"],
        "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_mlp_fwd_train",
        "path": "train",
        "route": "cuda",
        "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
        "launches": fwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in fwd_train),
        "ms": fwd_train[1]["ms"],
        "plain_ms": fwd_train[1]["plain_ms"],
        "module_ms": fwd_train[1]["module_ms"],
        "bound_ms": fwd_train[1]["bound_ms"],
        "bound_by": fwd_train[1]["bound_by"],
        "library_ms": None,
    }]
    for key, name, replaces, launches in (
            ("phase1", "fused_mlp_bwd_phase1", "pallas_mlp.py:312",
             bwd_launches[0]),
            ("phase2", "fused_mlp_bwd_phase2", "pallas_mlp.py:386",
             bwd_launches[1]),
            ("reduce", "fused_mlp_bwd_reduce", "pallas_mlp.py:327",
             bwd_launches[2])):
        r = ph_fine[key]
        kernels.append({
            "name": name,
            "path": "train",
            "route": "cuda",
            "source": "nerfmlp_torch/csrc/fused_mlp_bwd.cu",
            "replaces": "nerfmlp_tpu/ops/" + replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"],
                               ph_coarse[key]["max_abs_err"]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    for rec in bwds:
        print(f"[backward] {rec['label']} call, all three kernels: "
              f"{rec['ms']:.3f} ms ({rec['ms_no_spin']:.3f} ms without the "
              f"spin); bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}), design floor {rec['floor_ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
