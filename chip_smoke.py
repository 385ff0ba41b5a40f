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
     step;
  6. occupancy-grid sampling: hold the forward and the backward's kernels
     against their plain versions at its shapes (the 16-sample probe and
     48-sample refine queries of a 1024-ray step, a 64^3-point grid
     refresh, a served 16,384-ray tile's probe and refine queries; in
     hi_lo mode the one-shot recipe's 64-sample query, forward and
     backward, and its refresh) and time them; train the turbo recipe
     (8x256, batch 1024, occupancy 16+48 hierarchical, 64 grid-scored
     depths, a 64^3 grid refreshed every 16 steps, decaying after step
     64, bf16) for 300 steps through the Trainer, with the kernels and
     with use_kernel=False (the loss falls, the grid prunes cells,
     held-out PSNR rendered with the grid reaches 20 dB and agrees within
     1 dB, exactly 2 forward launches per step plus 1 per refresh and 2 of
     each backward kernel per step), profile one step; train the one-shot
     fp32 'high' (hi_lo) recipe for 100 steps, the first 50 on the
     central crop, with the kernels and with use_kernel=False (the loss
     falls and ends within 1% of the plain run's, 1 launch of each kernel
     per step plus 1 forward per refresh); serve the turbo model over HTTP
     with the grid the service builds from its weights (400x400 frames in
     16,384-ray tiles, 2 forward launches per tile), hold that grid
     against the plain build and the frame against use_kernel=False with
     the same grid (bf16: no farther from the fp32 frame than the bf16
     module path's; hi_lo: at the serving bar), and profile a frame;
  7. the inference entry points, as a user runs them: the train CLI on
     configs/lego_turbo_bf16.txt as it is (half_res from the file) on a
     128x128 synthetic scene (8 train / 2 val / 2 test views) it writes,
     for 200 steps at 64x64 with the orbit videos, a test-set sweep and
     held-out frames at step 100 (the events' files must exist, each GIF
     hold 8 frames, the loss fall and the final held-out PSNR reach 20
     dB; each backward kernel launched twice a step); --render_only, then
     --render_only --render_test on the run (test PSNR >= 20 dB); the
     render_video CLI on its model_final.pt with the grid, 8 frames at
     400x400 (20 forward launches a frame, frame 0 equal to
     RenderService's frame of the same pose, weights, grid and tile within
     1e-6); the eval CLI on the val split (mean PSNR >= 20 dB, within 1 dB
     of the Trainer's final validation);
  8. forward-facing (LLFF, NDC) and DeepVoxels scenes, as a user runs them:
     the train CLI on configs/fern.txt as it is (factor 8, llffhold 8,
     64 + 64 samples, raw noise 1, world viewdirs) on a 96x72 forward
     capture it writes as a pre-minified images_8/ (12 views, views 0 and 8
     held out), for 400 steps with 8-frame spiral videos and a quick
     validation at step 200, through the kernels and with --no_kernel (the
     loss falls, held-out PSNR reaches 20 dB on both and they agree within
     1 dB; exactly 2 launches of each kernel per step beside those of the
     renders, none on the plain run), a profiled step; render_video on its
     model, the loader's spiral, 8 frames at 504x378 (2 forward launches
     per 4,096-ray tile); the serve CLI with --dataset_type llff --datadir,
     one frame over HTTP equal to render_video's frame 0, and that frame
     through use_kernel=False (bf16: no farther from the fp32 module frame
     than the bf16 module frame, x1.1); the kernels against their plain
     versions at the path's shapes with random weights (a served NDC tile,
     262,144 points; a train call, 65,536 points, forward and backward),
     timed beside the module path; eval on the held-out views (within 1 dB
     of the Trainer's final validation); 50 train CLI steps on a 64x64
     DeepVoxels-layout scene it writes (the loss falls, 2 launches of each
     kernel per step beside the renders');
  9. steps_per_dispatch through CUDA graphs ("graph"): the flagship recipe
     of phase 5 for 300 steps at K = 16 (windows of 16 replays of one
     captured step; the device pool's 32 steps an epoch, so windows end at
     its reshuffles), held against phase 5's K = 1 run at the JAX
     package's scan bars (window-end losses rtol 1e-3, parameters rtol
     2e-4 / atol 2e-6; the measured difference is printed), the whole
     run traced (exactly 2 launches of each kernel per step: the warm-up
     steps' and the replays'; each kernel's device ms per launch), the
     four kernels held against their plain versions on its trained net at
     its two calls' shapes and timed, and exactly 2 launches of each kernel
     per replayed step in a profiled window; the
     turbo recipe of phase 6 at K = 16 (the same refresh steps and seeds
     as K = 1, held-out PSNR within 0.5 dB of it); the one-shot hi_lo
     recipe at K = 8 (host-batch windows through the central crop, then
     the pool; its last losses within 1% of K = 1's); each K = 16 and
     K = 1 step timed synchronised and profiled over a 16-step window
     (busy, wall, idle share), beside the card's name and power limit; one
     eager step of each recipe under set_sync_debug_mode('error');
 10. mesh extraction and hot reload ("mesh"): the turbo model phase 6
     trained, through extract_mesh at 128^3 and 256^3 with the kernel and
     with use_kernel=False: the density volume against the kernel's plain
     version on the same points (1e-2 of its largest value), every kernel
     vertex within a cell diagonal of the plain version's mesh and 99.9%
     of them within one of the module path's mesh, the faces within 2% of
     the module path's, the tet stage on the card equal to the CPU's on
     the same cells, ceil(G^3 / 65,536) + ceil(V / 65,536) forward
     launches, the default iso level 25 (or, if the model's sigma never
     reaches it, one inside its range), each stage timed at 256^3; the serve CLI with --watch 0.5 on a train CLI run (a
     subprocess: the turbo config at 64x64, a checkpoint every 50 steps,
     K = 16): at least two swaps, /health on the last step written, a
     frame served after the last swap bit-equal to a fresh service's from
     that file, POST /reload with nothing new, POST /mesh in json (counts
     equal to extract_mesh's on those weights), ply and obj; the train CLI
     with --i_mesh 100 for 200 steps at K = 16 (one .ply, at step 100).
 11. multi-scene batched training ("multi_scene"): the four kernels over a
     scene axis (one launch for 4 nets, seeds 0-3, 8x256 + view head) at
     the multi-scene step's calls — the dense step's coarse and fine calls
     (4 x 65,536 and 4 x 131,072 points), the turbo probe call (4 x
     16,384) and, in hi_lo, the one-shot query (4 x 65,536) — each bit-equal
     to 4 single-scene launches, at the single-scene bars from the stacked
     plain versions, timed beside the single-scene launches, the plain
     version and the module path, with its bound at 4 x n points; the
     train_multi_scene CLI on 4 synthetic 64x64 scenes (seeds 0-3, the
     smooth and the hard field; scene 0 is phase 5's) for 300 steps of the
     flagship recipe, through the kernels and with --no_kernel (each
     scene's held-out PSNR >= 20 dB and within 1 dB of its --no_kernel
     run's, scene 0 within 1 dB of phase 5's single-scene Trainer, exactly
     2 launches of each kernel a step); the stack's scene 0 held to a solo
     step seeded the same for 5 steps (phase 9's bars), a stacked step
     timed beside 4 solo eager steps and profiled (idle share); the turbo
     recipe with per-scene grids (phase 6's cuts) through the library's
     multi-scene step for 300 steps, through the kernels and without
     (every grid prunes; PSNR with each scene's grid >= 20 dB and within 1
     dB; 2 launches a step, 1 forward a refresh of all four grids); the
     CLI for 50 steps on a synthetic scene and phase 8's LLFF capture
     (per-scene bounds, NDC 0/1; the white-background warning; two .pt
     files read by load_params_any, one served for a frame by
     RenderService).
 12. ground truth on the card and the JAX package's .ckpt files
     ("interchange"): the make_synthetic_scene CLI writes the
     quality-certification scene (the hard field, 400x400, 48 / 4 / 8
     views, 512 GT samples, --device cuda), timed beside the card's name
     and power limit, and the Blender loader reads its 60 views; two of
     its test poses at 128x128 on the card and in numpy, within 1 level of
     8-bit sRGB on 99.9% of values and 2 everywhere; phase 6's turbo
     weights through the convert_checkpoint CLI to a .ckpt, served by the
     serve CLI over HTTP (the frame bit-equal to the .pt's, the same
     forward launches) and back to a .pth equal to the .pt; phase 5's
     final train state written as the JAX Trainer's metrics_latest.ckpt
     (flax msgpack, optax's Adam state), from which the train CLI resumes
     for 50 steps: the params, Adam moments and count, step and learning
     rate just after the resume bit-equal to a resume from the .pt, the
     mean loss below phase 5's last 50 steps', 2 launches of each kernel
     a step; the forward at the served tile and the four kernels at the
     resumed fine call, held on the weights read back, timed.
Then it prints the kernels' JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Weights are random, from a seed.
It exits non-zero, printing no result, without a CUDA device.
``--only multi_scene`` runs the build, phase 5 and phase 11 alone;
``--only interchange`` the build, phases 5 and 6 and phase 12.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os
import shutil
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
FRAME_RATIO = 1.1         # a trained model's bf16 frame: the kernel's
#                           distance from the fp32 module frame (99.9th
#                           percentile and mean) over the bf16 module
#                           path's. Both sit ~3e-2 from it at p99.9, and
#                           ~2e-2 from each other: rounding to bf16 moves
#                           sharp surfaces, and the refine samples with them
OCC_AABB = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)  # the synthetic scene's box
OCC_PROBE, OCC_REFINE = 16, 48   # the turbo recipe's samples per ray
OCC_DENSE = 64            # its grid-scored depths per ray
OCC_GRID = 64             # grid cells per side: 262,144 points a refresh
OCC_EVERY = 16            # steps between refreshes, and
OCC_WARMUP = 64           # refreshes up to this step only add density: the
#                           recipe's 64 and 1024, cut so that 15 of the 19
#                           refreshes decay (0.95 each), and a cell left at
#                           the initial 0.02 falls below the threshold 1e-2
#                           (it needs 14) within the run: the grid prunes
OCC_TILE = 16384          # rays per served tile with occupancy
LR_DECAY_STEPS = 500_000  # the occupancy recipes' lrate_decay 500
HI_LO_STEPS = 100         # the one-shot hi_lo run, the first half on the
#                           central crop (the official Blender recipe's
#                           precrop, cut from 500 steps): without it the
#                           white background drives every density below 0
#                           in the first step and the loss stays flat for
#                           the whole run, through the kernels and without
HI_LO_TRACK = 1e-2        # its loss at the end vs use_kernel=False's, rel.:
#                           a few times the gap measured on an H100 (1.4e-3)
INF_WH = 128              # the inference phase's scene, stored size: the
#                           config's half_res trains it at 64x64
INF_STEPS = 200           # the train CLI's steps there, and
INF_EVENT = 100           # the interval of its render events
INF_FRAMES = 8            # frames of every video in that phase
INF_SIZE = 400            # render_video's frame size
INF_FRAME_TOL = 1e-6      # render_video's frame 0 vs the service's frame
LLFF_WH = (96, 72)        # phase 8's forward capture, stored as images_8/
#                           (4:3, as fern), which configs/fern.txt's factor
#                           8 reads at this native size
LLFF_VIEWS = 12           # llffhold 8 holds out views 0 and 8
LLFF_STEPS = 400          # the train CLI's steps there, and
LLFF_EVENT = 200          # the interval of its videos and quick validation
LLFF_SIZE = 504           # render_video's --size: the loader snaps a 4:3
#                           capture to 504x378 (fern at factor 8)
LLFF_SAMPLES = 64         # configs/fern.txt's 64 + 64
DV_WH = 64                # phase 8's DeepVoxels-layout scene, and
DV_STEPS = 50             # the train CLI's steps on it
DV_RADIUS = 4.0           # its cameras' hemisphere (near / far R -/+ 1)
GRAPH_K = 16              # phase 9's steps_per_dispatch: 16 replays a window
GRAPH_HOST_K = 8          # ... for the one-shot run's host (precrop) windows
GRAPH_PSNR_GAP = 0.5      # turbo at GRAPH_K vs K = 1, dB
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6   # K = 16 vs K = 1 parameters and
LOSS_RTOL = 1e-3          # losses: the JAX package's bars for its scan
MESH_RES = (128, 256)     # phase 10's grids: 256 is the served cap
MESH_ISO = 25.0           # the default iso level (sigma)
MESH_CHUNK = 65536        # points per density query, vertices per colour one
MESH_FACE_GAP = 0.02      # the kernel mesh's faces vs the module path's
MESH_TET_TOL = 1e-6       # the card's tet stage vs the CPU's, vertices
MESH_WATCH = 0.5          # the serve CLI's --watch, seconds
MESH_SERVE_RES = 128      # ... and its --max_mesh_resolution
MESH_CKPT_EVERY = 50      # the watched train run's --i_weights, and
MESH_RELOAD_STEPS = 1000  # its steps (20 checkpoints, ~4 s at K = 16)
MESH_EVENT = 100          # --i_mesh of the 200-step run at K = 16, and
MESH_EVENT_ISO = 1.0      # its --mesh_threshold: that model's sigma peaks
#                           near 2.8 at step 100 (25 would give no faces)
KERNEL_NAMES = ("fused_mlp_fwd_kernel", "bwd_phase1_kernel",
                "bwd_phase2_kernel", "reduce_partials_kernel")


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
                + (dirs.numel() * (4 if packed.hi_lo else 2)
                   if dirs is not None else 0)
                + packed.weights.numel() * 2 + packed.biases.numel() * 4)
    dw_macs = sum(p.numel() for name, p in net.named_parameters()
                  if name.endswith("weight"))
    products = 3 if packed.hi_lo else 1   # bf16 products per product
    p1_macs = phase1_macs(net, dirs is not None)
    for key, flops, nbytes in (
            ("phase1", 2.0 * products * p1_macs * n, in_bytes + ws_bytes),
            ("phase2", 2.0 * products * dw_macs * n,
             ws_bytes + splits * total * 4),
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
    the synchronised run, held-out PSNR (rendered with the grid under
    occupancy), the four kernels' launches, the Trainer, and the grid
    refreshes with the forward launches made inside them."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.train.loop import Trainer

    trainer = Trainer(rc, tc, train_ds, save_dir=save_dir, device="cuda",
                      verbose=False)
    losses = []
    step_fn, occ_update = trainer.step_fn, trainer._occ_update
    refresh = {"n": 0, "launches": 0, "calls": []}

    def recorded(state, batch, *occ):
        m = step_fn(state, batch, *occ)
        losses.append(m["loss"])
        return m

    def counted(*args):
        before = fused_mlp.fused_nerf_mlp.launches
        occ_update(*args)
        refresh["calls"].append(args)      # (seed step, decay)
        refresh["n"] += 1
        refresh["launches"] += fused_mlp.fused_nerf_mlp.launches - before

    trainer.step_fn, trainer._occ_update = recorded, counted
    torch.cuda.synchronize()
    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    trainer.step_fn, trainer._occ_update = step_fn, occ_update
    val = trainer._validate(val_ds)
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not np.isfinite(val["psnr"]):
        raise SystemExit("[train] non-finite loss or PSNR")
    return losses, wall, val, launches, trainer, refresh


def profile_step(trainer):
    """One profiled train step: the kernels' device ms, the rest of the
    device time, and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.pool.batch(trainer.state.step)
    occ = () if trainer.occ_grid is None else (trainer.occ_grid,)
    trainer.step_fn(trainer.state, batch, *occ)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(trainer.state, batch, *occ)
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
    return {"wall": wall, "busy": busy}


SMOKE_DIR = os.path.join(ROOT, "build", "chip_smoke")


def make_scene():
    """The 64x64 synthetic scene (8 train / 2 val views), written under
    build/chip_smoke/: (train, val) datasets."""
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_scene

    t0 = time.perf_counter()
    scene = os.path.join(SMOKE_DIR, "scene")
    make_synthetic_scene(scene, n_train=8, n_val=2, n_test=0,
                         img_wh=(TRAIN_WH, TRAIN_WH), seed=SEED)
    wh = (TRAIN_WH, TRAIN_WH)
    print(f"[train] scene {TRAIN_WH}x{TRAIN_WH}, 8 train / 2 val views in "
          f"{time.perf_counter() - t0:.1f} s")
    return (BlenderDataset(scene, "train", img_wh=wh),
            BlenderDataset(scene, "val", img_wh=wh))


def train_both(tag, rc, tc, train_ds, val_ds):
    """Train one recipe through the Trainer with the kernels and with
    use_kernel=False (train_once sets the launch counts to 0 just before
    each run and reads them just after); check that each run's loss falls
    (the mean of the last 20 steps below half the first 20's), that the
    kernel run launched the forward once per query and grid refresh and
    each backward kernel once per query, and that the plain run launched
    none. Returns {"kernel" | "plain": run}, each run a dict of
    train_once's results, the losses' first and last means and, under
    occupancy, the share of the grid's cells left occupied."""
    import numpy as np

    steps = tc.iters
    queries = 1 if rc.use_occupancy and rc.occ_one_shot else 2
    n_ref = -(-steps // rc.occ_update_every) if rc.use_occupancy else 0
    want = (queries * steps + n_ref,) + (queries * steps,) * 3
    runs = {}
    for name, cfg in (("kernel", rc),
                      ("plain", dataclasses.replace(rc, use_kernel=False))):
        losses, wall, val, launches, trainer, refresh = train_once(
            cfg, tc, train_ds, val_ds,
            os.path.join(SMOKE_DIR, tag.replace(" ", "_") + "_" + name))
        run = {"val": val, "launches": launches, "trainer": trainer,
               "refresh": refresh, "losses": losses, "wall": wall,
               "first": float(losses[:20].mean()),
               "last": float(losses[-20:].mean()), "occupied": None}
        grid = ""
        if trainer.occ_grid is not None:
            run["occupied"] = float((trainer.occ_grid.density
                                     > rc.occ_threshold).float().mean())
            grid = (f" with the grid ({100 * run['occupied']:.1f}% of cells "
                    f"occupied)")
        times = trainer.history["iteration_times"][10:]
        print(f"[{tag}] {name}: loss {run['first']:.5f} -> {run['last']:.5f} "
              f"(mean of first / last 20 steps), held-out PSNR "
              f"{val['psnr']:.2f} dB{grid}, SSIM {val['ssim']:.4f}; "
              f"{1e3 * wall / steps:.2f} ms per step "
              f"({tc.batch_size * steps / wall:.0f} rays/s, synchronised, "
              f"{refresh['n']} refreshes included), host median "
              f"{1e3 * np.median(times):.2f} ms")
        if not run["last"] < 0.5 * run["first"]:
            raise SystemExit(f"[{tag}] {name}: the loss did not fall")
        runs[name] = run
    k = runs["kernel"]
    print(f"[{tag}] kernel launches over {steps} steps: forward "
          f"{k['launches'][0]} ({k['refresh']['launches']} in "
          f"{k['refresh']['n']} refreshes), backward phase 1 "
          f"{k['launches'][1]}, phase 2 {k['launches'][2]}, reduction "
          f"{k['launches'][3]} (want {want}: {queries} queries per step, 1 "
          f"forward per refresh); plain run: {runs['plain']['launches']}")
    if (k["launches"] != want
            or (k["refresh"]["n"], k["refresh"]["launches"]) != (n_ref, n_ref)
            or runs["plain"]["launches"] != (0, 0, 0, 0)):
        raise SystemExit(f"[{tag}] the train steps did not go through the "
                         "kernels as expected")
    return runs


def check_psnr(tag, runs):
    """The kernel run's held-out PSNR: at least PSNR_MIN, and within
    PSNR_GAP of the plain run's."""
    psnr, plain = runs["kernel"]["val"]["psnr"], runs["plain"]["val"]["psnr"]
    gap = abs(psnr - plain)
    print(f"[{tag}] held-out PSNR kernel {psnr:.2f} dB vs use_kernel=False "
          f"{plain:.2f} dB (gap {gap:.2f} dB, limit {PSNR_GAP} dB; floor "
          f"{PSNR_MIN} dB)")
    if not (psnr >= PSNR_MIN and gap <= PSNR_GAP):
        raise SystemExit(f"[{tag}] held-out PSNR below the floor or off the "
                         "plain path")


def phase_train(train_ds, val_ds):
    """Train the flagship recipe through the Trainer on the synthetic scene,
    with the kernels and with use_kernel=False (train_both), hold the
    held-out PSNR (check_psnr), profile a step. Returns the kernel run's
    launches (forward, backward phase 1, phase 2, reduction)."""
    t0 = time.perf_counter()
    rc, tc = train_configs(*train_ds.dynamic_near_far())
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_RAYS} rays, "
          f"{rc.N_samples}+{rc.N_importance} samples, bf16")
    runs = train_both("train", rc, tc, train_ds, val_ds)
    check_psnr("train", runs)
    k = runs["kernel"]
    k["params"] = [p.detach().clone() for net in k["trainer"].state.params
                   .values() for p in net.parameters()]   # before profiling
    k["profile"] = profile_step(k["trainer"])
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    return k


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


def serve_frames(svc, tag):
    """Warm ``svc`` up, serve three frames of the serving pose over HTTP
    from RenderServer on 127.0.0.1 (png, npy, json with the depth map),
    with the forward's launch count set to 0 just before and read just
    after; check the images. Returns (the npy rgb, launches, frames)."""
    import numpy as np

    from nerfmlp_torch.ops.fused_mlp import fused_nerf_mlp
    from nerfmlp_torch.serve import RenderServer

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
        with urllib.request.urlopen(url + "/spec", timeout=30) as resp:
            spec = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if any(status != 200 for status, _ in replies):
        raise SystemExit(f"[{tag}] HTTP status {[s for s, _ in replies]}")
    if spec["occupancy"] != (svc.occ_grid is not None):
        raise SystemExit(f"[{tag}] /spec misreports occupancy")
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
        raise SystemExit(f"[{tag}] images are not finite, of the right shape "
                         "and consistent across formats")
    lat = health["latency"]
    print(f"[{tag}] frame latency p50 {lat['p50_ms']} ms, max "
          f"{lat['max_ms']} ms over {lat['n']} frames "
          f"(warmup {health['warmup_s']} s); /spec occupancy "
          f"{spec['occupancy']}, tile {spec['tile']}")
    return rgb, launches, len(replies)


def phase_serve(net):
    import numpy as np
    import torch

    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.render_path import rays_for_pose_device
    from nerfmlp_torch.serve import RenderService

    cfg = slice_config()
    svc = RenderService({"coarse": net}, cfg, H, W, FOCAL, tile=TILE,
                        device="cuda", log=lambda m: print(f"[serve] {m}"))
    rgb, launches, n_frames = serve_frames(svc, "serve")
    n_tiles = -(-H * W // TILE)
    want = 2 * n_tiles * n_frames
    print(f"[serve] {n_frames} frames: {launches} kernel launches "
          f"(want {want} = 2 x {n_tiles} tiles per frame)")
    if launches != want:
        raise SystemExit("[serve] the served frames did not go through the "
                         "kernel as expected")

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


def refresh_points(cfg):
    """The points and encoded directions of one grid refresh: the
    OCC_GRID^3 cell corners plus a seeded jitter, one sample each, with the
    constant direction [0, 0, -1] (ops/occupancy.update_grid's query)."""
    import torch

    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.occupancy import _cell_centers

    n = OCC_GRID ** 3
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    jitter = torch.rand((n, 3), generator=gen, device="cuda")
    pts = _cell_centers(OCC_GRID, OCC_AABB, jitter, "cuda")
    down = torch.tensor([0.0, 0.0, -1.0], device="cuda").expand(n, 3)
    return pts.contiguous(), positional_encoding(down, cfg.dir_enc_L)


def phase_occ_kernels(net):
    """The forward and the backward's kernels at occupancy sampling's
    shapes: the probe (16 samples) and refine (48) queries of a 1024-ray
    step, each forward and backward (each backward kernel alone too); a
    grid refresh (64^3 points, forward only); a served 16,384-ray tile's
    probe and refine queries (forward only); and in hi_lo mode (fp32
    'high') the one-shot recipe's query (1024 rays x 64 samples, forward
    and backward) and its grid refresh. Returns {label: record} and the
    backward's per-kernel records {"refine", "probe", "hi_lo"}."""
    cfg = slice_config()
    t0 = time.perf_counter()
    recs, phases = {}, {}
    for n_samples, label in ((OCC_PROBE, "probe"), (OCC_REFINE, "refine")):
        pts, dirs = serving_points(n_samples, cfg, n_rays=TRAIN_RAYS)
        recs[f"train {label}"] = check_kernel(net, cfg, pts, dirs,
                                              f"occ train {label}",
                                              time_it=True)
        recs[f"bwd {label}"], phases[label] = check_backward(
            net, cfg, pts, dirs, f"occ {label}", time_it=True)
    refresh = refresh_points(cfg)
    recs["refresh"] = check_kernel(net, cfg, *refresh, "occ grid refresh",
                                   time_it=True)
    for n_samples, label in ((OCC_PROBE, "probe"), (OCC_REFINE, "refine")):
        pts, dirs = serving_points(n_samples, cfg, n_rays=OCC_TILE)
        recs[f"serve {label}"] = check_kernel(net, cfg, pts, dirs,
                                              f"occ served tile {label}",
                                              time_it=True)
    pts, dirs = serving_points(OCC_PROBE + OCC_REFINE, cfg, n_rays=TRAIN_RAYS)
    recs["hi_lo train"] = check_kernel(net, cfg, pts, dirs,
                                       "occ hi_lo one-shot train",
                                       time_it=True, hi_lo=True)
    recs["bwd hi_lo"], phases["hi_lo"] = check_backward(
        net, cfg, pts, dirs, "occ hi_lo one-shot", time_it=True, hi_lo=True)
    recs["hi_lo refresh"] = check_kernel(net, cfg, *refresh,
                                         "occ hi_lo grid refresh",
                                         time_it=True, hi_lo=True)
    print(f"[occ] kernel checks took {time.perf_counter() - t0:.1f} s")
    return recs, phases


def turbo_configs(near, far):
    """The turbo recipe (configs/lego_turbo_bf16.txt): 8x256, batch 1024,
    occupancy 16+48 hierarchical, 64 grid-scored depths, a 64^3 grid
    refreshed every OCC_EVERY steps, bf16 through the kernels, perturb on;
    TRAIN_STEPS steps, no validation inside the run."""
    from nerfmlp_torch.config import RenderConfig, TrainConfig

    rc = RenderConfig(N_samples=OCC_PROBE, N_importance=OCC_REFINE, near=near,
                      far=far, white_bkgd=True, perturb=True,
                      raw_noise_std=0.0, compute_dtype="bfloat16",
                      use_kernel=True, aabb=OCC_AABB, use_occupancy=True,
                      occ_dense_samples=OCC_DENSE, occ_grid_size=OCC_GRID,
                      occ_update_every=OCC_EVERY,
                      occ_warmup_steps=OCC_WARMUP)
    tc = TrainConfig(batch_size=TRAIN_RAYS, iters=TRAIN_STEPS, seed=SEED,
                     lr_decay_steps=LR_DECAY_STEPS, quick_val_interval=0,
                     full_val_interval=0, log_interval=100, ckpt_interval=0)
    return rc, tc


def fast_configs(near, far):
    """The fast recipe (configs/lego_fast_fp32.txt) in the one-shot
    protocol: the turbo recipe in fp32 'high' (the kernels' hi_lo mode)
    with 128 grid-scored depths; HI_LO_STEPS steps, the first half on the
    central crop."""
    rc, tc = turbo_configs(near, far)
    return (dataclasses.replace(rc, compute_dtype="float32",
                                fp32_precision="high", occ_one_shot=True,
                                occ_dense_samples=128),
            dataclasses.replace(tc, iters=HI_LO_STEPS,
                                precrop_iters=HI_LO_STEPS // 2))


def phase_occ_train(train_ds, val_ds):
    """Train the turbo recipe through the Trainer with the kernels and with
    use_kernel=False (train_both: 2 forward launches per step plus 1 per
    refresh, 2 of each backward kernel per step); check that each run's
    grid pruned cells, hold the held-out PSNR rendered with each run's grid
    (check_psnr), profile a step. Returns the kernel run."""
    t0 = time.perf_counter()
    rc, tc = turbo_configs(*train_ds.dynamic_near_far())
    print(f"[occ train] {TRAIN_STEPS} steps of {TRAIN_RAYS} rays, "
          f"occupancy {rc.N_samples}+{rc.N_importance} hierarchical, "
          f"{rc.occ_dense_samples} grid-scored depths, {OCC_GRID}^3 grid "
          f"every {OCC_EVERY} steps (decay 1 to step {OCC_WARMUP}), bf16")
    runs = train_both("occ train", rc, tc, train_ds, val_ds)
    if not all(r["occupied"] < 1.0 for r in runs.values()):
        raise SystemExit("[occ train] the grid pruned no cell: training "
                         "never sampled a pruned grid")
    check_psnr("occ train", runs)
    profile_step(runs["kernel"]["trainer"])
    print(f"[occ train] phase took {time.perf_counter() - t0:.1f} s")
    return runs["kernel"]


def phase_occ_hi_lo(train_ds, val_ds):
    """The one-shot fp32 'high' recipe through the kernels' hi_lo mode and
    with use_kernel=False (train_both: 1 launch of each kernel per step
    plus 1 forward per refresh); the kernel run's last losses must lie
    within HI_LO_TRACK of the plain run's. Returns the kernel run."""
    t0 = time.perf_counter()
    rc, tc = fast_configs(*train_ds.dynamic_near_far())
    print(f"[occ hi_lo] {HI_LO_STEPS} steps of {TRAIN_RAYS} rays, occupancy "
          f"one-shot {rc.N_samples + rc.N_importance} samples, "
          f"{rc.occ_dense_samples} grid-scored depths, fp32 'high', central "
          f"crop for {tc.precrop_iters} steps")
    runs = train_both("occ hi_lo", rc, tc, train_ds, val_ds)
    k, p = runs["kernel"]["last"], runs["plain"]["last"]
    gap = abs(k - p) / p
    print(f"[occ hi_lo] last-20 loss, kernel vs use_kernel=False: relative "
          f"gap {gap:.3e} (limit {HI_LO_TRACK}); "
          f"{time.perf_counter() - t0:.1f} s")
    if not gap <= HI_LO_TRACK:
        raise SystemExit("[occ hi_lo] the kernel run does not track the "
                         "plain run")
    return runs["kernel"]


def phase_occ_serve(trainer):
    """Serve the turbo model over HTTP in 16,384-ray tiles with the grid
    that RenderService builds from its weights (build_grid through the
    forward kernel, 4 launches): 2 forward launches per tile; that grid
    against the plain build from the same seed; the frame against
    use_kernel=False with the same grid (see below); a profiled frame.
    Returns the frames' launches."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops.occupancy import build_grid
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.render_path import rays_for_pose_device
    from nerfmlp_torch.serve import GRID_SEED, RenderService

    t0 = time.perf_counter()
    cfg, params = trainer.rc, trainer.state.params
    fused_mlp.fused_nerf_mlp.launches = 0
    svc = RenderService(params, cfg, H, W, FOCAL, tile=OCC_TILE,
                        device="cuda", log=lambda m: print(f"[occ serve] {m}"))
    built = fused_mlp.fused_nerf_mlp.launches
    grid = svc.occ_grid
    plain_grid = build_grid(params, dataclasses.replace(cfg, use_kernel=False),
                            torch.Generator(device="cuda").manual_seed(
                                GRID_SEED), resolution=cfg.occ_grid_size)
    dk, dp = grid.density, plain_grid.density
    err = float((dk - dp).abs().max())
    norm = err / max(float(dp.abs().max()), 1e-12)
    thr = cfg.occ_threshold
    flips = (dk > thr) != (dp > thr)
    near_thr = (dp - thr).abs() <= KERNEL_TOL * float(dp.abs().max())
    print(f"[occ serve] the service's grid, {OCC_GRID}^3 built through the "
          f"kernel ({built} launches, 4 refreshes), vs the plain build: "
          f"max|err| {err:.3e}, normalised {norm:.3e} (tol {KERNEL_TOL}); "
          f"occupied {100 * float((dk > thr).float().mean()):.1f}% / "
          f"{100 * float((dp > thr).float().mean()):.1f}%, "
          f"{int(flips.sum())} cells decided otherwise, all within "
          f"{KERNEL_TOL} x max density of the threshold: "
          f"{bool((near_thr | ~flips).all())}")
    if not (norm <= KERNEL_TOL and built == 4 and (near_thr | ~flips).all()):
        raise SystemExit("[occ serve] the kernel-built grid disagrees with "
                         "the plain build")
    rgb, launches, n_frames = serve_frames(svc, "occ serve")
    n_tiles = -(-H * W // OCC_TILE)
    want = 2 * n_tiles * n_frames
    print(f"[occ serve] {n_frames} frames: {launches} kernel launches (want "
          f"{want} = probe + refine query x {n_tiles} tiles per frame)")
    if launches != want:
        raise SystemExit("[occ serve] the served frames did not go through "
                         "the kernel as expected")

    # The same frame with the same grid through use_kernel=False. The
    # trained model's bf16 frames, the kernel's and the module path's, each
    # lie ~3e-2 (99.9th percentile) from the fp32 frame and ~2e-2 from
    # each other, beyond the random-weight serving bars; so the bf16 kernel
    # frame is held to be no farther from the fp32 module frame than the
    # bf16 module frame is, and the hi_lo kernel frame (fp32 'high') to
    # the serving bar against it, for 99.9% of values (the refine samples
    # follow the probes' weights discontinuously at a few pixels).
    o, d, _ = rays_for_pose_device(pose_spherical(*SERVE_POSE), H, W, FOCAL,
                                   cfg, device="cuda")
    frames = {}
    for name, c in (
            ("kernel", cfg),
            ("module bf16", dataclasses.replace(cfg, use_kernel=False)),
            ("kernel hi_lo", dataclasses.replace(
                cfg, compute_dtype="float32", fp32_precision="high")),
            ("module fp32", dataclasses.replace(
                cfg, use_kernel=False, compute_dtype="float32",
                fp32_precision="highest"))):
        p = prepare_params(params, c)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = render_image_maps(p, o, d, H, W, c, tile=OCC_TILE,
                                occ_grid=grid)
        frames[name] = np.clip(out["rgb_map"].cpu().numpy(), 0.0, 1.0)
        print(f"[occ serve] {name} frame rendered directly in "
              f"{time.perf_counter() - t1:.3f} s")
    if not np.array_equal(frames["kernel"], rgb):
        raise SystemExit("[occ serve] the served frame differs from a direct "
                         "render through the kernel")

    def dist(a, b):
        e = np.abs(frames[a] - frames[b])
        q = float(np.quantile(e, 0.999))
        print(f"[occ serve] {a} vs {b}: rgb max|err| {e.max():.3e}, 99.9th "
              f"percentile {q:.3e}, mean {e.mean():.3e}, "
              f"{100 * float((e > FRAME_TOL).mean()):.2f}% of values above "
              f"{FRAME_TOL}")
        return q, float(e.mean())

    dist("kernel", "module bf16")
    k_q, k_mean = dist("kernel", "module fp32")
    m_q, m_mean = dist("module bf16", "module fp32")
    h_q, _ = dist("kernel hi_lo", "module fp32")
    if not (k_q <= FRAME_RATIO * m_q and k_mean <= FRAME_RATIO * m_mean
            and h_q <= FRAME_TOL):
        raise SystemExit("[occ serve] served frame disagrees with the plain "
                         "path")
    profile_frame(prepare_params(params, cfg), o, d, cfg, tile=OCC_TILE,
                  occ_grid=grid)
    print(f"[occ serve] phase took {time.perf_counter() - t0:.1f} s")
    return launches


def gif_info(path):
    """(width, height, frames, loop count) of a GIF89a file, by walking
    its blocks: this phase's own reader, no imaging package."""
    with open(path, "rb") as f:
        b = f.read()
    if b[:6] != b"GIF89a":
        raise SystemExit(f"[inference] {path} is not a GIF89a file")
    w, h, packed = struct.unpack("<HHB", b[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, loop = 0, None

    def skip_sub_blocks(pos):
        n = 0
        while b[pos]:
            n += b[pos]
            pos += b[pos] + 1
        return pos + 1, n

    while pos < len(b) and b[pos] != 0x3B:
        if b[pos] == 0x21:                      # extension
            if b[pos + 1] == 0xFF and b[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", b[pos + 16:pos + 18])[0]
            pos, _ = skip_sub_blocks(pos + 2)
        elif b[pos] == 0x2C:                    # image
            packed = b[pos + 9]
            pos += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
            pos, n = skip_sub_blocks(pos + 1)
            if n == 0:
                raise SystemExit(f"[inference] {path}: a frame without data")
            frames += 1
        else:
            raise SystemExit(f"[inference] {path}: bad block at {pos}")
    if pos >= len(b):
        raise SystemExit(f"[inference] {path}: no trailer")
    return w, h, frames, loop


class Timed:
    """Wrap ``owner.name`` (a function or method) for the duration of a
    ``with`` block: each call synchronised and timed, seconds kept, and
    the forward kernel's launches inside it; with ``keep_args`` the calls'
    positional arguments too (a method's first is its object)."""

    def __init__(self, owner, name, keep_args=False):
        self.owner, self.name, self.times = owner, name, []
        self.fwd, self.keep_args, self.args = [], keep_args, []

    def __enter__(self):
        import torch

        from nerfmlp_torch.ops.fused_mlp import fused_nerf_mlp

        inner = self.fn = getattr(self.owner, self.name)

        def timed(*a, **kw):
            if self.keep_args:
                self.args.append(a)
            torch.cuda.synchronize()
            before = fused_nerf_mlp.launches
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            self.fwd.append(fused_nerf_mlp.launches - before)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def phase_inference():
    """The inference entry points on the card, as a user runs them (see
    the module docstring, phase 7). Returns the render_video run's forward
    launches (the grid build's and the frames')."""
    import numpy as np
    import torch

    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_scene
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops import render as render_mod
    from nerfmlp_torch.scripts import eval as eval_cli
    from nerfmlp_torch.scripts import render_video, train as train_cli
    from nerfmlp_torch.serve import RenderService
    from nerfmlp_torch.train import loop
    from nerfmlp_torch.train.checkpoint import load_params_any

    t0 = time.perf_counter()
    root = os.path.join(SMOKE_DIR, "inference")
    shutil.rmtree(root, ignore_errors=True)     # no auto-resume of a rerun
    scene, run = os.path.join(root, "scene"), os.path.join(root, "run")
    make_synthetic_scene(scene, n_train=8, n_val=2, n_test=2,
                         img_wh=(INF_WH, INF_WH), seed=SEED)
    print(f"[inference] scene {INF_WH}x{INF_WH}, 8 train / 2 val / 2 test "
          f"views in {time.perf_counter() - t0:.1f} s")
    # The config as it is; on the command line only what this scene and
    # the time limit force: its box, the steps, the turbo cell's refresh
    # cuts, the events' interval and frames, a quick validation inside the
    # 200 steps (the loss is read there), the save dir.
    box = [str(v) for v in OCC_AABB]
    argv = ["--config", os.path.join(ROOT, "configs", "lego_turbo_bf16.txt"),
            "--datadir", scene, "--save_dir", run, "--aabb", *box,
            "--iters", str(INF_STEPS), "--occ_update_every", str(OCC_EVERY),
            "--occ_warmup_steps", str(OCC_WARMUP),
            "--i_video", str(INF_EVENT), "--i_testset", str(INF_EVENT),
            "--i_img", str(INF_EVENT), "--video_frames", str(INF_FRAMES),
            "--quick_val_interval", str(INF_EVENT)]
    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with Timed(loop.Trainer, "_video_event") as video, \
            Timed(loop.Trainer, "_testset_event") as testset, \
            Timed(loop.Trainer, "_save_val_image") as frame:
        metrics = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = [c.launches for c in counters]
    res = metrics["config"]["full_val_res"]
    losses = metrics["train_losses"]
    final = metrics["final_val"]["psnr"]
    steps = metrics["iteration_times"]
    print(f"[inference] train CLI: {INF_STEPS} steps at {res[0]}x{res[1]} "
          f"in {wall:.1f} s (events and validation included), host median "
          f"{1e3 * statistics.median(steps):.2f} ms per step; mean loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} (steps 1-{INF_EVENT} / "
          f"{INF_EVENT + 1}-{INF_STEPS}); final held-out PSNR {final:.2f} dB; "
          f"test sweep {[round(p, 2) for p in metrics['testset_psnrs']]} dB "
          f"at {metrics['testset_steps']}")
    print(f"[inference] events: video {video.times} s, test sweep "
          f"{testset.times} s, held-out frames {frame.times} s")
    print(f"[inference] launches in the train CLI run: forward {launches[0]}"
          f", backward phase 1 {launches[1]}, phase 2 {launches[2]}, "
          f"reduction {launches[3]} (each backward kernel: want "
          f"{2 * INF_STEPS})")
    gifs = {}
    for kind in ("rgb", "disp", "rgb_still"):
        found = glob.glob(os.path.join(
            run, f"*_spiral_{INF_EVENT:06d}_{kind}.gif"))
        if len(found) != 1:
            raise SystemExit(f"[inference] no {kind} video at step "
                             f"{INF_EVENT}: {sorted(os.listdir(run))}")
        gifs[kind] = gif_info(found[0])
    print(f"[inference] videos (w, h, frames, loop): {gifs}")
    want_files = [os.path.join(run, f"testset_{INF_EVENT:06d}", n)
                  for n in ("000.png", "001.png")]
    want_files += [os.path.join(run, f"val_{s:06d}.png")
                   for s in (INF_EVENT, INF_STEPS)]
    missing = [f for f in want_files if not os.path.exists(f)]
    if (res != [INF_WH // 2] * 2 or missing
            or any(g[2:] != (INF_FRAMES, 0) for g in gifs.values())
            or metrics["testset_steps"] != [INF_EVENT]
            or not losses[-1] < losses[0] or not final >= PSNR_MIN
            or launches[1:] != [2 * INF_STEPS] * 3
            or launches[0] <= 2 * INF_STEPS):
        raise SystemExit(f"[inference] the train CLI run failed its checks "
                         f"(missing {missing})")

    t1 = time.perf_counter()
    path = train_cli.main(argv + ["--render_only"])
    test = train_cli.main(argv + ["--render_only", "--render_test"])
    test_psnr = float(np.mean(test["psnrs"]))
    print(f"[inference] --render_only: {path['render_only']}, "
          f"{gif_info(os.path.join(path['render_only'], 'video_rgb.gif'))}; "
          f"--render_test: {test['render_only']}, PSNR "
          f"{[round(float(p), 2) for p in test['psnrs']]} dB, mean "
          f"{test_psnr:.2f}; "
          f"{time.perf_counter() - t1:.1f} s")
    if not (os.path.exists(os.path.join(path["render_only"],
                                        f"{INF_FRAMES - 1:03d}.png"))
            and os.path.exists(os.path.join(path["render_only"],
                                            "video_disp.gif"))
            and test_psnr >= PSNR_MIN):
        raise SystemExit("[inference] --render_only failed its checks")

    ckpt = os.path.join(run, "model_final.pt")
    occ = ["--use_occupancy", "--aabb", *box, "--N_samples",
           str(OCC_PROBE), "--N_importance", str(OCC_REFINE),
           "--occ_dense_samples", str(OCC_DENSE)]
    fused_mlp.fused_nerf_mlp.launches = 0
    with Timed(render_mod, "render_image_maps") as frames:
        out = render_video.main(["--datadir", scene, "--ckpt", ckpt,
                                 "--out_dir", os.path.join(root, "video"),
                                 "--n_frames", str(INF_FRAMES), "--size",
                                 str(INF_SIZE)] + occ)
    rv_launches = fused_mlp.fused_nerf_mlp.launches
    n_tiles = -(-INF_SIZE * INF_SIZE // OCC_TILE)
    want = 4 + 2 * n_tiles * INF_FRAMES
    p50 = statistics.median(frames.times)
    print(f"[inference] render_video: {INF_FRAMES} frames of "
          f"{INF_SIZE}x{INF_SIZE}, p50 {p50:.4f} s a frame (max "
          f"{max(frames.times):.4f}); {rv_launches} forward launches (want "
          f"{want}: 4 for the grid, 2 x {n_tiles} tiles a frame); videos "
          f"{[gif_info(v) for v in out['videos']]}")
    if rv_launches != want or any(gif_info(v)[2] != INF_FRAMES
                                  for v in out["videos"]):
        raise SystemExit("[inference] render_video did not go through the "
                         "kernel as expected")
    rc = out["cfg"]
    ds = BlenderDataset(scene, "train", img_wh=(INF_SIZE, INF_SIZE))
    svc = RenderService(
        load_params_any(ckpt, rc.model_config(), device="cuda"), rc,
        INF_SIZE, INF_SIZE, ds.focal, tile=OCC_TILE, device="cuda",
        log=lambda m: None)
    ref = svc.render_pose(ds.render_poses(n_frames=INF_FRAMES)[0])["rgb_map"]
    err = float(np.abs(out["rgbs"][0] - ref).max())
    print(f"[inference] render_video frame 0 vs RenderService's frame: "
          f"max|err| {err:.3e} (tol {INF_FRAME_TOL})")
    if not err <= INF_FRAME_TOL:
        raise SystemExit("[inference] render_video's frame differs from the "
                         "service's")

    t1 = time.perf_counter()
    report = eval_cli.main(["--datadir", scene, "--split", "val", "--img_wh",
                            str(INF_WH // 2), str(INF_WH // 2), "--ckpt",
                            ckpt, "--out", os.path.join(root, "eval.json")]
                           + occ)
    gap = abs(report["mean_psnr"] - final)
    print(f"[inference] eval CLI on val: mean PSNR {report['mean_psnr']:.2f} "
          f"dB, SSIM {report['mean_ssim']:.4f} vs the Trainer's final "
          f"{final:.2f} dB (gap {gap:.2f}, limit {PSNR_GAP}); "
          f"{time.perf_counter() - t1:.1f} s")
    if not (report["mean_psnr"] >= PSNR_MIN and gap <= PSNR_GAP
            and os.path.exists(os.path.join(root, "eval.json"))):
        raise SystemExit("[inference] eval failed its checks")
    print(f"[inference] phase took {time.perf_counter() - t0:.1f} s")
    return rv_launches


def ndc_points(cfg, pose, hwf, n_rays, n_samples):
    """Points and encoded world view directions of ``n_rays`` NDC rays
    through the centre of a forward-facing pose's image, ``n_samples``
    evenly spaced NDC depths in [0, 1] per ray (the forward-facing path's
    inputs: NDC points, directions that are not rays_d)."""
    import torch

    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.render_path import rays_for_pose_device

    h, w, focal = hwf
    o, d, vd = rays_for_pose_device(pose, h, w, focal, cfg, device="cuda")
    mid = (h * w - n_rays) // 2
    o, d, vd = o[mid:mid + n_rays], d[mid:mid + n_rays], vd[mid:mid + n_rays]
    z = torch.linspace(0.0, 1.0, n_samples, device="cuda")
    pts = (o[:, None, :] + d[:, None, :] * z[None, :, None]).reshape(-1, 3)
    dirs = positional_encoding(vd, cfg.dir_enc_L)
    dirs = dirs[:, None, :].expand(n_rays, n_samples, dirs.shape[-1])
    return pts.contiguous(), dirs.reshape(n_rays * n_samples, -1)


def write_deepvoxels_scene(root):
    """A DeepVoxels-layout capture of the synthetic scene's field, written
    here (the layout of tests/test_deepvoxels.py's writer; a fixture of
    this script), scene "smoke": OpenCV poses on a hemisphere of
    DV_RADIUS, DV_WH images integrated over the loader's near / far
    (R -/+ 1) on white, 8 train / 2 validation / 1 test views."""
    import numpy as np

    from nerfmlp_torch.data.synthetic import render_analytic
    from nerfmlp_torch.ops.rays import look_at_matrix
    from nerfmlp_torch.utils.image import save_png

    wh, radius = DV_WH, DV_RADIUS
    focal = 0.5 * wh / np.tan(0.5 * 0.6911112070083618)   # Lego's FOV
    gl_to_cv = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    rng = np.random.default_rng(SEED)
    for split, n in (("train", 8), ("validation", 2), ("test", 1)):
        base = os.path.join(root, split, "smoke")
        os.makedirs(os.path.join(base, "pose"))
        os.makedirs(os.path.join(base, "rgb"))
        with open(os.path.join(base, "intrinsics.txt"), "w") as f:
            f.write(f"{focal} {wh / 2} {wh / 2} 0.\n0. 0. 0.\n1.0\n1.0\n"
                    f"{wh} {wh}\n")
        for i in range(n):
            theta = 2.0 * np.pi * (i + rng.uniform(0.0, 0.5)) / n
            phi = np.deg2rad(rng.uniform(20.0, 50.0))
            eye = radius * np.array([np.cos(theta) * np.cos(phi),
                                     np.sin(theta) * np.cos(phi),
                                     np.sin(phi)])
            c2w = look_at_matrix(eye, np.zeros(3))
            np.savetxt(os.path.join(base, "pose", f"{i:06d}.txt"),
                       (c2w @ gl_to_cv).reshape(1, 16))
            save_png(os.path.join(base, "rgb", f"{i:06d}.png"),
                     render_analytic(c2w, wh, wh, focal, near=radius - 1.0,
                                     far=radius + 1.0))


def train_cli_run(tag, argv, steps):
    """One train CLI run with every launch counter set to 0 just before
    and read just after; the renders inside it (held-out views, videos)
    timed and their forward launches counted apart. Returns (metrics,
    launches, the step's forward launches, seconds of train() less its
    renders, the Trainer)."""
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.scripts import train as train_cli
    from nerfmlp_torch.train import loop

    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    with Timed(loop.Trainer, "train", keep_args=True) as tr, \
            Timed(loop.Trainer, "_render_view") as views, \
            Timed(loop.Trainer, "_video_event") as video:
        metrics = train_cli.main(argv)
    launches = [c.launches for c in counters]
    rendered = sum(views.fwd) + sum(video.fwd)
    wall = tr.times[0] - sum(views.times) - sum(video.times)
    losses = metrics["train_losses"]
    print(f"[{tag}] {steps} steps at {metrics['config']['full_val_res']}: "
          f"{1e3 * wall / steps:.2f} ms per step synchronised (train() less "
          f"its renders: {len(views.times)} held-out views, "
          f"{len(video.times)} video events, {sum(video.times):.2f} s), "
          f"host median {1e3 * statistics.median(metrics['iteration_times']):.2f}"
          f" ms; mean loss {losses[0]:.5f} -> {losses[-1]:.5f}; final "
          f"held-out PSNR {metrics['final_val']['psnr']:.2f} dB, SSIM "
          f"{metrics['final_val']['ssim']:.4f}")
    print(f"[{tag}] launches: forward {launches[0]} ({rendered} in the "
          f"renders, {launches[0] - rendered} in the steps), backward phase "
          f"1 {launches[1]}, phase 2 {launches[2]}, reduction {launches[3]}")
    return metrics, launches, launches[0] - rendered, wall, tr.args[0][0]


def phase_llff(net):
    """Forward-facing (LLFF, NDC) and DeepVoxels scenes as a user runs them
    (the module docstring, phase 8). Returns the llff path's records: its
    forward launches, the kernel records at its shapes and the train CLI
    run's backward launches."""
    import numpy as np

    from nerfmlp_torch.data.llff import LLFFDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops import render as render_mod
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.render_path import rays_for_pose_device
    from nerfmlp_torch.scripts import eval as eval_cli
    from nerfmlp_torch.scripts import render_video
    from nerfmlp_torch.scripts import serve as serve_cli
    from nerfmlp_torch.serve import RenderServer
    from nerfmlp_torch.train.checkpoint import load_params_any

    t0 = time.perf_counter()
    root = os.path.join(SMOKE_DIR, "llff")
    shutil.rmtree(root, ignore_errors=True)     # no auto-resume of a rerun
    scene = os.path.join(root, "scene")
    make_synthetic_llff_scene(scene, n_images=LLFF_VIEWS, img_wh=LLFF_WH,
                              style="forward", seed=SEED)
    os.rename(os.path.join(scene, "images"), os.path.join(scene, "images_8"))
    print(f"[llff] forward-facing scene {LLFF_WH[0]}x{LLFF_WH[1]}, "
          f"{LLFF_VIEWS} views as a pre-minified images_8/, in "
          f"{time.perf_counter() - t0:.1f} s")

    # configs/fern.txt as it is; on the command line only what this scene
    # and the time limit force: the data and save dirs, the steps, the
    # interval of the videos (8 frames) and of a quick validation (the loss
    # is read there).
    runs = {}
    for name, extra in (("kernel", []), ("plain", ["--no_kernel"])):
        argv = ["--config", os.path.join(ROOT, "configs", "fern.txt"),
                "--datadir", scene, "--save_dir", os.path.join(root, name),
                "--iters", str(LLFF_STEPS), "--i_video", str(LLFF_EVENT),
                "--video_frames", str(INF_FRAMES), "--quick_val_interval",
                str(LLFF_EVENT)] + extra
        runs[name] = train_cli_run(f"llff {name}", argv, LLFF_STEPS)
    metrics, launches, step_fwd, _, trainer = runs["kernel"]
    plain_metrics, plain_launches = runs["plain"][:2]
    rc = trainer.rc
    final, plain_final = (metrics["final_val"]["psnr"],
                          plain_metrics["final_val"]["psnr"])
    gifs = {}
    for kind in ("rgb", "disp", "rgb_still"):
        found = glob.glob(os.path.join(
            root, "kernel", f"*_spiral_{LLFF_EVENT:06d}_{kind}.gif"))
        gifs[kind] = gif_info(found[0]) if len(found) == 1 else None
    print(f"[llff] config: {rc.N_samples}+{rc.N_importance} samples, ndc "
          f"{rc.ndc}, white_bkgd {rc.white_bkgd}, raw_noise_std "
          f"{rc.raw_noise_std}, near/far {rc.near}/{rc.far}, quick val "
          f"{metrics['config']['quick_val_res']}; spiral videos (w, h, "
          f"frames, loop): {gifs}")
    print(f"[llff] held-out PSNR kernel {final:.2f} dB vs --no_kernel "
          f"{plain_final:.2f} dB (gap {abs(final - plain_final):.2f}, limit "
          f"{PSNR_GAP}; floor {PSNR_MIN})")
    want = 2 * LLFF_STEPS
    if not (rc.ndc and not rc.white_bkgd and rc.raw_noise_std == 1.0
            and (rc.N_samples, rc.N_importance) == (LLFF_SAMPLES,) * 2
            and metrics["config"]["full_val_res"] == list(LLFF_WH)
            and all(g is not None and g[:3] == (*LLFF_WH, INF_FRAMES)
                    for g in gifs.values())
            and all(m["train_losses"][-1] < m["train_losses"][0]
                    for m in (metrics, plain_metrics))
            and final >= PSNR_MIN and plain_final >= PSNR_MIN
            and abs(final - plain_final) <= PSNR_GAP):
        raise SystemExit("[llff] the train CLI runs failed their checks")
    if (step_fwd != want or launches[1:] != [want] * 3
            or plain_launches != [0, 0, 0, 0]):
        raise SystemExit(f"[llff] the steps did not go through the kernels "
                         f"as expected (want {want} of each)")
    profile_step(trainer)

    ckpt = os.path.join(root, "kernel", "model_final.pt")
    flags = ["--datadir", scene, "--dataset_type", "llff", "--factor", "8"]
    fused_mlp.fused_nerf_mlp.launches = 0
    with Timed(render_mod, "render_image_maps") as frames:
        out = render_video.main(flags + [
            "--ckpt", ckpt, "--out_dir", os.path.join(root, "video"),
            "--n_frames", str(INF_FRAMES), "--size", str(LLFF_SIZE)])
    rv_launches = fused_mlp.fused_nerf_mlp.launches
    h, w = out["rgbs"].shape[1:3]
    n_tiles = -(-h * w // TILE)
    print(f"[llff] render_video: {INF_FRAMES} spiral frames of {w}x{h}, "
          f"p50 {statistics.median(frames.times):.4f} s a frame (max "
          f"{max(frames.times):.4f}); {rv_launches} forward launches "
          f"({rv_launches / INF_FRAMES:.0f} a frame, want 2 x {n_tiles} "
          f"tiles); videos {[gif_info(v) for v in out['videos']]}")
    if ((w, h) != (LLFF_SIZE, LLFF_SIZE * 3 // 4) or not out["cfg"].ndc
            or rv_launches != 2 * n_tiles * INF_FRAMES
            or any(gif_info(v)[2] != INF_FRAMES for v in out["videos"])):
        raise SystemExit("[llff] render_video failed its checks")

    pose = LLFFDataset(scene, "train", img_wh=LLFF_WH, factor=8
                       ).render_poses(n_frames=INF_FRAMES)[0]
    args = serve_cli.build_parser().parse_args(flags + [
        "--ckpt", ckpt, "--img_wh", str(w), str(h), "--N_importance",
        str(LLFF_SAMPLES)])
    svc = serve_cli.build_service(args)
    svc.warmup()
    server = RenderServer(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        fused_mlp.fused_nerf_mlp.launches = 0
        req = urllib.request.Request(
            "http://%s:%d/render" % server.server_address[:2],
            method="POST", data=json.dumps(
                {"c2w": pose.tolist(), "format": "npy"}).encode())
        t1 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, body = resp.status, resp.read()
        served_s = time.perf_counter() - t1
        served_launches = fused_mlp.fused_nerf_mlp.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    served = np.load(io.BytesIO(body))
    err = float(np.abs(served - np.clip(out["rgbs"][0], 0.0, 1.0)).max())
    print(f"[llff] serve CLI (--dataset_type llff --datadir): one {w}x{h} "
          f"frame over HTTP in {served_s:.3f} s, {served_launches} forward "
          f"launches; ndc {svc.cfg.ndc}, defaults {svc.defaults}; vs "
          f"render_video's frame 0: max|err| {err:.3e} (tol "
          f"{INF_FRAME_TOL})")
    if (status != 200 or served.shape != (h, w, 3) or not svc.cfg.ndc
            or svc.cfg.white_bkgd or served_launches != 2 * n_tiles
            or not err <= INF_FRAME_TOL):
        raise SystemExit("[llff] the served frame failed its checks")

    # The served frame through use_kernel=False: a trained model's bf16
    # frames lie apart from the fp32 frame on both bf16 paths, so the
    # kernel frame is held to be no farther from the fp32 module frame
    # than the bf16 module frame is (x FRAME_RATIO), as phase 6 holds it.
    params = load_params_any(ckpt, rc.model_config(), device="cuda")
    cfg = svc.cfg
    o, d, vd = rays_for_pose_device(pose, h, w, svc.defaults["focal"], cfg,
                                    device="cuda")
    got = {}
    for name, c in (
            ("kernel", cfg),
            ("module bf16", dataclasses.replace(cfg, use_kernel=False)),
            ("module fp32", dataclasses.replace(
                cfg, use_kernel=False, compute_dtype="float32",
                fp32_precision="highest"))):
        r = render_image_maps(prepare_params(params, c), o, d, h, w, c,
                              tile=TILE, viewdirs=vd)
        got[name] = np.clip(r["rgb_map"].cpu().numpy(), 0.0, 1.0)

    def dist(a, b):
        e = np.abs(got[a] - got[b])
        q = float(np.quantile(e, 0.999))
        print(f"[llff] {a} vs {b}: rgb max|err| {e.max():.3e}, 99.9th "
              f"percentile {q:.3e}, mean {e.mean():.3e}")
        return q, float(e.mean())

    dist("kernel", "module bf16")
    k_q, k_mean = dist("kernel", "module fp32")
    m_q, m_mean = dist("module bf16", "module fp32")
    if not (np.array_equal(got["kernel"], served)
            and k_q <= FRAME_RATIO * m_q and k_mean <= FRAME_RATIO * m_mean):
        raise SystemExit("[llff] the served frame disagrees with the plain "
                         "path")

    # The kernels at this path's shapes, random weights (seed 0).
    kcfg = dataclasses.replace(slice_config(), N_importance=LLFF_SAMPLES,
                               near=0.0, far=1.0, ndc=True, white_bkgd=False)
    hwf = (h, w, svc.defaults["focal"])
    pts, dirs = ndc_points(kcfg, pose, hwf, TILE, LLFF_SAMPLES)
    tile = check_kernel(net, kcfg, pts, dirs, "llff served NDC tile",
                        time_it=True)
    pts, dirs = ndc_points(kcfg, pose, hwf, TRAIN_RAYS, LLFF_SAMPLES)
    fwd_train = check_kernel(net, kcfg, pts, dirs, "llff train call",
                             time_it=True)
    bwd, phases = check_backward(net, kcfg, pts, dirs, "llff train call",
                                 time_it=True)

    t1 = time.perf_counter()
    report = eval_cli.main(flags + [
        "--split", "val", "--img_wh", str(LLFF_WH[0]), str(LLFF_WH[1]),
        "--ckpt", ckpt, "--N_importance", str(LLFF_SAMPLES), "--out",
        os.path.join(root, "eval.json")])
    gap = abs(report["mean_psnr"] - final)
    print(f"[llff] eval CLI on the held-out views: mean PSNR "
          f"{report['mean_psnr']:.2f} dB, SSIM {report['mean_ssim']:.4f} vs "
          f"the Trainer's final {final:.2f} dB (gap {gap:.2f}, limit "
          f"{PSNR_GAP}); {time.perf_counter() - t1:.1f} s")
    if not (report["n_views"] == 2 and gap <= PSNR_GAP):
        raise SystemExit("[llff] eval failed its checks")

    t1 = time.perf_counter()
    dv = os.path.join(root, "deepvoxels")
    write_deepvoxels_scene(dv)
    print(f"[deepvoxels] scene {DV_WH}x{DV_WH} (8 train / 2 validation / 1 "
          f"test views) in {time.perf_counter() - t1:.1f} s")
    dv_metrics, dv_launches, dv_fwd, _, _ = train_cli_run(
        "deepvoxels", ["--datadir", dv, "--dataset_type", "deepvoxels",
                       "--shape", "smoke", "--img_wh", str(DV_WH), str(DV_WH),
                       "--iters", str(DV_STEPS), "--save_dir",
                       os.path.join(dv, "run"), "--quick_val_interval",
                       str(DV_STEPS // 2), "--quick_val_res", str(DV_WH),
                       str(DV_WH)], DV_STEPS)
    dv_losses = dv_metrics["train_losses"]
    if not (dv_losses[-1] < dv_losses[0] and dv_fwd == 2 * DV_STEPS
            and dv_launches[1:] == [2 * DV_STEPS] * 3
            and dv_metrics["config"]["render"]["white_bkgd"]):
        raise SystemExit("[deepvoxels] the train CLI run failed its checks")
    print(f"[llff] phase took {time.perf_counter() - t0:.1f} s")
    return {"fwd_launches": launches[0] + rv_launches + served_launches,
            "bwd_launches": launches[1:], "tile": tile,
            "fwd_train": fwd_train, "bwd": bwd, "phases": phases}


def kernel_trace(prof):
    """(launches, device ms in all) of each of the four kernels in a
    torch.profiler trace, by kernel name. Read from the trace's raw
    events: ``key_averages()`` builds a Python object per event, ~0.1 ms
    each, which over a whole run's ~10^5 events takes tens of seconds."""
    from torch.autograd import DeviceType

    found = [[0, 0.0] for _ in KERNEL_NAMES]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            for f, kernel in zip(found, KERNEL_NAMES):
                if kernel in name:
                    f[0] += 1
                    f[1] += e.duration_ns() / 1e6
    return tuple((n, ms) for n, ms in found)


def graph_train(tag, rc, tc, train_ds, val_ds, k, trace=False):
    """Train through the Trainer at steps_per_dispatch ``k``: windows of
    replays of the captured step. Returns the Trainer, the loss at every
    window's end (the window's output tensor) by step, the synchronised
    wall seconds (the captures included), the held-out PSNR, the grid
    refreshes' (seed step, decay), and the four kernel wrappers' counts
    over the run: the warm-up steps' launches and each capture's, which
    records 2 per kernel into its graph (a replay calls no wrapper). With
    ``trace`` the whole run is traced (device activity only, from zero
    just before ``train()``), and ``trace`` holds each kernel's launches
    and device ms over it (:func:`kernel_trace`): the warm-up steps' and
    every replay's."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.train.loop import Trainer

    trainer = Trainer(rc, dataclasses.replace(tc, steps_per_dispatch=k),
                      train_ds, device="cuda", verbose=False,
                      save_dir=os.path.join(SMOKE_DIR, f"graph_{tag}_{k}"))
    win, ends, calls = trainer.windows, [], []
    for name in ("run_pool", "run_host"):
        def recorded(*args, inner=getattr(win, name)):
            m = inner(*args)
            ends.append((trainer.state.step, m["loss"].clone()))
            return m
        setattr(win, name, recorded)
    occ_update = trainer._occ_update
    trainer._occ_update = lambda *a: calls.append(a) or occ_update(*a)
    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    prof = (profile(activities=[ProfilerActivity.CUDA]) if trace
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = tuple(c.launches for c in counters)
    del win.run_pool, win.run_host, trainer._occ_update
    val = trainer._validate(val_ds)
    return {"trainer": trainer, "ends": {s: float(x) for s, x in ends},
            "wall": wall, "val": val, "calls": calls, "counts": counts,
            "trace": kernel_trace(prof) if trace else None}


def step_timing(trainer, w, graph):
    """``w`` steps of a trained Trainer: windows of replays (``graph``) or
    eager steps. Returns the synchronised ms per step over four windows,
    and one profiled window's wall and busy ms, idle share and the four
    kernels' launches per step, counted from the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    occ = () if trainer.occ_grid is None else (trainer.occ_grid,)

    def window():
        if graph:
            trainer.windows.run_pool(w)
        else:
            for _ in range(w):
                trainer.step_fn(trainer.state,
                                trainer.pool.batch(trainer.state.step), *occ)

    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        window()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (4 * w)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(ms for _, ms in device_rows(prof))
    per_step = tuple(n / w for n, _ in kernel_trace(prof))
    return {"ms": ms, "wall": wall, "busy": busy,
            "idle": 100 * (1 - busy / wall), "per_step": per_step}


def print_timing(tag, label, t, card):
    print(f"[graph] {tag} {label}: {t['ms']:.2f} ms per step synchronised; "
          f"a profiled window of {GRAPH_K} steps: wall {t['wall']:.2f} ms, "
          f"device busy {t['busy']:.2f} ms, idle {t['idle']:.1f}%; launches "
          f"per step (forward, phase 1, phase 2, reduction) "
          f"{t['per_step']} [{card}]")


def sync_check(trainer, tag):
    """One eager step under torch.cuda.set_sync_debug_mode('error'): any
    operation on the step's path that waits for the device raises."""
    import torch

    occ = () if trainer.occ_grid is None else (trainer.occ_grid,)
    batch = trainer.pool.batch(trainer.state.step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.step_fn(trainer.state, batch, *occ)
    except RuntimeError as e:
        raise SystemExit(f"[graph] sync check, {tag}: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def graph_kernels(tr, g):
    """The dense K = 16 run's kernels: each held against its plain version
    on the run's trained net at the run's two calls (1024 rays x 64 coarse
    / 128 fine samples; check_kernel, check_backward), timed. Returns one
    record per kernel, in KERNEL_NAMES' order: its launches and device ms
    per launch over the run, from the run's trace (``g["trace"]``); its
    bound, plain and library ms as the means of the two calls, which the
    run launches one each per step; the larger of their errors."""
    cfg = slice_config()
    net = tr.state.params["coarse"]
    fwd, phases = [], []
    for n_samples, label in ((cfg.N_samples, "coarse"),
                             (cfg.N_importance, "fine")):
        pts, dirs = serving_points(n_samples, cfg, n_rays=TRAIN_RAYS)
        label = f"graph-trained net, train {label}"
        fwd.append(check_kernel(net, cfg, pts, dirs, label, time_it=True))
        phases.append(check_backward(net, cfg, pts, dirs, label,
                                     time_it=True)[1])
    recs = []
    for (n, ms), calls in zip(g["trace"], [fwd] + [
            [ph[key] for ph in phases]
            for key in ("phase1", "phase2", "reduce")]):
        lib = [c.get("library_ms") for c in calls]
        recs.append({
            "launches": n, "ms": ms / n,
            "max_abs_err": max(c["max_abs_err"] for c in calls),
            "plain_ms": statistics.mean(c["plain_ms"] for c in calls),
            "bound_ms": statistics.mean(c["bound_ms"] for c in calls),
            "bound_by": calls[1]["bound_by"],
            "library_ms": None if None in lib else statistics.mean(lib)})
        if "module_ms" in calls[0]:
            recs[-1]["module_ms"] = statistics.mean(
                c["module_ms"] for c in calls)
    return recs


def phase_graph(train_ds, val_ds, dense1, turbo1, fast1, card):
    """steps_per_dispatch through CUDA graphs (the module docstring, phase
    9), against the K = 1 runs of phases 5 and 6 (``dense1``, ``turbo1``,
    ``fast1``). Returns the dense run's kernel records (graph_kernels):
    launches and device time from a trace of the whole run."""
    import numpy as np
    import torch

    from nerfmlp_torch.train.graph import WARMUP_STEPS

    t0 = time.perf_counter()
    near_far = train_ds.dynamic_near_far()
    rc, tc = train_configs(*near_far)
    print(f"[graph] dense flagship, {TRAIN_STEPS} steps at K = {GRAPH_K} "
          f"(device pool, {TRAIN_WH ** 2 * 8 // TRAIN_RAYS} steps an epoch)")
    g = graph_train("dense", rc, tc, train_ds, val_ds, GRAPH_K, trace=True)
    tr = g["trainer"]
    loss_k1 = dense1["losses"]
    d_loss = max(abs(v - float(loss_k1[s - 1])) for s, v in g["ends"].items())
    loss_ok = all(np.isclose(v, loss_k1[s - 1], rtol=LOSS_RTOL, atol=0)
                  for s, v in g["ends"].items())
    params = [p.detach() for net in tr.state.params.values()
              for p in net.parameters()]
    d_par = max(float((p - q).abs().max())
                for p, q in zip(params, dense1["params"]))
    par_ok = all(torch.allclose(p, q, rtol=PARAM_RTOL, atol=PARAM_ATOL)
                 for p, q in zip(params, dense1["params"]))
    replays = tr.windows.replays
    print(f"[graph] dense: {len(g['ends'])} windows, {replays} replays; "
          f"window-end losses vs K = 1: max |diff| {d_loss:.3e} (rtol "
          f"{LOSS_RTOL}); parameters: max |diff| {d_par:.3e} (rtol "
          f"{PARAM_RTOL}, atol {PARAM_ATOL}); wrapper counts over the run "
          f"{g['counts']} ({WARMUP_STEPS} warm-up steps + 1 capture, 2 each)")
    print(f"[graph] dense held-out PSNR: K = {GRAPH_K} "
          f"{g['val']['psnr']:.2f} dB, K = 1 {dense1['val']['psnr']:.2f} dB; "
          f"whole run {1e3 * g['wall'] / TRAIN_STEPS:.2f} ms per step "
          f"(captures included, traced) vs "
          f"{1e3 * dense1['wall'] / TRAIN_STEPS:.2f} [{card}]")
    want = 2 * (WARMUP_STEPS + replays)
    print(f"[graph] dense run traced whole: launches (forward, phase 1, "
          f"phase 2, reduction) {tuple(n for n, _ in g['trace'])} (want "
          f"{want}: 2 per step, {WARMUP_STEPS} warm-up steps + {replays} "
          f"replays), device ms per launch "
          f"{tuple(round(ms / max(n, 1), 4) for n, ms in g['trace'])} "
          f"[{card}]")
    if any(n != want for n, _ in g["trace"]):
        raise SystemExit("[graph] the traced dense run did not launch each "
                         "kernel twice a step")
    recs = graph_kernels(tr, g)
    t_graph = step_timing(tr, GRAPH_K, graph=True)
    t_eager = step_timing(dense1["trainer"], GRAPH_K, graph=False)
    print_timing("dense", f"K = {GRAPH_K}", t_graph, card)
    print_timing("dense", "K = 1", t_eager, card)
    if not (loss_ok and par_ok and replays == TRAIN_STEPS):
        raise SystemExit("[graph] the K = 16 run left the K = 1 run")
    if t_graph["per_step"] != (2, 2, 2, 2) or g["counts"] != (
            2 * (WARMUP_STEPS + 1),) * 4:
        raise SystemExit("[graph] a captured dense step did not launch each "
                         "kernel twice")

    orc, otc = turbo_configs(*near_far)
    o = graph_train("turbo", orc, otc, train_ds, val_ds, GRAPH_K)
    want = [tuple(c) for c in turbo1["refresh"]["calls"]]
    gap = abs(o["val"]["psnr"] - turbo1["val"]["psnr"])
    print(f"[graph] turbo at K = {GRAPH_K}: refreshes at steps "
          f"{[c[0] for c in o['calls']]} (seed step, decay equal to K = 1's: "
          f"{o['calls'] == want}); held-out PSNR {o['val']['psnr']:.2f} dB "
          f"vs K = 1 {turbo1['val']['psnr']:.2f} dB (gap {gap:.2f}, limit "
          f"{GRAPH_PSNR_GAP}); whole run "
          f"{1e3 * o['wall'] / TRAIN_STEPS:.2f} ms per step vs "
          f"{1e3 * turbo1['wall'] / TRAIN_STEPS:.2f} [{card}]")
    to_graph = step_timing(o["trainer"], GRAPH_K, graph=True)
    to_eager = step_timing(turbo1["trainer"], GRAPH_K, graph=False)
    print_timing("turbo", f"K = {GRAPH_K}", to_graph, card)
    print_timing("turbo", "K = 1", to_eager, card)
    if o["calls"] != want or gap > GRAPH_PSNR_GAP or to_graph[
            "per_step"] != (2, 2, 2, 2):
        raise SystemExit("[graph] the turbo run's refreshes, PSNR or "
                         "launches left the K = 1 run's")

    frc, ftc = fast_configs(*near_far)
    f = graph_train("fast", frc, ftc, train_ds, val_ds, GRAPH_HOST_K)
    loss_f1 = fast1["losses"]
    tail = [s for s in f["ends"] if s > HI_LO_STEPS - 20]
    ours = np.mean([f["ends"][s] for s in tail])
    theirs = np.mean([loss_f1[s - 1] for s in tail])
    rel = abs(ours - theirs) / theirs
    d_fast = max(abs(v - float(loss_f1[s - 1])) for s, v in f["ends"].items())
    sources = sorted(f["trainer"].windows.graphs)
    print(f"[graph] one-shot hi_lo at K = {GRAPH_HOST_K}: windows end at "
          f"{sorted(f['ends'])}; graphs {sources} (host batches through the "
          f"central crop, then the pool); last window-end losses vs K = 1: "
          f"relative gap {rel:.3e} (limit {HI_LO_TRACK}), max |diff| "
          f"{d_fast:.3e}; whole run {1e3 * f['wall'] / HI_LO_STEPS:.2f} ms "
          f"per step [{card}]")
    if rel > HI_LO_TRACK or sources != ["host", "pool"]:
        raise SystemExit("[graph] the host-batch run left the K = 1 run")

    for trainer, tag in ((tr, "dense"), (o["trainer"], "turbo"),
                         (f["trainer"], "one-shot hi_lo")):
        sync_check(trainer, tag)
    print("[graph] sync check: one eager step each of dense, turbo and "
          "one-shot hi_lo under set_sync_debug_mode('error'): no "
          "synchronising operation")
    print(f"[graph] phase took {time.perf_counter() - t0:.1f} s")
    return recs


def device_rows(prof):
    """(name, device ms) of the kernels the profiler saw on the card —
    the device events only, so a CPU-side op that launched a kernel (an
    autograd Function, aten::sort) does not count its kernel twice."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def profile_frame(params, o, d, cfg, tile=TILE, occ_grid=None):
    """Where one served frame's time goes: wall clock, device busy time,
    and the device time of the heaviest operations, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerfmlp_torch.ops.render import render_image_maps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_image_maps(params, o, d, H, W, cfg, tile=tile,
                          occ_grid=occ_grid)["rgb_map"].cpu()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = sorted(device_rows(prof), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    print(f"[profile] frame wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {100 * (1 - busy / wall):.1f}%)")
    for key, ms in rows[:5]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {key[:70]}")


@contextlib.contextmanager
def plain_forward():
    """A context in which ``_query_mlp`` runs the forward kernel's plain
    version (``fused_nerf_mlp_plain``, bf16) on the card in the kernel's
    place: the same path, the same inputs."""
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops import render as render_mod

    def plain(params, pts, dirs, cfg, mc=None):
        net = params.net if isinstance(params, fused_mlp.PackedMLP) else params
        return fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                              torch.bfloat16, False)

    inner = render_mod.fused_nerf_mlp
    render_mod.fused_nerf_mlp = plain
    try:
        yield
    finally:
        render_mod.fused_nerf_mlp = inner


def nearest(a, b, reach, rows=4096):
    """Distance from each point of ``a`` (N, 3) to its nearest point of
    ``b`` (M, 3), exact up to ``reach`` (beyond it: a lower bound, or inf),
    on the card: both sorted by x, each chunk of ``rows`` points of ``a``
    against the points of ``b`` within ``reach`` of its x range."""
    import numpy as np
    import torch

    a = a[np.argsort(a[:, 0], kind="stable")]
    b = b[np.argsort(b[:, 0], kind="stable")]
    bt = torch.from_numpy(b).cuda()
    out = []
    for s in range(0, len(a), rows):
        blk = a[s:s + rows]
        lo = np.searchsorted(b[:, 0], blk[0, 0] - reach, "left")
        hi = np.searchsorted(b[:, 0], blk[-1, 0] + reach, "right")
        if hi <= lo:
            out.append(torch.full((len(blk),), float("inf"), device="cuda"))
            continue
        out.append(torch.cdist(torch.from_numpy(blk).cuda(),
                               bt[lo:hi]).min(1).values)
    return torch.cat(out).cpu().numpy()


def ply_counts(body):
    """(vertices, faces, property names) from a PLY's header."""
    head = body.partition(b"end_header\n")[0].decode("ascii").splitlines()
    count = {ln.split()[1]: int(ln.split()[2]) for ln in head
             if ln.startswith("element ")}
    names = [ln.split()[2] for ln in head if ln.startswith("property ")
             and "list" not in ln]
    return count["vertex"], count["face"], names


class PathLaunches:
    """Count the forward launches of ``density_volume`` and
    ``vertex_colors`` inside ``with`` blocks (``Timed``), summed over the
    blocks in ``self.density`` and ``self.colours``."""

    def __init__(self):
        self.density = self.colours = 0

    @contextlib.contextmanager
    def __call__(self):
        from nerfmlp_torch.ops import mesh as mesh_mod

        with Timed(mesh_mod, "density_volume") as d, \
                Timed(mesh_mod, "vertex_colors") as c:
            yield
        self.density += sum(d.fwd)
        self.colours += sum(c.fwd)


def mesh_extract(params, cfg, g, thr, tag, card):
    """extract_mesh at ``g``^3, its stages timed (synchronised) and its
    forward launches counted; returns (mesh, {stage: s}, launches of the
    density and the colour bake)."""
    from nerfmlp_torch.ops import mesh as mesh_mod

    with Timed(mesh_mod, "density_volume") as dens, \
            Timed(mesh_mod, "_active_cells") as comp, \
            Timed(mesh_mod, "_tet_stage") as tets, \
            Timed(mesh_mod, "_weld_and_orient") as weld, \
            Timed(mesh_mod, "vertex_colors") as bake:
        t0 = time.perf_counter()
        m = mesh_mod.extract_mesh(params, cfg, resolution=g, threshold=thr,
                                  density_chunk=MESH_CHUNK)
        total = time.perf_counter() - t0
    stages = {"density": dens.times[0], "compaction": comp.times[0],
              "tets": tets.times[0], "weld+orient": weld.times[0],
              "colours": bake.times[0], "total": total}
    print(f"[mesh] {tag} {g}^3 iso {thr:g}: {len(m['verts'])} verts, "
          f"{len(m['faces'])} faces, sigma in [{m['sigma_min']:.3g}, "
          f"{m['sigma_max']:.3g}]; forward launches {dens.fwd[0]} + "
          f"{bake.fwd[0]}; s " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in stages.items())
          + f" [{card}]")
    return m, stages, (dens.fwd[0], bake.fwd[0])


def phase_mesh(turbo_ckpt, card):
    """Mesh extraction and hot reload on the card (the module docstring,
    phase 10). Returns the forward's two records (path ``mesh``)."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops import mesh as mesh_mod
    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.occupancy import _QUERY_DIR
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.scripts import serve as serve_cli
    from nerfmlp_torch.scripts import train as train_cli
    from nerfmlp_torch.serve import RenderServer
    from nerfmlp_torch.train import loop
    from nerfmlp_torch.train.checkpoint import load_params_any

    t0 = time.perf_counter()
    root = os.path.join(SMOKE_DIR, "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    box = [str(v) for v in OCC_AABB]
    occ = ["--use_occupancy", "--aabb", *box, "--N_samples", str(OCC_PROBE),
           "--N_importance", str(OCC_REFINE), "--occ_dense_samples",
           str(OCC_DENSE)]
    flags = occ + ["--focal", str(FOCAL), "--img_wh", str(W), str(H)]
    # The turbo recipe's config: its box, net, bf16 through the kernel.
    cfg = dataclasses.replace(turbo_configs(2.0, 6.0)[0], perturb=False)
    params = load_params_any(turbo_ckpt, cfg.model_config(), device="cuda")
    plain = dataclasses.replace(cfg, use_kernel=False)

    # -- extract_mesh at 128^3 and 256^3, kernel against module path -----
    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    for c in counters:
        c.launches = 0
    probe = mesh_mod.density_volume(params, cfg, resolution=MESH_RES[0])
    lo, hi = float(probe.min()), float(probe.max())
    thr = MESH_ISO if hi > MESH_ISO else 0.5 * (lo + hi)
    print(f"[mesh] the turbo model's sigma at {MESH_RES[0]}^3 lies in "
          f"[{lo:.3g}, {hi:.3g}]: iso level {thr:g}"
          + ("" if thr == MESH_ISO else f" (inside the range: the model "
             f"never reaches the default {MESH_ISO:g})"))
    # The path's launches: the kernel extractions, the served meshes and
    # the i_mesh event; not the threshold probe above, nor the volumes
    # recomputed below to hold against the plain version.
    path = PathLaunches()
    results = {}
    for g in MESH_RES:
        with path():
            mk, stages, (nd, nc) = mesh_extract(params, cfg, g, thr,
                                                "kernel", card)
        if not len(mk["faces"]):
            raise SystemExit(f"[mesh] the kernel's mesh at {g}^3 is empty")
        mp, pstages, _ = mesh_extract(params, plain, g, thr,
                                      "module path (use_kernel=False)", card)
        want = (-(-g ** 3 // MESH_CHUNK), -(-len(mk["verts"]) // MESH_CHUNK))
        # The volume through the kernel's plain version, same points.
        vk = mesh_mod.density_volume(params, cfg, resolution=g)
        with plain_forward():
            t1 = time.perf_counter()
            vp = mesh_mod.density_volume(params, cfg, resolution=g)
            plain_s = time.perf_counter() - t1
        err = float(np.abs(vk - vp).max())
        norm = err / max(float(np.abs(vp).max()), 1e-12)
        cell = (np.asarray(OCC_AABB[3:]) - np.asarray(OCC_AABB[:3])) / (g - 1)
        diag = float(np.linalg.norm(cell))
        gap = abs(len(mk["faces"]) - len(mp["faces"])) / max(
            len(mp["faces"]), 1)
        # Every kernel vertex within a cell diagonal of the mesh of the
        # plain version's volume (the same bf16 function on the same
        # points). Against the module path's mesh (cuBLAS bf16, another
        # rounding) the count of vertices beyond one diagonal is printed:
        # two bf16 fields' level sets part where sigma crosses the
        # threshold with little slope.
        pv, _ = mesh_mod.mesh_from_volume(vp, OCC_AABB, thr, device="cuda")
        to_plain = nearest(mk["verts"], pv, 4 * diag)
        to_module = nearest(mk["verts"], mp["verts"], 4 * diag)
        from_module = nearest(mp["verts"], mk["verts"], 4 * diag)

        def spread(d):
            return (f"max {d.max():.3e}, 99.9th percentile "
                    f"{np.quantile(d, 0.999):.3e}, {int((d > diag).sum())} "
                    f"beyond a diagonal")
        # The tet stage on the card against the CPU's on the same cells:
        # triangle soups in cell order, so equal soups weld into equal
        # meshes.
        idx, corners = mesh_mod._active_cells(vk, thr)
        soups = {}
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            soups[dev] = mesh_mod._tet_stage(
                idx, corners, np.asarray(OCC_AABB[:3], np.float32),
                (np.asarray(OCC_AABB[3:], np.float32)
                 - np.asarray(OCC_AABB[:3], np.float32)) / (g - 1), thr,
                16384, dev)
            soups[dev + " s"] = time.perf_counter() - t1
        same = soups["cuda"].shape == soups["cpu"].shape
        tet_err = (float(np.abs(soups["cuda"] - soups["cpu"]).max())
                   if same else float("inf"))
        bits = same and np.array_equal(soups["cuda"], soups["cpu"])
        print(f"[mesh] {g}^3: volume kernel vs its plain version (same "
              f"points, plain {plain_s:.2f} s): max|err| {err:.3e}, "
              f"normalised {norm:.3e} (tol {KERNEL_TOL}); faces kernel "
              f"{len(mk['faces'])} vs module path {len(mp['faces'])} (gap "
              f"{100 * gap:.2f}%, limit {100 * MESH_FACE_GAP:.0f}%); "
              f"kernel vertices to the plain version's mesh ({len(pv)} "
              f"verts): {spread(to_plain)}; to the module path's mesh: "
              f"{spread(to_module)}; the module path's to the kernel's: "
              f"{spread(from_module)} (cell diagonal {diag:.3e}, distances "
              f"exact to 4 diagonals); launches {(nd, nc)} (want "
              f"{want}); tet stage on the card ({soups['cuda s']:.3f} s) "
              f"vs the CPU ({soups['cpu s']:.3f} s) on {len(idx)} cells: "
              f"{len(soups['cuda'])} / {len(soups['cpu'])} triangles, max|err| "
              f"{tet_err:.3e} (tol {MESH_TET_TOL}), bit-equal {bits}")
        if not (norm <= KERNEL_TOL and gap <= MESH_FACE_GAP
                and to_plain.max() <= diag
                and np.quantile(to_module, 0.999) <= diag
                and (nd, nc) == want and same and tet_err <= MESH_TET_TOL
                and len(mk["faces"]) > 0
                and np.isfinite(mk["colors"]).all()):
            raise SystemExit(f"[mesh] extraction at {g}^3 failed its checks")
        results[g] = (mk, stages, pstages)
    mk, stages, pstages = results[MESH_RES[-1]]
    print(f"[mesh] stages at {MESH_RES[-1]}^3, kernel path: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + "; module path: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in pstages.items())
          + f" [{card}]")

    # -- serving a model while it trains ----------------------------------
    scene = os.path.join(SMOKE_DIR, "inference", "scene")
    run = os.path.join(root, "run")
    args = serve_cli.build_parser().parse_args(flags + [
        "--ckpt", turbo_ckpt, "--watch", str(MESH_WATCH), "--watch_dir", run,
        "--max_mesh_resolution", str(MESH_SERVE_RES)])
    svc = serve_cli.build_service(args)
    svc.log = lambda m: print(f"[mesh] serve: {m}")
    svc.warmup()
    server = RenderServer(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    watcher = svc.watch(args.watch)
    url = "http://%s:%d" % server.server_address[:2]
    cam = dict(zip(("theta", "phi", "radius"), SERVE_POSE))

    def post(route, req):
        r = urllib.request.Request(url + route, method="POST",
                                   data=json.dumps(req).encode())
        with urllib.request.urlopen(r, timeout=300) as resp:
            return resp.status, resp.read()

    def health():
        with urllib.request.urlopen(url + "/health", timeout=30) as resp:
            return json.loads(resp.read())

    argv = [sys.executable, "-m", "nerfmlp_torch.scripts.train", "--config",
            os.path.join(ROOT, "configs", "lego_turbo_bf16.txt"),
            "--datadir", scene, "--save_dir", run, "--aabb", *box,
            "--iters", str(MESH_RELOAD_STEPS), "--i_weights",
            str(MESH_CKPT_EVERY), "--steps_per_dispatch", str(GRAPH_K),
            "--occ_update_every", str(OCC_EVERY), "--occ_warmup_steps",
            str(OCC_WARMUP)]
    log_path = os.path.join(root, "train.log")
    try:
        t1 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(argv, cwd=ROOT, stdout=log,
                                    stderr=subprocess.STDOUT)
            try:
                rc = proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        train_s = time.perf_counter() - t1
        last = MESH_RELOAD_STEPS
        deadline = time.time() + 30
        while svc.ckpt["step"] != last and time.time() < deadline:
            time.sleep(0.1)
        swaps, h = svc.reloads, health()
        with open(log_path) as f:
            tail = f.read()[-2000:]
        print(f"[mesh] train CLI subprocess (turbo config, 64x64, "
              f"{MESH_RELOAD_STEPS} steps, K = {GRAPH_K}, a checkpoint every "
              f"{MESH_CKPT_EVERY}): rc {rc} in {train_s:.1f} s; the server "
              f"swapped {swaps} times, /health ckpt {h['ckpt']} [{card}]")
        if rc != 0 or swaps < 2 or h["ckpt"]["step"] != last:
            raise SystemExit(f"[mesh] serving while training failed its "
                             f"checks; the run's log ends:\n{tail}")
        served_path = h["ckpt"]["path"]
        status, body = post("/render", {**cam, "format": "npy"})
        served = np.load(io.BytesIO(body))
        fresh = serve_cli.build_service(serve_cli.build_parser().parse_args(
            flags + ["--ckpt", served_path]))
        fresh.log = lambda m: None
        ref = np.clip(fresh.render_pose(
            pose_spherical(*SERVE_POSE))["rgb_map"], 0.0, 1.0)
        frame_equal = status == 200 and np.array_equal(served, ref)
        quiet = svc.reload(force=False)
        status_r, body_r = post("/reload", {})
        info = json.loads(body_r)
        status, body = post("/render", {**cam, "format": "npy"})
        after = np.load(io.BytesIO(body))
        print(f"[mesh] frame served after the last swap vs a fresh "
              f"RenderService from {os.path.basename(served_path)}: equal "
              f"bit for bit {frame_equal}; the watcher's reload with nothing "
              f"new: {quiet}; POST /reload: {status_r} step {info['step']} "
              f"(same file {info['path'] == served_path}), the frame after "
              f"it equal {np.array_equal(after, served)}")
        if not (frame_equal and quiet is None and status_r == 200
                and info["step"] == last and info["path"] == served_path
                and np.array_equal(after, served)):
            raise SystemExit("[mesh] the reloaded service's frames failed "
                             "their checks")
        stats = json.loads(post("/mesh", {"resolution": MESH_SERVE_RES,
                                          "threshold": 1e9,
                                          "format": "json"})[1])
        thr_s = (MESH_ISO if stats["sigma_max"] > MESH_ISO
                 else 0.5 * (stats["sigma_min"] + stats["sigma_max"]))
        req = {"resolution": MESH_SERVE_RES, "threshold": thr_s}
        with path():
            counts = json.loads(post("/mesh", {**req, "format": "json"})[1])
            n_v, n_f, names = ply_counts(post("/mesh", req)[1])
            obj = post("/mesh", {**req, "format": "obj"})[1].decode()
        ref_mesh = mesh_mod.extract_mesh(
            load_params_any(served_path, cfg.model_config(), device="cuda"),
            svc.cfg, resolution=MESH_SERVE_RES, threshold=thr_s)
        obj_v = sum(ln.startswith("v ") for ln in obj.splitlines())
        obj_f = sum(ln.startswith("f ") for ln in obj.splitlines())
        h = health()
        print(f"[mesh] POST /mesh at {MESH_SERVE_RES}^3, sigma in "
              f"[{stats['sigma_min']:.3g}, {stats['sigma_max']:.3g}], iso "
              f"{thr_s:g}: json {counts['verts']} verts / {counts['faces']} "
              f"faces in {counts['seconds']} s (extract_mesh on the file: "
              f"{len(ref_mesh['verts'])} / {len(ref_mesh['faces'])}); ply "
              f"{n_v} / {n_f} {names}; obj {obj_v} / {obj_f}; /health "
              f"meshes {h['meshes']} [{card}]")
        if not (counts["faces"] > 0
                and (counts["verts"], counts["faces"])
                == (len(ref_mesh["verts"]), len(ref_mesh["faces"]))
                == (n_v, n_f) == (obj_v, obj_f)
                and names[:3] == ["x", "y", "z"] and h["meshes"] == 4):
            raise SystemExit("[mesh] POST /mesh failed its checks")
    finally:
        watcher.stop_event.set()
        watcher.join(timeout=30)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # -- i_mesh in training ----------------------------------------------
    imesh = os.path.join(root, "imesh")
    with path(), Timed(loop.Trainer, "_mesh_event") as events:
        train_cli.main(["--config", os.path.join(ROOT, "configs",
                                                 "lego_turbo_bf16.txt"),
                        "--datadir", scene, "--save_dir", imesh, "--aabb",
                        *box, "--iters", str(2 * MESH_EVENT), "--i_mesh",
                        str(MESH_EVENT), "--mesh_threshold",
                        str(MESH_EVENT_ISO), "--steps_per_dispatch",
                        str(GRAPH_K), "--occ_update_every", str(OCC_EVERY),
                        "--occ_warmup_steps", str(OCC_WARMUP)])
    found = sorted(f for f in os.listdir(imesh) if f.endswith(".ply"))
    want = [f"imesh_mesh_{MESH_EVENT:06d}.ply"]
    n_v = n_f = 0
    if found == want:
        with open(os.path.join(imesh, want[0]), "rb") as f:
            n_v, n_f, _ = ply_counts(f.read())
    print(f"[mesh] train CLI --i_mesh {MESH_EVENT}, {2 * MESH_EVENT} steps "
          f"at K = {GRAPH_K}: {found} (want {want}); {n_v} verts / {n_f} "
          f"faces; the event {events.times} s, {events.fwd} forward "
          f"launches [{card}]")
    if found != want or len(events.times) != 1 or not n_f:
        raise SystemExit("[mesh] i_mesh wrote other files than the JAX "
                         "Trainer would")

    # -- the forward at the path's two shapes ----------------------------
    net = params["coarse"]
    g = MESH_RES[-1]
    n = g ** 3
    s0 = (n // 2) // MESH_CHUNK * MESH_CHUNK
    ids = torch.arange(s0, s0 + MESH_CHUNK, dtype=torch.int32,
                       device="cuda")
    ijk = torch.stack([ids // (g * g), (ids // g) % g, ids % g], -1)
    lo_t = torch.tensor(OCC_AABB[:3], device="cuda")
    span = torch.tensor(OCC_AABB[3:], device="cuda") - lo_t
    pts = (lo_t + (ijk.float() / (g - 1)) * span).contiguous()
    dirs = positional_encoding(
        torch.tensor(_QUERY_DIR, device="cuda").expand(MESH_CHUNK, 3),
        cfg.dir_enc_L)
    dens = check_kernel(net, cfg, pts, dirs, "mesh density chunk",
                        time_it=True)
    m = min(MESH_CHUNK, len(mk["verts"]))
    vpts = torch.from_numpy(mk["verts"][:m]).cuda().contiguous()
    vdirs = positional_encoding(
        -torch.from_numpy(mk["normals"][:m]).cuda(), cfg.dir_enc_L)
    col = check_kernel(net, cfg, vpts, vdirs, "mesh colour chunk",
                       time_it=True)
    print(f"[mesh] forward launches on the path (extractions, the served "
          f"meshes, the i_mesh event): density {path.density}, colours "
          f"{path.colours}; phase took {time.perf_counter() - t0:.1f} s")
    if not (path.density > 0 and path.colours > 0):
        raise SystemExit("[mesh] the path launched no forward kernel")
    return [dict(rec, launches=n_l) for rec, n_l in
            ((dens, path.density), (col, path.colours))]


# --------------------------------------------------------------------- #
# Phase 11: multi-scene batched training ("multi_scene")
# --------------------------------------------------------------------- #
MS_SCENES = 4             # phase 11's scenes: each kernel call covers all
#                           four in one launch; 4 x 131,072 points hold a
#                           5.2 GB phase-1 workspace (9,984 B a point)
MS_CHECK_STEPS = 5        # stacked vs solo steps compared on the card
MS_MIXED_STEPS = 50       # the mixed blender + LLFF CLI run
MS_HARD_PSNR_MIN = 15.0   # the hard field's held-out PSNR floor after
#                           TRAIN_STEPS steps: the single-scene Trainer
#                           reaches 15.71 / 16.74 dB on this phase's two hard
#                           scenes on both paths (21.45 / 21.74 after 1,000
#                           steps), so PSNR_MIN holds the smooth scenes only
MS_GAP_EACH = 2 * PSNR_GAP  # one scene's distance from the module path's
#                           run: over three seeds of the ray batches the 12
#                           per-scene gaps of one 300-step dense run spread
#                           from -1.07 to +0.42 dB (std 0.38); the mean over
#                           the scenes is held at PSNR_GAP


def stack_inputs(n_samples, cfg):
    """MS_SCENES scenes' points (the serving pose's central rays, each
    scene's shifted by 0.03 * s) and encoded dirs, scene-major: (pts,
    dirs, points a scene)."""
    import torch

    pts, dirs = serving_points(n_samples, cfg, n_rays=TRAIN_RAYS)
    n_s = pts.shape[0]
    pts = torch.cat([pts + 0.03 * s for s in range(MS_SCENES)])
    dirs = dirs.repeat(MS_SCENES, 1)
    return pts.contiguous(), dirs.contiguous(), n_s


def ms_cotangent(nets, pts, dirs, cfg, n_s, hi_lo):
    """The cotangent of each scene's mean squared error against seeded
    targets, at the stacked plain forward's output."""
    import torch

    from nerfmlp_torch.ops import fused_mlp as fm

    raw = fm.fused_nerf_mlp_stack_plain(nets, pts, dirs, cfg.pos_enc_L,
                                        torch.bfloat16, hi_lo)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    target = torch.rand(raw.shape, device="cuda", generator=gen)
    return (2.0 / (n_s * raw.shape[1])) * (raw - target)


def check_stack(nets, cfg, n_samples, label, card, hi_lo=False):
    """The four kernels over a scene axis at one call of the multi-scene
    step (MS_SCENES x points of 1024 rays x ``n_samples``): the stacked
    launch against MS_SCENES single-scene launches of the same work, bit
    for bit, and against the stacked plain version at the single-scene
    bars; timed beside the single-scene launches, the plain version and
    (forward) the use_kernel=False module path; each with its bound at
    MS_SCENES x n_s points. Returns {"fwd", "phase1", "phase2", "reduce",
    "bwd"} records."""
    import torch

    from nerfmlp_torch.ops import fused_mlp as fm
    from nerfmlp_torch.ops.encoding import positional_encoding

    if hi_lo:
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  fp32_precision="high")
    dt = torch.float32 if hi_lo else torch.bfloat16
    vdirs = True
    pts, dirs, n_s = stack_inputs(n_samples, cfg)
    n = pts.shape[0]
    stack = fm.pack_params_stack(nets, cfg.pos_enc_L, vdirs, hi_lo)
    solos = [fm.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo) for net in nets]
    sl = [slice(s * n_s, (s + 1) * n_s) for s in range(MS_SCENES)]
    sp = [pts[x].contiguous() for x in sl]
    sd = [dirs[x].contiguous() for x in sl]
    g = ms_cotangent(nets, pts, dirs, cfg, n_s, hi_lo)
    sg = [g[x].contiguous() for x in sl]
    products = 3 if hi_lo else 1
    fwd_macs = sum(p.numel() for name, p in nets[0].named_parameters()
                   if name.endswith("weight"))
    w_bytes = stack.weights.numel() * 2 + stack.biases.numel() * 4
    in_bytes = pts.numel() * 4 + dirs.numel() * (4 if hi_lo else 2) + w_bytes
    tol = HI_LO_TOL if hi_lo else KERNEL_TOL
    recs = {}

    # The forward.
    def solo_fwd():
        return torch.cat([fm._launch(p, a, d) for p, a, d in
                          zip(solos, sp, sd)])

    with torch.no_grad():
        got = fm.fused_nerf_mlp(stack, pts, dirs, cfg)
        one = solo_fwd()
    want = fm.fused_nerf_mlp_stack_plain(nets, pts, dirs, cfg.pos_enc_L,
                                         torch.bfloat16, hi_lo)
    torch.cuda.synchronize()
    same = torch.equal(got, one)
    err = float((got - want).abs().max())
    norm = err / max(float(want.abs().max()), 1e-12)
    r = {"max_abs_err": err, "norm_err": norm, "n": n}
    r["bound_ms"], r["bound_by"] = bound(2.0 * products * fwd_macs * n,
                                         in_bytes + got.numel() * 4)
    with torch.no_grad():
        r["ms"] = cuda_ms(lambda: fm._launch(stack, pts, dirs), iters=10)
        r["solo_ms"] = cuda_ms(solo_fwd, iters=5)
        r["module_ms"] = cuda_ms(lambda: [
            net(positional_encoding(a, cfg.pos_enc_L), d, compute_dtype=dt)
            for net, a, d in zip(nets, sp, sd)], iters=3)
    r["plain_ms"] = cuda_ms(lambda: fm.fused_nerf_mlp_stack_plain(
        nets, pts, dirs, cfg.pos_enc_L, torch.bfloat16, hi_lo), iters=2,
        warmup=1)
    recs["fwd"] = r
    print(f"[multi_scene] {label} forward, {MS_SCENES} x {n_s} points: one "
          f"launch bit-equal to {MS_SCENES} single-scene launches: {same}; "
          f"max|err| {err:.3e} normalised {norm:.3e} (tol {tol}); kernel "
          f"{r['ms']:.3f} ms, {MS_SCENES} single-scene launches "
          f"{r['solo_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, module path "
          f"{r['module_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}) [{card}]")
    if not (same and norm <= tol):
        raise SystemExit(f"[multi_scene] {label}: the stacked forward "
                         "disagrees")

    # Phase 1, phase 2 and the reduction, each alone.
    tile = fm.bwd_tile_rows(hi_lo)
    rows_s = -(-n_s // tile) * tile
    ws = torch.empty(MS_SCENES * rows_s * stack.ws_cols, device="cuda",
                     dtype=torch.bfloat16)
    fm.bwd_workspace(stack, pts, dirs, g, ws)
    ws1 = [torch.empty(rows_s * stack.ws_cols, device="cuda",
                       dtype=torch.bfloat16) for _ in nets]
    for p, a, d, gg, w in zip(solos, sp, sd, sg, ws1):
        fm.bwd_workspace(p, a, d, gg, w)
    same1 = all(torch.equal(
        fm.ws_matrix(stack, ws, m)[:, s * rows_s:(s + 1) * rows_s],
        fm.ws_matrix(solos[s], ws1[s], m))
        for s in range(MS_SCENES) for m in range(len(stack.ws_mats)))
    want_ws = fm.bwd_workspace_plain(stack, pts, dirs, g, MS_SCENES * rows_s)
    rel1 = 0.0
    err1 = 0.0
    for m in range(len(stack.ws_mats)):
        a = fm.ws_matrix(stack, ws, m)[0].float()
        b = fm.ws_matrix(stack, want_ws, m)[0].float()
        err1 = max(err1, float((a - b).abs().max()))
        rel1 = max(rel1, float((a - b).norm() / b.norm().clamp_min(1e-30)))
    del want_ws
    splits, split_rows = fm.bwd_splits(rows_s)
    total = stack.grad_total
    part = torch.empty((MS_SCENES, splits, fm.part_stride(total)),
                       device="cuda")
    fm.weight_grads(stack, ws, rows_s, split_rows, part)
    part1 = [torch.empty((splits, fm.part_stride(total)), device="cuda")
             for _ in nets]
    for p, w, q in zip(solos, ws1, part1):
        fm.weight_grads(p, w, rows_s, split_rows, q)
    same2 = all(torch.equal(part[s, :, :total], part1[s][:, :total])
                for s in range(MS_SCENES))   # past total: padding
    want_part = fm.weight_grads_plain(stack, ws, rows_s, split_rows)
    err2 = float((part[..., :total] - want_part[..., :total]).abs().max())
    norm2 = err2 / float(want_part[..., :total].abs().max())
    del want_part
    red = fm.reduce_partials(part, total)
    same3 = all(torch.equal(red[s], fm.reduce_partials(part1[s], total))
                for s in range(MS_SCENES))
    err3 = float((red - fm.reduce_partials_plain(part, total)).abs().max())
    torch.cuda.synchronize()
    ws_bytes = MS_SCENES * rows_s * stack.ws_cols * 2
    p1_macs = phase1_macs(nets[0], vdirs)
    recs["phase1"] = {
        "max_abs_err": err1, "rel_l2": rel1,
        "ms": cuda_ms(lambda: fm.bwd_workspace(stack, pts, dirs, g, ws),
                      iters=10),
        "solo_ms": cuda_ms(lambda: [fm.bwd_workspace(p, a, d, gg, w) for
                                    p, a, d, gg, w in
                                    zip(solos, sp, sd, sg, ws1)], iters=5),
        "plain_ms": cuda_ms(lambda: fm.bwd_workspace_plain(
            stack, pts, dirs, g, MS_SCENES * rows_s), iters=2, warmup=1)}
    recs["phase2"] = {
        "max_abs_err": err2, "norm_err": norm2,
        "ms": cuda_ms(lambda: fm.weight_grads(stack, ws, rows_s, split_rows,
                                              part), iters=10),
        "solo_ms": cuda_ms(lambda: [fm.weight_grads(p, w, rows_s, split_rows,
                                                    q) for p, w, q in
                                    zip(solos, ws1, part1)], iters=5),
        "plain_ms": cuda_ms(lambda: fm.weight_grads_plain(
            stack, ws, rows_s, split_rows), iters=2, warmup=1)}
    recs["reduce"] = {
        "max_abs_err": err3,
        "ms": cuda_ms(lambda: fm.reduce_partials(part, total), iters=10),
        "solo_ms": cuda_ms(lambda: [fm.reduce_partials(q, total)
                                    for q in part1], iters=10),
        "plain_ms": cuda_ms(lambda: fm.reduce_partials_plain(part, total),
                            iters=3),
        "library_ms": cuda_ms(lambda: part[..., :total].sum(1), iters=10)}
    for key, flops, nbytes in (
            ("phase1", 2.0 * products * p1_macs * n, in_bytes
             + g.numel() * 4 + ws_bytes),
            ("phase2", 2.0 * products * fwd_macs * n,
             ws_bytes + MS_SCENES * splits * total * 4),
            ("reduce", 0.0, MS_SCENES * (splits + 1) * total * 4)):
        recs[key]["bound_ms"], recs[key]["bound_by"] = bound(flops, nbytes)
        recs[key].setdefault("library_ms", None)
    del ws, ws1
    r1, r2, r3 = recs["phase1"], recs["phase2"], recs["reduce"]
    print(f"[multi_scene] {label} phase 1 ({ws_bytes} B workspace): "
          f"bit-equal to single-scene launches: {same1}; rel-L2 {rel1:.3e} "
          f"(tol {PHASE1_TOL}); kernel {r1['ms']:.3f} ms, single-scene "
          f"{r1['solo_ms']:.3f} ms, plain {r1['plain_ms']:.3f} ms; bound "
          f"{r1['bound_ms']:.3f} ms ({r1['bound_by']}) [{card}]")
    print(f"[multi_scene] {label} phase 2 ({len(stack.bwd_jobs)} jobs x "
          f"{splits} splits x {MS_SCENES} scenes): bit-equal: {same2}; "
          f"normalised {norm2:.3e} (tol {PHASE2_TOL}); kernel "
          f"{r2['ms']:.3f} ms, single-scene {r2['solo_ms']:.3f} ms, plain "
          f"{r2['plain_ms']:.3f} ms; bound {r2['bound_ms']:.3f} ms "
          f"({r2['bound_by']}) [{card}]")
    print(f"[multi_scene] {label} reduction ({MS_SCENES} x {splits} slots): "
          f"bit-equal: {same3}; max|err| vs plain {err3:.3e}; kernel "
          f"{r3['ms']:.4f} ms, single-scene {r3['solo_ms']:.4f} ms, plain "
          f"{r3['plain_ms']:.4f} ms, part.sum(1) {r3['library_ms']:.4f} ms; "
          f"bound {r3['bound_ms']:.4f} ms ({r3['bound_by']}) [{card}]")
    if not (same1 and same2 and same3 and rel1 <= PHASE1_TOL
            and norm2 <= PHASE2_TOL and err3 == 0.0):
        raise SystemExit(f"[multi_scene] {label}: a backward kernel over the "
                         "scene axis disagrees")

    # The backward whole: bit-equal to single-scene backwards, repeatable,
    # at the single-scene bar from the stacked plain backward (hi_lo: the
    # bf16 kernels as the control, above the bar).
    flat = fm._launch_bwd(stack, pts, dirs, g)
    again = fm._launch_bwd(stack, pts, dirs, g)
    one = [fm._launch_bwd(p, a, d, gg) for p, a, d, gg in
           zip(solos, sp, sd, sg)]
    same = torch.equal(flat, again) and all(torch.equal(flat[s], one[s])
                                            for s in range(MS_SCENES))
    want = fm.fused_nerf_mlp_bwd_stack_plain(nets, pts, dirs, g,
                                             cfg.pos_enc_L, torch.bfloat16,
                                             hi_lo)

    def worst(grads):
        return max(float((gs[k] - ws_[k]).abs().max())
                   / max(float(ws_[k].abs().max()), 1e-12)
                   for gs, ws_ in zip(grads, want) for k in ws_)

    bwd_norm = worst(fm.unpack_grads(stack, flat))
    btol = HI_LO_BWD_TOL if hi_lo else KERNEL_TOL
    control = None
    if hi_lo:
        bf16 = fm.pack_params_stack(nets, cfg.pos_enc_L, vdirs, False)
        control = worst(fm.unpack_grads(bf16, fm._launch_bwd(bf16, pts, dirs,
                                                             g)))
    rb = {"norm_err": bwd_norm, "control_norm_err": control,
          "ms": cuda_ms(lambda: fm._launch_bwd(stack, pts, dirs, g),
                        iters=5),
          "solo_ms": cuda_ms(lambda: [fm._launch_bwd(p, a, d, gg) for
                                      p, a, d, gg in zip(solos, sp, sd, sg)],
                             iters=3)}
    rb["floor_ms"] = sum(recs[k]["bound_ms"] for k in ("phase1", "phase2",
                                                       "reduce"))
    recs["bwd"] = rb
    print(f"[multi_scene] {label} backward whole: bit-equal to "
          f"{MS_SCENES} single-scene backwards and repeatable: {same}; "
          f"normalised {bwd_norm:.3e} (tol {btol})"
          + (f", control (bf16 kernels) {control:.3e}" if hi_lo else "")
          + f"; {rb['ms']:.3f} ms vs {rb['solo_ms']:.3f} ms single-scene; "
          f"design floor {rb['floor_ms']:.3f} ms [{card}]")
    if not (same and bwd_norm <= btol
            and (control is None or control > btol)):
        raise SystemExit(f"[multi_scene] {label}: the stacked backward "
                         "disagrees")
    return recs


def ms_scenes():
    """The phase's MS_SCENES 64x64 synthetic scenes (8 train / 2 val
    views), seeds 0..3, the smooth and the hard field in turn: scene 0 is
    phase 5's scene. Returns their directories and (train, val) datasets."""
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_scene

    t0 = time.perf_counter()
    dirs, data = [], []
    wh = (TRAIN_WH, TRAIN_WH)
    for s in range(MS_SCENES):
        field = ("default", "hard")[s % 2]
        d = (os.path.join(SMOKE_DIR, "scene") if s == 0 else
             os.path.join(SMOKE_DIR, "multi_scene", f"scene{s}_{field}"))
        if s > 0:
            make_synthetic_scene(d, n_train=8, n_val=2, n_test=0, img_wh=wh,
                                 seed=SEED + s, field=field)
        dirs.append(d)
        data.append((BlenderDataset(d, "train", img_wh=wh),
                     BlenderDataset(d, "val", img_wh=wh)))
    print(f"[multi_scene] {MS_SCENES} scenes {TRAIN_WH}x{TRAIN_WH} (seeds "
          f"0-{MS_SCENES - 1}, default / hard fields) in "
          f"{time.perf_counter() - t0:.1f} s")
    return dirs, data


def ms_psnr(params, rc, val_ds, grid=None):
    """Held-out PSNR of one scene's params over its val views (the
    Trainer's validation: whole images, perturb off)."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops.render import prepare_params, render_image
    from nerfmlp_torch.train.metrics import psnr_images

    params = prepare_params(params, rc)
    out = []
    for i in range(val_ds.n_images):
        o, d, gt = val_ds.image_rays(i)
        t = lambda a: torch.as_tensor(a, device="cuda")
        img = render_image(params, t(o), t(d), val_ds.H, val_ds.W, rc,
                           tile=4096, occ_grid=grid)
        out.append(psnr_images(img.float().cpu().numpy(), gt))
    return float(np.mean(out))


def ms_check_psnr(tag, kernel, plain):
    """Each scene's held-out PSNR through the kernels: at least PSNR_MIN
    (smooth scenes) or MS_HARD_PSNR_MIN (hard ones, the odd scenes); the
    gaps to the module path's run: their mean within PSNR_GAP, each within
    MS_GAP_EACH."""
    gaps = [k - p for k, p in zip(kernel, plain)]
    floors = [MS_HARD_PSNR_MIN if s % 2 else PSNR_MIN
              for s in range(len(kernel))]
    mean = sum(gaps) / len(gaps)
    print(f"[multi_scene] {tag}: held-out PSNR kernel "
          f"{[round(x, 2) for x in kernel]} dB, use_kernel=False "
          f"{[round(x, 2) for x in plain]} dB; gaps "
          f"{[round(g, 2) for g in gaps]} (mean {mean:+.2f}, limit "
          f"{PSNR_GAP}; each {MS_GAP_EACH}); floors {floors} dB")
    if not (all(k >= f for k, f in zip(kernel, floors))
            and abs(mean) <= PSNR_GAP
            and max(abs(g) for g in gaps) <= MS_GAP_EACH):
        raise SystemExit(f"[multi_scene] {tag}: held-out PSNR below its "
                         "floor or off the module path")


def ms_counters():
    from nerfmlp_torch.ops import fused_mlp

    return (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
            fused_mlp.weight_grads, fused_mlp.reduce_partials)


def ms_cli_dense(dirs, data, single_psnr, card):
    """(b): the train_multi_scene CLI on the MS_SCENES scenes, the flagship
    recipe's flags, TRAIN_STEPS steps, through the kernels and with
    --no_kernel: launches, ms a step, held-out PSNR per scene."""
    import torch

    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.parallel import multi_scene as ms
    from nerfmlp_torch.scripts import train_multi_scene as cli

    runs = {}
    for name, extra in (("kernel", []), ("plain", ["--no_kernel"])):
        argv = ["--datadirs", *dirs, "--img_wh", str(TRAIN_WH),
                str(TRAIN_WH), "--batch_size", str(TRAIN_RAYS), "--iters",
                str(TRAIN_STEPS), "--N_samples", "64", "--N_importance",
                "128", "--log_interval", "100", "--save_dir",
                os.path.join(SMOKE_DIR, "multi_scene", f"dense_{name}")]
        torch.cuda.synchronize()
        for c in ms_counters():
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            state, _ = cli.main(argv + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(c.launches for c in ms_counters())
        rc = RenderConfig(N_samples=64, N_importance=128, perturb=False,
                          compute_dtype="bfloat16",
                          use_kernel=name == "kernel")
        psnr = []
        for s, (tr, val) in enumerate(data):
            near, far = tr.dynamic_near_far()
            psnr.append(ms_psnr(ms.scene_params(state, s), dataclasses.replace(
                rc, near=near, far=far), val))
        lines = [ln for ln in log.getvalue().splitlines()
                 if ln.startswith("iter")]
        runs[name] = {"state": state, "launches": launches, "psnr": psnr,
                      "wall": wall}
        print(f"[multi_scene] CLI dense {name}: {TRAIN_STEPS} steps of "
              f"{MS_SCENES} x {TRAIN_RAYS} rays in {wall:.2f} s "
              f"({1e3 * wall / TRAIN_STEPS:.2f} ms a step, the loaders' "
              f"host batches included); launches (forward, phase 1, phase 2, "
              f"reduction) {launches}; held-out PSNR per scene "
              f"{[round(p, 2) for p in psnr]} dB; last log: {lines[-1]} "
              f"[{card}]")
    k, p = runs["kernel"], runs["plain"]
    want = (2 * TRAIN_STEPS,) * 4
    print(f"[multi_scene] dense: launches {k['launches']} (want {want}: 2 of "
          f"each kernel a step whatever the scenes), plain run "
          f"{p['launches']}; scene 0 {k['psnr'][0]:.2f} dB vs phase 5's "
          f"single-scene Trainer {single_psnr:.2f} dB (limit {PSNR_GAP})")
    if (k["launches"] != want or p["launches"] != (0, 0, 0, 0)
            or abs(k["psnr"][0] - single_psnr) > PSNR_GAP):
        raise SystemExit("[multi_scene] the dense CLI run failed its checks")
    ms_check_psnr("dense", k["psnr"], p["psnr"])
    return runs


def ms_batches(data, steps, seed_offset=0):
    """Per-scene loaders' batches (the CLI's RayBatchLoader, seeded by the
    scene's index) for ``steps`` steps: a list of (S, B, 9) CUDA tensors."""
    import numpy as np
    import torch

    from nerfmlp_torch.data.pipeline import RayBatchLoader

    loaders = [RayBatchLoader.from_dataset(tr, TRAIN_RAYS,
                                           seed=s + seed_offset)
               for s, (tr, _) in enumerate(data)]
    return [torch.from_numpy(np.stack([ld.next_batch() for ld in loaders]))
            .cuda() for _ in range(steps)]


def ms_against_solo(data, card):
    """The stack's scene 0 over MS_CHECK_STEPS steps against a solo step
    seeded the same on the same batches and bounds (phase 9's bars); then
    ms a step of the stack beside MS_SCENES solo eager steps, and a
    profiled stacked step's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerfmlp_torch.parallel import multi_scene as ms
    from nerfmlp_torch.parallel import train_step as ts

    bounds = torch.tensor([tr.dynamic_near_far() for tr, _ in data],
                          device="cuda", dtype=torch.float32)
    rc, tc = train_configs(float(bounds[:, 0].min()),
                           float(bounds[:, 1].max()))
    state = ms.create_multi_scene_state(MS_SCENES, rc, tc, device="cuda")
    step = ms.make_multi_scene_step(rc, tc, with_bounds=True)
    solos = [ts.create_train_state(rc, dataclasses.replace(
        tc, seed=tc.seed + ms.SCENE_SEED_STRIDE * s), device="cuda")
        for s in range(MS_SCENES)]
    solo_step = ts.make_step_fn(rc, tc)
    batches = ms_batches(data, MS_CHECK_STEPS + 12)
    worst = 0.0
    for b in batches[:MS_CHECK_STEPS]:
        step(state, b, bounds)
        solo_step(solos[0], b[0], None, bounds[0])
        for p, q in zip(state.params["coarse"].nets[0].parameters(),
                        solos[0].params["coarse"].parameters()):
            d = (p - q).abs() - 2e-4 * q.abs()
            worst = max(worst, float(d.max()))
    ok = worst <= 2e-6
    print(f"[multi_scene] the stack's scene 0 vs a solo step seeded the "
          f"same, {MS_CHECK_STEPS} steps: max(|diff| - 2e-4 |solo|) = "
          f"{worst:.3e} (atol 2e-6)")
    if not ok:
        raise SystemExit("[multi_scene] scene 0 of the stack left its solo "
                         "step")

    def stacked():
        for b in batches[MS_CHECK_STEPS:MS_CHECK_STEPS + 4]:
            step(state, b, bounds)

    def solo():
        for b in batches[MS_CHECK_STEPS:MS_CHECK_STEPS + 4]:
            for s in range(MS_SCENES):
                solo_step(solos[s], b[s], None, bounds[s])

    out = {}
    for key, fn in (("stack", stacked), ("solo", solo)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[key] = 1e3 * (time.perf_counter() - t0) / 4
    b = batches[-1]
    step(state, b, bounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, b, bounds)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy = sum(ms_ for _, ms_ in rows)
    kern = {k: sum(ms_ for name, ms_ in rows if k in name)
            for k in KERNEL_NAMES}
    out.update(wall=wall, busy=busy, idle=100 * (1 - busy / wall))
    print(f"[multi_scene] eager: one step of {MS_SCENES} scenes "
          f"{out['stack']:.2f} ms vs {MS_SCENES} solo steps "
          f"{out['solo']:.2f} ms (synchronised, mean of 4); a profiled "
          f"stacked step: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle {out['idle']:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in kern.items())
          + f" [{card}]")
    return out


def ms_turbo(data, card):
    """(c): the turbo recipe with per-scene grids through the library's
    multi-scene step and grid refresh (the CLI keeps the JAX CLI's flags,
    which cut no warmup: its grids would not prune in TRAIN_STEPS steps),
    through the kernels and with use_kernel=False: launches, pruning and
    held-out PSNR per scene, rendered with the scene's grid."""
    import torch

    from nerfmlp_torch.ops.occupancy import OccupancyGrid
    from nerfmlp_torch.parallel import multi_scene as ms

    bounds = torch.tensor([tr.dynamic_near_far() for tr, _ in data],
                          device="cuda", dtype=torch.float32)
    rc0, tc = turbo_configs(float(bounds[:, 0].min()),
                            float(bounds[:, 1].max()))
    batches = ms_batches(data, TRAIN_STEPS)   # the CLI's loaders' seeds
    runs = {}
    for name, rc in (("kernel", rc0),
                     ("plain", dataclasses.replace(rc0, use_kernel=False))):
        state = ms.create_multi_scene_state(MS_SCENES, rc, tc, device="cuda")
        step = ms.make_multi_scene_step(rc, tc, with_bounds=True)
        update = ms.make_multi_scene_grid_update(rc)
        grids = ms.create_multi_scene_grids(MS_SCENES, rc, device="cuda")
        torch.cuda.synchronize()
        for c in ms_counters():
            c.launches = 0
        refreshes = 0
        t0 = time.perf_counter()
        for it, b in enumerate(batches, start=1):
            if (it - 1) % rc.occ_update_every == 0:
                gens = [torch.Generator(device="cuda").manual_seed(
                    (17 + it) * 1_000_003 + s) for s in range(MS_SCENES)]
                grids = update(grids, state.params, gens,
                               1.0 if it <= rc.occ_warmup_steps else 0.95)
                refreshes += 1
            step(state, b, grids, bounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(c.launches for c in ms_counters())
        occupied = [float((grids.density[s] > rc.occ_threshold).float()
                          .mean()) for s in range(MS_SCENES)]
        psnr = []
        for s, (tr, val) in enumerate(data):
            near, far = tr.dynamic_near_far()
            psnr.append(ms_psnr(ms.scene_params(state, s), dataclasses.replace(
                rc, near=near, far=far), val,
                OccupancyGrid(grids.density[s])))
        runs[name] = {"launches": launches, "psnr": psnr,
                      "occupied": occupied, "refreshes": refreshes}
        print(f"[multi_scene] turbo {name}: {TRAIN_STEPS} steps in "
              f"{wall:.2f} s ({1e3 * wall / TRAIN_STEPS:.2f} ms a step, "
              f"{refreshes} refreshes); launches {launches}; cells occupied "
              f"{[round(100 * o, 1) for o in occupied]}%; held-out PSNR "
              f"{[round(p, 2) for p in psnr]} dB [{card}]")
    k, p = runs["kernel"], runs["plain"]
    want = (2 * TRAIN_STEPS + k["refreshes"],) + (2 * TRAIN_STEPS,) * 3
    print(f"[multi_scene] turbo: launches {k['launches']} (want {want}: 2 "
          f"queries a step, 1 forward a refresh of every scene's grid); "
          f"every grid pruned: {max(k['occupied']) < 1.0}")
    if (k["launches"] != want or p["launches"] != (0, 0, 0, 0)
            or max(k["occupied"]) >= 1.0):
        raise SystemExit("[multi_scene] the turbo run failed its checks")
    ms_check_psnr("turbo", k["psnr"], p["psnr"])
    return runs


def ms_mixed(blender_dir, focal, card):
    """(d): the CLI on one synthetic scene and phase 8's LLFF fixture (NDC),
    MS_MIXED_STEPS steps: per-scene bounds and the white-background
    warning printed, two .pt files that load_params_any reads, one served
    for a frame by RenderService."""
    import numpy as np

    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.scripts import train_multi_scene as cli
    from nerfmlp_torch.serve import RenderService
    from nerfmlp_torch.train.checkpoint import load_params_any

    llff = os.path.join(SMOKE_DIR, "llff", "scene")
    if not os.path.isdir(os.path.join(llff, "images_8")):   # phase 8's
        make_synthetic_llff_scene(llff, n_images=LLFF_VIEWS, img_wh=LLFF_WH,
                                  style="forward", seed=SEED)
        os.rename(os.path.join(llff, "images"),
                  os.path.join(llff, "images_8"))
    out = os.path.join(SMOKE_DIR, "multi_scene", "mixed")
    shutil.rmtree(out, ignore_errors=True)
    for c in ms_counters():
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        cli.main(["--datadirs", blender_dir, llff, "--dataset_types",
                  "blender", "llff", "--factor", "8", "--img_wh",
                  str(TRAIN_WH), str(TRAIN_WH), "--batch_size",
                  str(TRAIN_RAYS), "--iters", str(MS_MIXED_STEPS),
                  "--log_interval", "25", "--save_dir", out])
    wall = time.perf_counter() - t0
    text = log.getvalue()
    launches = tuple(c.launches for c in ms_counters())
    for ln in text.splitlines():
        print(f"[multi_scene] mixed CLI | {ln}")
    files = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    params = [load_params_any(os.path.join(out, f), device="cuda")
              for f in files]
    rc = RenderConfig(N_samples=64, N_importance=128, near=2.0, far=6.0,
                      compute_dtype="bfloat16", use_kernel=True,
                      white_bkgd=False)
    svc = RenderService(params[0], rc, TRAIN_WH, TRAIN_WH, focal, tile=4096,
                        device="cuda", log=lambda m: None)
    before = ms_counters()[0].launches
    frame = svc.render_pose(pose_spherical(30.0, -30.0, 4.0))["rgb_map"]
    served = ms_counters()[0].launches - before
    nf = [ln for ln in text.splitlines() if "near/far" in ln]
    ok = (len(nf) == 2 and "0.00/1.00" in nf[1] and "0.00/1.00" not in nf[0]
          and "white_bkgd" in text
          # both directories are named "scene": the names are made unique
          and files == ["model_scene_0_final.pt", "model_scene_1_final.pt"]
          and launches == (2 * MS_MIXED_STEPS,) * 4
          and np.isfinite(np.asarray(frame)).all() and served > 0)
    print(f"[multi_scene] mixed CLI: {MS_MIXED_STEPS} steps in {wall:.1f} s, "
          f"launches {launches}; wrote {files}, each read by "
          f"load_params_any; {files[0]} served a {TRAIN_WH}x{TRAIN_WH} frame "
          f"({served} forward launches, finite) [{card}]")
    if not ok:
        raise SystemExit("[multi_scene] the mixed CLI run failed its checks")
    return files


def phase_multi_scene(single_psnr, card):
    """Phase 11 (the module docstring). Returns the kernel records of path
    multi_scene and the CLI runs' launches."""
    from nerfmlp_torch.models.mlp import init_model

    t0 = time.perf_counter()
    cfg = slice_config()
    nets = [init_model(cfg.model_config(), seed=SEED + s, device="cuda")
            for s in range(MS_SCENES)]
    checks = {
        "coarse": check_stack(nets, cfg, cfg.N_samples, "dense coarse",
                              card),
        "fine": check_stack(nets, cfg, cfg.N_importance, "dense fine", card),
        "probe": check_stack(nets, cfg, OCC_PROBE, "turbo probe", card),
        "hi_lo": check_stack(nets, cfg, OCC_PROBE + OCC_REFINE,
                             "hi_lo one-shot query", card, hi_lo=True),
    }
    del nets
    dirs, data = ms_scenes()
    dense = ms_cli_dense(dirs, data, single_psnr, card)
    timing = ms_against_solo(data, card)
    turbo = ms_turbo(data, card)
    files = ms_mixed(dirs[0], data[0][0].focal, card)
    print(f"[multi_scene] phase took {time.perf_counter() - t0:.1f} s")
    k = turbo["kernel"]
    queries = (k["launches"][0] - k["refreshes"],) + k["launches"][1:]
    return {"checks": checks, "dense": dense["kernel"]["launches"],
            "turbo": queries, "timing": timing, "files": files}


def multi_scene_records(ms_run):
    """The JSON line's records of path multi_scene: each kernel at the
    dense step's fine call (launches: the dense CLI run's; max_abs_err over
    its coarse and fine calls; the hi_lo one-shot query's error and times
    beside them) and at the turbo probe call (launches: the turbo run's
    queries, its grid refreshes left out); S single-scene launches' time
    as solo_ms."""
    c = ms_run["checks"]
    recs = []
    for key, name, source, replaces, i in (
            ("fwd", "fused_mlp_fwd", "fused_mlp_fwd.cu", "pallas_mlp.py:264",
             0),
            ("phase1", "fused_mlp_bwd_phase1", "fused_mlp_bwd.cu",
             "pallas_mlp.py:312", 1),
            ("phase2", "fused_mlp_bwd_phase2", "fused_mlp_bwd.cu",
             "pallas_mlp.py:386", 2),
            ("reduce", "fused_mlp_bwd_reduce", "fused_mlp_bwd.cu",
             "pallas_mlp.py:327", 3)):
        for suffix, big, small, launches in (
                ("_multi_scene", c["fine"], c["coarse"], ms_run["dense"][i]),
                ("_multi_scene_probe", c["probe"], c["probe"],
                 ms_run["turbo"][i])):
            r = big[key]
            hi_lo = ({"hi_lo_max_abs_err": c["hi_lo"][key]["max_abs_err"],
                      "hi_lo_ms": c["hi_lo"][key]["ms"],
                      "hi_lo_solo_ms": c["hi_lo"][key]["solo_ms"]}
                     if suffix == "_multi_scene" else {})
            recs.append({
                "name": name + suffix,
                "path": "multi_scene",
                "route": "cuda",
                "source": "nerfmlp_torch/csrc/" + source,
                "replaces": "nerfmlp_tpu/ops/" + replaces,
                "launches": launches,
                "scenes": MS_SCENES,
                "max_abs_err": max(r["max_abs_err"],
                                   small[key]["max_abs_err"]),
                "ms": r["ms"],
                "solo_ms": r["solo_ms"],
                "plain_ms": r["plain_ms"],
                "module_ms": r.get("module_ms"),
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"),
                **hi_lo,
            })
    return recs


# -- phase 12 ------------------------------------------------------------- #
GT_WH = 400               # phase 12's certification scene (README.md:42-43,
GT_SPLITS = (48, 4, 8)    # docs/RESULTS.md:185-203): 400x400, the hard
GT_SAMPLES = 512          # field, 48 / 4 / 8 views, 512 GT samples a ray
GT_CHECK_WH = 128         # two of its poses on the card and in numpy,
GT_LEVEL_SHARE = 0.999    # 8-bit sRGB: within 1 level on this share of
GT_LEVEL_MAX = 2          # values, within 2 everywhere (float32 trig)
RESUME_STEPS = 50         # train CLI steps after each resume


def jax_train_state_tree(raw, cfgs):
    """A train state the port's Trainer wrote (a ``metrics_latest.pt``
    dict), as the JAX package's Trainer writes its ``metrics_latest.ckpt``
    (``nerfmlp_tpu/parallel/train_step.py:30-37`` through flax's
    serialization): step, params in the JAX layout, ``opt_state`` as
    ``optax.chain(adam)`` holds it with ``grad_clip`` 0 — ((Adam's count,
    mu, nu), the schedule's count) — and a PRNG key of the seed, which the
    port does not read. Dict keys sorted, as ``jax.device_get`` leaves
    them. ``cfgs``: the nets' ModelConfigs by name."""
    import numpy as np

    from nerfmlp_torch.models import convert

    def srt(t):
        return {k: srt(t[k]) for k in sorted(t)} if isinstance(t, dict) else t

    state = raw["opt_state"]["state"]
    moments, i = {"mu": {}, "nu": {}}, 0
    for k, sd in raw["params"].items():
        names = list(sd)   # the Adam's order: each net's parameters
        for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[key][k] = convert.params_from_state_dict(
                {n: state[i + j][slot] for j, n in enumerate(names)},
                cfgs[k])
        i += len(names)
    if i != len(state):
        raise SystemExit(f"[interchange] {len(state)} Adam slots for {i} "
                         "parameters")
    count = np.asarray(int(state[0]["step"]), np.int32)
    return {
        "step": np.asarray(int(raw["step"]), np.int32),
        "params": srt({k: convert.params_from_state_dict(sd, cfgs[k])
                       for k, sd in raw["params"].items()}),
        "opt_state": {"0": {
            "0": {"count": count, "mu": srt(moments["mu"]),
                  "nu": srt(moments["nu"])},
            "1": {"count": count}}},
        "rng": np.asarray([0, SEED], np.uint32),
    }


def gt_scene(card):
    """The certification scene through the make_synthetic_scene CLI on the
    card, timed and loaded back; two of its test poses at GT_CHECK_WH
    rendered on the card and in numpy, compared in 8-bit sRGB levels."""
    import numpy as np
    import torch

    from nerfmlp_torch.data.blender import BlenderDataset, linear_to_srgb
    from nerfmlp_torch.data.synthetic import FIELDS, render_analytic
    from nerfmlp_torch.scripts import make_synthetic_scene as gt_cli

    scene = os.path.join(SMOKE_DIR, "interchange", "hard400")
    n_views = sum(GT_SPLITS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gt_cli.main(["--outdir", scene, "--field", "hard", "--img_wh",
                 str(GT_WH), str(GT_WH), "--n_train", str(GT_SPLITS[0]),
                 "--n_val", str(GT_SPLITS[1]), "--n_test", str(GT_SPLITS[2]),
                 "--gt_samples", str(GT_SAMPLES), "--device", "cuda"])
    gt_s = time.perf_counter() - t1
    print(f"[interchange] make_synthetic_scene --field hard {GT_WH}x{GT_WH}, "
          f"{n_views} views x {GT_SAMPLES} GT samples, --device cuda: "
          f"{gt_s:.2f} s, {gt_s / n_views:.3f} s a view (PNGs included) "
          f"[{card}]")
    loaded = {split: BlenderDataset(scene, split, img_wh=(GT_WH, GT_WH))
              for split in ("train", "val", "test")}
    sizes = tuple(len(ds.poses) for ds in loaded.values())
    print(f"[interchange] the Blender loader reads {sizes} views")
    if sizes != GT_SPLITS or not all(
            np.isfinite(ds.images).all() for ds in loaded.values()):
        raise SystemExit("[interchange] the certification scene does not "
                         "load as written")

    with open(os.path.join(scene, "transforms_test.json")) as f:
        meta = json.load(f)
    focal = 0.5 * GT_CHECK_WH / np.tan(0.5 * meta["camera_angle_x"])
    worst = {"levels": 0, "share": 1.0, "linear": 0.0}
    times = {"cuda": 0.0, "numpy": 0.0}
    for frame in meta["frames"][:2]:
        pose = np.asarray(frame["transform_matrix"], np.float32)
        imgs = {}
        for dev in ("cuda", "numpy"):
            t1 = time.perf_counter()
            imgs[dev] = render_analytic(
                pose, GT_CHECK_WH, GT_CHECK_WH, focal, n_samples=GT_SAMPLES,
                near=2.0, far=6.0, field=FIELDS["hard"],
                device=None if dev == "numpy" else dev)
            times[dev] += time.perf_counter() - t1
        lv = np.abs((linear_to_srgb(imgs["cuda"]) * 255.0).round()
                    - (linear_to_srgb(imgs["numpy"]) * 255.0).round())
        worst["levels"] = max(worst["levels"], int(lv.max()))
        worst["share"] = min(worst["share"], float((lv <= 1).mean()))
        worst["linear"] = max(worst["linear"], float(
            np.abs(imgs["cuda"] - imgs["numpy"]).max()))
    print(f"[interchange] two test poses at {GT_CHECK_WH}x{GT_CHECK_WH} "
          f"({GT_SAMPLES} samples), card vs numpy: max {worst['levels']} "
          f"levels of 8-bit sRGB, {100 * worst['share']:.4f}% of values "
          f"within 1 level (bars: {GT_LEVEL_MAX}, "
          f"{100 * GT_LEVEL_SHARE:g}%), max |linear err| "
          f"{worst['linear']:.3e}; {times['cuda']:.2f} s on the card, "
          f"{times['numpy']:.2f} s in numpy")
    if not (worst["levels"] <= GT_LEVEL_MAX
            and worst["share"] >= GT_LEVEL_SHARE):
        raise SystemExit("[interchange] the card's ground truth is off the "
                         "numpy path")
    return {"seconds": gt_s, "views": n_views}


def serve_frame(flags, ckpt_path):
    """One frame served over HTTP by the serve CLI's service from
    ``ckpt_path``: (frame, forward launches in the request)."""
    import numpy as np

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.scripts import serve as serve_cli
    from nerfmlp_torch.serve import RenderServer

    svc = serve_cli.build_service(serve_cli.build_parser().parse_args(
        flags + ["--ckpt", ckpt_path]))
    svc.log = lambda m: None
    svc.warmup()
    server = RenderServer(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        fused_mlp.fused_nerf_mlp.launches = 0
        req = urllib.request.Request(
            "http://%s:%d/render" % server.server_address[:2], method="POST",
            data=json.dumps({**dict(zip(("theta", "phi", "radius"),
                                        SERVE_POSE)),
                             "format": "npy"}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, body = resp.status, resp.read()
        launches = fused_mlp.fused_nerf_mlp.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if status != 200:
        raise SystemExit(f"[interchange] /render answered {status}")
    return np.load(io.BytesIO(body)), launches


def resume_run(tag, argv, path):
    """The train CLI resumed from ``path`` for RESUME_STEPS steps
    (train_cli_run: every launch counter set to 0 just before, read just
    after): the state just after the resume (step, params, Adam moments
    and count, the learning rate of the next update), the per-step losses
    after it, and train_cli_run's results."""
    import torch

    from nerfmlp_torch.parallel.train_step import lr_tensor
    from nerfmlp_torch.train import loop

    snap = {}
    resume = loop.Trainer.resume

    def snapshot(self, p):
        ok = resume(self, p)
        st = self.state
        snap.update(
            ok=ok, step=st.step,
            params=[p.detach().clone() for net in st.params.values()
                    for p in net.parameters()],
            moments=[t.clone() for t in st.optimizer.exp_avg
                     + st.optimizer.exp_avg_sq],
            count=st.optimizer.count.clone(),
            lr=lr_tensor(self.tc, st.counter).clone(), losses=[])
        inner = self.step_fn

        def recorded(state, batch, *occ):
            m = inner(state, batch, *occ)
            snap["losses"].append(m["loss"])
            return m

        self.step_fn = recorded
        return ok

    loop.Trainer.resume = snapshot
    try:
        out = train_cli_run(tag, argv + ["--resume", path], RESUME_STEPS)
    finally:
        loop.Trainer.resume = resume
    snap["loss"] = float(torch.stack(snap["losses"]).mean())
    return snap, out


def phase_interchange(train_run, turbo_ckpt, card):
    """Ground truth on the card and the JAX package's .ckpt files (the
    module docstring, phase 12). Returns the records of path interchange."""
    import numpy as np
    import torch

    from nerfmlp_torch.scripts import convert_checkpoint as conv_cli
    from nerfmlp_torch.train.checkpoint import load_params_any, save_ckpt

    t0 = time.perf_counter()
    root = os.path.join(SMOKE_DIR, "interchange")
    shutil.rmtree(root, ignore_errors=True)     # no auto-resume of a rerun
    os.makedirs(root)
    gt = gt_scene(card)

    # -- phase 6's turbo weights as a .ckpt, served and converted back ----
    ckpt = os.path.join(root, "turbo_phase6.ckpt")
    conv_cli.main(["--in", turbo_ckpt, "--out", ckpt])
    flags = ["--use_occupancy", "--aabb", *[str(v) for v in OCC_AABB],
             "--N_samples", str(OCC_PROBE), "--N_importance", str(OCC_REFINE),
             "--occ_dense_samples", str(OCC_DENSE), "--focal", str(FOCAL),
             "--img_wh", str(W), str(H)]
    frame_pt, launches_pt = serve_frame(flags, turbo_ckpt)
    frame_ck, launches_ck = serve_frame(flags, ckpt)
    pth = os.path.join(root, "turbo_phase6.pth")
    conv_cli.main(["--in", ckpt, "--out", pth])
    back = torch.load(pth, map_location="cpu", weights_only=True)
    orig = torch.load(turbo_ckpt, map_location="cpu", weights_only=True)
    same = list(back) == list(orig) and all(
        torch.equal(back[k], orig[k]) for k in orig)
    print(f"[interchange] turbo weights .pt -> .ckpt ({os.path.getsize(ckpt)} "
          f"B) served by the serve CLI: frame bit-equal to the .pt's "
          f"{np.array_equal(frame_ck, frame_pt)}, forward launches "
          f"{launches_ck} vs {launches_pt} a frame; .ckpt -> .pth equal to "
          f"the .pt bit for bit {same}")
    if not (np.array_equal(frame_ck, frame_pt) and launches_ck == launches_pt
            and launches_ck > 0 and same and np.isfinite(frame_ck).all()):
        raise SystemExit("[interchange] the .ckpt did not serve or convert "
                         "as the .pt")
    cfg = slice_config()
    net = load_params_any(ckpt, cfg.model_config(), device="cuda")["coarse"]
    serve_rec = check_kernel(net, cfg, *serving_points(OCC_REFINE, cfg,
                                                       n_rays=OCC_TILE),
                             "interchange served tile refine (.ckpt)",
                             time_it=True)

    # -- phase 5's final train state as the JAX Trainer writes it --------
    trainer = train_run["trainer"]
    pt_state = os.path.join(trainer.save_dir, "metrics_latest.pt")
    raw = torch.load(pt_state, map_location="cpu", weights_only=True)
    jax_dir = os.path.join(root, "jax_run")
    ck_state = os.path.join(jax_dir, "metrics_latest.ckpt")
    save_ckpt(ck_state, jax_train_state_tree(
        raw, {"coarse": trainer.rc.model_config()}))
    shutil.copy(os.path.join(trainer.save_dir,
                             "metrics_latest.history.json"), jax_dir)
    step = int(raw["step"])
    argv = ["--datadir", os.path.join(SMOKE_DIR, "scene"), "--img_wh",
            str(TRAIN_WH), str(TRAIN_WH), "--white_bkgd", "--N_samples",
            str(cfg.N_samples), "--N_importance", str(cfg.N_importance),
            "--batch_size", str(TRAIN_RAYS), "--iters",
            str(step + RESUME_STEPS), "--quick_val_interval",
            str(RESUME_STEPS // 2), "--quick_val_res", str(TRAIN_WH),
            str(TRAIN_WH), "--quick_val_subset", "1", "--full_val_interval",
            "0", "--i_weights", "0"]
    runs = {}
    for name, path in (("pt", pt_state), ("ckpt", ck_state)):
        runs[name] = resume_run(
            f"interchange resume {name}",
            argv + ["--save_dir", os.path.join(root, "resumed_" + name)],
            path)
    (a, _), (b, out) = runs["pt"], runs["ckpt"]
    equal = {key: (a[key] == b[key] if key == "step" else
                   all(torch.equal(x, y) for x, y in zip(a[key], b[key]))
                   if isinstance(a[key], list) else torch.equal(a[key],
                                                                b[key]))
             for key in ("step", "params", "moments", "count", "lr")}
    before = float(np.mean(train_run["losses"][-RESUME_STEPS:]))
    _, launches, step_fwd, _, tr = out
    want = 2 * RESUME_STEPS
    print(f"[interchange] train CLI resumed at step {b['step']} from the "
          f"JAX-layout metrics_latest.ckpt vs from metrics_latest.pt: "
          f"bit-equal {equal}; mean loss of the next {RESUME_STEPS} steps "
          f"{b['loss']:.6f} (.ckpt) / {a['loss']:.6f} (.pt) vs {before:.6f} "
          f"over phase 5's last {RESUME_STEPS}; launches in the steps "
          f"{(step_fwd, *launches[1:])} (want {want} of each)")
    if not (a["ok"] and b["ok"] and all(equal.values()) and b["step"] == step
            and b["loss"] < before and a["loss"] < before
            and step_fwd == want and list(launches[1:]) == [want] * 3):
        raise SystemExit("[interchange] the .ckpt resume failed its checks")
    pts, dirs = serving_points(cfg.N_importance, cfg, n_rays=TRAIN_RAYS)
    resumed = tr.state.params["coarse"]
    fwd_rec = check_kernel(resumed, cfg, pts, dirs,
                           "interchange resumed fine call", time_it=True)
    _, phases = check_backward(resumed, cfg, pts, dirs,
                               "interchange resumed fine call", time_it=True)
    print(f"[interchange] phase took {time.perf_counter() - t0:.1f} s "
          f"(ground truth {gt['seconds']:.1f} s)")

    recs = []
    base = {"path": "interchange", "route": "cuda"}
    for name, launches_n, r in (
            ("fused_mlp_fwd_interchange_serve", launches_ck, serve_rec),
            ("fused_mlp_fwd_interchange_train", step_fwd, fwd_rec)):
        recs.append({**base, "name": name,
                     "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
                     "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
                     "launches": launches_n, "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "module_ms": r["module_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    for key, name, replaces, i in (
            ("phase1", "fused_mlp_bwd_phase1", "pallas_mlp.py:312", 1),
            ("phase2", "fused_mlp_bwd_phase2", "pallas_mlp.py:386", 2),
            ("reduce", "fused_mlp_bwd_reduce", "pallas_mlp.py:327", 3)):
        r = phases[key]
        recs.append({**base, "name": name + "_interchange",
                     "source": "nerfmlp_torch/csrc/fused_mlp_bwd.cu",
                     "replaces": "nerfmlp_tpu/ops/" + replaces,
                     "launches": launches[i], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    return recs


def save_turbo(occ_run):
    """Phase 6's turbo weights, as phase 10 and 12 read them."""
    from nerfmlp_torch.train.checkpoint import save_params

    path = os.path.join(SMOKE_DIR, "turbo_phase6.pt")
    save_params(path, occ_run["trainer"].state.params)
    return path


def smi_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


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
    if sys.argv[1:] == ["--only", "interchange"]:
        # Phase 12 alone, after the runs whose files it reads: phase 5's
        # train state and phase 6's turbo weights.
        train_ds, val_ds = make_scene()
        card = smi_line()
        train_run = phase_train(train_ds, val_ds)
        turbo_ckpt = save_turbo(phase_occ_train(train_ds, val_ds))
        print(json.dumps({"kernels": phase_interchange(train_run, turbo_ckpt,
                                                       card)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "multi_scene"]:
        # Phase 11 alone, after the single-scene run it is held against.
        train_ds, val_ds = make_scene()
        card = smi_line()
        ms_run = phase_multi_scene(phase_train(train_ds, val_ds)["val"]
                                   ["psnr"], card)
        print(json.dumps({"kernels": multi_scene_records(ms_run)}))
        print(card)
        return 0
    net = init_model(slice_config().model_config(), seed=SEED, device="cuda")
    coarse, fine = phase_kernel(net)
    fwd_train, bwds, ph_fine, ph_coarse = phase_backward(net)
    serve_launches = phase_serve(net)
    train_ds, val_ds = make_scene()
    train_run = phase_train(train_ds, val_ds)
    fwd_launches, *bwd_launches = train_run["launches"]
    occ, occ_ph = phase_occ_kernels(net)
    occ_run = phase_occ_train(train_ds, val_ds)
    hi_lo_run = phase_occ_hi_lo(train_ds, val_ds)
    occ_serve_launches = phase_occ_serve(occ_run["trainer"])
    # Phase 10's model: the turbo weights as phase 6 left them (phase 9
    # trains that Trainer on).
    turbo_ckpt = save_turbo(occ_run)
    cli_launches = phase_inference()
    llff = phase_llff(net)
    card = smi_line()
    graph_recs = phase_graph(train_ds, val_ds, train_run, occ_run,
                             hi_lo_run, card)
    mesh_recs = phase_mesh(turbo_ckpt, card)
    ms_run = phase_multi_scene(train_run["val"]["psnr"], card)
    interchange_recs = phase_interchange(train_run, turbo_ckpt, card)

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
    # Occupancy sampling's paths: the forward's records per call kind
    # (the train step's queries, timed at the refine call; the grid
    # refreshes; the served tiles, timed at the refine query; the one-shot
    # hi_lo recipe's query and refreshes; render_video's frames, the served
    # tile's shapes), each with its launches on that path.
    occ_launches, occ_refresh = occ_run["launches"], occ_run["refresh"]
    hi_lo_launches, hi_lo_refresh = hi_lo_run["launches"], hi_lo_run["refresh"]
    for name, path, launches, recs in (
            ("fused_mlp_fwd_occ_train", "occ_train",
             occ_launches[0] - occ_refresh["launches"],
             (occ["train refine"], occ["train probe"])),
            ("fused_mlp_fwd_occ_refresh", "occ_train",
             occ_refresh["launches"], (occ["refresh"],)),
            ("fused_mlp_fwd_occ_serve", "occ_serve", occ_serve_launches,
             (occ["serve refine"], occ["serve probe"])),
            ("fused_mlp_fwd_occ_hi_lo", "occ_hi_lo",
             hi_lo_launches[0] - hi_lo_refresh["launches"],
             (occ["hi_lo train"],)),
            ("fused_mlp_fwd_occ_hi_lo_refresh", "occ_hi_lo",
             hi_lo_refresh["launches"], (occ["hi_lo refresh"],)),
            # render_video's frames: the served tile's shapes.
            ("fused_mlp_fwd_cli", "cli", cli_launches,
             (occ["serve refine"], occ["serve probe"]))):
        r = recs[0]
        kernels.append({
            "name": name,
            "path": path,
            "route": "cuda",
            "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
            "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
            "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in recs),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "module_ms": r["module_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    # The forward-facing path (phase 8): its forward launches (the train CLI
    # run, render_video and the served frame) with the served NDC tile's
    # times; the backward's with the train call's.
    tile = llff["tile"]
    kernels.append({
        "name": "fused_mlp_fwd_llff",
        "path": "llff",
        "route": "cuda",
        "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
        "launches": llff["fwd_launches"],
        "max_abs_err": max(tile["max_abs_err"],
                           llff["fwd_train"]["max_abs_err"]),
        "ms": tile["ms"],
        "plain_ms": tile["plain_ms"],
        "module_ms": tile["module_ms"],
        "bound_ms": tile["bound_ms"],
        "bound_by": tile["bound_by"],
        "library_ms": None,
    })
    for key, name, replaces, i in (
            ("phase1", "fused_mlp_bwd_phase1", "pallas_mlp.py:312", 0),
            ("phase2", "fused_mlp_bwd_phase2", "pallas_mlp.py:386", 1),
            ("reduce", "fused_mlp_bwd_reduce", "pallas_mlp.py:327", 2)):
        for suffix, path, launches, big, small in (
                ("", "train", bwd_launches[i], ph_fine, ph_coarse),
                ("_occ_train", "occ_train", occ_launches[1 + i],
                 occ_ph["refine"], occ_ph["probe"]),
                ("_occ_hi_lo", "occ_hi_lo", hi_lo_launches[1 + i],
                 occ_ph["hi_lo"], occ_ph["hi_lo"]),
                ("_llff", "llff", llff["bwd_launches"][i], llff["phases"],
                 llff["phases"])):
            r = big[key]
            kernels.append({
                "name": name + suffix,
                "path": path,
                "route": "cuda",
                "source": "nerfmlp_torch/csrc/fused_mlp_bwd.cu",
                "replaces": "nerfmlp_tpu/ops/" + replaces,
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"],
                                   small[key]["max_abs_err"]),
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
            })
    # The dense step replayed from its CUDA graph (phase 9): launches and
    # device ms per launch from the trace of the whole K = 16 run; errors,
    # bounds, plain and library times from the kernels held on its trained
    # net at its two calls (graph_kernels).
    for (name, source, replaces), r in zip(
            (("fused_mlp_fwd", "fused_mlp_fwd.cu", "pallas_mlp.py:264"),
             ("fused_mlp_bwd_phase1", "fused_mlp_bwd.cu", "pallas_mlp.py:312"),
             ("fused_mlp_bwd_phase2", "fused_mlp_bwd.cu", "pallas_mlp.py:386"),
             ("fused_mlp_bwd_reduce", "fused_mlp_bwd.cu",
              "pallas_mlp.py:327")),
            graph_recs):
        kernels.append({
            "name": name + "_graph",
            "path": "graph",
            "route": "cuda",
            "source": "nerfmlp_torch/csrc/" + source,
            "replaces": "nerfmlp_tpu/ops/" + replaces,
            **r,
        })
    # Mesh extraction (phase 10): the forward at the density query's shape
    # (65,536 grid nodes, one sample each, the constant direction) and at
    # the colour bake's (surface vertices, their inward normals), each with
    # its launches on the path.
    for suffix, r in zip(("density", "colour"), mesh_recs):
        kernels.append({
            "name": "fused_mlp_fwd_mesh_" + suffix,
            "path": "mesh",
            "route": "cuda",
            "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
            "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
            "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "module_ms": r["module_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    # Multi-scene training (phase 11): each kernel over the scene axis.
    kernels += multi_scene_records(ms_run)
    # The JAX package's .ckpt files (phase 12): the served frame's forward
    # and the resumed steps' four kernels, held on the weights read back.
    kernels += interchange_recs
    for rec in bwds + [occ["bwd probe"], occ["bwd refine"], occ["bwd hi_lo"],
                       llff["bwd"]]:
        print(f"[backward] {rec['label']} call, all three kernels: "
              f"{rec['ms']:.3f} ms ({rec['ms_no_spin']:.3f} ms without the "
              f"spin); bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}), design floor {rec['floor_ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
