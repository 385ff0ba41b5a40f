#!/usr/bin/env python3
"""Drive the PyTorch port (nerfmlp_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the port from csrc/ (nvcc, in parallel);
     fail where ptxas serialized the wgmma of a kernel (note C7520) or
     where an instantiation of the forward or phase 1 has no HGMMA or no
     bulk copy in its SASS;
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
 13. data parallelism ("parallel"): phase 5's flagship recipe on two gloo
     ranks sharing the card (512 of the 1,024 rays a step each), spawned
     by parallel/mesh.py::launch: the first step's averaged gradient held
     against one process's on the same rays (KERNEL_TOL), 100 steps
     through the Trainer (held-out PSNR within 0.5 dB of the one-process
     run's, the ranks' parameters bit-equal, 2 launches of each kernel a
     step on each rank, rank 0 alone writing files), each rank's step
     time, idle share and the gradient all-reduce timed; one NCCL rank at
     K = 1 and K = 16 (the all-reduce captured in the CUDA graph; the
     parameters bit-equal after 100 steps), timed beside the in-process
     Trainer; NCCL over every card where there is more than one (the
     count printed either way); a 400x400 frame through
     render_image_sharded over [cuda:0, cuda:0], dense and with a grid,
     bit-equal to the local renderer's; a frame served by the serve CLI
     with sharding on (the default) bit-equal to --no_shard_render's, and
     RenderService over [cuda:0, cuda:0] at the serving bars; the train
     CLI with --n_devices 1 in this process (with one visible card also
     bit-equal to the run without the flag); the four kernels at a rank's
     shapes (32,768 coarse and 65,536 fine points), held and timed.
 14. JPEG captures and the Trainer's extras ("jpeg"): every committed
     JPEG of tests/data/jpeg/ decoded by the port's decoder and held to
     its stored Pillow decode (0 levels; the decode rate per megapixel on
     this host printed beside the card); the train CLI on
     configs/fern.txt as it is with --factor 4 on the committed 384x288
     JPEG images/ of phase 8's 12-view capture (the loader minifies them
     to 96x72 PNGs), 400 steps through the kernels with --profile_dir and
     --check_numerics: held-out PSNR >= 20 dB and within 1 dB of the same
     capture's PNG renders (written on the card) trained alike (phase 8's
     run printed beside them), 2 launches of each kernel a step, the trace
     of steps 10-29
     parsed (40 launches of each kernel, device ms per launch), the four
     kernels held against their plain versions on the net of that window
     at the run's call; the same run without --check_numerics, both step
     times printed; --tensorboard refused by name where the tensorboard
     package does not import, else its event file written.
 15. the rest of the JAX package ("finish"): tensor parallelism on two
     ranks as (data 1, model 2), NCCL over two cards where there are two,
     else two gloo ranks sharing the card: the flagship 8x256 net in fp32
     on the module path (1,024 rays, 64 + 128 samples), its first step
     against one process's on the same global batch (loss rtol 1e-5, the
     gradient within 1e-5 of its largest element, parameters atol 5e-3),
     pts_linears.0's shard 128 rows, no kernel launched in the TP steps,
     100 steps through the TP Trainer at 32 + 64 samples within 0.5 dB of
     the one-process run's at 32 + 64, ms per step a rank beside the
     one-process module path's; the turbo weights' 256^3 mesh dealt over
     two devices (two cards, or the card twice) against one device: the
     volume, vertices, faces and colours bit-equal, the forward launches
     summed over the devices equal to one device's, seconds per stage; every
     committed progressive JPEG against its Pillow decode (0 levels), the
     decode rate, the progressive capture's pixels equal to the baseline
     capture's, and configs/fern.txt trained on it at --factor 4 (>= 20
     dB, within 1 dB of phase 14's baseline-JPEG run, 2 launches of each
     kernel a step; the four kernels held on its net); the tools on phase
     7's run directory: its three end-of-run figures, view_progress
     showing its step, make_timelapse's GIF with one frame per
     val_*.png, side_by_side_compare's 2W x H image.
 16. the fused MLP kernels at every width the JAX package runs them
     ("wide"): the forward and the backward's three kernels at depth 8
     and widths 288, 384, 512 and 640 in bf16 and 384, 512 and 576 in
     hi_lo (column passes of 256; phase-1 tiles of 128 to 32 points),
     at the train fine call's 131,072 points with random weights, against
     their plain versions (each alone and the backward whole, repeat runs
     bit-identical), timed beside their bounds and the module path
     (autograd through the nn.Linear net); the train CLI at --netwidth
     512 for 300 steps and at --netwidth 384 in fp32 'high' for 100 steps
     on phase 5's scene, through the kernels and with --no_kernel
     (exactly 2 launches of each kernel a step, held-out PSNR >= 20 dB and
     within 1 dB); one 400x400 frame of the trained 8x384 hi_lo net
     served by RenderService (2 launches a tile, equal to a direct render,
     the fp32 module path's frame at the serving bar); one stacked call
     of two 8x512 nets against two single-scene launches, bit for bit.
 17. the fused MLP kernels on the deep nets the JAX package runs through
     Pallas ("deep"): the forward and the backward's three kernels at
     32x256, 54x256, 43x256 hi_lo, 26x384, 36x320, 177x128, 509x64,
     866x16 and 600x16 hi_lo (CLI shapes; random weights, the trunk's
     scaled by 0.7, and random biases, so that the activations stay
     alive), at the train fine call's 131,072 points, against their plain
     versions at phase 16's bars layer by layer (phase 1's every matrix
     from its own stored operands, the forward's output from the heads
     on phase 1's activations, on the call's first chunk; phase 2 and the
     reduction as before; the end-to-end distances, which grow with
     depth, printed beside), repeat runs bit-identical, timed beside
     their bounds and the module path, and a differentiated call of each
     through fused_nerf_mlp with its launches counted; the train CLI at
     --netdepth 32 for 300 steps, through the kernels and with
     --no_kernel (2 launches of each kernel a step, held-out PSNRs within
     1 dB); one stacked call of two 32x256 nets against two single-scene
     launches, bit for bit.
 18. the fused MLP kernels on the shallow wide nets the JAX package runs
     through Pallas ("shallow"): the forward and the backward's three
     kernels at 1x1696, 2x1312 and 5x864 in bf16, 1x1472, 3x960 and 5x752
     in hi_lo and 2x1024 (CLI shapes, random weights as initialised;
     forward tiles of 32 and 16 points, phase-1 tiles of 32 and 16, passes
     of 128 columns at 1x1472 hi_lo), at the train fine call's 131,072
     points, against their plain versions at phase 16's bars (each alone
     and the backward whole, the hi_lo bf16 control above its bar),
     repeat runs bit-identical, timed beside their bounds and the module
     path, and a differentiated call of each through fused_nerf_mlp with
     its launches counted; the train CLI at --netdepth 2 --netwidth 1024
     for 300 steps, through the kernels and with --no_kernel (2 launches
     of each kernel a step, held-out PSNR >= 20 dB and within 1 dB); one
     stacked call of two 2x1024 nets against two single-scene launches,
     bit for bit.
Then it prints the kernels' JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Weights are random, from a seed.
It exits non-zero, printing no result, without a CUDA device.
``--only multi_scene`` runs the build, phase 5 and phase 11 alone;
``--only interchange`` the build, phases 5 and 6 and phase 12;
``--only parallel`` the build, phase 5 and phase 13;
``--only jpeg`` the build and phase 14;
``--only finish`` the build, phases 5, 6 and 7 and phase 15;
``--only wide`` the build and phase 16;
``--only deep`` the build and phase 17;
``--only shallow`` the build and phase 18.
Plain versions are timed once: their times are no yardstick.
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


# The redesigned kernels' SASS, per kernel function: wgmma (HGMMA) and
# bulk copies (UBLKCP, or TMA's UTMALDG) in every instantiation, and the
# waits for retired wgmma (WARPGROUP.DEPBAR: one an HGMMA where ptxas
# serialized them), read from the built libraries by phase_build.
SASS_KERNELS = {"fused_mlp_fwd": "fused_mlp_fwd_kernel",
                "fused_mlp_bwd_phase1": "bwd_phase1_kernel"}
SASS = {}


def sass_counts(lib, function):
    """{instantiation: (HGMMA, bulk copies, WARPGROUP.DEPBAR)} of the
    kernel functions whose name holds ``function`` in the library ``lib``,
    from cuobjdump -sass."""
    from nerfmlp_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if function in name:
            counts[name] = (part.count("HGMMA"),
                            part.count("UBLKCP") + part.count("UTMALDG"),
                            part.count("WARPGROUP.DEPBAR"))
    return counts


def phase_build():
    from nerfmlp_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s "
          f"-> {_build.build_dir()}")
    serialized = []
    for name, path in paths.items():
        with open(path + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "C752" in line:
                    print(f"[build] {name}: {line.strip()}")
                if "C7520" in line:
                    serialized.append(name)
    # ptxas's note C7520: it serialized every wgmma of a kernel (a branch
    # it cannot prove warpgroup-uniform touches the accumulators).
    if serialized:
        raise SystemExit(f"[build] wgmma serialized by ptxas (C7520) in "
                         f"{sorted(set(serialized))}")
    # Each redesigned kernel computes with wgmma and fills its ring with
    # bulk copies, in every instantiation, or the script fails.
    for key, function in SASS_KERNELS.items():
        counts = sass_counts(paths[key.replace("_phase1", "")], function)
        if not counts or min(min(c[:2]) for c in counts.values()) == 0:
            raise SystemExit(f"[build] {function}: an instantiation without "
                             f"wgmma or bulk copies in its SASS: {counts}")
        SASS[key] = {"hgmma": sum(c[0] for c in counts.values()),
                     "bulk_copies": sum(c[1] for c in counts.values()),
                     "wgmma_waits": sum(c[2] for c in counts.values()),
                     "instantiations": len(counts)}
        print(f"[build] {function}: {SASS[key]['instantiations']} "
              f"instantiations, {SASS[key]['hgmma']} HGMMA, "
              f"{SASS[key]['bulk_copies']} bulk copies (UBLKCP / UTMALDG) "
              f"and {SASS[key]['wgmma_waits']} WARPGROUP.DEPBAR in their "
              f"SASS")


def annotate(kernels):
    """Each redesigned kernel's record (the forward and phase 1) with its
    SASS counts and its layout: the record's own where its check gave one,
    else the flagship 8x256 net's (bf16, or hi_lo where the name says)."""
    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops import fused_mlp

    flagship = {}
    for rec in kernels:
        key = next((k for k in SASS_KERNELS if rec["name"].startswith(k)),
                   None)
        if key is None:
            continue
        rec["sass"] = SASS[key]
        if rec.get("layout") is None:
            hi_lo = "hi_lo" in rec["name"]
            if hi_lo not in flagship:
                cfg = slice_config()
                net = init_model(cfg.model_config(), seed=SEED, device="cuda")
                flagship[hi_lo] = fused_mlp.kernel_layouts(
                    fused_mlp.pack_params(net, cfg.pos_enc_L, True, hi_lo))
            rec["layout"] = flagship[hi_lo][
                "fwd" if key == "fused_mlp_fwd" else "phase1"]
    return kernels


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


def check_kernel(net, cfg, pts, dirs, label, time_it, hi_lo=False,
                 iters=10, plain_iters=1, held=True):
    """Kernel vs plain on the same inputs; returns a result record.
    ``hi_lo``: fp32_precision="high", three bf16 products per matmul. With
    ``time_it`` the module path that use_kernel=False takes for the same
    call (encoding + the nn.Linear net, bf16; fp32 for hi_lo) is timed
    too, as the kernel's yardstick: no single PyTorch call computes this
    function. ``iters`` / ``plain_iters``: timed runs of the kernel (and
    the module path, half as many) / of the plain version. ``held=False``
    (a deep net, held layer by layer instead): the distance is printed,
    not held to the bar."""
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
           "layout": fused_mlp.kernel_layouts(packed)["fwd"],
           "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS,
                                 nbytes / PEAK_MEM_BYTES),
           "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                        >= nbytes / PEAK_MEM_BYTES else "bytes")}
    if time_it:
        with torch.no_grad():
            for key, spin in (("ms", True), ("ms_no_spin", False)):
                rec[key] = cuda_ms(lambda: fused_mlp.fused_nerf_mlp(
                    packed, pts, dirs, cfg), iters=iters, spin=spin)
        rec["plain_ms"] = cuda_ms(plain, iters=plain_iters,
                                  warmup=plain_iters - 1)
        dt = torch.float32 if hi_lo else torch.bfloat16
        with torch.no_grad():
            rec["module_ms"] = cuda_ms(lambda: net(
                positional_encoding(pts, cfg.pos_enc_L), dirs,
                compute_dtype=dt).float(), iters=max(1, iters // 2))
        rec["tflops"] = flops / rec["ms"] / 1e9
    print(f"[kernel] {label}: n={n} max|err|={err:.3e} "
          f"normalised={norm:.3e} (tol {tol})"
          + (f" kernel {rec['ms']:.3f} ms ({rec['tflops']:.1f} TFLOP/s; "
             f"{rec['ms_no_spin']:.3f} ms without the spin) plain "
             f"{rec['plain_ms']:.3f} ms, module path (use_kernel=False, "
             f"{'fp32' if hi_lo else 'bf16'}) {rec['module_ms']:.3f} ms"
             if time_it else "")
          + f" bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})"
          + ("" if held else " (end to end: printed, not held)"))
    if held and not norm <= tol:
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
                  f"{lay.rows}-point tiles in clusters of {lay.cluster}, "
                  f"{lay.stages} weight stages of {lay.kr} rows, {lay.smem} B "
                  f"shared memory, fits={kernel_fits(mc, True, hi_lo)}")
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


def check_backward(net, cfg, pts, dirs, label, time_it, hi_lo=False,
                   iters=10, plain_iters=1, phase_rows=None):
    """The backward (both phases + reduction) vs the plain backward on the
    same inputs and a cotangent from a seeded loss, per parameter (max
    |err| / max |plain|); a repeat run must give the same bits. In hi_lo
    mode the bf16 kernels' gradients are held against the same hi_lo
    reference as a control, which must land above the bar: the bar then
    tells hi_lo from bf16. With ``time_it``, each kernel is also held
    against its own plain version and timed (check_phases), and the whole
    backward is timed with and without the spin; ``phase_rows`` (a deep
    net): each kernel alone on the first that many points (a chunk of the
    call, as the backward runs its phases), phase 1 held matrix by matrix
    to one plain step from its own operands (check_phases' ``forced``),
    else on all. Returns (the whole backward's record, the kernels'
    records or None)."""
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
                packed, pts, dirs, g), iters=iters, spin=spin)
        rec["plain_ms"] = cuda_ms(plain, iters=plain_iters,
                                  warmup=plain_iters - 1)
        rec["tflops"] = flops / rec["ms"] / 1e9
        m = n if phase_rows is None else min(n, phase_rows)
        phases = check_phases(net, packed, pts[:m],
                              None if dirs is None else dirs[:m], g[:m],
                              label, iters, plain_iters,
                              forced=phase_rows is not None)
        rec["floor_ms"] = sum(r["bound_ms"] for r in phases.values())
    print(f"[backward] {label}: n={n} max|err|={err:.3e} "
          f"normalised={norm:.3e} ({leaf}; tol {tol}"
          + ("" if phase_rows is None else "; end to end: printed, not held,"
             " the kernels held alone")
          + "), repeat bit-identical"
          + (f" kernels {rec['ms']:.3f} ms ({rec['tflops']:.1f} TFLOP/s; "
             f"{rec['ms_no_spin']:.3f} ms without the spin) plain "
             f"{rec['plain_ms']:.3f} ms; design floor {rec['floor_ms']:.3f} "
             f"ms" if time_it else "")
          + f" bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    if phase_rows is None and not norm <= tol:
        raise SystemExit(f"[backward] {label}: kernels disagree with plain")
    if control is not None and not control > tol:
        raise SystemExit(f"[backward] {label}: the bar does not tell hi_lo "
                         f"from bf16")
    return rec, phases


class _Stored:
    """Phase 1's workspace ``ws`` of n points read as the plain version's
    operands: ``planes(name, cols)`` a matrix's bf16 planes in fp32 (hi,
    and lo in hi_lo mode); ``dot(a, w)`` planes times a weight the plain
    version's way (hi@hi + hi@lo + lo@hi in hi_lo); ``rnd`` its rounding
    to the compute type."""

    def __init__(self, packed, ws, n):
        self.packed, self.ws, self.n = packed, ws, n
        self.at = {name: m for m, (name, _, _) in enumerate(packed.ws_mats)}

    def planes(self, name, cols):
        from nerfmlp_torch.ops import fused_mlp as fm

        return list(fm.ws_matrix(self.packed, self.ws, self.at[name])
                    [:, :self.n, :cols].float())

    def split(self, t):
        import torch

        from nerfmlp_torch.ops import fused_mlp as fm

        return (list(fm._split_bf16(t)) if self.packed.hi_lo
                else [t.to(torch.bfloat16).float()])

    def dot(self, a, w):
        w = self.split(w.float())
        out = a[0] @ w[0]
        return out + a[0] @ w[1] + a[1] @ w[0] if self.packed.hi_lo else out

    def rnd(self, t):
        import torch

        return t if self.packed.hi_lo else t.to(torch.bfloat16).float()


def phase1_forced(packed, ws, pts, dirs, g):
    """Each matrix of phase 1's workspace ``ws`` (a net with the view head)
    recomputed by one step of the plain version's arithmetic from the
    kernel's own stored operands: the layer below's activation (the layer
    above's cotangent, and the stored activation's ReLU mask, down the dX
    chain), in its (hi, lo) planes in hi_lo mode. Yields (name, fp32 (n,
    real columns)) in the workspace's order. Held against the workspace
    it checks every operation of the program at any depth, where the
    plain version run end to end (bwd_workspace_plain) carries each
    earlier summation-order difference and ReLU flip down the chain."""
    import torch

    from nerfmlp_torch.ops import fused_mlp as fm
    from nerfmlp_torch.ops.encoding import positional_encoding

    net, mc = packed.net, packed.net.cfg
    enc, bott_ch = mc.input_ch, mc.bottleneck_ch
    st = _Stored(packed, ws, pts.shape[0])
    stored, dot, rnd = st.planes, st.dot, st.rnd

    def masked(planes, t):   # the stored activation's ReLU mask
        return rnd(torch.where(sum(planes) > 0, t, torch.zeros_like(t)))

    x = stored("x", enc)
    n_freqs = int(packed.bwd_program[fm._BWD_HEADER.index("n_freqs")])
    yield "x", rnd(positional_encoding(pts.float(), n_freqs))
    yield "d", rnd(dirs.float())
    for i, lin in enumerate(net.pts_linears):
        a = x if i == 0 else stored(f"h{i - 1}", mc.width)
        w = lin.weight.t()
        acc = (dot(x, w[:enc]) + dot(a, w[enc:]) if i in mc.skips
               else dot(a, w))
        yield f"h{i}", rnd(torch.relu(acc + lin.bias.float()))
    h_last = stored(f"h{mc.depth - 1}", mc.width)
    yield "bott", rnd(dot(h_last, net.bottleneck_linear.weight.t())
                      + net.bottleneck_linear.bias.float())
    wv = net.view_linear.weight.t()
    yield "v", rnd(torch.relu(
        dot(stored("bott", bott_ch), wv[:bott_ch])
        + dot(stored("d", mc.input_ch_views), wv[bott_ch:])
        + net.view_linear.bias.float()))
    yield "g_rgb", rnd(g[:, :3].float())
    yield "g_sigma", rnd(g[:, 3:4].float())
    yield "dv", masked(stored("v", mc.view_width),
                       dot(stored("g_rgb", 3), net.rgb_linear.weight))
    yield "dbott", rnd(dot(stored("dv", mc.view_width),
                           net.view_linear.weight[:, :bott_ch]))
    yield f"dacc{mc.depth - 1}", masked(h_last, dot(
        stored("dbott", bott_ch), net.bottleneck_linear.weight)
        + dot(stored("g_sigma", 1), net.sigma_linear.weight))
    for i in range(mc.depth - 1, 0, -1):
        w = net.pts_linears[i].weight
        yield f"dacc{i - 1}", masked(
            stored(f"h{i - 1}", mc.width),
            dot(stored(f"dacc{i}", mc.width),
                w[:, enc:] if i in mc.skips else w))


def heads_forced(packed, ws, n):
    """The forward's (n, 4) output from the plain version's output heads
    on the last trunk activation and the view activation that phase 1
    stored for the same points: the forward kernel and phase 1's
    recomputed forward run the same arithmetic, so their hidden
    activations are the same bits, and this holds the forward at any depth
    to one layer of summation order."""
    import torch

    net, mc = packed.net, packed.net.cfg
    st = _Stored(packed, ws, n)
    rgb = (st.dot(st.planes("v", mc.view_width), net.rgb_linear.weight.t())
           + net.rgb_linear.bias.float())
    sigma = (st.dot(st.planes(f"h{mc.depth - 1}", mc.width),
                    net.sigma_linear.weight.t())
             + net.sigma_linear.bias.float())
    return torch.cat([rgb, sigma], -1)


def check_phases(net, packed, pts, dirs, g, label, iters=10,
                 plain_iters=1, forced=False):
    """Each kernel of the backward alone, against its plain version on the
    same inputs, and timed: phase 1's workspace (per matrix, relative L2
    over the n rows; ``forced``: against phase1_forced, each matrix from
    the kernel's own operands, the end-to-end plain version's distance
    printed beside it), phase 2's partials on that workspace, the
    reduction of those partials (bit-identical; beside part.sum(0), the
    library call for the same function). Returns {"phase1", "phase2",
    "reduce"} records, each with its bound from this run's shapes."""
    import torch

    from nerfmlp_torch.ops import fused_mlp as fm

    n = pts.shape[0]
    rows = fm.ws_rows(n, packed.bwd_rows)
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
    del want_ws
    free = None
    if forced:
        free, err1, worst = worst, 0.0, (0.0, "")
        with torch.no_grad():
            for m, (name, t) in enumerate(phase1_forced(packed, ws, pts,
                                                        dirs, g)):
                if name != packed.ws_mats[m][0]:
                    raise SystemExit(f"[backward] {label}: phase 1's "
                                     f"matrices out of order at {name}")
                a = fm.ws_matrix(packed, ws, m)[0, :n, :t.shape[1]].float()
                b = t.to(torch.bfloat16).float()
                err1 = max(err1, float((a - b).abs().max()))
                worst = max(worst, (float((a - b).norm()
                                          / b.norm().clamp_min(1e-30)), name))
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
    warm = plain_iters - 1
    recs = {
        "phase1": {"max_abs_err": err1, "rel_l2": worst[0],
                   "rel_l2_end_to_end": free and free[0],
                   "layout": fm.kernel_layouts(packed)["phase1"],
                   "ms": cuda_ms(lambda: fm.bwd_workspace(
                       packed, pts, dirs, g, ws), iters=iters),
                   "plain_ms": cuda_ms(lambda: fm.bwd_workspace_plain(
                       packed, pts, dirs, g, rows), iters=plain_iters,
                       warmup=warm)},
        "phase2": {"max_abs_err": err2, "norm_err": norm2,
                   "ms": cuda_ms(lambda: fm.weight_grads(
                       packed, ws, rows, split_rows, part), iters=iters),
                   "plain_ms": cuda_ms(lambda: fm.weight_grads_plain(
                       packed, ws, rows, split_rows), iters=plain_iters,
                       warmup=warm)},
        "reduce": {"max_abs_err": err3,
                   "ms": cuda_ms(lambda: fm.reduce_partials(part, total),
                                 iters=iters),
                   "plain_ms": cuda_ms(lambda: fm.reduce_partials_plain(
                       part, total), iters=plain_iters, warmup=warm),
                   "library_ms": cuda_ms(lambda: part[:, :total].sum(0),
                                         iters=iters)},
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
          f"{PHASE1_TOL}"
          + (f"; each matrix from the kernel's own operands, the plain "
             f"version end to end {free[0]:.3e} ({free[1]})" if forced
             else "")
          + f") kernel {r1['ms']:.3f} ms plain {r1['plain_ms']:.3f} "
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


def write_llff_scene(root):
    """Phase 8's forward capture (LLFF_VIEWS views of LLFF_WH) under a fresh
    ``root`` (no auto-resume of a rerun), as a pre-minified images_8/:
    the scene's directory."""
    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, "scene")
    make_synthetic_llff_scene(scene, n_images=LLFF_VIEWS, img_wh=LLFF_WH,
                              style="forward", seed=SEED)
    os.rename(os.path.join(scene, "images"), os.path.join(scene, "images_8"))
    print(f"[llff] forward-facing scene {LLFF_WH[0]}x{LLFF_WH[1]}, "
          f"{LLFF_VIEWS} views as a pre-minified images_8/, in "
          f"{time.perf_counter() - t0:.1f} s")
    return scene


def fern_argv(scene, save_dir, extra=()):
    """The train CLI on configs/fern.txt as it is; on the command line only
    what the scene and the time limit force: the data and save dirs, the
    steps, the interval of the videos (8 frames) and of a quick validation
    (the loss is read there)."""
    return ["--config", os.path.join(ROOT, "configs", "fern.txt"),
            "--datadir", scene, "--save_dir", save_dir,
            "--iters", str(LLFF_STEPS), "--i_video", str(LLFF_EVENT),
            "--video_frames", str(INF_FRAMES), "--quick_val_interval",
            str(LLFF_EVENT)] + list(extra)


def phase_llff(net):
    """Forward-facing (LLFF, NDC) and DeepVoxels scenes as a user runs them
    (the module docstring, phase 8). Returns the llff path's records: its
    forward launches, the kernel records at its shapes and the train CLI
    run's backward launches, and the kernel run's held-out PSNR."""
    import numpy as np

    from nerfmlp_torch.data.llff import LLFFDataset
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
    scene = write_llff_scene(root)
    runs = {}
    for name, extra in (("kernel", []), ("plain", ["--no_kernel"])):
        runs[name] = train_cli_run(
            f"llff {name}", fern_argv(scene, os.path.join(root, name), extra),
            LLFF_STEPS)
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
            "fwd_train": fwd_train, "bwd": bwd, "phases": phases,
            "psnr": final}


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
    kernels' launches per step, counted from the trace. A collective's
    kernels (NCCL's, under data parallelism) spin while they wait for the
    other ranks, and other kernels may run beside them: their time is kept
    apart (``comm``), and the idle share is of the time no other kernel
    runs."""
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
    rows = device_rows(prof)
    comm = sum(ms for name, ms in rows if "nccl" in name.lower())
    busy = sum(ms for _, ms in rows) - comm
    per_step = tuple(n / w for n, _ in kernel_trace(prof))
    return {"ms": ms, "wall": wall, "busy": busy, "comm": comm,
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


def mesh_extract(params, cfg, g, thr, tag, card, mesh=None):
    """extract_mesh at ``g``^3 (over the devices ``mesh``, where given), its
    stages timed (synchronised) and its forward launches counted; returns
    (mesh, {stage: s}, launches of the density and the colour bake)."""
    from nerfmlp_torch.ops import mesh as mesh_mod

    with Timed(mesh_mod, "density_volume") as dens, \
            Timed(mesh_mod, "_active_cells") as comp, \
            Timed(mesh_mod, "_tet_stage") as tets, \
            Timed(mesh_mod, "_weld_and_orient") as weld, \
            Timed(mesh_mod, "vertex_colors") as bake:
        t0 = time.perf_counter()
        m = mesh_mod.extract_mesh(params, cfg, resolution=g, threshold=thr,
                                  density_chunk=MESH_CHUNK, mesh=mesh)
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


def stack_inputs(n_samples, cfg, scenes=MS_SCENES):
    """``scenes`` scenes' points (the serving pose's central rays, each
    scene's shifted by 0.03 * s) and encoded dirs, scene-major: (pts,
    dirs, points a scene)."""
    import torch

    pts, dirs = serving_points(n_samples, cfg, n_rays=TRAIN_RAYS)
    n_s = pts.shape[0]
    pts = torch.cat([pts + 0.03 * s for s in range(scenes)])
    dirs = dirs.repeat(scenes, 1)
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


def check_stack(nets, cfg, n_samples, label, card, hi_lo=False,
                tag="multi_scene", forced=False):
    """The four kernels over a scene axis at one call of the multi-scene
    step (S = len(nets) x points of 1024 rays x ``n_samples``): the
    stacked launch against S single-scene launches of the same work, bit
    for bit, and against the stacked plain version at the single-scene
    bars; timed beside the single-scene launches, the plain version and
    (forward) the use_kernel=False module path; each with its bound at S x
    n_s points (``forced``, deep nets: phase 1 held matrix by matrix to
    phase1_forced on each scene's single-scene workspace). Returns {"fwd",
    "phase1", "phase2", "reduce", "bwd"} records."""
    import torch

    from nerfmlp_torch.ops import fused_mlp as fm
    from nerfmlp_torch.ops.encoding import positional_encoding

    if hi_lo:
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  fp32_precision="high")
    dt = torch.float32 if hi_lo else torch.bfloat16
    vdirs = True
    scenes = len(nets)
    pts, dirs, n_s = stack_inputs(n_samples, cfg, scenes)
    n = pts.shape[0]
    stack = fm.pack_params_stack(nets, cfg.pos_enc_L, vdirs, hi_lo)
    solos = [fm.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo) for net in nets]
    sl = [slice(s * n_s, (s + 1) * n_s) for s in range(scenes)]
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
    print(f"[{tag}] {label} forward, {scenes} x {n_s} points: one "
          f"launch bit-equal to {scenes} single-scene launches: {same}; "
          f"max|err| {err:.3e} normalised {norm:.3e} (tol {tol}); kernel "
          f"{r['ms']:.3f} ms, {scenes} single-scene launches "
          f"{r['solo_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, module path "
          f"{r['module_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}) [{card}]")
    if not (same and norm <= tol):
        raise SystemExit(f"[{tag}] {label}: the stacked forward "
                         "disagrees")

    # Phase 1, phase 2 and the reduction, each alone.
    rows_s = fm.ws_rows(n_s, stack.bwd_rows)
    ws = torch.empty(scenes * rows_s * stack.ws_cols, device="cuda",
                     dtype=torch.bfloat16)
    fm.bwd_workspace(stack, pts, dirs, g, ws)
    ws1 = [torch.empty(rows_s * stack.ws_cols, device="cuda",
                       dtype=torch.bfloat16) for _ in nets]
    for p, a, d, gg, w in zip(solos, sp, sd, sg, ws1):
        fm.bwd_workspace(p, a, d, gg, w)
    same1 = all(torch.equal(
        fm.ws_matrix(stack, ws, m)[:, s * rows_s:(s + 1) * rows_s],
        fm.ws_matrix(solos[s], ws1[s], m))
        for s in range(scenes) for m in range(len(stack.ws_mats)))
    want_ws = fm.bwd_workspace_plain(stack, pts, dirs, g, scenes * rows_s)
    rel1 = 0.0
    err1 = 0.0
    for m in range(len(stack.ws_mats)):
        a = fm.ws_matrix(stack, ws, m)[0].float()
        b = fm.ws_matrix(stack, want_ws, m)[0].float()
        err1 = max(err1, float((a - b).abs().max()))
        rel1 = max(rel1, float((a - b).norm() / b.norm().clamp_min(1e-30)))
    del want_ws
    free1 = rel1
    if forced:
        rel1 = 0.0
        with torch.no_grad():
            for p, w, a_, d, gg in zip(solos, ws1, sp, sd, sg):
                for m, (name, t) in enumerate(phase1_forced(p, w, a_, d, gg)):
                    a = fm.ws_matrix(p, w, m)[0, :n_s, :t.shape[1]].float()
                    b = t.to(torch.bfloat16).float()
                    rel1 = max(rel1, float((a - b).norm()
                                           / b.norm().clamp_min(1e-30)))
    splits, split_rows = fm.bwd_splits(rows_s)
    total = stack.grad_total
    part = torch.empty((scenes, splits, fm.part_stride(total)),
                       device="cuda")
    fm.weight_grads(stack, ws, rows_s, split_rows, part)
    part1 = [torch.empty((splits, fm.part_stride(total)), device="cuda")
             for _ in nets]
    for p, w, q in zip(solos, ws1, part1):
        fm.weight_grads(p, w, rows_s, split_rows, q)
    same2 = all(torch.equal(part[s, :, :total], part1[s][:, :total])
                for s in range(scenes))   # past total: padding
    want_part = fm.weight_grads_plain(stack, ws, rows_s, split_rows)
    err2 = float((part[..., :total] - want_part[..., :total]).abs().max())
    norm2 = err2 / float(want_part[..., :total].abs().max())
    del want_part
    red = fm.reduce_partials(part, total)
    same3 = all(torch.equal(red[s], fm.reduce_partials(part1[s], total))
                for s in range(scenes))
    err3 = float((red - fm.reduce_partials_plain(part, total)).abs().max())
    torch.cuda.synchronize()
    ws_bytes = scenes * rows_s * stack.ws_cols * 2
    p1_macs = phase1_macs(nets[0], vdirs)
    recs["phase1"] = {
        "max_abs_err": err1, "rel_l2": rel1,
        "ms": cuda_ms(lambda: fm.bwd_workspace(stack, pts, dirs, g, ws),
                      iters=10),
        "solo_ms": cuda_ms(lambda: [fm.bwd_workspace(p, a, d, gg, w) for
                                    p, a, d, gg, w in
                                    zip(solos, sp, sd, sg, ws1)], iters=5),
        "plain_ms": cuda_ms(lambda: fm.bwd_workspace_plain(
            stack, pts, dirs, g, scenes * rows_s), iters=2, warmup=1)}
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
             ws_bytes + scenes * splits * total * 4),
            ("reduce", 0.0, scenes * (splits + 1) * total * 4)):
        recs[key]["bound_ms"], recs[key]["bound_by"] = bound(flops, nbytes)
        recs[key].setdefault("library_ms", None)
    del ws, ws1
    r1, r2, r3 = recs["phase1"], recs["phase2"], recs["reduce"]
    print(f"[{tag}] {label} phase 1 ({ws_bytes} B workspace): "
          f"bit-equal to single-scene launches: {same1}; rel-L2 {rel1:.3e} "
          f"(tol {PHASE1_TOL}"
          + (f"; each matrix from its own operands, the plain version end "
             f"to end {free1:.3e}" if forced else "")
          + f"); kernel {r1['ms']:.3f} ms, single-scene "
          f"{r1['solo_ms']:.3f} ms, plain {r1['plain_ms']:.3f} ms; bound "
          f"{r1['bound_ms']:.3f} ms ({r1['bound_by']}) [{card}]")
    print(f"[{tag}] {label} phase 2 ({len(stack.bwd_jobs)} jobs x "
          f"{splits} splits x {scenes} scenes): bit-equal: {same2}; "
          f"normalised {norm2:.3e} (tol {PHASE2_TOL}); kernel "
          f"{r2['ms']:.3f} ms, single-scene {r2['solo_ms']:.3f} ms, plain "
          f"{r2['plain_ms']:.3f} ms; bound {r2['bound_ms']:.3f} ms "
          f"({r2['bound_by']}) [{card}]")
    print(f"[{tag}] {label} reduction ({scenes} x {splits} slots): "
          f"bit-equal: {same3}; max|err| vs plain {err3:.3e}; kernel "
          f"{r3['ms']:.4f} ms, single-scene {r3['solo_ms']:.4f} ms, plain "
          f"{r3['plain_ms']:.4f} ms, part.sum(1) {r3['library_ms']:.4f} ms; "
          f"bound {r3['bound_ms']:.4f} ms ({r3['bound_by']}) [{card}]")
    if not (same1 and same2 and same3 and rel1 <= PHASE1_TOL
            and norm2 <= PHASE2_TOL and err3 == 0.0):
        raise SystemExit(f"[{tag}] {label}: a backward kernel over the "
                         "scene axis disagrees")

    # The backward whole: bit-equal to single-scene backwards, repeatable,
    # at the single-scene bar from the stacked plain backward (hi_lo: the
    # bf16 kernels as the control, above the bar).
    flat = fm._launch_bwd(stack, pts, dirs, g)
    again = fm._launch_bwd(stack, pts, dirs, g)
    one = [fm._launch_bwd(p, a, d, gg) for p, a, d, gg in
           zip(solos, sp, sd, sg)]
    same = torch.equal(flat, again) and all(torch.equal(flat[s], one[s])
                                            for s in range(scenes))
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
    print(f"[{tag}] {label} backward whole: bit-equal to "
          f"{scenes} single-scene backwards and repeatable: {same}; "
          f"normalised {bwd_norm:.3e} (tol {btol})"
          + (f", control (bf16 kernels) {control:.3e}" if hi_lo else "")
          + f"; {rb['ms']:.3f} ms vs {rb['solo_ms']:.3f} ms single-scene; "
          f"design floor {rb['floor_ms']:.3f} ms [{card}]")
    if not (same and bwd_norm <= btol
            and (control is None or control > btol)):
        raise SystemExit(f"[{tag}] {label}: the stacked backward "
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


# --------------------------------------------------------------------- #
# Phase 13: data parallelism ("parallel")
# --------------------------------------------------------------------- #
PAR_RANKS = 2             # gloo ranks on the one card
PAR_RAYS = TRAIN_RAYS // PAR_RANKS   # each rank's rays of a step
PAR_STEPS = 100           # the Trainer runs held against each other
PAR_PSNR_GAP = 0.5        # held-out PSNR, 2 ranks vs 1, dB
PAR_WINDOW = 16           # steps of a timed and of a profiled window
PAR_CLI_STEPS = 50        # the train CLI's steps at --n_devices 1
PAR_TIMEOUT_S = 300       # a collective waiting longer fails the phase


def par_configs(near, far, k=1):
    """Phase 5's flagship recipe, PAR_STEPS steps, K = ``k``."""
    rc, tc = train_configs(near, far)
    return rc, dataclasses.replace(tc, iters=PAR_STEPS, log_interval=0,
                                   steps_per_dispatch=k)


def par_timing(mesh, rc, tc, scene):
    """A fresh Trainer (of ``mesh``'s rank, or this process's) timed at
    its K: phase 9's step_timing over windows of PAR_WINDOW steps (ms per
    step synchronised, a profiled window's idle share), and the median
    time of one all-reduce (mean) of the step's flat gradient buffer
    (every parameter and the two losses, fp32). Returns this rank's
    numbers, or every rank's (rows in rank order) under a mesh."""
    import torch

    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.parallel.mesh import all_gather_rows, all_reduce_mean_
    from nerfmlp_torch.train.loop import Trainer

    from torch.profiler import ProfilerActivity, profile

    ds = BlenderDataset(scene, "train", img_wh=(TRAIN_WH, TRAIN_WH))
    tr = Trainer(rc, tc, ds, save_dir=os.path.join(SMOKE_DIR, "parallel",
                                                   "timing"),
                 verbose=False, device="cuda" if mesh is None else None,
                 mesh=mesh)
    tr.pool.ensure_epoch(0)
    # A spawned rank's first profile starts the tracer (seconds): not in
    # the profiled window.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tr.step_fn(tr.state, tr.pool.batch(tr.state.step))
        torch.cuda.synchronize()
    t = step_timing(tr, PAR_WINDOW, graph=tr.windows is not None)
    n = sum(p.numel() for p in tr.state.optimizer.params) + 2
    ar = None
    if mesh is not None:
        buf = torch.zeros(n, device=mesh.device)
        times = []
        for i in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_mean_(buf, mesh)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(1e3 * (time.perf_counter() - t0))
        ar = statistics.median(times)
    row = torch.tensor([[t["ms"], t["idle"], t["wall"], t["busy"],
                         t["comm"], -1.0 if ar is None else ar, float(n)]],
                       dtype=torch.float64, device=tr.device)
    if mesh is not None:
        row = all_gather_rows(row, mesh)
    cols = ("ms", "idle", "wall", "busy", "comm", "allreduce_ms", "floats")
    return [dict(zip(cols, r)) for r in row.cpu().tolist()], t["per_step"]


def par_rank(mesh, rc, tc, scene, save_dir, batch):
    """One gloo rank of phase 13: the first step on a global batch (its
    averaged gradient), PAR_STEPS steps through the Trainer, the timing."""
    from nerfmlp_torch.parallel import checks

    first = checks.dp_steps(mesh, rc, tc, [batch])
    run = checks.dp_trainer(mesh, rc, tc, scene, (TRAIN_WH, TRAIN_WH),
                            save_dir)
    timing = par_timing(mesh, rc, tc, scene)
    return {"first": {k: first[k] for k in ("grads0", "loss",
                                            "ranks_bit_equal")},
            "run": run, "timing": timing}


def par_cards_rank(mesh, rc, tc, scene, save_dir, batch):
    """One NCCL rank of phase 13 over every card: par_rank's checks, then
    the timing at K = GRAPH_K too."""
    out = par_rank(mesh, rc, tc, scene, save_dir, batch)
    out["timing_graph"] = par_timing(
        mesh, rc, dataclasses.replace(tc, steps_per_dispatch=GRAPH_K), scene)
    return out


def par_nccl_rank(mesh, rc, tc, scene, root):
    """The NCCL rank of phase 13: the Trainer at K = 1 and at K = GRAPH_K
    (the all-reduce captured in the CUDA graph), each timed."""
    from nerfmlp_torch.parallel import checks

    out = {}
    for k in (1, GRAPH_K):
        tck = dataclasses.replace(tc, steps_per_dispatch=k)
        out[k] = {"run": checks.dp_trainer(
            mesh, rc, tck, scene, (TRAIN_WH, TRAIN_WH),
            os.path.join(root, f"nccl_k{k}")),
                  "timing": par_timing(mesh, rc, tck, scene)}
    return out


def par_grad_err(got, want):
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def phase_parallel(train_run, card):
    """Data parallelism (the module docstring, phase 13). Returns the
    records of path parallel."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nerfmlp_torch.data.pipeline import RayBatchLoader
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.parallel import checks
    from nerfmlp_torch.parallel.mesh import launch
    from nerfmlp_torch.parallel.render_parallel import render_image_sharded
    from nerfmlp_torch.render_path import rays_for_pose_device
    from nerfmlp_torch.serve import RenderService
    from nerfmlp_torch.train.checkpoint import load_params_any, save_params

    t0 = time.perf_counter()
    root = os.path.join(SMOKE_DIR, "parallel")
    shutil.rmtree(root, ignore_errors=True)     # no auto-resume of a rerun
    os.makedirs(root)
    scene = os.path.join(SMOKE_DIR, "scene")
    trainer = train_run["trainer"]
    rc, tc = par_configs(trainer.rc.near, trainer.rc.far)
    batch = RayBatchLoader.from_dataset(trainer.train_ds, TRAIN_RAYS,
                                        seed=SEED).next_batch()
    n_dev = torch.cuda.device_count()
    print(f"[parallel] visible cards: {n_dev}")

    # -- two gloo ranks on the one card, against one process -----------
    one_first = checks.dp_steps(None, rc, tc, [batch], device="cuda")
    one = checks.dp_trainer(None, rc, tc, scene, (TRAIN_WH, TRAIN_WH),
                            os.path.join(root, "one"), device="cuda")
    t1 = time.perf_counter()
    two = launch(par_rank, PAR_RANKS,
                 args=(rc, tc, scene, os.path.join(root, "two"), batch),
                 device="cuda", backend="gloo", timeout_s=PAR_TIMEOUT_S)
    t_two = time.perf_counter() - t1
    gerr = par_grad_err(two["first"]["grads0"], one_first["grads0"])
    run = two["run"]
    psnr1, psnr2 = one["after"]["psnr"], run["after"]["psnr"]
    want = [2 * PAR_STEPS] * 4
    print(f"[parallel] {PAR_RANKS} gloo ranks on {min(PAR_RANKS, n_dev)} "
          f"card(s), {PAR_RAYS} rays "
          f"a rank of a {TRAIN_RAYS}-ray batch: the first step's averaged "
          f"gradient vs one rank's on the same rays, max|diff| / max|g| "
          f"{gerr:.3e} (bar {KERNEL_TOL}); its loss "
          f"{two['first']['loss'][0]:.6f} vs {one_first['loss'][0]:.6f}")
    print(f"[parallel] {PAR_STEPS} steps through the Trainer: held-out PSNR "
          f"{psnr2:.2f} dB on {PAR_RANKS} ranks vs {psnr1:.2f} dB on one "
          f"(gap bar {PAR_PSNR_GAP}); parameters bit-equal across ranks "
          f"{run['ranks_bit_equal'] and two['first']['ranks_bit_equal']}; "
          f"launches in the steps per rank {run['step_launches']} (want "
          f"{want}); files written per rank {run['writes']}; spawn + run "
          f"{t_two:.1f} s")
    if not (gerr <= KERNEL_TOL and abs(psnr2 - psnr1) <= PAR_PSNR_GAP
            and np.isfinite(psnr2) and run["ranks_bit_equal"]
            and two["first"]["ranks_bit_equal"]
            and all(r == want for r in run["step_launches"])
            and run["writes"][0] > 0 and not any(run["writes"][1:])):
        raise SystemExit("[parallel] the gloo ranks failed their checks")
    for rank, t in enumerate(two["timing"][0]):
        print(f"[parallel] gloo rank {rank}: {t['ms']:.2f} ms per step "
              f"synchronised ({PAR_RAYS / t['ms'] * 1e3:.0f} rays/s a rank); "
              f"a profiled window of {PAR_WINDOW} steps: wall {t['wall']:.2f}"
              f" ms, device busy {t['busy']:.2f} ms, idle {t['idle']:.1f}%; "
              f"all-reduce (through the host) of the {int(t['floats'])}-float "
              f"gradient buffer "
              f"({4 * t['floats'] / 1e6:.2f} MB) {t['allreduce_ms']:.3f} ms "
              f"[{card}]")

    # -- one NCCL rank at K = 1 and K = GRAPH_K, beside one process -----
    t1 = time.perf_counter()
    nccl = launch(par_nccl_rank, 1, args=(rc, tc, scene, root),
                  device="cuda", backend="nccl", timeout_s=PAR_TIMEOUT_S)
    t_nccl = time.perf_counter() - t1
    same = np.array_equal(nccl[1]["run"]["params"],
                          nccl[GRAPH_K]["run"]["params"])
    local = {k: par_timing(None, *par_configs(trainer.rc.near,
                                              trainer.rc.far, k), scene)
             for k in (1, GRAPH_K)}
    for k in (1, GRAPH_K):
        t, t_in = nccl[k]["timing"][0][0], local[k][0][0]
        print(f"[parallel] one NCCL rank, K = {k}: {t['ms']:.2f} ms per step"
              f" synchronised, idle {t['idle']:.1f}%, NCCL kernels "
              f"{t['comm']:.2f} ms a window (all-reduce "
              f"{t['allreduce_ms']:.3f} ms); the in-process Trainer "
              f"{t_in['ms']:.2f} ms, idle {t_in['idle']:.1f}%; launches per "
              f"replayed step {nccl[k]['timing'][1]} [{card}]")
    print(f"[parallel] NCCL rank: K = {GRAPH_K} parameters bit-equal to K = "
          f"1's after {PAR_STEPS} steps {same}; held-out PSNR "
          f"{nccl[1]['run']['after']['psnr']:.2f} / "
          f"{nccl[GRAPH_K]['run']['after']['psnr']:.2f} dB; {t_nccl:.1f} s")
    if not (same and nccl[1]["run"]["step_launches"][0] == want
            and np.isfinite(nccl[1]["run"]["after"]["psnr"])):
        raise SystemExit("[parallel] the NCCL rank failed its checks")

    # -- NCCL over every card, where there is more than one ------------
    if n_dev > 1:
        multi = launch(par_cards_rank, n_dev,
                       args=(rc, tc, scene, os.path.join(root, "cards"),
                             batch),
                       device="cuda", backend="nccl",
                       timeout_s=PAR_TIMEOUT_S)
        merr = par_grad_err(multi["first"]["grads0"], one_first["grads0"])
        mrun = multi["run"]
        print(f"[parallel] NCCL over {n_dev} cards, {TRAIN_RAYS // n_dev} "
              f"rays a card: the first step's averaged gradient vs one "
              f"rank's {merr:.3e}; {PAR_STEPS} steps: held-out PSNR "
              f"{mrun['after']['psnr']:.2f} dB vs {psnr1:.2f}; parameters "
              f"bit-equal across ranks {mrun['ranks_bit_equal']}; launches "
              f"in the steps per rank {mrun['step_launches']}")
        for k, (rows, _) in ((1, multi["timing"]),
                             (GRAPH_K, multi["timing_graph"])):
            for rank, t in enumerate(rows):
                rate = TRAIN_RAYS / t["ms"] * 1e3
                print(f"[parallel] NCCL card {rank}, K = {k}: {t['ms']:.2f} "
                      f"ms per step synchronised ({rate:.0f} rays/s over the "
                      f"{n_dev} cards); a profiled window of "
                      f"{PAR_WINDOW} steps: wall {t['wall']:.2f} ms, compute "
                      f"busy {t['busy']:.2f} ms, NCCL kernels {t['comm']:.2f}"
                      f" ms, idle {t['idle']:.1f}%; all-reduce of the "
                      f"{4 * t['floats'] / 1e6:.2f} MB buffer "
                      f"{t['allreduce_ms']:.3f} ms [{card}]")
        if not (merr <= KERNEL_TOL and mrun["ranks_bit_equal"]
                and multi["first"]["ranks_bit_equal"]
                and abs(mrun["after"]["psnr"] - psnr1) <= PAR_PSNR_GAP
                and all(r == want for r in mrun["step_launches"])):
            raise SystemExit("[parallel] NCCL over the cards failed")
    else:
        print("[parallel] NCCL over every card: one visible card, not run "
              "(NCCL refuses two ranks on one GPU)")

    # -- a 400x400 frame over [cuda:0, cuda:0], dense and occupancy -----
    nets = {"coarse": trainer.state.params["coarse"]}
    cfg = slice_config()
    occ_cfg = dataclasses.replace(cfg, use_occupancy=True, aabb=OCC_AABB,
                                  N_samples=OCC_PROBE,
                                  N_importance=OCC_REFINE,
                                  occ_dense_samples=OCC_DENSE,
                                  occ_grid_size=OCC_GRID)
    from nerfmlp_torch.serve import grid_from_weights

    for tag, c, tile in (("dense", cfg, TILE), ("occupancy", occ_cfg,
                                                OCC_TILE)):
        params = prepare_params(nets, c)
        grid = grid_from_weights(params, c) if c.use_occupancy else None
        o, d, vd = rays_for_pose_device(pose_spherical(*SERVE_POSE), H, W,
                                        FOCAL, c, device="cuda")
        with torch.no_grad():
            want_f = render_image_maps(params, o, d, H, W, c, tile=tile,
                                       occ_grid=grid, viewdirs=vd)["rgb_map"]
            fused_mlp.fused_nerf_mlp.launches = 0
            got_f = render_image_sharded(params, o, d, H, W, c,
                                         ["cuda:0", "cuda:0"], tile=tile,
                                         occ_grid=grid,
                                         viewdirs=vd)["rgb_map"]
            launches = fused_mlp.fused_nerf_mlp.launches
        eq = torch.equal(got_f, want_f)
        print(f"[parallel] {W}x{H} {tag} frame over [cuda:0, cuda:0] "
              f"({tile} rays a device a tile): bit-equal to the local "
              f"renderer's {eq}, {launches} forward launches")
        if not (eq and launches > 0):
            raise SystemExit(f"[parallel] the sharded {tag} frame differs")

    # -- one served frame with sharding on (the default) -----------------
    ckpt = os.path.join(root, "flagship.pt")
    save_params(ckpt, nets)
    flags = ["--focal", str(FOCAL), "--img_wh", str(W), str(H)]
    frame_on, l_on = serve_frame(flags, ckpt)
    frame_off, l_off = serve_frame(flags + ["--no_shard_render"], ckpt)
    svc_args = dict(H=H, W=W, focal=FOCAL, device="cuda",
                    log=lambda *a: None)
    loaded = load_params_any(ckpt, cfg.model_config(), device="cuda")
    svc2 = RenderService(loaded, cfg, devices=["cuda:0", "cuda:0"],
                         **svc_args)
    pose = pose_spherical(*SERVE_POSE)
    f2 = svc2.render_pose(pose)["rgb_map"]
    e2 = np.abs(f2 - frame_off)
    print(f"[parallel] served frame, serve CLI with sharding on ({n_dev} "
          f"card(s); one: the local renderer) bit-equal to "
          f"--no_shard_render's "
          f"{np.array_equal(frame_on, frame_off)} ({l_on} / {l_off} forward "
          f"launches); RenderService over [cuda:0, cuda:0] ({TILE // 2} "
          f"rays a device a tile) vs it: max|err| {e2.max():.3e}, p99.9 "
          f"{np.percentile(e2, 99.9):.3e}, bit-equal "
          f"{np.array_equal(f2, frame_off)}")
    if not (np.array_equal(frame_on, frame_off) and l_on > 0 and l_off > 0
            and np.percentile(e2, 99.9) <= FRAME_TOL
            and e2.max() <= FRAME_MAX):
        raise SystemExit("[parallel] the served frames differ")

    # -- the train CLI with --n_devices 1: in this process, as before ---
    argv = ["--datadir", scene, "--img_wh", str(TRAIN_WH), str(TRAIN_WH),
            "--white_bkgd", "--N_samples", str(cfg.N_samples),
            "--N_importance", str(cfg.N_importance), "--batch_size",
            str(TRAIN_RAYS), "--iters", str(PAR_CLI_STEPS),
            "--quick_val_interval", str(PAR_CLI_STEPS), "--quick_val_res",
            str(TRAIN_WH), str(TRAIN_WH), "--quick_val_subset", "1",
            "--full_val_interval", "0", "--i_weights", "0"]
    cli = {}
    # With one visible card the default (every card) is one rank too; with
    # more it spawns ranks, which the NCCL branch above covers.
    runs = [("n1", ["--n_devices", "1"])] + ([("default", [])]
                                             if n_dev == 1 else [])
    for name, extra in runs:
        _, launches, step_fwd, _, tr = train_cli_run(
            f"parallel cli {name}",
            argv + extra + ["--save_dir", os.path.join(root, "cli_" + name)],
            PAR_CLI_STEPS)
        cli[name] = ([p.detach().clone() for p in
                      tr.state.optimizer.params], step_fwd, launches)
    same_cli = all(torch.equal(a, b) for a, b in zip(
        cli["n1"][0], cli.get("default", cli["n1"])[0]))
    print(f"[parallel] train CLI --n_devices 1: in this process (process "
          f"group started: {dist.is_initialized()}), parameters bit-equal "
          f"to the run without the flag {same_cli}"
          + ("" if n_dev == 1 else " (not run: it spawns a rank a card)")
          + f", step launches {cli['n1'][1]} (want {2 * PAR_CLI_STEPS})")
    if not (same_cli and not dist.is_initialized()
            and cli["n1"][1] == 2 * PAR_CLI_STEPS):
        raise SystemExit("[parallel] --n_devices 1 changed the CLI's run")

    # -- the kernels at a rank's shapes -----------------------------------
    net = nets["coarse"]
    recs = []
    fwd = [check_kernel(net, cfg, *serving_points(n, cfg, n_rays=PAR_RAYS),
                        f"parallel rank {what} call", time_it=True)
           for what, n in (("fine", cfg.N_importance),
                           ("coarse", cfg.N_samples))]
    _, phases = check_backward(net, cfg, *serving_points(
        cfg.N_importance, cfg, n_rays=PAR_RAYS), "parallel rank fine call",
        time_it=True)
    launches = run["step_launches"][0]
    base = {"path": "parallel", "route": "cuda"}
    r = fwd[0]
    recs.append({**base, "name": "fused_mlp_fwd_parallel",
                 "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
                 "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
                 "launches": launches[0],
                 "max_abs_err": max(x["max_abs_err"] for x in fwd),
                 "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "module_ms": r["module_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": None})
    for key, name, replaces, i in (
            ("phase1", "fused_mlp_bwd_phase1", "pallas_mlp.py:312", 1),
            ("phase2", "fused_mlp_bwd_phase2", "pallas_mlp.py:386", 2),
            ("reduce", "fused_mlp_bwd_reduce", "pallas_mlp.py:327", 3)):
        r = phases[key]
        recs.append({**base, "name": name + "_parallel",
                     "source": "nerfmlp_torch/csrc/fused_mlp_bwd.cu",
                     "replaces": "nerfmlp_tpu/ops/" + replaces,
                     "launches": launches[i], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(f"[parallel] phase took {time.perf_counter() - t0:.1f} s")
    return recs


# --------------------------------------------------------------------- #
# Phase 14: JPEG captures and the Trainer's extras ("jpeg")
# --------------------------------------------------------------------- #
JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")   # the fixtures
JPEG_FACTOR = 4           # 384x288 JPEG images/ -> 96x72, phase 8's size
JPEG_CAPTURE_WH = (384, 288)
JPEG_TRACED = 20          # steps 10-29 in the --profile_dir trace: 2
#                           launches of each kernel a step (coarse, fine)


def jpeg_decode_rate(repeats=3):
    """Seconds per megapixel of the port's JPEG decoder on this host: the
    committed capture's twelve 384x288 views, the best of ``repeats``
    passes. Runs anywhere (no card): ``python -c "import chip_smoke;
    print(chip_smoke.jpeg_decode_rate())"``."""
    sys.path.insert(0, ROOT)
    from nerfmlp_torch.utils.jpeg import read_jpeg

    images = os.path.join(JPEG_DIR, "capture", "images")
    paths = [os.path.join(images, n) for n in sorted(os.listdir(images))]
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        pixels = 0
        for p in paths:
            px = read_jpeg(p)
            pixels += px.shape[0] * px.shape[1]
        best = min(best, (time.perf_counter() - t0) / (pixels / 1e6))
    return best


def check_jpeg_fixtures(card):
    """Every committed JPEG against the Pillow decode stored with it: the
    sha256 of its RGB pixels (max |err| 0 levels) and, for the decoder
    cases, their PNG; the decode rate printed beside the card."""
    import hashlib

    import numpy as np

    from nerfmlp_torch.utils.image import read_png
    from nerfmlp_torch.utils.jpeg import read_jpeg

    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    bad = []
    for name, want in sorted(manifest.items()):
        px = read_jpeg(os.path.join(JPEG_DIR, name))
        if px.shape[2] == 1:
            px = np.repeat(px, 3, axis=2)
        same = (list(px.shape) == want["shape"] and hashlib.sha256(
            px.tobytes()).hexdigest() == want["sha256"])
        if name.startswith("cases/"):
            same = same and np.array_equal(px, read_png(os.path.join(
                JPEG_DIR, name[:-4] + ".png")))
        if not same:
            bad.append(name)
    rate = jpeg_decode_rate()
    print(f"[jpeg] {len(manifest)} committed JPEGs decoded, {len(bad)} "
          f"departing from their Pillow decodes {bad}; decoder "
          f"{rate:.3f} s per megapixel on this host (the capture's 12 "
          f"views, best of 3) | {card}")
    if bad:
        raise SystemExit("[jpeg] the decoder departs from Pillow's pixels")
    return rate


def image_dirs_psnr(a, b):
    """Mean PSNR (dB, 8-bit pixels) between the images of two directories,
    paired in sorted order."""
    import numpy as np

    from nerfmlp_torch.utils.image import read_rgb

    out = []
    for x, y in zip(sorted(os.listdir(a)), sorted(os.listdir(b))):
        d = (read_rgb(os.path.join(a, x)).astype(np.float64)
             - read_rgb(os.path.join(b, y))) / 255.0
        out.append(-10.0 * np.log10(max(float(np.mean(d * d)), 1e-10)))
    return float(np.mean(out))


def trace_file_kernels(path):
    """(launches, device ms in all) of each of the four kernels in an
    exported Chrome trace, by kernel_trace's rule (kernel events whose name
    holds the kernel's)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = [[0, 0.0] for _ in KERNEL_NAMES]
    for e in events:
        if e.get("cat") == "kernel":
            for f, kernel in zip(found, KERNEL_NAMES):
                if kernel in e.get("name", ""):
                    f[0] += 1
                    f[1] += e.get("dur", 0.0) / 1e3
    return tuple((n, ms) for n, ms in found)


def phase_jpeg(png_psnr, card):
    """JPEG captures and the Trainer's extras (the module docstring, phase
    14). ``png_psnr``: phase 8's PNG run's held-out PSNR, printed beside
    this phase's (None: not run). Returns four records (path ``jpeg``):
    the run's launches, device ms per launch from its --profile_dir trace,
    the kernels held on the run's net as the trace closed."""
    import copy
    import importlib.util

    from nerfmlp_torch.data.llff import LLFFDataset
    from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene
    from nerfmlp_torch.scripts import train as train_cli
    from nerfmlp_torch.train import loop

    t0 = time.perf_counter()
    check_jpeg_fixtures(card)
    root = os.path.join(SMOKE_DIR, "jpeg")
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, "scene")
    shutil.copytree(os.path.join(JPEG_DIR, "capture"), scene)
    prof = os.path.join(root, "prof")
    flags = ["--factor", str(JPEG_FACTOR), "--profile_dir", prof]
    # The same capture as PNG: the JPEG run is held against it, since
    # phase 8's 96x72 renders are point-sampled where the minified 384x288
    # views are area-averaged (they lie ~33 dB apart, the q90 JPEGs ~50 dB
    # from their PNGs).
    twin = os.path.join(root, "png_twin")
    make_synthetic_llff_scene(twin, n_images=LLFF_VIEWS,
                              img_wh=JPEG_CAPTURE_WH, style="forward",
                              seed=SEED, device="cuda")
    twin_psnr = train_cli_run("jpeg png twin", fern_argv(
        twin, os.path.join(root, "png_run"), ["--factor", str(JPEG_FACTOR)]),
        LLFF_STEPS)[0]["final_val"]["psnr"]

    # The net as the trace closes (steps 10-29), for the kernel checks.
    window = {}
    stop = loop.Trainer._stop_trace

    def keep_net(self, *a):
        window["net"] = copy.deepcopy(self.state.params["coarse"])
        window["path"] = stop(self, *a)
        return window["path"]

    loop.Trainer._stop_trace = keep_net
    try:
        metrics, launches, step_fwd, wall, trainer = train_cli_run(
            "jpeg checked", fern_argv(scene, os.path.join(root, "checked"),
                                      flags + ["--check_numerics"]),
            LLFF_STEPS)
    finally:
        loop.Trainer._stop_trace = stop
    fdir = os.path.join(scene, f"images_{JPEG_FACTOR}")
    minified = sorted(os.listdir(fdir))
    final = metrics["final_val"]["psnr"]
    # How far apart the image sets lie: the minified JPEGs from the
    # minified PNGs, and phase 8's point-sampled 96x72 renders from the
    # minified ones.
    point = os.path.join(root, "point_sampled")
    make_synthetic_llff_scene(point, n_images=LLFF_VIEWS, img_wh=LLFF_WH,
                              style="forward", seed=SEED, device="cuda")
    twin_min = os.path.join(twin, f"images_{JPEG_FACTOR}")
    print(f"[jpeg] minified views, mean PSNR between the sets: the JPEGs' vs "
          f"the PNGs' {image_dirs_psnr(fdir, twin_min):.2f} dB; phase 8's "
          f"point-sampled renders vs the PNGs' "
          f"{image_dirs_psnr(os.path.join(point, 'images'), twin_min):.2f} dB")
    traced = trace_file_kernels(window["path"])
    print(f"[jpeg] fern from JPEG images/ at --factor {JPEG_FACTOR}: "
          f"{len(minified)} PNGs in images_{JPEG_FACTOR}/, trained at "
          f"{metrics['config']['full_val_res']}; held-out PSNR {final:.2f} dB "
          f"vs the same capture as PNG {twin_psnr:.2f} dB (gap "
          f"{abs(final - twin_psnr):.2f}, limit {PSNR_GAP}; floor "
          f"{PSNR_MIN}); phase 8's point-sampled 96x72 PNG run "
          + ("not run" if png_psnr is None else f"{png_psnr:.2f} dB")
          + f"; trace {os.path.basename(window['path'])}: "
          f"{[n for n, _ in traced]} launches (want "
          f"{2 * JPEG_TRACED} each) | {card}")
    want = 2 * LLFF_STEPS
    if not (len(minified) == LLFF_VIEWS
            and all(n.endswith(".png") for n in minified)
            and metrics["config"]["full_val_res"] == list(LLFF_WH)
            and final >= PSNR_MIN and abs(final - twin_psnr) <= PSNR_GAP
            and step_fwd == want and launches[1:] == [want] * 3
            and all(n == 2 * JPEG_TRACED for n, _ in traced)):
        raise SystemExit("[jpeg] the JPEG capture's run failed its checks")

    # The kernels on the net of the traced window, at the run's call.
    ds = LLFFDataset(scene, "train", img_wh=LLFF_WH, factor=JPEG_FACTOR)
    kcfg = dataclasses.replace(slice_config(), N_importance=LLFF_SAMPLES,
                               near=0.0, far=1.0, ndc=True, white_bkgd=False)
    pts, dirs = ndc_points(kcfg, ds.render_poses(n_frames=INF_FRAMES)[0],
                          (ds.H, ds.W, ds.focal), TRAIN_RAYS, LLFF_SAMPLES)
    label = "jpeg run's net at step 29, train call"
    fwd = check_kernel(window["net"], kcfg, pts, dirs, label, time_it=True)
    _, phases = check_backward(window["net"], kcfg, pts, dirs, label,
                               time_it=True)

    # The same run without --check_numerics: the checks' cost.
    _, _, _, plain_wall, _ = train_cli_run(
        "jpeg unchecked", fern_argv(scene, os.path.join(root, "unchecked"),
                                    flags), LLFF_STEPS)
    print(f"[jpeg] train CLI step time (train() less its renders): "
          f"--check_numerics {1e3 * wall / LLFF_STEPS:.2f} ms, without "
          f"{1e3 * plain_wall / LLFF_STEPS:.2f} ms | {card}")

    # --tensorboard: refused by name where the package does not import,
    # else its event file written.
    has_tb = importlib.util.find_spec("tensorboard") is not None
    tb_dir = os.path.join(root, "tb")
    try:
        train_cli.main(fern_argv(scene, tb_dir, ["--factor", str(JPEG_FACTOR),
                                                 "--tensorboard", "--iters",
                                                 "1"]))
        refused = None
    except SystemExit as e:
        refused = str(e)
    events = glob.glob(os.path.join(tb_dir, "tb", "events.out.tfevents.*"))
    print(f"[jpeg] --tensorboard with the tensorboard package "
          f"{'present' if has_tb else 'absent'}: "
          + (f"refused: {refused}" if refused else
             f"accepted, {len(events)} event file(s) written"))
    if (has_tb and (refused or not events)) or (not has_tb and not (
            refused and "--tensorboard" in refused)):
        raise SystemExit("[jpeg] --tensorboard was neither refused by name "
                         "nor written")

    recs = []
    for (n, ms), (name, source, replaces), r, i in zip(
            traced,
            (("fused_mlp_fwd", "fused_mlp_fwd.cu", "pallas_mlp.py:264"),
             ("fused_mlp_bwd_phase1", "fused_mlp_bwd.cu", "pallas_mlp.py:312"),
             ("fused_mlp_bwd_phase2", "fused_mlp_bwd.cu", "pallas_mlp.py:386"),
             ("fused_mlp_bwd_reduce", "fused_mlp_bwd.cu",
              "pallas_mlp.py:327")),
            (fwd, phases["phase1"], phases["phase2"], phases["reduce"]),
            range(4)):
        rec = {"name": name + "_jpeg", "path": "jpeg", "route": "cuda",
               "source": "nerfmlp_torch/csrc/" + source,
               "replaces": "nerfmlp_tpu/ops/" + replaces,
               "launches": launches[i], "max_abs_err": r["max_abs_err"],
               "ms": ms / n, "kernel_call_ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        if "module_ms" in r:
            rec["module_ms"] = r["module_ms"]
        if "layout" in r:
            rec["layout"] = r["layout"]
        recs.append(rec)
        print(f"[jpeg] {name}: {launches[i]} launches in the run, "
              f"{n} in the trace at {ms / n:.4f} ms each (device), "
              f"{r['ms']:.4f} ms timed alone; plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | {card}")
    print(f"[jpeg] phase took {time.perf_counter() - t0:.1f} s")
    return recs


# --------------------------------------------------------------------- #
# Phase 15: the rest of the JAX package ("finish")
# --------------------------------------------------------------------- #
TP_RANKS = 2              # tensor parallelism: one model group of two
TP_SHARD_ROWS = 128       # ... so pts_linears.0's shard: 256 / 2 rows
TP_LOSS_RTOL = 1e-5       # the first step against one process's
TP_GRAD_TOL = 1e-5        # ... its gradient, of the largest element, with
#                           the MLP in fp64: in fp32 the weight gradients'
#                           sums over 196,608 points take another cuBLAS
#                           order at the shards' shapes (2.4e-5 measured)
TP_PARAM_ATOL = 5e-3      # ... its parameters (tests/test_parallel.py:
#                           248-252: Adam's first update is ~lr sign(g))
TP_PSNR_GAP = 0.5         # held-out PSNR after PAR_STEPS steps, dB


def tp_configs(near, far):
    """Phase 5's flagship recipe in fp32, PAR_STEPS steps: the module path
    (a TP step runs no kernel; the Trainer turns them off itself). The
    first step is held at this recipe; the PAR_STEPS-step runs take half
    its samples a ray (32 + 64), on both sides (``tp_run_config``)."""
    rc, tc = par_configs(near, far)
    return dataclasses.replace(rc, compute_dtype="float32"), tc


def tp_run_config(rc):
    """The recipe of phase 15's PAR_STEPS-step runs, TP and one process:
    ``rc`` at half its samples a ray. Two gloo ranks sharing the card move
    every activation through the host: 3,339 ms a TP step at 64 + 128 on
    an H100 host where the whole script then took 1,339.3 s of its 1,200 s
    limit (TP 393.7 s)."""
    return dataclasses.replace(rc, N_samples=rc.N_samples // 2,
                               N_importance=rc.N_importance // 2)


def tp_rank(mesh, rc, tc, scene, save_dir, batch):
    """One rank of phase 15's TP runs: the first step on a global batch in
    fp32 and with the MLP in fp64, then PAR_STEPS steps through the TP
    Trainer (at ``tp_run_config(rc)``)."""
    from nerfmlp_torch.parallel import checks

    rc64 = dataclasses.replace(rc, compute_dtype="float64")
    return {"first": checks.dp_steps(mesh, rc, tc, [batch],
                                     tensor_parallel=TP_RANKS),
            "first64": checks.dp_steps(mesh, rc64, tc, [batch],
                                       tensor_parallel=TP_RANKS),
            "run": checks.dp_trainer(mesh, tp_run_config(rc), tc, scene,
                                     (TRAIN_WH, TRAIN_WH), save_dir,
                                     tensor_parallel=TP_RANKS)}


def grad_err(got, want):
    """max |got - want| over max |want|."""
    import numpy as np

    return float(np.abs(got - want).max() / np.abs(want).max())


def finish_tp(train_run, backend, card):
    """Tensor parallelism over TP_RANKS ranks (the module docstring, phase
    15): the first step and PAR_STEPS Trainer steps against one process."""
    from nerfmlp_torch.data.pipeline import RayBatchLoader
    from nerfmlp_torch.parallel import checks
    from nerfmlp_torch.parallel.mesh import launch

    import numpy as np

    root = os.path.join(SMOKE_DIR, "finish", "tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    scene = os.path.join(SMOKE_DIR, "scene")
    trainer = train_run["trainer"]
    rc, tc = tp_configs(trainer.rc.near, trainer.rc.far)
    batch = RayBatchLoader.from_dataset(trainer.train_ds, TRAIN_RAYS,
                                        seed=SEED).next_batch()
    rc64 = dataclasses.replace(rc, compute_dtype="float64")
    one_first = checks.dp_steps(None, rc, tc, [batch], device="cuda")
    one64 = checks.dp_steps(None, rc64, tc, [batch], device="cuda")
    one = checks.dp_trainer(None, tp_run_config(rc), tc, scene,
                            (TRAIN_WH, TRAIN_WH), os.path.join(root, "one"),
                            device="cuda")
    t1 = time.perf_counter()
    ranks = launch(tp_rank, TP_RANKS,
                   args=(rc, tc, scene, os.path.join(root, "tp"), batch),
                   device="cuda", backend=backend, timeout_s=PAR_TIMEOUT_S)
    t_tp = time.perf_counter() - t1
    tp_first, tp = ranks["first"], ranks["run"]
    loss_err = abs(tp_first["loss"][0] - one_first["loss"][0]) / abs(
        one_first["loss"][0])
    gerr = grad_err(ranks["first64"]["grads0"], one64["grads0"])
    gerr32 = grad_err(tp_first["grads0"], one_first["grads0"])
    perr = max(float(np.abs(tp_first["params"]["coarse"][k] - v).max())
               for k, v in one_first["params"]["coarse"].items())
    rows = tp_first["shard_shapes"]["pts_linears.0.weight"][0]
    psnr1, psnr2 = one["after"]["psnr"], tp["after"]["psnr"]
    zero = [[0] * 4] * TP_RANKS
    print(f"[finish] tensor parallelism, {TP_RANKS} {backend} ranks as "
          f"(data 1, model {TP_RANKS}), the flagship 8x256 fp32 net on the "
          f"module path, {TRAIN_RAYS} rays, {rc.N_samples} + "
          f"{rc.N_importance}: the first step's loss {tp_first['loss'][0]:.7f} "
          f"vs one process {one_first['loss'][0]:.7f} (rel {loss_err:.2e}, "
          f"limit {TP_LOSS_RTOL}), gradient {gerr:.2e} of its largest "
          f"element with the MLP in fp64 (limit {TP_GRAD_TOL}; in fp32 "
          f"{gerr32:.2e}, the one-process fp32 gradient's own distance from "
          f"fp64 {grad_err(one_first['grads0'], one64['grads0']):.2e}), "
          f"parameters max |diff| "
          f"{perr:.2e} (limit {TP_PARAM_ATOL}); pts_linears.0's shard "
          f"{tp_first['shard_shapes']['pts_linears.0.weight']}; held-out "
          f"PSNR after {PAR_STEPS} steps at "
          f"{tp_run_config(rc).N_samples} + "
          f"{tp_run_config(rc).N_importance} {psnr2:.2f} dB vs one process "
          f"{psnr1:.2f} (limit {TP_PSNR_GAP}); kernel launches in the TP "
          f"steps {tp_first['launches']} / in train() {tp['launches']}; "
          f"ranks' shards bit-equal {tp['ranks_bit_equal']} | {card}")
    print(f"[finish] TP step, host median: {tp['step_ms']:.2f} ms per step "
          f"a rank ({TP_RANKS} ranks, {backend}); the one-process module "
          f"path (fp32) {one['step_ms']:.2f} ms; the TP Trainer's run "
          f"{t_tp:.1f} s with its spawn | {card}")
    if not (loss_err <= TP_LOSS_RTOL and gerr <= TP_GRAD_TOL
            and perr <= TP_PARAM_ATOL and rows == TP_SHARD_ROWS
            and abs(psnr1 - psnr2) <= TP_PSNR_GAP
            and tp_first["launches"] == [0] * 4 and tp["launches"] == zero
            and tp["ranks_bit_equal"] and tp_first["ranks_bit_equal"]
            and ranks["first64"]["launches"] == [0] * 4):
        raise SystemExit("[finish] the tensor-parallel step failed its "
                         "checks")
    return {"step_ms": tp["step_ms"], "one_step_ms": one["step_ms"]}


def finish_mesh(turbo_ckpt, devices, card):
    """The turbo model's MESH_RES[-1]^3 mesh dealt over ``devices``,
    against one device. Returns the forward's record (path
    ``mesh_devices``)."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops import mesh as mesh_mod
    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.occupancy import _QUERY_DIR
    from nerfmlp_torch.parallel.render_parallel import replicate
    from nerfmlp_torch.train.checkpoint import load_params_any

    cfg = dataclasses.replace(turbo_configs(2.0, 6.0)[0], perturb=False)
    params = load_params_any(turbo_ckpt, cfg.model_config(), device="cuda")
    g = MESH_RES[-1]
    probe = mesh_mod.density_volume(params, cfg, resolution=MESH_RES[0])
    lo, hi = float(probe.min()), float(probe.max())
    thr = MESH_ISO if hi > MESH_ISO else 0.5 * (lo + hi)
    reps = replicate(params, cfg, devices)
    one, one_s, one_l = mesh_extract(params, cfg, g, thr, "one device", card)
    two, two_s, two_l = mesh_extract(params, cfg, g, thr,
                                     f"over {list(map(str, devices))}", card,
                                     mesh=reps)
    vol_one = mesh_mod.density_volume(params, cfg, resolution=g)
    vol_two = mesh_mod.density_volume(params, cfg, resolution=g, mesh=reps)
    same = {k: bool(np.array_equal(one[k], two[k]))
            for k in ("verts", "faces", "normals", "colors")}
    print(f"[finish] mesh over {len(devices)} devices: volume bit-equal "
          f"{bool(np.array_equal(vol_one, vol_two))}, {same}; forward "
          f"launches summed (density + colours) {two_l} vs one device "
          f"{one_l}; s per stage over the devices "
          + ", ".join(f"{k} {v:.3f}" for k, v in two_s.items())
          + f" (one device: density {one_s['density']:.3f}, colours "
          f"{one_s['colours']:.3f}) | {card}")
    if not (np.array_equal(vol_one, vol_two) and all(same.values())
            and len(two["faces"]) and tuple(two_l) == tuple(one_l)):
        raise SystemExit("[finish] the mesh over devices departs from one "
                         "device's")
    # The forward at the density chunk's shape on each distinct device.
    n = g ** 3
    s0 = (n // 2) // MESH_CHUNK * MESH_CHUNK
    recs = []
    for dev in dict.fromkeys(reps.devices):
        ids = torch.arange(s0, s0 + MESH_CHUNK, dtype=torch.int32, device=dev)
        ijk = torch.stack([ids // (g * g), (ids // g) % g, ids % g], -1)
        lo_t = torch.tensor(OCC_AABB[:3], device=dev)
        span = torch.tensor(OCC_AABB[3:], device=dev) - lo_t
        pts = (lo_t + (ijk.float() / (g - 1)) * span).contiguous()
        dirs = positional_encoding(
            torch.tensor(_QUERY_DIR, device=dev).expand(MESH_CHUNK, 3),
            cfg.dir_enc_L)
        with torch.cuda.device(dev):
            recs.append(check_kernel(
                reps.params[dev]["coarse"].net, cfg, pts, dirs,
                f"mesh density chunk on {dev}", time_it=True))
    rec = dict(recs[0], max_abs_err=max(r["max_abs_err"] for r in recs),
               launches=sum(two_l))
    return rec


def finish_progressive(jpeg_run, card):
    """The progressive capture: every committed progressive JPEG against
    its Pillow decode, the decode rate, and the train CLI on
    configs/fern.txt with --factor 4 on it. Returns the four kernels'
    records (path ``progressive``)."""
    import hashlib

    import numpy as np

    from nerfmlp_torch.data.llff import LLFFDataset
    from nerfmlp_torch.utils.jpeg import read_jpeg

    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    prog = []
    for name in sorted(manifest):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            if b"\xff\xc2" in f.read():
                prog.append(name)
    bad, pixels, t_dec = [], 0, 0.0
    for name in prog:
        t1 = time.perf_counter()
        px = read_jpeg(os.path.join(JPEG_DIR, name))
        t_dec += time.perf_counter() - t1
        pixels += px.shape[0] * px.shape[1]
        if px.shape[2] == 1:
            px = np.repeat(px, 3, axis=2)
        if hashlib.sha256(px.tobytes()).hexdigest() != \
                manifest[name]["sha256"]:
            bad.append(name)
    views = [n for n in prog if n.startswith("capture_progressive/")]
    same = all(np.array_equal(
        read_jpeg(os.path.join(JPEG_DIR, n)),
        read_jpeg(os.path.join(JPEG_DIR, n.replace("capture_progressive",
                                                    "capture"))))
        for n in views)
    print(f"[finish] {len(prog)} committed progressive JPEGs decoded, "
          f"{len(bad)} departing from their Pillow decodes {bad}; "
          f"{t_dec / (pixels / 1e6):.3f} s per megapixel on this host; the "
          f"{len(views)} capture views' pixels equal the baseline capture's: "
          f"{same} | {card}")
    if bad or not same or len(views) != LLFF_VIEWS:
        raise SystemExit("[finish] a progressive JPEG departs from Pillow's "
                         "pixels")
    root = os.path.join(SMOKE_DIR, "finish", "progressive")
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, "scene")
    shutil.copytree(os.path.join(JPEG_DIR, "capture_progressive"), scene)
    metrics, launches, step_fwd, wall, trainer = train_cli_run(
        "finish progressive", fern_argv(scene, os.path.join(root, "run"),
                                        ["--factor", str(JPEG_FACTOR)]),
        LLFF_STEPS)
    final = metrics["final_val"]["psnr"]
    want = 2 * LLFF_STEPS
    print(f"[finish] fern from progressive JPEG images/ at --factor "
          f"{JPEG_FACTOR}: held-out PSNR {final:.2f} dB; phase 14's baseline "
          f"JPEG run without --check_numerics "
          + ("not run" if jpeg_run is None else f"{jpeg_run:.2f} dB")
          + f" (the same pixels); step launches {step_fwd} forward, "
          f"{launches[1:]} backward (want {want} each) | {card}")
    if not (final >= PSNR_MIN and step_fwd == want
            and launches[1:] == [want] * 3
            and (jpeg_run is None or abs(final - jpeg_run) <= PSNR_GAP)):
        raise SystemExit("[finish] the progressive capture's run failed its "
                         "checks")
    ds = LLFFDataset(scene, "train", img_wh=LLFF_WH, factor=JPEG_FACTOR)
    kcfg = dataclasses.replace(slice_config(), N_importance=LLFF_SAMPLES,
                               near=0.0, far=1.0, ndc=True, white_bkgd=False)
    pts, dirs = ndc_points(kcfg, ds.render_poses(n_frames=INF_FRAMES)[0],
                          (ds.H, ds.W, ds.focal), TRAIN_RAYS, LLFF_SAMPLES)
    net = trainer.state.params["coarse"]
    label = "progressive run's net, train call"
    fwd = check_kernel(net, kcfg, pts, dirs, label, time_it=True)
    _, phases = check_backward(net, kcfg, pts, dirs, label, time_it=True)
    recs = []
    for (name, source, replaces), r, n in zip(
            (("fused_mlp_fwd", "fused_mlp_fwd.cu", "pallas_mlp.py:264"),
             ("fused_mlp_bwd_phase1", "fused_mlp_bwd.cu", "pallas_mlp.py:312"),
             ("fused_mlp_bwd_phase2", "fused_mlp_bwd.cu", "pallas_mlp.py:386"),
             ("fused_mlp_bwd_reduce", "fused_mlp_bwd.cu",
              "pallas_mlp.py:327")),
            (fwd, phases["phase1"], phases["phase2"], phases["reduce"]),
            launches):
        rec = {"name": name + "_progressive", "path": "progressive",
               "route": "cuda", "source": "nerfmlp_torch/csrc/" + source,
               "replaces": "nerfmlp_tpu/ops/" + replaces, "launches": n,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        if "module_ms" in r:
            rec["module_ms"] = r["module_ms"]
        if "layout" in r:
            rec["layout"] = r["layout"]
        recs.append(rec)
    return recs


def finish_tools(run, gt, card):
    """The plotting and status tools on phase 7's train CLI run directory
    ``run``: its three end-of-run figures, view_progress, make_timelapse
    and side_by_side_compare (its last held-out frame beside ``gt``)."""
    from nerfmlp_torch.scripts import (
        make_timelapse, side_by_side_compare, view_progress,
    )
    from nerfmlp_torch.utils.image import read_png

    shapes = {}
    for name in ("training_report.png", "convergence_plot.png",
                 "comprehensive_metrics.png"):
        shapes[name] = read_png(os.path.join(run, name)).shape
    with open(os.path.join(run, "metrics_latest.json")) as f:
        step = json.load(f)["step"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_view = view_progress.main(["--metrics-dir", run])
    shown = f"step:                {step:,}" in buf.getvalue()
    frames = sorted(n for n in os.listdir(run) if n.startswith("val_")
                    and n.endswith(".png"))
    out = os.path.join(SMOKE_DIR, "finish", "timelapse")
    with contextlib.redirect_stdout(io.StringIO()):
        gif = make_timelapse.main(["--run_dir", run, "--out", out])
    gw, gh, n_frames, _ = gif_info(gif)
    rendered = os.path.join(run, frames[-1])
    sbs = os.path.join(SMOKE_DIR, "finish", "side_by_side.png")
    with contextlib.redirect_stdout(io.StringIO()):
        side_by_side_compare.main([rendered, sbs, "--gt", gt])
    h, w = read_png(rendered).shape[:2]
    got = read_png(sbs).shape
    print(f"[finish] tools on phase 7's run: figures {shapes}; "
          f"view_progress exit {rc_view}, step {step:,} shown {shown}; "
          f"make_timelapse {n_frames} frames of {gw}x{gh} for {len(frames)} "
          f"val_*.png; side_by_side_compare {got[1]}x{got[0]} from a "
          f"{w}x{h} render | {card}")
    if not (rc_view == 0 and shown and frames and n_frames == len(frames)
            and got[:2] == (h, 2 * w)
            and all(len(v) == 3 and v[2] == 3 for v in shapes.values())):
        raise SystemExit("[finish] a tool failed its checks")


def phase_finish(train_run, turbo_ckpt, card):
    """The rest of the JAX package (the module docstring, phase 15).
    Returns the records of paths mesh_devices and progressive."""
    import torch

    t0 = time.perf_counter()
    n_dev = torch.cuda.device_count()
    backend = "nccl" if n_dev >= TP_RANKS else "gloo"
    devices = ([f"cuda:{i}" for i in range(TP_RANKS)] if n_dev >= TP_RANKS
               else ["cuda:0"] * TP_RANKS)
    print(f"[finish] visible cards: {n_dev}: TP over {backend}, the mesh "
          f"over {devices}")
    inference = os.path.join(SMOKE_DIR, "inference")
    finish_tools(os.path.join(inference, "run"),
                 os.path.join(inference, "scene", "val", "r_0.png"), card)
    t1 = time.perf_counter()
    mesh_rec = finish_mesh(turbo_ckpt, devices, card)
    t_mesh = time.perf_counter() - t1
    unchecked = os.path.join(SMOKE_DIR, "jpeg", "unchecked",
                             "comprehensive_metrics.json")
    jpeg_run = None
    if os.path.exists(unchecked):
        with open(unchecked) as f:
            jpeg_run = json.load(f)["final_val"]["psnr"]
    t1 = time.perf_counter()
    prog = finish_progressive(jpeg_run, card)
    t_prog = time.perf_counter() - t1
    t1 = time.perf_counter()
    finish_tp(train_run, backend, card)
    t_tp = time.perf_counter() - t1
    print(f"[finish] phase took {time.perf_counter() - t0:.1f} s (TP "
          f"{t_tp:.1f}, mesh {t_mesh:.1f}, progressive {t_prog:.1f})")
    rec = {"name": "fused_mlp_fwd_mesh_devices", "path": "mesh_devices",
           "route": "cuda", "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
           "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
           "launches": mesh_rec["launches"],
           "max_abs_err": mesh_rec["max_abs_err"], "ms": mesh_rec["ms"],
           "plain_ms": mesh_rec["plain_ms"],
           "module_ms": mesh_rec["module_ms"],
           "bound_ms": mesh_rec["bound_ms"],
           "bound_by": mesh_rec["bound_by"], "library_ms": None}
    return [rec] + prog


# --------------------------------------------------------------------- #
# Phase 16: the fused MLP kernels at every width the JAX package runs
# them ("wide")
# --------------------------------------------------------------------- #
WIDE_BF16 = (288, 384, 512, 640)   # depth 8, bf16: 128 / 64 / 64 / 32 points
#                                    a phase-1 tile
WIDE_HI_LO = (384, 512, 576)       # depth 8, hi_lo: 32-point tiles
WIDE_TRAIN = 512                   # --netwidth of the flagship recipe's run
WIDE_HI_LO_TRAIN = 384             # ... and of the fp32 'high' run, which
WIDE_HI_LO_STEPS = 100             # takes this many steps
WIDE_SCENES = 2                    # the stacked call's scenes, at 8x512


def module_bwd_ms(net, cfg, pts, dirs, hi_lo, iters):
    """Milliseconds of autograd's backward through the nn.Linear net (the
    module path's backward, bf16 or fp32 as the mode) on the same call."""
    import torch

    from nerfmlp_torch.ops.encoding import positional_encoding

    dt = torch.float32 if hi_lo else torch.bfloat16
    params = list(net.parameters())
    out = net(positional_encoding(pts, cfg.pos_enc_L), dirs, compute_dtype=dt)
    g = torch.ones_like(out)
    return cuda_ms(lambda: torch.autograd.grad(out, params, g,
                                               retain_graph=True),
                   iters=iters)


def call_launches(net, pts, dirs, cfg):
    """The launches of each of the four kernels in one differentiated call
    through fused_nerf_mlp (the train step's entry), the counts set to 0
    just before; every gradient must be finite."""
    import torch

    from nerfmlp_torch.ops import fused_mlp

    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    (fused_mlp.fused_nerf_mlp(net, pts, dirs, cfg) ** 2).mean().backward()
    torch.cuda.synchronize()
    if not all(torch.isfinite(p.grad).all() for p in net.parameters()):
        raise SystemExit("a differentiated call gave a gradient that is "
                         "not finite")
    return [c.launches for c in counters]


def times_line(c):
    """A net's check {"fwd", "bwd", "phase1", "phase2", "reduce"}: each
    time beside its bound, the plain version and the module path."""
    fwd, bwd = c["fwd"], c["bwd"]
    return (f"forward {fwd['ms']:.3f} ms (bound {fwd['bound_ms']:.3f}, plain "
            f"{fwd['plain_ms']:.3f}, module path {fwd['module_ms']:.3f}); "
            f"backward {bwd['ms']:.3f} ms (bound {bwd['bound_ms']:.3f}, plain "
            f"{bwd['plain_ms']:.3f}, autograd through the module "
            f"{bwd['module_bwd_ms']:.3f}): phase 1 {c['phase1']['ms']:.3f} "
            f"(bound {c['phase1']['bound_ms']:.3f}), phase 2 "
            f"{c['phase2']['ms']:.3f} (bound {c['phase2']['bound_ms']:.3f}), "
            f"reduction {c['reduce']['ms']:.4f} (bound "
            f"{c['reduce']['bound_ms']:.4f})")


KERNEL_RECORDS = (
    ("fused_mlp_fwd", "fused_mlp_fwd.cu", "pallas_mlp.py:264", "fwd"),
    ("fused_mlp_bwd_phase1", "fused_mlp_bwd.cu", "pallas_mlp.py:312",
     "phase1"),
    ("fused_mlp_bwd_phase2", "fused_mlp_bwd.cu", "pallas_mlp.py:386",
     "phase2"),
    ("fused_mlp_bwd_reduce", "fused_mlp_bwd.cu", "pallas_mlp.py:327",
     "reduce"))


def kernel_records(suffix, path, c, launches):
    """The four kernels' records of one net's check ``c`` on ``path``,
    named ``<kernel>_<suffix>``, with ``launches`` of each; the module
    path's forward time beside the forward, autograd's backward beside
    phase 1 where the check timed them."""
    recs = []
    for (name, source, replaces, key), n in zip(KERNEL_RECORDS, launches):
        r = c[key]
        rec = {"name": f"{name}_{suffix}", "path": path, "route": "cuda",
               "source": "nerfmlp_torch/csrc/" + source,
               "replaces": "nerfmlp_tpu/ops/" + replaces, "launches": n,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        if "module_ms" in r:
            rec["module_ms"] = r["module_ms"]
        if "layout" in r:
            rec["layout"] = r["layout"]
        if key == "phase1" and "module_bwd_ms" in c["bwd"]:
            rec["module_bwd_ms"] = c["bwd"]["module_bwd_ms"]
        recs.append(rec)
    return recs


def arch_train(tag, flags, steps, card, floor=True):
    """The train CLI with ``flags`` (an architecture and mode) for
    ``steps`` steps on phase 5's synthetic scene, through the kernels and
    with --no_kernel: exactly 2 launches of each of the four kernels a
    step (none on the plain run), held-out PSNRs within PSNR_GAP of each
    other and (``floor``) >= PSNR_MIN. Returns (the kernel run's launches,
    its Trainer)."""
    scene = os.path.join(SMOKE_DIR, "scene")
    if not os.path.exists(os.path.join(scene, "transforms_train.json")):
        make_scene()
    root = os.path.join(SMOKE_DIR, tag, "_".join(f.lstrip("-")
                                                 for f in flags))
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    for name, extra in (("kernel", []), ("plain", ["--no_kernel"])):
        # A quick validation at half way and at the end (the CLI records
        # the mean loss of the steps before each).
        argv = ["--datadir", scene, "--img_wh", str(TRAIN_WH), str(TRAIN_WH),
                "--iters", str(steps), *flags,
                "--quick_val_interval", str(steps // 2), "--quick_val_res",
                str(TRAIN_WH), str(TRAIN_WH),
                "--save_dir", os.path.join(root, name), *extra]
        runs[name] = train_cli_run(f"{tag} {' '.join(flags)} {name}", argv,
                                   steps)
    metrics, launches, step_fwd, wall, trainer = runs["kernel"]
    plain_metrics, plain_launches = runs["plain"][:2]
    psnr = metrics["final_val"]["psnr"]
    plain = plain_metrics["final_val"]["psnr"]
    want = 2 * steps
    label = " ".join(flags)
    print(f"[{tag}] {label}: {steps} steps, {1e3 * wall / steps:.2f} ms a "
          f"step (--no_kernel {1e3 * runs['plain'][3] / steps:.2f}); "
          f"held-out PSNR {psnr:.2f} dB vs --no_kernel {plain:.2f} dB ("
          + (f"floor {PSNR_MIN}, " if floor else "")
          + f"gap {PSNR_GAP}); step launches {step_fwd} forward, "
          f"{launches[1:]} backward (want {want} each); --no_kernel "
          f"{plain_launches} | {card}")
    if not (step_fwd == want and launches[1:] == [want] * 3
            and plain_launches == [0, 0, 0, 0]
            and (psnr >= PSNR_MIN or not floor)
            and abs(psnr - plain) <= PSNR_GAP):
        raise SystemExit(f"[{tag}] the {label} train CLI runs failed their "
                         "checks")
    return [step_fwd, *launches[1:]], trainer


def wide_check(width, hi_lo, pts, dirs, card):
    """One wide net (depth 8, CLI shapes, random weights from the seed) at
    the train fine call's points: the forward and the backward's three
    kernels against their plain versions, alone and the backward whole,
    repeat runs bit-identical (check_kernel, check_backward); beside each
    kernel's time its bound and the module path on the same call (the
    forward's module_ms; autograd's backward through the module,
    module_bwd_ms). Returns {"fwd", "bwd", "phase1", "phase2", "reduce"}."""
    import torch

    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops import fused_mlp

    cfg = dataclasses.replace(slice_config(), width=width)
    mc = cfg.model_config()
    lay = fused_mlp._bwd_layout(mc, True, hi_lo)
    flay = fused_mlp._fwd_layout(mc, True, hi_lo)
    label = f"8x{width}{' hi_lo' if hi_lo else ''}"
    print(f"[wide] {label} budget: forward {flay.rows}-point tiles, "
          f"{flay.stages} stages, {flay.smem} B; phase 1 {lay.rows}-point "
          f"tiles, {lay.stages} stages, {lay.smem} B, "
          f"{fused_mlp.backward_counts(mc, True, hi_lo)[0]} operations, "
          f"{fused_mlp.bwd_scratch_bytes(mc, True, hi_lo)} B of workspace a "
          f"point; fits {fused_mlp.kernel_fits(mc, True, hi_lo)} / "
          f"{fused_mlp.backward_fits(mc, True, hi_lo)}")
    net = init_model(mc, seed=SEED + width, device="cuda")
    fwd = check_kernel(net, cfg, pts, dirs, f"wide {label}", time_it=True,
                       hi_lo=hi_lo)
    bwd, phases = check_backward(net, cfg, pts, dirs, f"wide {label}",
                                 time_it=True, hi_lo=hi_lo)
    bwd["module_bwd_ms"] = module_bwd_ms(net, cfg, pts, dirs, hi_lo, 5)
    c = {"fwd": fwd, "bwd": bwd, **phases}
    print(f"[wide] {label}: {times_line(c)} | {card}")
    torch.cuda.empty_cache()
    return c


def wide_serve(trainer, card):
    """One 400x400 frame of the trained 8x384 hi_lo net through
    RenderService (2 forward launches a 4,096-ray tile), equal to a direct
    render through the kernel, and held against the fp32 module path's
    frame at the serving bar (99.9% of values within FRAME_TOL). Returns
    the frame's launches."""
    import numpy as np
    import torch

    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.render_path import rays_for_pose_device
    from nerfmlp_torch.serve import RenderService

    cfg, params = trainer.rc, trainer.state.params
    svc = RenderService(params, cfg, H, W, FOCAL, tile=TILE, device="cuda",
                        log=lambda m: None)
    svc.warmup()
    pose = pose_spherical(*SERVE_POSE)
    torch.cuda.synchronize()
    fused_mlp.fused_nerf_mlp.launches = 0
    t0 = time.perf_counter()
    served = np.clip(svc.render_pose(pose)["rgb_map"], 0.0, 1.0)
    wall = time.perf_counter() - t0
    launches = fused_mlp.fused_nerf_mlp.launches
    o, d, _ = rays_for_pose_device(pose, H, W, FOCAL, cfg, device="cuda")
    frames = {}
    for name, c in (("kernel", cfg),
                    ("module", dataclasses.replace(
                        cfg, use_kernel=False, fp32_precision="highest"))):
        out = render_image_maps(prepare_params(params, c), o, d, H, W, c,
                                tile=TILE)
        frames[name] = np.clip(out["rgb_map"].cpu().numpy(), 0.0, 1.0)
    e = np.abs(served - frames["module"])
    q = float(np.quantile(e, 0.999))
    want = 2 * -(-H * W // TILE)
    print(f"[wide] served 8x{WIDE_HI_LO_TRAIN} hi_lo frame {H}x{W}: "
          f"{wall:.3f} s, {launches} forward launches (want {want}); equal "
          f"to a direct render: {np.array_equal(served, frames['kernel'])}; "
          f"vs the fp32 module path: max|err| {e.max():.3e}, 99.9th "
          f"percentile {q:.3e} (tol {FRAME_TOL}) | {card}")
    if not (launches == want and np.isfinite(served).all()
            and np.array_equal(served, frames["kernel"]) and q <= FRAME_TOL):
        raise SystemExit("[wide] the served wide frame failed its checks")
    return launches


def phase_wide(card):
    """The fused MLP kernels at every width the JAX package runs them (the
    module docstring, phase 16). Returns the kernels' records of paths
    wide (the 8x512 train run) and wide_hi_lo (the 8x384 hi_lo run)."""
    import torch

    from nerfmlp_torch.models.mlp import init_model

    t0 = time.perf_counter()
    cfg = slice_config()
    pts, dirs = serving_points(cfg.N_importance, cfg, n_rays=TRAIN_RAYS)
    checks = {}
    for width, hi_lo in ([(w, False) for w in WIDE_BF16]
                         + [(w, True) for w in WIDE_HI_LO]):
        checks[width, hi_lo] = wide_check(width, hi_lo, pts, dirs, card)
    del pts, dirs
    t1 = time.perf_counter()
    bf16_launches, _ = arch_train("wide", ["--netwidth", str(WIDE_TRAIN)],
                                  TRAIN_STEPS, card)
    hi_lo_launches, trainer = arch_train(
        "wide", ["--netwidth", str(WIDE_HI_LO_TRAIN), "--compute_dtype",
                 "float32", "--fp32_precision", "high"],
        WIDE_HI_LO_STEPS, card)
    t2 = time.perf_counter()
    wide_serve(trainer, card)
    del trainer
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    wcfg = dataclasses.replace(cfg, width=WIDE_TRAIN)
    nets = [init_model(wcfg.model_config(), seed=SEED + s, device="cuda")
            for s in range(WIDE_SCENES)]
    check_stack(nets, wcfg, cfg.N_samples, f"8x{WIDE_TRAIN}", card,
                tag="wide")
    del nets
    torch.cuda.empty_cache()
    print(f"[wide] phase took {time.perf_counter() - t0:.1f} s (kernels "
          f"{t1 - t0:.1f}, train {t2 - t1:.1f}, serve {t3 - t2:.1f}, stack "
          f"{time.perf_counter() - t3:.1f})")
    recs = []
    for path, key, launches in (
            ("wide", (WIDE_TRAIN, False), bf16_launches),
            ("wide_hi_lo", (WIDE_HI_LO_TRAIN, True), hi_lo_launches)):
        recs += kernel_records(path, path, checks[key], launches)
    return recs


# --------------------------------------------------------------------- #
# Phase 17: the fused MLP kernels on the deep nets the JAX package runs
# through Pallas ("deep")
# --------------------------------------------------------------------- #
# (depth, width, hi_lo) at CLI shapes: to JAX's deepest at widths 256 (bf16
# 54, hi_lo 43), 128 (177), 64 (509) and 16 (866, hi_lo 600), and past the
# old tables at 320 and 384. Phase 1: 64-point tiles at 32x256, 32-point
# ones elsewhere; 866x16 keeps its tables in device memory.
DEEP_NETS = ((32, 256, False), (54, 256, False), (43, 256, True),
             (26, 384, False), (36, 320, False), (177, 128, False),
             (509, 64, False), (866, 16, False), (600, 16, True))
DEEP_TRAIN = 32                    # --netdepth of the train CLI runs
DEEP_SCENES = 2                    # the stacked call's scenes, at 32x256
DEEP_ITERS, DEEP_PLAIN_ITERS = 5, 1   # timed runs: kernels, plain versions
DEEP_GAIN, DEEP_BIAS = 0.7, 0.3    # deep_net's trunk weight scale, bias std


def deep_net(cfg, seed):
    """A random net of ``cfg``'s shape from ``seed`` whose deep trunk keeps
    its activations alive and lets a rounding difference fade: lecun-normal
    weights as initialised, the trunk's scaled by DEEP_GAIN, and every bias
    drawn from N(0, DEEP_BIAS^2), as a trained net's biases are not zero.
    With zero biases the activations shrink ~1.4x a layer (exact zeros
    past ~300 layers at width 64), so kernel and plain would agree
    trivially; weights scaled to hold them at gain 1 carry each layer's
    summation-order difference on to the output."""
    import torch

    from nerfmlp_torch.models.mlp import init_model

    net = init_model(cfg.model_config(), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in net.pts_linears:
            lin.weight.mul_(DEEP_GAIN)
        for m in net.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(DEEP_BIAS * torch.randn(m.bias.shape,
                                                     generator=gen))
    return net.cuda()


def deep_check(depth, width, hi_lo, pts, dirs, card):
    """One deep net (CLI shapes, deep_net's weights from the seed) at the
    train fine call's points: the forward (twice, bit-identical) and the
    backward's three kernels against their plain versions, alone (on the
    call's first chunk, the points phase 1 and phase 2 take at once) and
    the backward whole (repeat bit-identical), at the wide phase's bars;
    beside each kernel's time its bound and the module path on the same
    call. A plain version run end to end parts from the kernels with
    depth (each layer's summation order flips a rounding or a ReLU mask,
    and the dX chain carries the flips on undamped), so a deep net is held
    layer by layer: phase 1's matrices to phase1_forced, the forward's
    output to heads_forced on phase 1's activations of the same points;
    the end-to-end distances are printed beside. Then one differentiated
    call through fused_nerf_mlp, the train step's entry, with the launch
    counts set to 0 just before: its launches of each kernel. Returns
    {"fwd", "bwd", "phase1", "phase2", "reduce", "launches"}."""
    import torch

    from nerfmlp_torch.ops import fused_mlp

    cfg = dataclasses.replace(slice_config(), depth=depth, width=width)
    mc = cfg.model_config()
    lay = fused_mlp._bwd_layout(mc, True, hi_lo)
    flay = fused_mlp._fwd_layout(mc, True, hi_lo)
    chunk = fused_mlp.bwd_chunk_rows(mc, True, hi_lo)
    label = f"{depth}x{width}{' hi_lo' if hi_lo else ''}"
    tables = ("shared" if lay.prog_ints > fused_mlp.BWD_TABLES_BASE
              else "device")
    print(f"[deep] {label} budget: forward {flay.rows}-point tiles, "
          f"{flay.stages} stages, {flay.smem} B; phase 1 {lay.rows}-point "
          f"tiles, {lay.stages} stages, {lay.smem} B "
          f"({lay.ring_off - lay.mask_off} B of masks, tables in {tables} "
          f"memory), {fused_mlp.backward_counts(mc, True)} (operations, "
          f"matrices), {fused_mlp.bwd_scratch_bytes(mc, True, hi_lo)} B of "
          f"workspace a point, chunks of {chunk} points; fits "
          f"{fused_mlp.kernel_fits(mc, True, hi_lo)} / "
          f"{fused_mlp.backward_fits(mc, True, hi_lo)}")
    net = deep_net(cfg, SEED + depth + width)
    fwd = check_kernel(net, cfg, pts, dirs, f"deep {label}", time_it=True,
                       hi_lo=hi_lo, iters=DEEP_ITERS,
                       plain_iters=DEEP_PLAIN_ITERS, held=False)
    kcfg = (dataclasses.replace(cfg, compute_dtype="float32",
                                fp32_precision="high") if hi_lo else cfg)
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True, hi_lo)
    m = min(pts.shape[0], chunk)
    ws = torch.empty(fused_mlp.ws_rows(m, packed.bwd_rows) * packed.ws_cols,
                     device="cuda", dtype=torch.bfloat16)
    fused_mlp.bwd_workspace(packed, pts[:m], dirs[:m],
                            torch.zeros((m, 4), device="cuda"), ws)
    with torch.no_grad():
        out = fused_mlp.fused_nerf_mlp(packed, pts, dirs, kcfg)
        same = torch.equal(out, fused_mlp.fused_nerf_mlp(packed, pts, dirs,
                                                         kcfg))
        want = heads_forced(packed, ws, m)
    err = float((out[:m] - want).abs().max())
    fwd.update(end_to_end_norm_err=fwd["norm_err"],
               end_to_end_max_abs_err=fwd["max_abs_err"], max_abs_err=err,
               norm_err=err / max(float(want.abs().max()), 1e-12))
    ftol = HI_LO_TOL if hi_lo else KERNEL_TOL
    print(f"[deep] {label} forward, on phase 1's activations of the first "
          f"{m} points: max|err| {err:.3e} normalised {fwd['norm_err']:.3e} "
          f"(tol {ftol}); end to end {fwd['end_to_end_norm_err']:.3e}; "
          f"repeat bit-identical: {same}")
    if not (same and fwd["norm_err"] <= ftol):
        raise SystemExit(f"[deep] {label}: the forward disagrees with its "
                         f"plain heads, or two runs differ")
    del packed, ws, out, want
    bwd, phases = check_backward(net, cfg, pts, dirs, f"deep {label}",
                                 time_it=True, hi_lo=hi_lo,
                                 iters=DEEP_ITERS,
                                 plain_iters=DEEP_PLAIN_ITERS,
                                 phase_rows=chunk)
    bwd["module_bwd_ms"] = module_bwd_ms(net, cfg, pts, dirs, hi_lo,
                                         DEEP_ITERS)
    launches = call_launches(net, pts, dirs, kcfg)
    chunks = -(-pts.shape[0] // chunk)
    if launches != [1, chunks, chunks, 1]:
        raise SystemExit(f"[deep] {label}: the differentiated call launched "
                         f"{launches}, want [1, {chunks}, {chunks}, 1]")
    c = {"fwd": fwd, "bwd": bwd, **phases, "launches": launches}
    print(f"[deep] {label}: {times_line(c)} on a chunk of "
          f"{min(chunk, pts.shape[0])} points; a differentiated call "
          f"launched {launches} | {card}")
    del net
    torch.cuda.empty_cache()
    return c


def phase_deep(card):
    """The fused MLP kernels on the deep nets the JAX package runs through
    Pallas (the module docstring, phase 17). Returns the kernels' records:
    path deep (the --netdepth 32 train run's launches) for each net."""
    import torch

    t0 = time.perf_counter()
    cfg = slice_config()
    pts, dirs = serving_points(cfg.N_importance, cfg, n_rays=TRAIN_RAYS)
    checks = {net: deep_check(*net, pts, dirs, card) for net in DEEP_NETS}
    t1 = time.perf_counter()
    # No PSNR floor: the CLI's lecun-normal trunk with zero biases shrinks
    # its activations ~1e4 by layer 32, on both paths alike, so this run
    # shows the kernels on the train path, not a trained net (the deep
    # kernels' gradients are held in deep_check).
    launches, _ = arch_train("deep", ["--netdepth", str(DEEP_TRAIN)],
                             TRAIN_STEPS, card, floor=False)
    t2 = time.perf_counter()
    dcfg = dataclasses.replace(cfg, depth=DEEP_TRAIN)
    nets = [deep_net(dcfg, SEED + s) for s in range(DEEP_SCENES)]
    check_stack(nets, dcfg, cfg.N_samples, f"{DEEP_TRAIN}x256", card,
                tag="deep", forced=True)
    del nets, pts, dirs
    torch.cuda.empty_cache()
    print(f"[deep] phase took {time.perf_counter() - t0:.1f} s (kernels "
          f"{t1 - t0:.1f}, train {t2 - t1:.1f}, stack "
          f"{time.perf_counter() - t2:.1f})")
    recs = []
    for (depth, width, hi_lo), c in checks.items():
        # The --netdepth 32 run's launches (its own net), else those of the
        # net's differentiated call through fused_nerf_mlp.
        recs += kernel_records(
            f"deep_{depth}x{width}{'_hi_lo' if hi_lo else ''}", "deep", c,
            launches if (depth, width, hi_lo) == (DEEP_TRAIN, 256, False)
            else c["launches"])
    return recs


# --------------------------------------------------------------------- #
# Phase 18: the fused MLP kernels on the shallow wide nets the JAX package
# runs through Pallas ("shallow")
# --------------------------------------------------------------------- #
# (depth, width, hi_lo) at CLI shapes: JAX's widest bf16 net (1x1696:
# 16-point tiles of both kernels), its widest at depth 2 and 5, JAX's
# widest hi_lo net (1x1472: phase 1's passes of 128 columns), its widest
# hi_lo at depth 3, and 5x752 hi_lo. The bf16 forward takes 32-point
# tiles past width 784 (16 at 1x1696), the hi_lo forward 16-point tiles.
SHALLOW_NETS = ((1, 1696, False), (2, 1312, False), (5, 864, False),
                (1, 1472, True), (3, 960, True), (5, 752, True))
SHALLOW_TRAIN = (2, 1024)          # --netdepth, --netwidth of the train CLI
SHALLOW_SCENES = 2                 # the stacked call's scenes, at 2x1024


def shallow_check(depth, width, hi_lo, pts, dirs, card):
    """One shallow wide net (CLI shapes, random weights from the seed, as
    initialised: a shallow trunk keeps its activations alive) at the train
    fine call's points: the forward (twice, bit-identical) and the
    backward's three kernels against their plain versions, alone and the
    backward whole (repeat bit-identical), at the wide phase's bars end to
    end; beside each kernel's time its bound and the module path on the
    same call; then the launches of one differentiated call
    (call_launches). Returns {"fwd", "bwd", "phase1", "phase2", "reduce",
    "launches"}."""
    import torch

    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops import fused_mlp

    cfg = dataclasses.replace(slice_config(), depth=depth, width=width)
    mc = cfg.model_config()
    lay = fused_mlp._bwd_layout(mc, True, hi_lo)
    flay = fused_mlp._fwd_layout(mc, True, hi_lo)
    chunk = fused_mlp.bwd_chunk_rows(mc, True, hi_lo)
    label = f"{depth}x{width}{' hi_lo' if hi_lo else ''}"
    print(f"[shallow] {label} budget: forward {flay.rows}-point tiles, "
          f"{flay.stages} stages, {flay.smem} B; phase 1 {lay.rows}-point "
          f"tiles, passes of {lay.pass_cols} columns, {lay.stages} stages, "
          f"{lay.smem} B, {fused_mlp.backward_counts(mc, True, hi_lo)} "
          f"(operations, matrices), "
          f"{fused_mlp.bwd_scratch_bytes(mc, True, hi_lo)} B of workspace a "
          f"point, chunks of {chunk} points; fits "
          f"{fused_mlp.kernel_fits(mc, True, hi_lo)} / "
          f"{fused_mlp.backward_fits(mc, True, hi_lo)}")
    if pts.shape[0] > chunk:
        raise SystemExit(f"[shallow] {label}: the call is cut into chunks "
                         f"of {chunk} points; the phases are checked whole")
    net = init_model(mc, seed=SEED + depth + width, device="cuda")
    fwd = check_kernel(net, cfg, pts, dirs, f"shallow {label}", time_it=True,
                       hi_lo=hi_lo, iters=DEEP_ITERS,
                       plain_iters=DEEP_PLAIN_ITERS)
    kcfg = (dataclasses.replace(cfg, compute_dtype="float32",
                                fp32_precision="high") if hi_lo else cfg)
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, True, hi_lo)
    with torch.no_grad():
        same = torch.equal(fused_mlp.fused_nerf_mlp(packed, pts, dirs, kcfg),
                           fused_mlp.fused_nerf_mlp(packed, pts, dirs, kcfg))
    if not same:
        raise SystemExit(f"[shallow] {label}: two runs of the forward differ")
    del packed
    bwd, phases = check_backward(net, cfg, pts, dirs, f"shallow {label}",
                                 time_it=True, hi_lo=hi_lo, iters=DEEP_ITERS,
                                 plain_iters=DEEP_PLAIN_ITERS)
    bwd["module_bwd_ms"] = module_bwd_ms(net, cfg, pts, dirs, hi_lo,
                                         DEEP_ITERS)
    launches = call_launches(net, pts, dirs, kcfg)
    if launches != [1, 1, 1, 1]:
        raise SystemExit(f"[shallow] {label}: the differentiated call "
                         f"launched {launches}, want [1, 1, 1, 1]")
    c = {"fwd": fwd, "bwd": bwd, **phases, "launches": launches}
    print(f"[shallow] {label}: {times_line(c)}; the forward's repeat "
          f"bit-identical; a differentiated call launched {launches} | "
          f"{card}")
    del net
    torch.cuda.empty_cache()
    return c


def phase_shallow(card):
    """The fused MLP kernels on the shallow wide nets the JAX package runs
    through Pallas (the module docstring, phase 18). Returns the kernels'
    records: path shallow, for each net the launches of its differentiated
    call, and for the train CLI's net (2x1024, timed at the train fine
    call on random weights of its shape) those of the run."""
    import torch

    from nerfmlp_torch.models.mlp import init_model

    t0 = time.perf_counter()
    cfg = slice_config()
    pts, dirs = serving_points(cfg.N_importance, cfg, n_rays=TRAIN_RAYS)
    depth, width = SHALLOW_TRAIN
    nets = SHALLOW_NETS + ((depth, width, False),)
    checks = {net: shallow_check(*net, pts, dirs, card) for net in nets}
    del pts, dirs
    t1 = time.perf_counter()
    train_launches, _ = arch_train(
        "shallow", ["--netdepth", str(depth), "--netwidth", str(width)],
        TRAIN_STEPS, card)
    t2 = time.perf_counter()
    scfg = dataclasses.replace(cfg, depth=depth, width=width)
    stack = [init_model(scfg.model_config(), seed=SEED + s, device="cuda")
             for s in range(SHALLOW_SCENES)]
    check_stack(stack, scfg, cfg.N_samples, f"{depth}x{width}", card,
                tag="shallow")
    del stack
    torch.cuda.empty_cache()
    print(f"[shallow] phase took {time.perf_counter() - t0:.1f} s (kernels "
          f"{t1 - t0:.1f}, train {t2 - t1:.1f}, stack "
          f"{time.perf_counter() - t2:.1f})")
    recs = []
    for (d, w, hi_lo), c in checks.items():
        recs += kernel_records(
            f"shallow_{d}x{w}{'_hi_lo' if hi_lo else ''}", "shallow", c,
            train_launches if (d, w, hi_lo) == (depth, width, False)
            else c["launches"])
    return recs


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
    t_start = time.perf_counter()
    phase_build()
    if sys.argv[1:] == ["--only", "interchange"]:
        # Phase 12 alone, after the runs whose files it reads: phase 5's
        # train state and phase 6's turbo weights.
        train_ds, val_ds = make_scene()
        card = smi_line()
        train_run = phase_train(train_ds, val_ds)
        turbo_ckpt = save_turbo(phase_occ_train(train_ds, val_ds))
        recs = phase_interchange(train_run, turbo_ckpt, card)
        print(json.dumps({"kernels": annotate(recs)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "parallel"]:
        # Phase 13 alone, after the single-process run it starts from.
        train_ds, val_ds = make_scene()
        card = smi_line()
        recs = phase_parallel(phase_train(train_ds, val_ds), card)
        print(json.dumps({"kernels": annotate(recs)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "jpeg"]:
        # Phase 14 alone.
        card = smi_line()
        print(json.dumps({"kernels": annotate(phase_jpeg(None, card))}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "finish"]:
        # Phase 15 alone, after the runs whose files it reads: phase 5's
        # scene and run, phase 6's turbo weights, phase 7's run directory.
        train_ds, val_ds = make_scene()
        card = smi_line()
        train_run = phase_train(train_ds, val_ds)
        turbo_ckpt = save_turbo(phase_occ_train(train_ds, val_ds))
        phase_inference()
        recs = phase_finish(train_run, turbo_ckpt, card)
        print(json.dumps({"kernels": annotate(recs)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "wide"]:
        # Phase 16 alone.
        card = smi_line()
        print(json.dumps({"kernels": annotate(phase_wide(card))}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "deep"]:
        # Phase 17 alone.
        card = smi_line()
        print(json.dumps({"kernels": annotate(phase_deep(card))}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "shallow"]:
        # Phase 18 alone.
        card = smi_line()
        recs = phase_shallow(card)
        print(f"[chip_smoke] build and phase 18 took "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": annotate(recs)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "multi_scene"]:
        # Phase 11 alone, after the single-scene run it is held against.
        train_ds, val_ds = make_scene()
        card = smi_line()
        ms_run = phase_multi_scene(phase_train(train_ds, val_ds)["val"]
                                   ["psnr"], card)
        print(json.dumps({"kernels": annotate(
            multi_scene_records(ms_run))}))
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
    parallel_recs = phase_parallel(train_run, card)
    jpeg_recs = phase_jpeg(llff["psnr"], card)
    finish_recs = phase_finish(train_run, turbo_ckpt, card)
    wide_recs = phase_wide(card)
    deep_recs = phase_deep(card)
    shallow_recs = phase_shallow(card)

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
    # Data parallelism (phase 13): each kernel at a rank's shapes, with
    # the launches of a rank's steps.
    kernels += parallel_recs
    # JPEG captures (phase 14): each kernel's launches in the train CLI run
    # on the JPEG capture, its device ms per launch from the run's own
    # --profile_dir trace, held on the net of the traced window.
    kernels += jpeg_recs
    # The rest of the JAX package (phase 15): the forward of the mesh over
    # two devices (launches summed over them), and the four kernels on the
    # progressive capture's train CLI run.
    kernels += finish_recs
    # The wide nets (phase 16): each kernel's launches in the --netwidth
    # 512 train CLI run (path wide) and the 8x384 hi_lo run (wide_hi_lo),
    # timed at the train fine call on random weights of the same shape.
    kernels += wide_recs
    # The deep nets (phase 17): each kernel's launches in the --netdepth 32
    # train CLI run (path deep, 32x256) or in one differentiated call of
    # each other deep net, timed at the train fine call.
    kernels += deep_recs
    # The shallow wide nets (phase 18): each kernel's launches in the
    # --netdepth 2 --netwidth 1024 train CLI run (2x1024) or in one
    # differentiated call of each other shallow net, timed at the train
    # fine call.
    kernels += shallow_recs
    for rec in bwds + [occ["bwd probe"], occ["bwd refine"], occ["bwd hi_lo"],
                       llff["bwd"]]:
        print(f"[backward] {rec['label']} call, all three kernels: "
              f"{rec['ms']:.3f} ms ({rec['ms_no_spin']:.3f} ms without the "
              f"spin); bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}), design floor {rec['floor_ms']:.3f} ms")
    print(f"[chip_smoke] the whole script took "
          f"{time.perf_counter() - t_start:.1f} s after the device check")
    print(json.dumps({"kernels": annotate(kernels)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
