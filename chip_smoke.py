#!/usr/bin/env python3
"""Drive the PyTorch port (nerfmlp_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the port from csrc/ (nvcc, in parallel);
  2. hold the fused MLP kernel against its plain PyTorch version at the
     serving path's shapes (8x256 + view head, 262,144 and 524,288 points
     from real rays of a serving pose), in hi_lo mode (fp32 'high') at the
     first shape, and at one generic architecture (depth 6, width 128, no
     view head), and time both versions;
  3. serve 400x400 frames (64+128 samples, shared net, bf16, kernel on)
     over HTTP from RenderServer on 127.0.0.1 — png, npy and json — and
     check the kernel launches per frame, the images, and the frame
     against the same frame rendered with use_kernel=False on the card;
     then profile one frame.
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
KERNEL_TOL = 1e-2         # max |kernel - plain| / max |plain|, bf16: a
#                           bf16 rounding that flips cascades through 8 layers
HI_LO_TOL = 1e-4          # the same in hi_lo mode: fp32-grade activations,
#                           only the fp32 summation order differs
FRAME_TOL = 3e-3          # served rgb vs the use_kernel=False frame
FRAME_MAX = 1e-2          # ... at the few discontinuous fine-pass pixels


def cuda_ms(fn, iters, warmup=2):
    """Median milliseconds of ``fn`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def serving_points(n_samples, cfg):
    """Points and encoded view directions of the first tile of rays of the
    serving pose, ``n_samples`` evenly spaced depths per ray."""
    import torch

    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.rays import pose_spherical
    from nerfmlp_torch.render_path import rays_for_pose_device

    o, d, _ = rays_for_pose_device(pose_spherical(*SERVE_POSE), H, W, FOCAL,
                                   cfg, device="cuda")
    mid = (H * W - TILE) // 2            # a tile through the image centre
    o, d = o[mid:mid + TILE], d[mid:mid + TILE]
    z = torch.linspace(cfg.near, cfg.far, n_samples, device="cuda")
    pts = (o[:, None, :] + d[:, None, :] * z[None, :, None]).reshape(-1, 3)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dirs = positional_encoding(vd, cfg.dir_enc_L)
    dirs = dirs[:, None, :].expand(TILE, n_samples, dirs.shape[-1])
    return pts.contiguous(), dirs.reshape(TILE * n_samples, -1)


def check_kernel(net, cfg, pts, dirs, label, time_it, hi_lo=False):
    """Kernel vs plain on the same inputs; returns a result record.
    ``hi_lo``: fp32_precision="high", three bf16 products per matmul."""
    import torch

    from nerfmlp_torch.ops import fused_mlp

    vdirs = dirs is not None
    tol = HI_LO_TOL if hi_lo else KERNEL_TOL
    if hi_lo:
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  fp32_precision="high")
    packed = fused_mlp.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)

    def plain():
        return fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                              torch.bfloat16, hi_lo)

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
        rec["ms"] = cuda_ms(lambda: fused_mlp.fused_nerf_mlp(packed, pts, dirs,
                                                             cfg), iters=10)
        rec["plain_ms"] = cuda_ms(plain, iters=3)
        rec["tflops"] = flops / rec["ms"] / 1e9
    print(f"[kernel] {label}: n={n} max|err|={err:.3e} "
          f"normalised={norm:.3e} (tol {tol})"
          + (f" kernel {rec['ms']:.3f} ms ({rec['tflops']:.1f} TFLOP/s) "
             f"plain {rec['plain_ms']:.3f} ms" if time_it else "")
          + f" bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    if not norm <= tol:
        raise SystemExit(f"[kernel] {label}: kernel disagrees with plain")
    return rec


def phase_kernel(net):
    from nerfmlp_torch.models.mlp import init_model
    from nerfmlp_torch.ops.fused_mlp import kernel_fits, smem_bytes

    cfg = slice_config()
    mc = cfg.model_config()
    print(f"[kernel] 8x256 budget: {smem_bytes(mc, True)} B shared memory, "
          f"fits={kernel_fits(mc, True)}")
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
    return recs


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
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
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

    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    phase_build()
    net = init_model(slice_config().model_config(), seed=SEED, device="cuda")
    coarse, fine = phase_kernel(net)
    launches = phase_serve(net)

    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "nerfmlp_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfmlp_tpu/ops/pallas_mlp.py:264",
        "launches": launches,
        "max_abs_err": max(coarse["max_abs_err"], fine["max_abs_err"]),
        "ms": fine["ms"],
        "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"],
        "library_ms": None,
    }]
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
