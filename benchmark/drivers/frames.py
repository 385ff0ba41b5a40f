"""Traffic of kind ``frames``: one closed-loop client sends
``RenderService.render_request`` (the core of ``POST /render``) one
camera after another and waits for each frame's bytes.

The cameras lie on the Blender test orbit: azimuth uniform in
``theta_deg``, elevation ``phi_deg``, distance ``radius``, drawn from the
seed; every frame has the same size and format. Set-up builds the
service from the seeded weights (and, with occupancy, its grid) and
sends ``warm_requests`` frames; the window sends frames until
``--seconds`` have passed (``trace_frames`` of them under the profiler
with ``--trace 1``). Each frame is timed from the call to its returned
bytes. Afterwards ``check_frames`` of the served frames, drawn from the
seed, are rendered by the reference and compared.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import check, counts, harness, scene
from benchmark.reference import nerf, png
from benchmark.trace import Traced


def build(cell: harness.Cell, seed: int, device):
    """(service, weights, focal) of one seed: the program's RenderService
    holding the seeded weights (and the grid it builds from them)."""
    from nerfmlp_torch.models.mlp import NeRFMLP
    from nerfmlp_torch.serve import RenderService

    cfg, tr = cell.config, cell.traffic
    rc, _ = harness.program_configs(cfg, 0)
    weights = scene.make_weights(cfg["model"],
                                 harness.subseed(seed, harness.WEIGHTS),
                                 device, tr["weights"])
    net = NeRFMLP(rc.model_config()).to(device)
    net.load_state_dict(weights)
    focal = 0.5 * tr["W"] / math.tan(0.5 * cfg["scene"]["camera_angle_x"])
    srv = cfg["serve"]
    svc = RenderService({"coarse": net}, rc, tr["H"], tr["W"], focal,
                        tile=srv["tile"], max_queue=srv["max_queue"],
                        device=device,
                        log=lambda m: print(f"[service] {m}", flush=True))
    return svc, weights, focal


def request(tr: dict, theta: float) -> dict:
    """One client request: a camera on the orbit and the format."""
    return {"theta": theta, "phi": tr["phi_deg"], "radius": tr["radius"],
            "format": tr["format"]}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t0: float) -> dict:
    cfg, tr = cell.config, cell.traffic
    svc, weights, focal = build(cell, seed, device)
    rc = svc.cfg
    h, w, srv = tr["H"], tr["W"], cfg["serve"]
    rng = np.random.default_rng(harness.subseed(seed, harness.POSES))
    lo, hi = tr["theta_deg"]

    for theta in rng.uniform(lo, hi, tr["warm_requests"]):
        svc.render_request(request(tr, float(theta)))
    if svc.occ_grid is not None:
        occ = svc.occ_grid.density > rc.occ_threshold
        print(f"[bench] grid occupied share {float(occ.float().mean())}",
              flush=True)
    setup_s = time.perf_counter() - t0

    thetas, bodies, times, failed = [], [], [], 0
    tmp = tempfile.mkdtemp(prefix="bench_frames_")
    traced = None
    try:
        def frame() -> None:
            nonlocal failed
            theta = float(rng.uniform(lo, hi))
            t = time.perf_counter()
            try:
                body, _ = svc.render_request(request(tr, theta))
            except Exception as e:   # a refused or failed frame counts
                failed += 1
                print(f"[bench] frame failed: {type(e).__name__}: {e}",
                      flush=True)
                return
            times.append(time.perf_counter() - t)
            thetas.append(theta)
            bodies.append(body)

        t1 = time.perf_counter()
        if trace:
            with Traced(device, f"{tmp}/trace.json") as traced:
                for _ in range(tr["trace_frames"]):
                    frame()
        else:
            while time.perf_counter() - t1 < seconds:
                frame()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    del svc
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    frames = len(times)
    work = {"mode": "serve", "frames": frames, "pixels": h * w,
            "fwd_calls": counts.frame_calls(cfg["render"], h * w,
                                            srv["tile"]) * frames,
            "bwd_calls": []}
    e2e = {"setup_s": setup_s}
    if times:
        ms = np.asarray(times) * 1e3
        e2e["frame_ms_mean"] = float(ms.mean())
        print(f"[bench] {frames} frames: p50 {np.percentile(ms, 50)} ms, "
              f"p95 {np.percentile(ms, 95)} ms, max {ms.max()} ms",
              flush=True)
    pick = np.random.default_rng(harness.subseed(seed, harness.CHECK))
    idx = pick.choice(frames, min(tr["check_frames"], frames), replace=False)
    density = reference_density(cfg, weights, device)
    readings = check.worst(
        frame_check(cfg, weights, thetas[i], tr, png.decode(bodies[i]),
                    focal, device, density) for i in sorted(idx))
    return {"e2e": e2e, "attempted": frames + failed, "failed": failed,
            "peak": peak, "traced": traced, "work": work,
            "readings": readings}


def reference_density(cfg: dict, weights, device, quant=None):
    """The reference's grid from the weights, or None without occupancy."""
    if not cfg["render"].get("use_occupancy"):
        return None
    srv = cfg["serve"]
    return check.reference_grid(cfg, weights, srv["grid_seed"],
                                srv["grid_refreshes"], device, quant)


def frame_check(cfg: dict, weights, theta: float, tr: dict,
                served: np.ndarray, focal: float, device, density=None,
                quant=None) -> dict:
    """The numbers of one served frame against the reference's render of
    its camera (``density``: a grid already worked out, else built)."""
    if density is None:
        density = reference_density(cfg, weights, device, quant)
    c2w = nerf.pose_spherical(theta, tr["phi_deg"], tr["radius"])
    ref = check.reference_frame(cfg, weights, c2w, tr["H"], tr["W"], focal,
                                cfg["serve"]["tile"], device, density, quant)
    return check.frame_readings(served[..., :3], ref)
