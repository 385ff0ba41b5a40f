"""The comparison that decides ``correct``: the plain reference worked out
again from the cell's inputs, and the numbers that hold the program's
outputs against it.

Training: the reference follows two groups of the program's steps, its
first steps from the same weights, batches and uniforms
(``reference.data``), and the steps it takes, at the end of set-up, in
the window's regime from the state it reached there (weights, Adam's
moments, the generators, the grid). For each it compares each step's
loss, each leaf's gradient as Adam received it at the group's first step
and each leaf's change over the group, by the worst leaf: the gap between
the two norms over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose gradient in the reference is under a
thousandth of the median leaf's are left out of the change (they move by
round-off alone). With an occupancy grid, the grid's density after the
steps too. The gradient gaps are also read against the reference's own
steps in bfloat16, the stated precision (:func:`train_readings`).

Frames: the reference renders each sampled frame's pose in float32; the
served PNG, decoded, is compared by its mean gap in 8-bit levels and the
share of its values more than 8 levels off.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.reference import data as rdata
from benchmark.reference import fp8, nerf

DENSITY_INIT = 0.02   # a fresh grid, just above the 1e-2 threshold


def reference_train(cfg: Dict, weights: Dict, pool: np.ndarray, shape,
                    seed: int, steps: int, device,
                    quant: Optional[Callable] = None,
                    half_batch: bool = False,
                    start: Optional[Dict] = None) -> Dict:
    """The reference's ``steps`` steps of the recipe from ``weights``:
    {losses, grads (the first step's), update (last - first), density
    (the grid after them, or None)}. Without ``start`` they are the first
    steps, everything drawn from ``seed``; with it they follow the state a
    trainer had (``drivers.train.keep_state``). ``half_batch`` takes the
    loss over the first half of each batch (a planted fault)."""
    nerf.true_fp32()
    tr, rd = cfg["train"], nerf_cfg(cfg)
    w = {k: v.detach().clone().float().to(device) for k, v in weights.items()}
    w0 = {k: v.clone() for k, v in w.items()}
    opt = nerf.Adam(w, tr["lr"], tr["lr_decay_rate"], tr["lr_decay_steps"])
    host = rdata.HostBatches(pool, shape, tr["batch_size"], seed)
    dev_pool = None
    if not tr.get("no_batching"):
        dev_pool = torch.from_numpy(pool).to(device)
    uniforms = rdata.Uniforms(seed, device)
    density, s0 = None, 0
    if rd.get("use_occupancy"):
        g = rd["occ_grid_size"]
        density = torch.full((g, g, g), DENSITY_INIT, device=device)
    if start is not None:
        s0 = opt.count = start["step"]
        for k in w:
            opt.m[k] = start["m"][k].detach().clone().float().to(device)
            opt.v[k] = start["v"][k].detach().clone().float().to(device)
        uniforms.gen.set_state(start["uniforms"])
        host.rng.bit_generator.state = start["host"]
        if density is not None:
            density = start["density"].detach().clone().float().to(device)
    losses, grads1 = [], None
    for s in range(s0 + 1, s0 + steps + 1):
        crop = tr.get("precrop_frac", 1.0) if s <= tr.get(
            "precrop_iters", 0) else 1.0
        if dev_pool is None or crop < 1.0:
            batch = torch.from_numpy(np.ascontiguousarray(host.next(crop)))
            batch = batch.to(device)
        else:
            batch = rdata.pool_batch(dev_pool, tr["batch_size"], seed, s)
        if density is not None and (s - 1) % rd["occ_update_every"] == 0:
            jitter = rdata.Uniforms(rdata.GRID_SEED_BASE + s, device)(
                (density.numel(), 3))
            decay = 1.0 if s <= rd["occ_warmup_steps"] else 0.95
            density = nerf.grid_refresh(density, w, rd, jitter, decay, quant)
        if half_batch:
            batch = batch[: batch.shape[0] // 2]
        loss, grads = nerf.train_step(w, opt, rd, batch, uniforms, density,
                                      quant, tr.get("grad_clip", 0.0))
        losses.append(loss)
        if s == s0 + 1:
            grads1 = grads
    return {"losses": losses, "grads": grads1,
            "update": {k: w[k] - w0[k] for k in w}, "density": density}


def train_check(cfg: Dict, weights: Dict, views, seed: int, steps: int,
                device, prog: Dict, kept: Dict, late: Dict,
                variants: Dict[str, Dict] = None,
                leaves: bool = False) -> Dict[str, Dict]:
    """The numbers of a training check: the trainer's first steps
    (``prog``) against the reference's from ``weights``, and its steps
    from the ``kept`` state (``late``) against the reference's from the
    same state, the latter's numbers named ``win_*``. Under
    ``"program"``; each of ``variants`` (keyword arguments of
    :func:`reference_train`: the control, a fault) puts the reference so
    changed in the program's place and reads the same numbers. With
    ``leaves``, ``"leaves"`` gives each moved leaf's change gap at set-up's
    end: [program's, the twin's, the reference's norm of the change]."""
    pool, shape = views.pool(), (views.n_images, views.H, views.W)

    def pair(**kw):
        return (reference_train(cfg, weights, pool, shape, seed, steps,
                                device, **kw),
                reference_train(cfg, kept["weights"], pool, shape, seed,
                                steps, device, start=kept, **kw))

    ref, twin = pair(), pair(quant=fp8.bf16_linear)

    def readings(first, then):
        out = train_readings(first, ref[0], twin[0])
        out.update({"win_" + k: v for k, v in
                    train_readings(then, ref[1], twin[1]).items()})
        return out

    out = {"program": readings(prog, late)}
    for name, kw in (variants or {}).items():
        out[name] = readings(*pair(**kw))
    if leaves:
        moved = moved_leaves(ref[1])
        ref_n = {k: float(ref[1]["update"][k].double().norm()) for k in moved}
        out["leaves"] = {
            k: [g, t, ref_n[k]] for (k, g), t in zip(
                leaf_gaps(late["update"], ref[1]["update"], moved).items(),
                leaf_gaps(twin[1]["update"], ref[1]["update"],
                          moved).values())}
    return out


def nerf_cfg(cfg: Dict) -> Dict:
    return dict(cfg["model"], **cfg["render"])


def leaf_gaps(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
              keys) -> Dict[str, float]:
    """Each leaf's gap |‖p‖ - ‖r‖| / max(‖r‖, the median leaf's ‖r‖),
    for the leaves of ``keys``."""
    rn = {k: float(r[k].double().norm()) for k in r}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(p[k].double().norm()) - rn[k]) / (max(rn[k], med)
                                                           or 1.0)
            for k in keys}


def _leaf_gap(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
              keys, over=max) -> float:
    """The leaves' gaps (:func:`leaf_gaps`) taken ``over`` the leaves of
    ``keys`` (the worst, or their median)."""
    gaps = list(leaf_gaps(p, r, keys).values())
    return float(over(gaps)) if gaps else 0.0


def moved_leaves(ref: Dict):
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move by round-off."""
    gn = {k: float(g.double().norm()) for k, g in ref["grads"].items()}
    med = float(np.median(list(gn.values())))
    return [k for k in ref["update"] if gn[k] >= 1e-3 * med]


def train_readings(prog: Dict, ref: Dict,
                   twin: Dict) -> Dict[str, float]:
    """The numbers of one group of steps: ``loss_gap`` (the worst step's
    relative gap) and the first step's, ``grad_gap`` and ``update_gap``
    (worst leaf), ``update_median`` (the median leaf's change gap), with a
    grid ``grid_gap`` (relative L2 of the density); and against ``twin``
    (the reference's own steps in bfloat16) ``grad_ratio`` and
    ``grad_median_ratio``: the worst and the median leaf's gradient gap
    over the twin's, so that a field on which any rounding moves the
    sampling far reads about 1 in the stated precision, and far more below
    it; ``update_twin_gap`` is the twin's own worst leaf change gap."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    out = {"loss_gap": max(gaps), "loss_gap_step1": gaps[0]}
    keys = list(ref["grads"])
    out["grad_gap"] = _leaf_gap(prog["grads"], ref["grads"], keys)
    moved = moved_leaves(ref)
    out["update_gap"] = _leaf_gap(prog["update"], ref["update"], moved)
    out["update_median"] = _leaf_gap(prog["update"], ref["update"], moved,
                                     np.median)
    out["update_twin_gap"] = _leaf_gap(twin["update"], ref["update"], moved)
    if ref.get("density") is not None:
        d_r = ref["density"].double()
        out["grid_gap"] = float((prog["density"].double().to(d_r.device)
                                 - d_r).norm() / d_r.norm())
    t_worst = _leaf_gap(twin["grads"], ref["grads"], keys)
    t_med = _leaf_gap(twin["grads"], ref["grads"], keys, np.median)
    out["grad_ratio"] = out["grad_gap"] / max(t_worst, 1e-12)
    out["grad_median_ratio"] = _leaf_gap(
        prog["grads"], ref["grads"], keys, np.median) / max(t_med, 1e-12)
    return out


@torch.no_grad()
def reference_frame(cfg: Dict, weights: Dict, c2w: torch.Tensor, h: int,
                    w: int, focal: float, tile: int, device,
                    density=None, quant=None) -> np.ndarray:
    """Float32 rgb (H, W, 3) of one frame, deterministic depths, in tiles
    of rays."""
    nerf.true_fp32()
    rd = nerf_cfg(cfg)
    wt = {k: v.detach().float().to(device) for k, v in weights.items()}
    o, d = nerf.camera_rays(h, w, focal, c2w, device)
    rgb = torch.cat([nerf.render(wt, rd, o[i:i + tile], d[i:i + tile], None,
                                 density, quant)
                     for i in range(0, o.shape[0], tile)])
    return rgb.reshape(h, w, 3).cpu().numpy()


@torch.no_grad()
def reference_grid(cfg: Dict, weights: Dict, seed: int, refreshes: int,
                   device, quant=None) -> torch.Tensor:
    """A serving grid from weights: zero density, then the running max of
    ``refreshes`` jittered queries, the jitter drawn in turn from one
    generator seeded ``seed`` on the card."""
    nerf.true_fp32()
    rd = nerf_cfg(cfg)
    wt = {k: v.detach().float().to(device) for k, v in weights.items()}
    g = rd["occ_grid_size"]
    density = torch.zeros((g, g, g), device=device)
    draw = rdata.Uniforms(seed, device)
    for _ in range(refreshes):
        density = nerf.grid_refresh(density, wt, rd, draw((g ** 3, 3)), 1.0,
                                    quant)
    return density


def levels(rgb: np.ndarray) -> np.ndarray:
    """Float colour -> the 8-bit levels a PNG of it holds."""
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def frame_readings(served: np.ndarray, ref_rgb: np.ndarray) -> Dict:
    """|served - reference| in 8-bit levels (the reference unrounded):
    its mean, and the share of values more than 8 levels off."""
    gap = np.abs(served.astype(np.float64)
                 - np.clip(ref_rgb.astype(np.float64), 0.0, 1.0) * 255.0)
    return {"level_gap_mean": float(gap.mean()),
            "level_far_share": float(np.mean(gap > 8.0))}


def worst(readings) -> Dict[str, float]:
    """Each number's worst over several readings."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
