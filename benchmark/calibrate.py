"""Readings that the correctness limits are set from, on the card, at the
cells' own sizes: the program's numbers over many seeds, and the same
numbers of the precision control (the reference with fp8 products in the
program's place) and of planted faults.

    python -m benchmark.calibrate --workload paper_train \\
        --seeds 1 2 3 --control 1 2 3 --out readings.jsonl

Training cells: the program's set-up steps through the Trainer, as a run
takes them (the first steps and those from the state set-up reaches);
the control and the half-batch fault (the loss over half of each batch)
are the reference's own steps, held against the float32 reference.
Frame cells: ``check_frames`` frames through ``render_request``; the
control renders the same cameras in fp8, and the altered-answer fault
inverts one tile of each served frame.

One JSON line per seed and reading kind. The benchmark's runs never call
this.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from benchmark import check, harness
from benchmark.drivers import frames, train
from benchmark.reference import fp8, nerf, png


def train_seed(cell, seed: int, device, control: bool) -> dict:
    tr = cell.traffic
    with tempfile.TemporaryDirectory() as tmp:
        trainer, views, weights, t_seed = train.build(cell, seed, device, tmp)
        done = train.set_up(trainer, tr, device)
        del trainer
    torch.cuda.empty_cache()
    variants = ({"control": {"quant": fp8.fp8_linear},
                 "half_batch": {"half_batch": True}} if control else {})
    return check.train_check(cell.config, weights, views, t_seed,
                             tr["check_steps"], device, done["first"],
                             done["kept"], done["late"], variants,
                             leaves=True)


def frames_seed(cell, seed: int, device, control: bool) -> dict:
    cfg, tr = cell.config, cell.traffic
    svc, weights, focal = frames.build(cell, seed, device)
    rng = np.random.default_rng(harness.subseed(seed, harness.POSES))
    thetas = [float(t) for t in rng.uniform(*tr["theta_deg"],
                                            tr["check_frames"])]
    served = [png.decode(svc.render_request(frames.request(tr, t))[0])
              for t in thetas]
    tile = cfg["serve"]["tile"]
    del svc
    torch.cuda.empty_cache()
    density = frames.reference_density(cfg, weights, device)
    refs = [check.reference_frame(
        cfg, weights, nerf.pose_spherical(t, tr["phi_deg"],
                                                 tr["radius"]),
        tr["H"], tr["W"], focal, tile, device, density) for t in thetas]
    out = {"program": check.worst(check.frame_readings(s[..., :3], r)
                                  for s, r in zip(served, refs))}
    if control:
        dens8 = frames.reference_density(cfg, weights, device,
                                         fp8.fp8_linear)
        ctl = [check.reference_frame(
            cfg, weights, nerf.pose_spherical(t, tr["phi_deg"],
                                                     tr["radius"]),
            tr["H"], tr["W"], focal, tile, device, dens8, fp8.fp8_linear)
            for t in thetas]
        out["control"] = check.worst(
            check.frame_readings(check.levels(c), r)
            for c, r in zip(ctl, refs))
        altered = []
        for s in served:
            a = s[..., :3].copy().reshape(-1, 3)
            a[:tile] = 255 - a[:tile]
            altered.append(a.reshape(s[..., :3].shape))
        out["altered_answer"] = check.worst(
            check.frame_readings(a, r) for a, r in zip(altered, refs))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from benchmark.run import cache_dirs

    cache_dirs(harness.ROOT)
    cell = harness.load_cell(args.workload)
    one = train_seed if cell.traffic["kind"] == "train" else frames_seed
    with open(args.out, "a") as f:
        for seed in sorted(set(args.seeds) | set(args.control)):
            rec = one(cell, seed, "cuda", seed in args.control)
            for kind, r in rec.items():
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "kind": kind, **r})
                print(line, flush=True)
                f.write(line + "\n")


if __name__ == "__main__":
    main()
