"""Tiny sizes for the benchmark's CPU tests: a cell's configuration and
traffic cut down so that a whole run takes seconds on the CPU."""

from __future__ import annotations

import argparse

from benchmark import run as bench_run


def shrink(cell) -> None:
    c, t = cell.config, cell.traffic
    c["model"].update(depth=2, width=32, skips=[])
    r = c["render"]
    r.update(N_samples=8, N_importance=8)
    if r.get("use_occupancy"):
        r.update(occ_grid_size=8, occ_dense_samples=8, occ_warmup_steps=8,
                 occ_update_every=4)
    c["train"].update(batch_size=64, steps_per_dispatch=4)
    if c["train"].get("precrop_iters"):
        c["train"]["precrop_iters"] = 4
    c["scene"].update(n_views=4, H=16, W=16, gt_samples=32)
    c["serve"]["tile"] = 64
    if t["kind"] == "train":
        t.update(setup_past_steps=8, step_multiple=4,
                 trace_steps=8)
    else:
        t.update(H=32, W=32, trace_frames=2, check_frames=2)


def tiny_run(workload: str, seed: int = 2 ** 31 + 5, trace: int = 0):
    """One whole run of ``workload`` on the CPU at the tiny size: its
    result line."""
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.5,
                              trace=trace)
    return bench_run.run(args, device="cpu", overrides=shrink)
