"""A terminal status of a training run from its metrics JSON.

The PyTorch counterpart of ``scripts/view_progress.py``: the same text
(step, best PSNR, the latest quick validation, the improvement since the
first, an overfitting warning, the median iteration time and iterations
per hour, the recorded config), with the port's package name in the
header. It reads only the JSON.

Example:
    python -m nerfmlp_torch.scripts.view_progress \\
        --metrics outputs/run/metrics_latest.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_latest_metrics(path):
    """The metrics JSON at ``path``, or None where there is none."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def display_progress(m):
    """Print the status of metrics ``m``."""
    step = m.get("step", 0)
    print("=" * 64)
    print("NeRF TRAINING STATUS (nerfmlp_torch)")
    print("=" * 64)
    print(f"step:                {step:,}")
    print(f"best quick-val PSNR: {m.get('best_val_psnr', 0.0):.2f} dB")

    ql = m.get("quick_val_losses", [])
    qp = m.get("quick_val_psnrs", [])
    qs = m.get("quick_val_ssims", [])
    tl = m.get("train_losses", [])
    if qp:
        # Each part gated on its own list: hand-edited files can hold
        # these histories at different lengths.
        parts = [f"loss {ql[-1]:.6f}"] if ql else []
        parts.append(f"PSNR {qp[-1]:.2f}")
        if qs:
            parts.append(f"SSIM {qs[-1]:.4f}")
        print("latest quick val:    " + " | ".join(parts))
    if len(qp) > 1:
        print(f"PSNR improvement:    {qp[-1] - qp[0]:+.2f} dB since first "
              "validation")

    # Overfitting heuristic: a train / val gap above half the val loss.
    if tl and ql:
        gap = abs(tl[-1] - ql[-1])
        if gap > 0.5 * ql[-1]:
            print(f"⚠️  possible overfitting: |train-val| gap {gap:.6f} "
                  f"> 50% of val loss {ql[-1]:.6f}")

    it = m.get("iteration_times", [])
    if it:
        med = float(np.median(it[-1000:]))
        print(f"median iter time:    {med * 1e3:.1f} ms  "
              f"({3600.0 / med:,.0f} iters/hour)")

    cfg = m.get("config", {})
    if cfg:
        print("-" * 64)
        print("config:")
        for section, d in cfg.items():
            if isinstance(d, dict):
                kv = " ".join(f"{k}={v}" for k, v in list(d.items())[:8])
                print(f"  {section}: {kv}")
    print("=" * 64)


def main(argv=None):
    p = argparse.ArgumentParser(description="Show NeRF training status")
    p.add_argument("--metrics", type=str,
                   default="outputs/checkpoints/metrics_latest.json")
    p.add_argument("--metrics-dir", type=str, default=None,
                   help="run directory; reads <dir>/metrics_latest.json")
    args = p.parse_args(argv)
    if args.metrics_dir is not None:
        args.metrics = os.path.join(args.metrics_dir, "metrics_latest.json")
    m = load_latest_metrics(args.metrics)
    if m is None:
        print(f"no metrics found at {args.metrics} — is training running?")
        return 1
    display_progress(m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
