"""A minimal trainer with no validation, to see that a model learns:
short runs, PSNR from the loss, periodic checkpoints and the metrics
JSON, on one GPU (or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/train_only.py``, with its flags, its
``model_{step}.pt`` / ``metrics_{step}.json`` every 1,000 steps and its
``final_metrics.json``, and its best-effort loss / PSNR plot,
``training_progress.png``, drawn by the port's numpy plotter
(``utils/plot.py``: no matplotlib). Beside the JAX CLI: ``--device``, and
``--no_kernel`` as an alias of ``--no_pallas``.

Example:
    python -m nerfmlp_torch.scripts.train_only --datadir /tmp/scene \\
        --img_wh 64 64 --iters 2000
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from nerfmlp_torch.utils.cli import add_device_flags


def build_parser():
    p = argparse.ArgumentParser(
        description="Minimal NeRF training (learning smoke test)")
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--img_wh", type=int, nargs=2, default=[64, 64])
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--iters", type=int, default=10000)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--save_dir", type=str, default="outputs/train_only")
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=128)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    add_device_flags(p)
    return p


def main(argv=None):
    """Returns (losses, psnrs), one of each per 100 steps."""
    args = build_parser().parse_args(argv)

    import torch

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig, TrainConfig
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.data.pipeline import RayBatchLoader
    from nerfmlp_torch.parallel.train_step import (
        create_train_state, make_step_fn,
    )
    from nerfmlp_torch.train.checkpoint import save_metrics_json, save_params

    device = resolve_device(args.device)
    use_true_fp32()
    os.makedirs(args.save_dir, exist_ok=True)
    ds = BlenderDataset(args.datadir, "train", img_wh=tuple(args.img_wh))
    near, far = ds.dynamic_near_far()
    print(f"near/far: {near:.3f}/{far:.3f} | rays: {len(ds):,}")
    rc = RenderConfig(N_samples=args.N_samples,
                      N_importance=args.N_importance, near=near, far=far,
                      perturb=True, compute_dtype=args.compute_dtype,
                      use_kernel=args.use_kernel)
    tc = TrainConfig(batch_size=args.batch_size, iters=args.iters,
                     lr=args.lr)
    state = create_train_state(rc, tc, device)
    step_fn = make_step_fn(rc, tc)
    loader = RayBatchLoader.from_dataset(ds, tc.batch_size)

    losses, psnrs, iter_times = [], [], []
    t0 = t_prev = time.time()
    for step in range(1, args.iters + 1):
        batch = torch.from_numpy(loader.next_batch()).to(device)
        m = step_fn(state, batch)
        now = time.time()
        iter_times.append(now - t_prev)
        t_prev = now
        if step % 100 == 0:
            loss = float(m["loss"])
            psnr = float(20.0 * np.log10(1.0 / np.sqrt(max(loss, 1e-12))))
            losses.append(loss)
            psnrs.append(psnr)
            print(f"iter {step:6d} | loss {loss:.6f} | psnr {psnr:.2f} | "
                  f"{step / (time.time() - t0):,.0f} it/s")
        if step % 1000 == 0:
            save_params(os.path.join(args.save_dir, f"model_{step}.pt"),
                        state.params)
            save_metrics_json(
                os.path.join(args.save_dir, f"metrics_{step}.json"),
                {"step": step, "losses": losses, "psnrs": psnrs})
    save_params(os.path.join(args.save_dir, "model_final.pt"), state.params)
    save_metrics_json(os.path.join(args.save_dir, "final_metrics.json"), {
        "train_losses": losses, "train_psnrs": psnrs,
        "final_loss": losses[-1] if losses else None,
        "final_psnr": psnrs[-1] if psnrs else None,
        "total_training_time": time.time() - t0,
        "iteration_times": iter_times,
        "losses": losses, "psnrs": psnrs, "iters": args.iters,
        "config": {"batch_size": args.batch_size, "learning_rate": args.lr,
                   "total_iterations": args.iters,
                   "img_wh": list(args.img_wh)},
    })
    try:
        from nerfmlp_torch.utils.plot import subplots

        fig, (a1, a2) = subplots(1, 2, 1100, 440)
        xs = np.arange(1, len(losses) + 1) * 100
        a1.semilogy(xs, losses)
        a1.set_title("loss")
        a1.set_xlabel("iter")
        a2.plot(xs, psnrs)
        a2.set_title("train PSNR (dB)")
        a2.set_xlabel("iter")
        fig.savefig(os.path.join(args.save_dir, "training_progress.png"))
        print(f"saved {args.save_dir}/training_progress.png")
    except Exception as e:
        print(f"(plot skipped: {e})")
    if losses:
        print(f"final loss {losses[-1]:.6f}, PSNR {psnrs[-1]:.2f}")
    else:
        print(f"done ({args.iters} iters; below the 100-step metric "
              "interval)")
    return losses, psnrs


if __name__ == "__main__":
    main()
