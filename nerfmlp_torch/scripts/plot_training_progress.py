"""Training-progress figures from a Trainer's metrics JSON, drawn without
matplotlib.

The PyTorch counterpart of ``scripts/plot_training_progress.py``, with its
figures, panels, titles, series, file names and flags, drawn by the
port's numpy plotter (``nerfmlp_torch/utils/plot.py``), so it runs where
no plotting package is installed:

  * :func:`create_progress_plot`: the 2x3 figure (loss, log y; PSNR;
    SSIM; the train / val loss gap; iteration times; a text summary);
  * :func:`create_comprehensive_report`: the 3x3 end-of-run figure (loss
    and PSNR convergence, the gap, the learning-rate schedule from the
    run's recorded config, SSIM, iteration times, the full-validation loss
    and PSNR);
  * :func:`create_convergence_plot`: the 1x2 loss / PSNR figure;
  * ``--live``: redraw whenever the JSON changes.

Histories of uneven lengths (a quick validation that was skipped) and
missing keys are drawn as far as they go, as JAX's ``_xy`` allows.

Examples:
    python -m nerfmlp_torch.scripts.plot_training_progress \\
        --metrics outputs/run/metrics_latest.json --out progress.png
    python -m nerfmlp_torch.scripts.plot_training_progress \\
        --metrics-file outputs/run/metrics_latest.json --save-dir plots --live
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nerfmlp_torch.utils.plot import Figure, subplots


def _xy(steps, ys):
    """x and y cut to the shorter one's length: histories can outrun
    val_steps when a quick validation was skipped."""
    n = min(len(steps), len(ys))
    return steps[:n], ys[:n]


def _load(metrics_path):
    with open(metrics_path) as f:
        return json.load(f)


def _create_plots_on_axes(axes, m):
    """The six panels of the progress figure on ``axes`` (JAX's
    ``_create_plots_on_axes``)."""
    val_steps = m.get("val_steps", [])
    tl, tp = m.get("train_losses", []), m.get("train_psnrs", [])
    ql, qp, qs = (m.get("quick_val_losses", []),
                  m.get("quick_val_psnrs", []),
                  m.get("quick_val_ssims", []))

    ax = axes[0]
    if tl:
        ax.semilogy(*_xy(val_steps, tl), label="train")
    if ql:
        ax.semilogy(*_xy(val_steps, ql), label="quick val")
    ax.set_title("Loss (log)")
    ax.set_xlabel("iter")
    ax.legend()

    ax = axes[1]
    if tp:
        ax.plot(*_xy(val_steps, tp), label="train")
    if qp:
        ax.plot(*_xy(val_steps, qp), label="quick val")
    fvp, fvs = m.get("full_val_psnrs", []), m.get("full_val_steps", [])
    if fvp:
        ax.plot(*_xy(fvs, fvp), "o-", label="full val")
    ax.set_title("PSNR (dB)")
    ax.set_xlabel("iter")
    ax.legend()

    ax = axes[2]
    if qs:
        ax.plot(*_xy(val_steps, qs))
    ax.set_title("SSIM (quick val)")
    ax.set_xlabel("iter")

    ax = axes[3]
    if tl and ql:
        n = min(len(tl), len(ql))
        gap = [abs(a - b) for a, b in zip(tl[:n], ql[:n])]
        ax.semilogy(*_xy(val_steps, gap))
    ax.set_title("|train - val| loss gap (overfitting)")
    ax.set_xlabel("iter")

    ax = axes[4]
    it = m.get("iteration_times", [])
    if it:
        it_ms = np.asarray(it[-20000:]) * 1e3
        ax.plot(np.arange(len(it_ms)), it_ms, lw=0.6)
        ax.set_ylim(0, np.percentile(it_ms, 99) * 1.5)
    ax.set_title("iter time (ms)")
    ax.set_xlabel("recent iters")

    ax = axes[5]
    ax.axis("off")
    lines = [f"step: {m.get('step', 0):,}",
             f"best quick-val PSNR: {m.get('best_val_psnr', 0):.2f} dB"]
    if qp:
        lines.append(f"latest quick-val PSNR: {qp[-1]:.2f} dB")
    if ql:
        lines.append(f"latest quick-val loss: {ql[-1]:.6f}")
    if it:
        lines.append(f"median iter time: "
                     f"{np.median(np.asarray(it)) * 1e3:.1f} ms")
    ax.text(0.02, 0.95, "\n".join(lines))
    ax.set_title("summary")


def progress_figure(m) -> Figure:
    """The 2x3 progress figure of metrics ``m``."""
    fig, axes = subplots(2, 3, 1760, 990)
    _create_plots_on_axes(axes, m)
    fig.suptitle("NeRF training progress (nerfmlp_torch)")
    return fig


def create_progress_plot(metrics_path, out_path=None):
    """The 2x3 progress figure of ``metrics_path``, written to
    ``out_path`` (default: the JSON's path with ``.png``)."""
    fig = progress_figure(_load(metrics_path))
    out_path = out_path or metrics_path.replace(".json", ".png")
    fig.savefig(out_path)
    print(f"wrote {out_path}")
    return out_path


def comprehensive_figure(m) -> Figure:
    """The end-of-run 3x3 figure of metrics ``m`` (JAX's
    ``create_comprehensive_report``): loss and PSNR convergence, the
    overfitting gap, the learning-rate schedule from the run's recorded
    config, SSIM, iteration times and the full-validation loss and
    PSNR."""
    steps = m.get("val_steps", [])
    tl, tp = m.get("train_losses", []), m.get("train_psnrs", [])
    ql, qp, qs = (m.get("quick_val_losses", []),
                  m.get("quick_val_psnrs", []),
                  m.get("quick_val_ssims", []))
    fvl, fvp, fvs, fsteps = (m.get("full_val_losses", []),
                             m.get("full_val_psnrs", []),
                             m.get("full_val_ssims", []),
                             m.get("full_val_steps", []))
    fig = Figure(1800, 1440)

    def panel(index, title, xlabel, ylabel):
        ax = fig.subplot(3, 3, index)
        ax.set_title(title)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.grid(True)
        return ax

    ax = panel((1, 2), "Training vs Validation Loss Convergence",
               "Iteration", "Loss")
    if tl:
        ax.plot(*_xy(steps, tl), "o-", ms=4, color="tab:blue",
                label="Training Loss")
    if ql:
        ax.plot(*_xy(steps, ql), "s-", ms=4, color="tab:red",
                label="Validation Loss")
    ax.set_yscale("log")
    ax.legend()

    ax = panel(3, "Training vs Validation PSNR", "Iteration", "PSNR (dB)")
    if tp:
        ax.plot(*_xy(steps, tp), "o-", ms=4, color="tab:green",
                label="Training PSNR")
    if qp:
        ax.plot(*_xy(steps, qp), "s-", ms=4, color="tab:orange",
                label="Validation PSNR")
    ax.legend()

    ax = panel(4, "Overfitting Indicator", "Iteration", "|Train - Val Loss|")
    if tl and ql:
        n = min(len(tl), len(ql))
        ax.plot(*_xy(steps, [abs(a - b) for a, b in zip(tl[:n], ql[:n])]),
                "o-", ms=3, color="tab:purple")
        ax.set_yscale("log")

    ax = panel(5, "Learning Rate Schedule", "Iteration", "Learning Rate")
    cfg_train = m.get("config", {}).get("train", {})
    lr0 = cfg_train.get("lr", 5e-4)
    rate = cfg_train.get("lr_decay_rate", 0.1)
    dsteps = max(cfg_train.get("lr_decay_steps", 250_000), 1)
    if steps:
        ax.plot(steps, [lr0 * rate ** (s / dsteps) for s in steps], "o-",
                ms=3, color="tab:brown")
        ax.set_yscale("log")

    ax = panel(6, "SSIM Progress", "Iteration", "SSIM")
    if qs:
        ax.plot(*_xy(steps, qs), "s-", ms=3, color="tab:green",
                label="Quick Val SSIM")
    if fvs:
        ax.plot(*_xy(fsteps, fvs), "^-", ms=4, color="tab:orange",
                label="Full Val SSIM")
    ax.legend()

    ax = panel(7, "Training Time per Iteration", "Recent Iterations",
               "Time (seconds)")
    it = m.get("iteration_times", [])
    if it:
        ax.plot(np.asarray(it[-1000:]), color="tab:purple")

    ax = panel(8, "Full Validation Loss", "Iteration", "Loss")
    if fvl:
        ax.plot(*_xy(fsteps, fvl), "^-", ms=4, color="tab:red",
                label="Full Val Loss")
        ax.set_yscale("log")
        ax.legend()

    ax = panel(9, "Full Validation PSNR", "Iteration", "PSNR (dB)")
    if fvp:
        ax.plot(*_xy(fsteps, fvp), "^-", ms=4, color="tab:orange",
                label="Full Val PSNR")
        ax.legend()
    return fig


def create_comprehensive_report(metrics_path, out_path=None):
    """:func:`comprehensive_figure` of ``metrics_path``, written to
    ``out_path`` (default: ``comprehensive_metrics.png`` beside it)."""
    fig = comprehensive_figure(_load(metrics_path))
    out_path = out_path or os.path.join(os.path.dirname(metrics_path),
                                        "comprehensive_metrics.png")
    fig.savefig(out_path)
    print(f"wrote {out_path}")
    return out_path


def convergence_figure(m) -> Figure:
    """The 1x2 loss / PSNR convergence figure of metrics ``m`` (JAX's
    ``create_convergence_plot``)."""
    steps = m.get("val_steps", [])
    fig, (a1, a2) = subplots(1, 2, 1210, 440)
    if m.get("train_losses"):
        a1.semilogy(*_xy(steps, m["train_losses"]), label="train")
    if m.get("quick_val_losses"):
        a1.semilogy(*_xy(steps, m["quick_val_losses"]), label="val")
    a1.set_title("Convergence: loss")
    a1.set_xlabel("iter")
    a1.legend()
    if m.get("train_psnrs"):
        a2.plot(*_xy(steps, m["train_psnrs"]), label="train")
    if m.get("quick_val_psnrs"):
        a2.plot(*_xy(steps, m["quick_val_psnrs"]), label="val")
    a2.set_title("Convergence: PSNR (dB)")
    a2.set_xlabel("iter")
    a2.legend()
    return fig


def create_convergence_plot(metrics_path, out_path=None):
    """:func:`convergence_figure` of ``metrics_path``, written to
    ``out_path`` (default: the JSON's path with ``_convergence.png``)."""
    fig = convergence_figure(_load(metrics_path))
    out_path = out_path or metrics_path.replace(".json", "_convergence.png")
    fig.savefig(out_path)
    print(f"wrote {out_path}")
    return out_path


def end_of_run_figures(save_dir: str) -> None:
    """The train CLIs' three end-of-run figures in ``save_dir``
    (``training_report.png``, ``convergence_plot.png``,
    ``comprehensive_metrics.png``; JAX's ``scripts/train.py:563-600``),
    best-effort: a failure is printed and training's result stands."""
    try:
        metrics_json = os.path.join(save_dir, "metrics_latest.json")
        create_progress_plot(metrics_json, out_path=os.path.join(
            save_dir, "training_report.png"))
        create_convergence_plot(metrics_json, out_path=os.path.join(
            save_dir, "convergence_plot.png"))
        # The comprehensive report reads the end-of-run snapshot (the
        # full-val series and the recorded config of the lr panel).
        comp_json = os.path.join(save_dir, "comprehensive_metrics.json")
        create_comprehensive_report(
            comp_json if os.path.exists(comp_json) else metrics_json,
            out_path=os.path.join(save_dir, "comprehensive_metrics.png"))
    except Exception as e:  # plotting is best-effort
        print(f"(plotting skipped: {e})")


def animate_progress(metrics_path, interval_s=5.0, out_path=None):
    """Live mode: redraw the figure whenever the JSON changes; Ctrl-C
    stops it."""
    last_mtime = 0.0
    while True:
        try:
            mtime = os.path.getmtime(metrics_path)
            if mtime > last_mtime:
                last_mtime = mtime
                create_progress_plot(metrics_path, out_path)
        except FileNotFoundError:
            print(f"waiting for {metrics_path} ...")
        except json.JSONDecodeError:
            pass  # caught mid-write; the next poll sees the whole file
        except KeyboardInterrupt:
            return
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:
            return


def main(argv=None):
    p = argparse.ArgumentParser(description="Plot NeRF training progress")
    p.add_argument("--metrics", "--metrics-file", type=str,
                   default="outputs/checkpoints/metrics_latest.json",
                   help="metrics JSON (reference flag name: --metrics-file)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--save-dir", type=str, default=None,
                   help="write the figure as <save-dir>/training_progress.png")
    p.add_argument("--live", action="store_true")
    p.add_argument("--interval", type=float, default=5000.0,
                   help="--live refresh interval in MILLISECONDS")
    args = p.parse_args(argv)
    if args.save_dir is not None and args.out is None:
        args.out = os.path.join(args.save_dir, "training_progress.png")
        os.makedirs(args.save_dir, exist_ok=True)
    if args.live:
        animate_progress(args.metrics, interval_s=args.interval / 1000.0,
                         out_path=args.out)
        return None
    return create_progress_plot(args.metrics, args.out)


if __name__ == "__main__":
    main()
