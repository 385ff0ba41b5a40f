"""The port's plotting and status tools (nerfmlp_torch/utils/plot.py, the
scripts plot_training_progress, view_progress, make_timelapse and
side_by_side_compare, and the train CLIs' end-of-run figures) against
the JAX package's scripts (tests/test_cli.py:220-260, :588), on the CPU.

Bars: view_progress prints JAX's text, the header's package name masked;
side_by_side_compare's image equals the JAX script's pixel for pixel (the
port's LANCZOS is Pillow's, bit for bit); make_timelapse's frames come in
step order; each figure takes what JAX's takes (missing keys, histories
of uneven lengths) and draws every series where its data lies, read back
from the canvas.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from nerfmlp_torch.scripts import make_timelapse, plot_training_progress
from nerfmlp_torch.scripts import side_by_side_compare, view_progress
from nerfmlp_torch.utils import plot
from nerfmlp_torch.utils.image import read_png, save_png


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(kind: str) -> dict:
    """A metrics JSON as the Trainer writes it: whole, with histories of
    uneven lengths (a skipped quick validation), partial (keys missing),
    or empty."""
    steps = list(range(100, 2100, 100))
    rng = np.random.default_rng(0)
    m = {
        "step": 2000, "best_val_psnr": 26.5, "val_steps": steps,
        "train_losses": list(np.geomspace(0.05, 0.002, 20)),
        "train_psnrs": list(np.linspace(13.0, 27.0, 20)),
        "quick_val_losses": list(np.geomspace(0.1, 0.01, 20)),
        "quick_val_psnrs": list(np.linspace(10.0, 20.0, 20)),
        "quick_val_ssims": list(np.linspace(0.3, 0.9, 20)),
        "full_val_losses": [0.02, 0.004], "full_val_psnrs": [17.0, 24.0],
        "full_val_ssims": [0.6, 0.85], "full_val_steps": [1000, 2000],
        "iteration_times": list(0.015 + 0.003 * rng.random(500)),
        "config": {"train": {"lr": 5e-4, "lr_decay_rate": 0.1,
                             "lr_decay_steps": 2000},
                   "render": {"N_samples": 64, "N_importance": 128}},
    }
    if kind == "uneven":
        m["quick_val_losses"] = m["quick_val_losses"][:17]
        m["quick_val_ssims"] = m["quick_val_ssims"][:12]
        m["val_steps"] = steps[:18]
    elif kind == "partial":
        for k in ("train_losses", "quick_val_ssims", "full_val_psnrs",
                  "iteration_times", "config", "best_val_psnr"):
            del m[k]
    elif kind == "empty":
        m = {}
    return m


def _write(tmp_path, m, name="metrics_latest.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(m, f)
    return path


# -- view_progress ------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["whole", "uneven", "partial", "empty"])
def test_view_progress_prints_jax_text(kind, tmp_path):
    from scripts import view_progress as jax_view

    path = _write(tmp_path, _metrics(kind))
    outs = []
    for mod in (view_progress, jax_view):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(["--metrics", path]) == 0
        outs.append(buf.getvalue())
    ours, theirs = outs
    assert "NeRF TRAINING STATUS (nerfmlp_torch)" in ours
    assert ours.replace("nerfmlp_torch", "<pkg>") == theirs.replace(
        "nerfmlp_tpu", "<pkg>")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert view_progress.main(["--metrics-dir", str(tmp_path)]) == 0
    assert buf.getvalue() == ours
    assert view_progress.main(["--metrics", str(tmp_path / "x.json")]) == 1


# -- side_by_side_compare ------------------------------------------------ #
@pytest.mark.parametrize("gt_wh", [(24, 16), (37, 29)], ids=["same_size",
                                                            "resized"])
def test_side_by_side_equals_jax(gt_wh, tmp_path):
    """[gt | rendered] through the flags and the positional interface, the
    ground truth a PNG with alpha (dropped, as convert("RGB") drops it)
    or a JPEG, resized with LANCZOS where the sizes differ."""
    from scripts import side_by_side_compare as jax_sbs

    rng = np.random.default_rng(1)
    rendered = str(tmp_path / "r.png")
    save_png(rendered, rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
    gts = {"png": str(tmp_path / "gt.png"), "jpg": str(tmp_path / "gt.jpg")}
    px = rng.integers(0, 256, (gt_wh[1], gt_wh[0], 4), dtype=np.uint8)
    save_png(gts["png"], px)
    Image.fromarray(px[..., :3]).save(gts["jpg"], quality=90)
    for kind, gt in gts.items():
        ours, theirs = str(tmp_path / f"o_{kind}.png"), str(
            tmp_path / f"t_{kind}.png")
        side_by_side_compare.main([rendered, ours, "--gt", gt])
        jax_sbs.main(["--rendered", rendered, "--gt", gt, "--out", theirs])
        got = read_png(ours)
        assert got.shape == (16, 48, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(theirs)))
    # The dataset-index form: <datadir>/<split>/r_{i}.png.
    os.makedirs(tmp_path / "data" / "val")
    save_png(str(tmp_path / "data" / "val" / "r_3.png"), px[..., :3])
    out = side_by_side_compare.main(["--rendered", rendered, "--datadir",
                                     str(tmp_path / "data"), "--split", "val",
                                     "--index", "3", "--out",
                                     str(tmp_path / "idx.png")])
    np.testing.assert_array_equal(read_png(out), read_png(
        str(tmp_path / "o_png.png")))


# -- make_timelapse ------------------------------------------------------ #
def test_make_timelapse_orders_frames_by_step(tmp_path):
    """Frames named so that their names sort otherwise (val_900 after
    val_10000): the GIF holds them in step order, one frame each."""
    run = tmp_path / "run"
    run.mkdir()
    colors = {900: (0, 0, 255), 1000: (255, 0, 0), 10000: (0, 255, 0)}
    for step, rgb in colors.items():
        save_png(str(run / f"val_{step}.png"),
                 np.broadcast_to(np.array(rgb, np.uint8), (8, 8, 3)).copy())
    (run / "val_latest.png").write_bytes(b"")      # not a step: ignored
    out = make_timelapse.main(["--run_dir", str(run), "--fps", "5"])
    assert out == str(run / "timelapse.gif")
    with Image.open(out) as gif:
        frames = []
        for i in range(gif.n_frames):
            gif.seek(i)
            frames.append(tuple(np.asarray(gif.convert("RGB"))[4, 4]))
    assert frames == [colors[s] for s in sorted(colors)]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert make_timelapse.main(["--run_dir", str(empty)]) is None


# -- the figures --------------------------------------------------------- #
def _drawn_where_data_lies(fig):
    """Every series of every panel: at least 90% of its points that fall
    inside its panel's data area show its colour within a pixel."""
    px = fig.canvas.px
    n_series = 0
    for ax in fig.axes:
        for x, y, color, *_ in ax.series:
            cols, rows = ax.to_pixel(x, y)
            x0, y0, x1, y1 = ax.area
            ok = (np.isfinite(cols) & np.isfinite(rows) & (cols >= x0 + 1)
                  & (cols < x1 - 1) & (rows >= y0 + 1) & (rows < y1 - 1))
            if not ok.any():
                continue
            n_series += 1
            hits = 0
            for c, r in zip(np.rint(cols[ok]).astype(int),
                            np.rint(rows[ok]).astype(int)):
                patch = px[r - 1:r + 2, c - 1:c + 2].reshape(-1, 3)
                hits += bool((patch == np.array(color)).all(1).any())
            assert hits >= 0.9 * ok.sum(), (ax.title, color, hits, ok.sum())
    return n_series


@pytest.mark.parametrize("kind", ["whole", "uneven", "partial", "empty"])
@pytest.mark.parametrize("figure", ["progress", "comprehensive",
                                    "convergence"])
def test_figures_draw_each_series_where_its_data_lies(figure, kind,
                                                      tmp_path):
    """Each figure takes what JAX's takes and writes a PNG; read back, every
    series sits at its data's pixels."""
    m = _metrics(kind)
    build = getattr(plot_training_progress, f"{figure}_figure")
    fig = build(m)
    img = fig.render()
    assert img.dtype == np.uint8 and img.shape == (fig.height, fig.width, 3)
    n = _drawn_where_data_lies(fig)
    if kind == "whole":
        assert n == {"progress": 8, "comprehensive": 11,
                     "convergence": 4}[figure]
    elif kind == "empty":
        assert n == 0
    path = _write(tmp_path, m)
    out = {"progress": plot_training_progress.create_progress_plot,
           "comprehensive": plot_training_progress.create_comprehensive_report,
           "convergence": plot_training_progress.create_convergence_plot}[
        figure](path, str(tmp_path / "fig.png"))
    np.testing.assert_array_equal(read_png(out), img)


def test_figures_have_jax_titles():
    """The panels, in JAX's order, with JAX's titles."""
    fig = plot_training_progress.comprehensive_figure(_metrics("whole"))
    assert [ax.title for ax in fig.axes] == [
        "Training vs Validation Loss Convergence",
        "Training vs Validation PSNR", "Overfitting Indicator",
        "Learning Rate Schedule", "SSIM Progress",
        "Training Time per Iteration", "Full Validation Loss",
        "Full Validation PSNR"]
    fig = plot_training_progress.progress_figure(_metrics("whole"))
    assert [ax.title for ax in fig.axes] == [
        "Loss (log)", "PSNR (dB)", "SSIM (quick val)",
        "|train - val| loss gap (overfitting)", "iter time (ms)", "summary"]
    assert fig.title == "NeRF training progress (nerfmlp_torch)"
    assert [ax.title for ax in plot_training_progress.convergence_figure(
        _metrics("whole")).axes] == ["Convergence: loss",
                                     "Convergence: PSNR (dB)"]


def test_plot_cli_flags(tmp_path):
    """JAX's flags: --metrics-file and --save-dir (training_progress.png)."""
    path = _write(tmp_path, _metrics("whole"))
    out = plot_training_progress.main(["--metrics-file", path, "--save-dir",
                                       str(tmp_path / "plots")])
    assert out == str(tmp_path / "plots" / "training_progress.png")
    assert read_png(out).shape == (990, 1760, 3)


def test_text_and_ticks():
    """The bitmap font covers printable ASCII, 6 columns a glyph; ticks
    fall on round values inside the range."""
    m = plot.text_mask("Loss 0.5 dB", 2)
    assert m.shape == (14, 2 * (6 * 11 - 1)) and m.any()
    assert not plot.text_mask(" ").any()
    np.testing.assert_array_equal(plot.text_mask("Δ"),
                                  plot.text_mask("?"))
    assert plot.nice_ticks(0.0, 1.0) == [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    assert plot.nice_ticks(103.0, 1987.0) == [500.0, 1000.0, 1500.0]
    assert plot.log_ticks(-3.2, -0.9) == [-3.0, -2.0, -1.0]


# -- the CLIs' end-of-run figures ----------------------------------------- #
def test_train_clis_write_their_figures(tmp_path):
    """The train CLI writes JAX's three end-of-run figures; train_only its
    loss / PSNR plot, which it skipped before this port drew plots."""
    from nerfmlp_torch.scripts import train as train_cli
    from nerfmlp_torch.scripts import train_only

    out = tmp_path / "run"
    train_cli.main(["--datadir", str(tmp_path / "scene"),
                    "--make_synthetic_scene", "--img_wh", "16", "16",
                    "--device", "cpu", "--iters", "4", "--batch_size", "64",
                    "--N_samples", "8", "--N_importance", "0", "--netdepth",
                    "2", "--netwidth", "32", "--quick_val_interval", "2",
                    "--quick_val_subset", "1", "--quick_val_res", "16", "16",
                    "--full_val_interval", "0", "--save_dir", str(out)])
    for name, shape in (("training_report.png", (990, 1760, 3)),
                        ("convergence_plot.png", (440, 1210, 3)),
                        ("comprehensive_metrics.png", (1440, 1800, 3))):
        assert read_png(str(out / name)).shape == shape, name
    to = tmp_path / "to"
    train_only.main(["--datadir", str(tmp_path / "scene"), "--img_wh", "16",
                     "16", "--device", "cpu", "--iters", "200",
                     "--batch_size", "32", "--N_samples", "4",
                     "--N_importance", "0", "--save_dir", str(to)])
    assert read_png(str(to / "training_progress.png")).shape == (440, 1100, 3)
