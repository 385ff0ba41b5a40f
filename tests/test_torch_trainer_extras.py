"""The port's Trainer extras on the CPU, against the JAX Trainer where it
has them: the profiler window (TrainConfig.profile_dir), TensorBoard
(Trainer(tensorboard_dir=)) and --check_numerics (the JAX CLI's
jax_debug_nans), and the train CLI's three flags.

Bars: the TensorBoard tags and steps equal the JAX Trainer's; its scalars,
from the same weights, batches and deterministic sampling, at the JAX
package's scan bars (tests/test_train_loop.py:385-411: losses and PSNRs
rtol 1e-3), for the gradient norm the port's step-parity bar
(tests/test_torch_multi_scene.py: rtol 5e-2), for the held-out renders'
the render path's (BARS below).
"""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JRC
from nerfmlp_tpu.config import TrainConfig as JTC
from nerfmlp_tpu.data.blender import BlenderDataset as JDS
from nerfmlp_tpu.models.import_torch import params_to_torch_state_dict
from nerfmlp_tpu.parallel import train_step as jts
from nerfmlp_tpu.train import loop as jloop

from nerfmlp_torch import check_numerics, numerics_checked
from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.scripts import train as train_cli
from nerfmlp_torch.train.loop import Trainer

WH = (16, 16)
ARCH = dict(depth=2, width=32, N_samples=8, N_importance=8)
TC = TrainConfig(batch_size=64, iters=35, quick_val_interval=0,
                 full_val_interval=0, log_interval=0, ckpt_interval=0,
                 seed=1)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module, so that parallel test workers
    do not oversubscribe the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_synthetic_scene(root, n_train=3, n_val=1, n_test=1, img_wh=WH)
    return root


def _datasets(root, pkg=BlenderDataset):
    return (pkg(root, "train", img_wh=WH), pkg(root, "val", img_wh=WH))


def _trainer(scene, save_dir, verbose=False, **tc):
    """The Trainer on the fused MLP's path (bf16: its plain versions on the
    CPU)."""
    train_ds, val_ds = _datasets(scene)
    near, far = train_ds.dynamic_near_far()
    rc = RenderConfig(near=near, far=far, compute_dtype="bfloat16",
                      use_kernel=True, **ARCH)
    return Trainer(rc, dataclasses.replace(TC, **tc), train_ds, val_ds,
                   save_dir=str(save_dir), device="cpu", verbose=verbose)


# -- the profiler window --------------------------------------------------- #
def _traced_steps(profile_dir):
    """{trace file name: the steps its ``train step N`` ranges cover}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(profile_dir, "*.json"))):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        out[os.path.basename(path)] = sorted(
            int(e["name"].split()[-1]) for e in events
            if e.get("name", "").startswith("train step "))
    return out


@pytest.mark.parametrize("iters, first, last", [(35, 10, 29), (20, 10, 20)])
def test_profile_window(scene, tmp_path, iters, first, last):
    """One trace of steps 10-29, counted from the run's start (JAX's
    s - start_step == 10 ... 30); a run that ends inside the window closes
    its trace after the loop."""
    prof = str(tmp_path / "prof")
    _trainer(scene, tmp_path / "run", iters=iters, profile_dir=prof).train()
    name = f"train_steps_{first:06d}-{last:06d}.rank0.pt.trace.json"
    assert _traced_steps(prof) == {name: list(range(first, last + 1))}


def test_profile_window_of_a_resumed_run(scene, tmp_path):
    """A run resumed at step 12 traces its own steps 10-29: 22-41."""
    first = _trainer(scene, tmp_path / "run", iters=12)
    first.train()
    prof = str(tmp_path / "prof")
    again = _trainer(scene, tmp_path / "run", iters=50, profile_dir=prof)
    assert again.resume(str(tmp_path / "run" / "metrics_latest.pt"))
    again.train()
    assert _traced_steps(prof) == {
        "train_steps_000022-000041.rank0.pt.trace.json": list(range(22, 42))}


def test_profile_runs_windows_step_by_step(scene, tmp_path, capsys):
    """steps_per_dispatch 4 with profile_dir: every step dispatched alone
    (no window runs), JAX's log line, every step of the window traced."""
    prof = str(tmp_path / "prof")
    t = _trainer(scene, tmp_path / "run", verbose=True, profile_dir=prof,
                 steps_per_dispatch=4)
    assert t.windows is not None
    t.windows.run_pool = t.windows.run_host = None    # must not be called
    t.train()
    assert ("(steps_per_dispatch disabled while profiling: the trace wants "
            "per-step dispatch boundaries)") in capsys.readouterr().out
    assert list(_traced_steps(prof).values()) == [list(range(10, 30))]
    assert t.state.step == 35


def test_profile_writes_one_trace_per_rank(scene, tmp_path):
    """--n_devices 2 on the CPU (two gloo ranks): each rank writes its own
    trace of the window, rank 0's and rank 1's."""
    prof = tmp_path / "prof"
    m = train_cli.main(["--datadir", scene, "--device", "cpu", "--n_devices",
                        "2", "--img_wh", "16", "16", "--netdepth", "2",
                        "--netwidth", "32", "--N_samples", "8",
                        "--N_importance", "8", "--batch_size", "64",
                        "--iters", "12", "--quick_val_interval", "12",
                        "--quick_val_res", "16", "16", "--quick_val_subset",
                        "1", "--profile_dir", str(prof),
                        "--save_dir", str(tmp_path / "out")])
    assert m["step"] == 12
    assert _traced_steps(str(prof)) == {
        f"train_steps_000010-000012.rank{r}.pt.trace.json": [10, 11, 12]
        for r in (0, 1)}


# -- TensorBoard ----------------------------------------------------------- #
# The scalars' bars: the scan bars for the train losses, the step-parity bar
# for the gradient norm, and for what a held-out render gives, the render
# path's (tests/test_torch_render_path.py: PSNR 1e-2 dB; the MSE to the
# same 1e-2 dB, rtol 10 ** 1e-3 - 1; SSIM of frames that meet the rgb bar
# 3e-3, measured 2.0e-3 apart near 0, held at 1e-2).
BARS = {"train/loss": dict(rtol=1e-3), "train/psnr": dict(rtol=1e-3),
        "train/grad_norm": dict(rtol=5e-2), "train/lr": dict(rtol=1e-6),
        "val/loss": dict(rtol=10 ** 1e-3 - 1), "val/psnr": dict(atol=1e-2),
        "test/psnr": dict(atol=1e-2), "val/ssim": dict(atol=1e-2)}
def _events(log_dir):
    """{kind: {tag: [(step, value or None)]}} of one event directory."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0,
                                                   "histograms": 0,
                                                   "images": 0})
    acc.Reload()
    tags = acc.Tags()
    return {
        "scalars": {t: [(e.step, e.value) for e in acc.Scalars(t)]
                    for t in tags["scalars"]},
        "histograms": {t: [(e.step, None) for e in acc.Histograms(t)]
                       for t in tags["histograms"]},
        "images": {t: [(e.step, None) for e in acc.Images(t)]
                   for t in tags["images"]},
    }


def test_tensorboard_tags_match_the_jax_trainer(scene, tmp_path):
    """Both Trainers from the same weights, host batches (the loaders draw
    the same rays from one seed) and deterministic sampling, with the same
    events: the same tags at the same steps; the scalars at the scan bars
    (train/grad_norm at the step-parity bar, train/lr exactly). Five steps:
    every event fires by step 4, and past it the two trajectories part
    through the fine pass's discontinuity (ROADMAP.md, Queue 3: 2.5e-3 of
    the loss at step 8), which this test does not hold."""
    loop = dict(batch_size=64, iters=5, log_interval=2, quick_val_interval=4,
                full_val_interval=0, quick_val_subset=1, ckpt_interval=0,
                i_testset=4, device_pool=False, seed=1)
    arch = dict(ARCH, perturb=False, raw_noise_std=0.0,
                compute_dtype="float32")
    jtrain, jval = _datasets(scene, JDS)
    near, far = jtrain.dynamic_near_far()
    jt = jloop.Trainer(JRC(near=near, far=far, **arch), JTC(**loop), jtrain,
                       jval, jval, save_dir=str(tmp_path / "jax"),
                       verbose=False, tensorboard_dir=str(tmp_path / "jtb"),
                       test_ds=JDS(scene, "test", img_wh=WH))
    train_ds, val_ds = _datasets(scene)
    tr = Trainer(RenderConfig(near=near, far=far, **arch),
                 TrainConfig(**loop), train_ds, val_ds, val_ds,
                 save_dir=str(tmp_path / "port"), device="cpu",
                 verbose=False, tensorboard_dir=str(tmp_path / "tb"),
                 test_ds=BlenderDataset(scene, "test", img_wh=WH))
    jparams = jax.tree.map(np.asarray, jt.state.params)
    for key, net in tr.state.params.items():
        net.load_state_dict(params_to_torch_state_dict(jparams[key],
                                                       net.cfg))
    jt.train()
    tr.train()
    got, want = _events(str(tmp_path / "tb")), _events(str(tmp_path / "jtb"))
    for kind in ("scalars", "histograms", "images"):
        assert {t: [s for s, _ in v] for t, v in got[kind].items()} == {
            t: [s for s, _ in v] for t, v in want[kind].items()}, kind
    assert set(got["scalars"]) == {
        "train/loss", "train/psnr", "train/grad_norm", "train/lr",
        "val/loss", "val/psnr", "val/ssim", "test/psnr"}
    assert {"val/render", "val/gt", "val/rgb0", "val/disp0"} == set(
        got["images"])
    assert "val/z_std" in got["histograms"]
    assert any(t.startswith("params/coarse/") for t in got["histograms"])
    for tag, events in want["scalars"].items():
        mine = np.array([v for _, v in got["scalars"][tag]])
        theirs = np.array([v for _, v in events])
        np.testing.assert_allclose(mine, theirs, err_msg=tag, **BARS[tag])


def test_tensorboard_refused_by_name_without_the_package(scene, tmp_path,
                                                         monkeypatch):
    """Where torch.utils.tensorboard does not import, the train CLI's
    --tensorboard is refused by name and the Trainer's tensorboard_dir
    raises ImportError naming it; without the flag the CLI runs."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(SystemExit, match="--tensorboard: .*"
                       "torch.utils.tensorboard"):
        train_cli.main(["--datadir", scene, "--device", "cpu",
                        "--tensorboard"])
    with pytest.raises(ImportError, match="torch.utils.tensorboard"):
        Trainer(RenderConfig(**ARCH), TC, _datasets(scene)[0], device="cpu",
                save_dir=str(tmp_path / "t"), tensorboard_dir=str(tmp_path))


# -- --check_numerics ------------------------------------------------------ #
@pytest.fixture
def numerics():
    """check_numerics on for the test, off after it."""
    check_numerics(True)
    yield
    check_numerics(False)


def _nan_weight(params):
    params["coarse"].pts_linears[0].weight.data[0, 0] = float("nan")


def _jax_step(scene, where, debug_nans):
    """JAX's jitted train step on the same kind of NaN (in a weight, the
    batch or the learning rate), under jax_debug_nans or not: "raised"
    for a FloatingPointError, else the step's loss."""
    train_ds, _ = _datasets(scene, JDS)
    near, far = train_ds.dynamic_near_far()
    rc = JRC(near=near, far=far, **ARCH)
    tc = JTC(batch_size=64, lr=float("nan") if where == "lr" else 5e-4)
    state = jts.create_train_state(rc, tc)
    if where == "weight":
        p = jax.tree.map(np.array, state.params)
        p["coarse"]["pts_0"]["kernel"][0, 0] = np.nan
        state = state.replace(params=jax.tree.map(jnp.asarray, p))
    batch = np.concatenate([train_ds.all_rays_o[:64], train_ds.all_rays_d[:64],
                            train_ds.all_rgbs[:64]], axis=1)
    if where == "batch":
        batch[5, 0] = np.nan
    step = jts.make_train_step(rc, tc)
    with jax.debug_nans(debug_nans):
        try:
            _, m = step(state, jnp.asarray(batch))
            return float(m["loss"])
        except FloatingPointError:
            return "raised"


@pytest.mark.parametrize("where, names", [
    ("weight", "the output of the fused MLP's plain forward \\(train step 1, "
               "coarse call\\)"),
    ("batch", "the output of the fused MLP's plain forward \\(train step 1, "
              "coarse call\\)"),
    ("lr", "the parameter coarse.pts_linears.0.weight after the update "
           "\\(train step 1\\)"),
])
def test_check_numerics_raises_at_the_step(scene, tmp_path, numerics, where,
                                           names):
    """A NaN in one weight, in the batch or in the learning rate raises
    FloatingPointError at step 1, naming the tensor, where JAX's step
    under jax_debug_nans raises too."""
    t = _trainer(scene, tmp_path, iters=3, device_pool=False,
                 lr=float("nan") if where == "lr" else 5e-4)
    if where == "weight":
        _nan_weight(t.state.params)
    elif where == "batch":
        inner = t.loader.next_batch

        def nan_batch():
            b = inner().copy()
            b[5, 0] = np.nan
            return b

        t.loader.next_batch = nan_batch
    with pytest.raises(FloatingPointError, match=names):
        t.train()
    assert t.state.step == 0
    assert _jax_step(scene, where, debug_nans=True) == "raised"


def test_check_numerics_names_a_gradient_and_the_loss(scene, tmp_path,
                                                      numerics):
    """A NaN in the target colours: the loss is the first NaN; a NaN
    gradient of an otherwise finite step names the parameter; a render
    names the view."""
    t = _trainer(scene, tmp_path / "a", iters=2, device_pool=False)
    inner = t.loader.next_batch
    t.loader.next_batch = lambda: np.concatenate(
        [inner()[:, :6], np.full((64, 3), np.nan, np.float32)], axis=1)
    with pytest.raises(FloatingPointError,
                       match="NaN in the loss \\(train step 1\\)"):
        t.train()
    t = _trainer(scene, tmp_path / "b", iters=2, device_pool=False)
    bias = t.state.params["coarse"].rgb_linear.bias
    bias.register_hook(lambda g: torch.full_like(g, float("nan")))
    with pytest.raises(FloatingPointError,
                       match="NaN in the gradient of coarse\\.rgb_linear\\.bias "
                             "\\(train step 1\\)"):
        t.train()
    t = _trainer(scene, tmp_path / "c", iters=2)
    _nan_weight(t.state.params)
    with pytest.raises(FloatingPointError,
                       match="the render of view 0, coarse call"):
        t.quick_validate()


def test_without_check_numerics_the_run_goes_on(scene, tmp_path):
    """With the flag off a NaN weight is not checked: the run goes on to
    NaN losses, as JAX's step without jax_debug_nans returns NaNs."""
    assert not numerics_checked()
    t = _trainer(scene, tmp_path, iters=3, device_pool=False)
    _nan_weight(t.state.params)
    losses = []
    inner = t.step_fn
    t.step_fn = lambda s, b: (lambda m: losses.append(float(m["loss"]))
                              or m)(inner(s, b))
    t.train()
    assert t.state.step == 3 and np.isnan(losses).all()
    assert np.isnan(_jax_step(scene, "weight", debug_nans=False))


def test_check_numerics_runs_windows_step_by_step(scene, tmp_path, numerics,
                                                  capsys):
    """steps_per_dispatch 4 under check_numerics: no window runs (a check
    cannot raise inside a captured graph), and a clean run finishes."""
    t = _trainer(scene, tmp_path, verbose=True, iters=6,
                 steps_per_dispatch=4)
    t.windows.run_pool = t.windows.run_host = None
    t.train()
    assert ("(steps_per_dispatch disabled while checking numerics: a "
            "captured graph cannot raise)") in capsys.readouterr().out
    assert t.state.step == 6


# -- the train CLI --------------------------------------------------------- #
def test_cli_flags(scene, tmp_path):
    """--check_numerics, --profile_dir and --tensorboard parse with the JAX
    CLI's names and reach the run: a NaN-free run with all three writes
    its trace and events and leaves the checks as they were; the flag
    that stays unported (--compilation_cache) is still refused by name
    (--remat is ported: tests/test_torch_remat.py)."""
    out, prof = tmp_path / "out", tmp_path / "prof"
    argv = ["--datadir", scene, "--device", "cpu", "--img_wh", "16", "16",
            "--netdepth", "2", "--netwidth", "32", "--N_samples", "8",
            "--N_importance", "8", "--batch_size", "64", "--iters", "12",
            "--quick_val_interval", "12", "--quick_val_res", "16", "16",
            "--quick_val_subset", "1", "--i_print", "4",
            "--save_dir", str(out)]
    args = train_cli.parse_args(argv + ["--check_numerics", "--profile_dir",
                                        str(prof), "--tensorboard"])
    assert args.check_numerics and args.tensorboard
    assert args.profile_dir == str(prof)
    m = train_cli.main(argv + ["--check_numerics", "--profile_dir",
                               str(prof), "--tensorboard"])
    assert m["step"] == 12 and not numerics_checked()
    assert list(_traced_steps(str(prof)).values()) == [list(range(10, 13))]
    assert "train/loss" in _events(str(out / "tb"))["scalars"]
    for flag, match in (("--compilation_cache", "compilation cache"),):
        with pytest.raises(SystemExit, match=match):
            train_cli.main(argv + [flag, "2"])
    # --tensor_parallel is ported: on one device it fails JAX's check.
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        train_cli.main(argv + ["--tensor_parallel", "2"])


@pytest.mark.cuda
def test_check_numerics_names_the_kernel(scene, tmp_path, numerics):
    """On the card a NaN weight is first seen in what the forward kernel
    wrote, and named as the kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    train_ds, val_ds = _datasets(scene)
    near, far = train_ds.dynamic_near_far()
    t = Trainer(RenderConfig(near=near, far=far, **ARCH),
                dataclasses.replace(TC, iters=2), train_ds, val_ds,
                save_dir=str(tmp_path), device="cuda", verbose=False)
    _nan_weight(t.state.params)
    with pytest.raises(FloatingPointError,
                       match="the output of the fused_mlp_fwd kernel "
                             "\\(train step 1, coarse call\\)"):
        t.train()
