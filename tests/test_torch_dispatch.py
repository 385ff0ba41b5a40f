"""steps_per_dispatch in the port's Trainer (train/loop.py, train/graph.py)
against K = 1 and against the JAX Trainer, on the CPU.

On the CPU a window runs the graph's step body eagerly w times, so a
windowed run must match the eager one at the JAX package's own scan bars
(tests/test_train_loop.py:385-411: params rtol 2e-4 / atol 2e-6, losses
and PSNRs rtol 1e-3), and its events, checkpoints and grid refreshes must
land on the steps where the JAX Trainer's scan windows put them.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nerfmlp_tpu.config import RenderConfig as JRC
from nerfmlp_tpu.config import TrainConfig as JTC
from nerfmlp_tpu.data.blender import BlenderDataset as JDS
from nerfmlp_tpu.train import loop as jloop

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train.loop import Trainer, dispatch_window

WH = (40, 40)
ARCH = dict(depth=3, width=32)          # small: CPU time, not parity, binds
OCC = dict(aabb=(-1.5, -1.5, -1.2, 1.5, 1.5, 1.5), use_occupancy=True,
           occ_grid_size=16, occ_dense_samples=16, occ_update_every=10)
# The JAX scan tests' loop: log 10, quick validation 15 (15 % 4 != 0),
# checkpoint 30, a precrop stop at 7.
LOOP = dict(batch_size=256, iters=30, quick_val_interval=15,
            full_val_interval=0, quick_val_subset=1, log_interval=10,
            ckpt_interval=30, precrop_iters=7, precrop_frac=0.6)


# ---- dispatch_window: the JAX package's function, copied ---------------- #

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's tests and fixtures (restored
    after), so that parallel test workers do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("args, kw, want", [
    ((1, 1000, 10, [100]), {}, 10),         # no boundary inside: full K
    ((95, 1000, 10, [100]), {}, 6),         # ends at the interval multiple
    ((100, 1000, 10, [100]), {}, 1),        # the event at the start
    ((13, 1000, 10, [100, 16]), {}, 4),     # the tightest interval wins
    ((998, 1000, 10, [7000]), {}, 3),       # the run's end
    ((4, 1000, 10, [1000]), {"stop_steps": (7,)}, 4),   # precrop stop
    ((8, 1000, 10, [1000]), {"stop_steps": (7,)}, 10),  # past the stop
    ((50, 50, 10, [0, None]), {"stop_steps": (0,)}, 1),  # zeros ignored
])
def test_dispatch_window_cases_match_jax(args, kw, want):
    assert dispatch_window(*args, **kw) == want
    assert jloop.dispatch_window(*args, **kw) == want


def test_dispatch_window_grid_matches_jax():
    """A seeded grid of (step, iters, K, intervals, stop)."""
    rng = np.random.default_rng(19)
    for _ in range(2000):
        iters = int(rng.integers(1, 400))
        step = int(rng.integers(1, iters + 1))
        k = int(rng.integers(1, 40))
        intervals = [int(v) if v > 0 else None if v < 0 else 0
                     for v in rng.integers(-3, 120, size=rng.integers(0, 6))]
        stops = tuple(int(v) for v in rng.integers(0, 300,
                                                   size=rng.integers(0, 3)))
        assert (dispatch_window(step, iters, k, intervals, stops)
                == jloop.dispatch_window(step, iters, k, intervals, stops))


# ---- the Trainer at K > 1 against K = 1 --------------------------------- #

def _trainer(scene, save_dir, k, rc_kw=None, **tc_kw):
    ds = BlenderDataset(scene, "train", img_wh=WH)
    val = BlenderDataset(scene, "val", img_wh=WH)
    near, far = ds.dynamic_near_far()
    rc = RenderConfig(N_samples=8, N_importance=8, near=near, far=far,
                      perturb=True, **ARCH, **(rc_kw or {}))
    tc = TrainConfig(**dict(LOOP, steps_per_dispatch=k, **tc_kw))
    return Trainer(rc, tc, ds, val, val, save_dir=str(save_dir),
                   device="cpu", verbose=False)


def _params(t):
    return [p.detach().numpy() for net in t.state.params.values()
            for p in net.parameters()]


def _spy_refreshes(t):
    """Record (seed step, decay) of every grid refresh."""
    calls, inner = [], t._occ_update
    t._occ_update = lambda s, d: calls.append((s, d)) or inner(s, d)
    return calls


def _assert_same_run(t1, m1, tk, mk):
    for x, y in zip(_params(t1), _params(tk)):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-6)
    assert m1["val_steps"] == mk["val_steps"]
    assert len(m1["iteration_times"]) == len(mk["iteration_times"]) \
        == t1.tc.iters
    np.testing.assert_allclose(m1["train_losses"], mk["train_losses"],
                               rtol=1e-3)
    np.testing.assert_allclose(m1["quick_val_psnrs"], mk["quick_val_psnrs"],
                               rtol=1e-3)


def test_windows_match_single_steps(synthetic_scene, tmp_path):
    """K = 4 runs the same math as K = 1 across log / quick-val boundaries,
    the precrop stop at 7 (host windows, then pool windows) and a
    non-dividing interval (15 % 4 != 0); the step counter and the host's
    step agree at the end."""
    t1 = _trainer(synthetic_scene, tmp_path / "k1", 1)
    assert t1.windows is None
    m1 = t1.train()
    t4 = _trainer(synthetic_scene, tmp_path / "k4", 4)
    assert t4.windows is not None and not t4.windows.on_cuda
    m4 = t4.train()
    _assert_same_run(t1, m1, t4, m4)
    assert t4.state.step == int(t4.state.counter) == 30
    assert os.path.exists(tmp_path / "k4" / "model_30.pt")
    assert m4["val_steps"] == [15, 30]


def test_host_windows_without_pool_match(synthetic_scene, tmp_path):
    """--no_batching: every window's batches come from the host, through
    the static buffer."""
    kw = dict(no_batching=True, precrop_iters=0, iters=12,
              quick_val_interval=6)
    t1 = _trainer(synthetic_scene, tmp_path / "n1", 1, **kw)
    m1 = t1.train()
    t5 = _trainer(synthetic_scene, tmp_path / "n5", 5, **kw)
    assert t5.pool is None
    m5 = t5.train()
    _assert_same_run(t1, m1, t5, m5)


def test_pool_windows_cross_an_epoch(synthetic_scene, tmp_path):
    """Batch 512: 18 steps per epoch, so the 30 steps cross one reshuffle;
    windows end at it and read one stack each (the stack is rewritten in
    place), as make_pool_scan's windows do."""
    kw = dict(batch_size=512, precrop_iters=0)
    t1 = _trainer(synthetic_scene, tmp_path / "p1", 1, **kw)
    assert t1.pool.steps_per_epoch == 18
    m1 = t1.train()
    t5 = _trainer(synthetic_scene, tmp_path / "p5", 5, **kw)
    stack = t5.pool.ensure_epoch(0)
    sizes = []
    inner = t5.windows.run_pool
    t5.windows.run_pool = lambda w: sizes.append(w) or inner(w)
    m5 = t5.train()
    assert t5.pool.epoch == 1 and t5.pool.stack is stack
    # 1-5 6-10 11-15 16-18 | 19-20 21-25 26-30
    assert sizes == [5, 5, 5, 3, 2, 5, 5]
    _assert_same_run(t1, m1, t5, m5)


def test_occupancy_refresh_cadence(synthetic_scene, tmp_path):
    """K = 5 with a refresh every 10 steps: three refreshes, at steps 1,
    11, 21, with K = 1's seeds and decays; the grid is refreshed in place,
    and the runs agree."""
    kw = dict(precrop_iters=0)
    t1 = _trainer(synthetic_scene, tmp_path / "o1", 1, OCC, **kw)
    c1 = _spy_refreshes(t1)
    m1 = t1.train()
    t5 = _trainer(synthetic_scene, tmp_path / "o5", 5, OCC, **kw)
    density = t5.occ_grid.density
    c5 = _spy_refreshes(t5)
    m5 = t5.train()
    assert c1 == c5 == [(1, 1.0), (11, 1.0), (21, 1.0)]
    assert t5.occ_grid.density is density
    assert torch.equal(t1.occ_grid.density, t5.occ_grid.density)
    _assert_same_run(t1, m1, t5, m5)


def _jax_trainer(scene, save_dir, k, occupancy=False):
    ds = JDS(scene, "train", img_wh=WH)
    val = JDS(scene, "val", img_wh=WH)
    near, far = ds.dynamic_near_far()
    rc = JRC(N_samples=8, N_importance=8, near=near, far=far, perturb=True,
             **ARCH, **(OCC if occupancy else {}))
    tc = JTC(**dict(LOOP, steps_per_dispatch=k))
    return jloop.Trainer(rc, tc, ds, val, val, save_dir=str(save_dir),
                         verbose=False)


@pytest.mark.parametrize("occupancy", [False, True])
def test_event_steps_match_the_jax_trainer(synthetic_scene, tmp_path,
                                           occupancy):
    """At K = 4 the port's Trainer validates, checkpoints and refreshes the
    grid on the steps where the JAX Trainer's scan windows do."""
    rc_kw = OCC if occupancy else None
    t = _trainer(synthetic_scene, tmp_path / "port", 4, rc_kw)
    refreshes = _spy_refreshes(t) if occupancy else None
    m = t.train()
    jt = _jax_trainer(synthetic_scene, tmp_path / "jax", 4, occupancy)
    jsteps = []
    if occupancy:
        inner = jt._occ_update
        # At a refresh the history holds the step before it.
        jt._occ_update = lambda g, p, rng, decay: (
            jsteps.append((jt.history["step"] + 1, decay))
            or inner(g, p, rng, decay))
    jm = jt.train()
    assert m["val_steps"] == jm["val_steps"] == [15, 30]
    assert len(m["iteration_times"]) == len(jm["iteration_times"]) == 30
    ours = sorted(f[:-3] for f in os.listdir(tmp_path / "port")
                  if f.startswith("model_") and f.endswith(".pt"))
    theirs = sorted(f[:-5] for f in os.listdir(tmp_path / "jax")
                    if f.startswith("model_") and f.endswith(".ckpt"))
    assert ours == theirs
    if occupancy:
        assert refreshes == jsteps == [(1, 1.0), (11, 1.0), (21, 1.0)]


@pytest.mark.parametrize("k_first, k_then", [(4, 1), (1, 4)])
def test_resume_across_k(synthetic_scene, tmp_path, k_first, k_then):
    """A run saved at one K resumes at the other: 12 steps, then 12 more
    from metrics_latest.pt, equal to 24 steps at K = 1 without a break."""
    kw = dict(precrop_iters=0, quick_val_interval=6)
    whole = _trainer(synthetic_scene, tmp_path / "whole", 1, iters=24, **kw)
    whole.train()
    first = _trainer(synthetic_scene, tmp_path / "split", k_first, iters=12,
                     **kw)
    first.train()
    second = _trainer(synthetic_scene, tmp_path / "split", k_then, iters=24,
                      **kw)
    assert second.resume(ckpt.latest_checkpoint(str(tmp_path / "split")))
    assert second.state.step == int(second.state.counter) == 12
    second.train()
    for x, y in zip(_params(whole), _params(second)):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-6)
    a, b = whole.state.optimizer, second.state.optimizer
    assert float(a.count) == float(b.count) == 24
    for x, y in zip(a.exp_avg_sq, b.exp_avg_sq):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4,
                                   atol=1e-12)


def test_train_cli_takes_steps_per_dispatch(synthetic_scene, tmp_path):
    """--steps_per_dispatch K through the train CLI on the CPU."""
    from nerfmlp_torch.scripts import train as cli

    out = tmp_path / "cli"
    cli.main(["--datadir", synthetic_scene, "--img_wh", "40", "40",
              "--iters", "6", "--save_dir", str(out), "--device", "cpu",
              "--netdepth", "2", "--netwidth", "16", "--N_samples", "4",
              "--N_importance", "4", "--batch_size", "128",
              "--steps_per_dispatch", "3", "--quick_val_interval", "3",
              "--quick_val_res", "8", "8", "--quick_val_subset", "1",
              "--full_val_interval", "0"])
    assert os.path.exists(out / "model_final.pt")


def test_resume_reads_an_earlier_state_file(synthetic_scene, tmp_path):
    """A train state as earlier versions wrote it (torch.optim.Adam's
    state, count per parameter) resumes at K = 4: the step, the counter,
    Adam's count and moments load, and training goes on."""
    from nerfmlp_torch.parallel import train_step as ts

    kw = dict(precrop_iters=0, iters=8, quick_val_interval=4)
    t = _trainer(synthetic_scene, tmp_path / "a", 1, **kw)
    params = [p for net in t.state.params.values() for p in net.parameters()]
    ref = torch.optim.Adam(params, lr=1e-3, betas=ts.ADAM_BETAS,
                           eps=ts.ADAM_EPS)
    for i in range(2):
        for p in params:
            p.grad = torch.full_like(p, 0.01 * (i + 1))
        ref.step()
    torch.save({"format": ckpt.STATE_FORMAT, "step": 5,
                "params": {k: net.state_dict()
                           for k, net in t.state.params.items()},
                "opt_state": ref.state_dict(),
                "generator": t.state.generator.get_state()},
               tmp_path / "old.pt")
    again = _trainer(synthetic_scene, tmp_path / "b", 4, **kw)
    assert again.resume(str(tmp_path / "old.pt"))
    opt = again.state.optimizer
    assert again.state.step == int(again.state.counter) == 5
    assert float(opt.count) == 2
    assert torch.equal(opt.exp_avg_sq[0], ref.state[params[0]]["exp_avg_sq"])
    again.train()
    assert again.state.step == int(again.state.counter) == 8
    assert float(opt.count) == 5
