"""Traffic of kind ``train``: the recipe's training loop, ``Trainer.train``
as the train CLI runs it, on the cell's scene.

Set-up builds one Trainer, loads the seeded weights, takes the first
``check_steps`` steps one ``train()`` call each (their losses, Adam's
first moments after the first and the weights after the last are kept
for the check), trains on past the recipe's one-off boundaries (the
central crop, the grid's warm-up) by ``setup_past_steps`` in one call
whose rate sizes the window, then keeps the trainer's state and
takes ``check_steps`` more steps the same way: steps in the window's
regime (whole images or pool batches, the grid refreshed with decay).
The window is one ``train()`` call of whole multiples of
``step_multiple`` steps that lasts about ``--seconds`` and ends with the
trainer's own final save; with ``--trace 1`` it is ``trace_steps`` steps
under the profiler. Then the trainer is dropped and the reference follows
both groups of steps, in float32 and in bfloat16: the first from the
seeded weights, the second from the kept state.
"""

from __future__ import annotations

import copy
import math
import shutil
import tempfile
import time

import torch

from benchmark import check, counts, harness, scene
from benchmark.trace import Traced, sync


def build(cell: harness.Cell, seed: int, device, save_dir: str):
    """(trainer, scene, weights, the trainer's seed) of one seed: the
    program's Trainer on the seeded scene, holding the seeded weights."""
    from nerfmlp_torch.train.loop import Trainer

    cfg = cell.config
    t_seed = harness.subseed(seed, harness.TRAINER)
    rc, tc = harness.program_configs(cfg, t_seed)
    t = time.perf_counter()
    views = scene.Scene(cfg["scene"], harness.subseed(seed, harness.SCENE),
                        device)
    weights = scene.make_weights(cfg["model"],
                                 harness.subseed(seed, harness.WEIGHTS),
                                 device, cell.traffic["weights"])
    sync(device)
    print(f"[bench] scene and weights {time.perf_counter() - t:.2f} s",
          flush=True)
    trainer = Trainer(rc, tc, views, save_dir=save_dir, device=device)
    for net in trainer.state.params.values():
        net.load_state_dict(weights)
    return trainer, views, weights, t_seed


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t0: float) -> dict:
    cfg, tr = cell.config, cell.traffic
    tmp = tempfile.mkdtemp(prefix="bench_train_")
    try:
        trainer, views, weights, t_seed = build(cell, seed, device, tmp)
        rc, tc = trainer.rc, trainer.tc
        done = set_up(trainer, tr, device)
        setup_s = time.perf_counter() - t0

        mult = tr["step_multiple"]
        n = (tr["trace_steps"] if trace
             else max(mult,
                      math.ceil(seconds * done["rate"] / mult) * mult))
        first = trainer.state.step
        traced = None
        t1 = time.perf_counter()
        if trace:
            with Traced(device, f"{tmp}/trace.json") as traced:
                trainer.train(iters=first + n)
        else:
            trainer.train(iters=first + n)
            sync(device)
        window = time.perf_counter() - t1
        steps = trainer.state.step - first
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    rays = steps * tc.batch_size
    refresh = 0
    if rc.use_occupancy:
        refresh = sum(1 for s in range(first + 1, first + steps + 1)
                      if (s - 1) % rc.occ_update_every == 0)
    calls = counts.step_calls(cfg["render"], tc.batch_size)
    fwd = calls * steps
    if refresh:
        fwd += [counts.refresh_points(cfg["render"])] * refresh
    work = {"mode": "train", "steps": steps, "rays": rays,
            "fwd_calls": fwd, "bwd_calls": calls * steps}

    readings = check.train_check(cfg, weights, views, t_seed,
                                 tr["check_steps"], device, done["first"],
                                 done["kept"], done["late"])["program"]
    return {"e2e": {"train_rays_per_s": rays / window, "setup_s": setup_s},
            "attempted": steps, "failed": 0, "peak": peak,
            "traced": traced, "work": work, "readings": readings}


def set_up(trainer, tr: dict, device) -> dict:
    """Set-up's steps: {first (the first steps), rate (steps a second
    over the rest, one call), kept (the state after them), late (the
    steps taken from it)}."""
    rc, tc = trainer.rc, trainer.tc
    t = time.perf_counter()
    first = take_steps(trainer, tr["check_steps"])
    print(f"[bench] first {tr['check_steps']} steps (graph capture "
          f"included) {time.perf_counter() - t:.2f} s", flush=True)
    boundary = max(tc.precrop_iters,
                   rc.occ_warmup_steps if rc.use_occupancy else 0)
    setup_steps = boundary + tr["setup_past_steps"]
    s0, t = trainer.state.step, time.perf_counter()
    trainer.train(iters=setup_steps)
    sync(device)
    rate = (setup_steps - s0) / (time.perf_counter() - t)
    kept = keep_state(trainer)
    late = take_steps(trainer, tr["check_steps"])
    print(f"[bench] set-up steps to {trainer.state.step} "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if rc.use_occupancy:
        occ = trainer.occ_grid.density > rc.occ_threshold
        print(f"[bench] grid occupied share {float(occ.float().mean())}"
              f" at step {trainer.state.step}", flush=True)
    return {"first": first, "rate": rate, "kept": kept, "late": late}


def _names(trainer):
    return [f"{key}.{name}" if len(trainer.state.params) > 1 else name
            for key, net in trainer.state.params.items()
            for name, _ in net.named_parameters()]


def keep_state(trainer) -> dict:
    """What the reference needs to follow the trainer from here: its step,
    weights, Adam's moments, the generator of its uniforms, the host
    loader's generator and the grid."""
    opt, names = trainer.state.optimizer, _names(trainer)

    def clone(ts):
        return {k: t.detach().clone() for k, t in zip(names, ts)}

    return {"step": trainer.state.step, "weights": clone(opt.params),
            "m": clone(opt.exp_avg), "v": clone(opt.exp_avg_sq),
            "uniforms": trainer.state.generator.get_state(),
            "host": copy.deepcopy(trainer.loader.rng.bit_generator.state),
            "density": (None if trainer.occ_grid is None
                        else trainer.occ_grid.density.detach().clone())}


def take_steps(trainer, n: int) -> dict:
    """The next n steps, one ``train()`` call each: {losses, grads (what
    Adam got at the first, from its first moment), update (weights after
    the last less before the first), density (the grid after the last, or
    None)}."""
    names = _names(trainer)
    opt = trainer.state.optimizer
    before = {k: p.detach().clone() for k, p in zip(names, opt.params)}
    m0 = [m.detach().clone() for m in opt.exp_avg]
    s0 = trainer.state.step
    losses, grads = [], None
    for k in range(1, n + 1):
        trainer.train(iters=s0 + k)
        losses.append(float(trainer._sums[0]))
        if k == 1:
            b1 = opt.betas[0]
            grads = {nm: (m.detach() - b1 * m_0) / (1.0 - b1)
                     for nm, m, m_0 in zip(names, opt.exp_avg, m0)}
    update = {k: p.detach() - before[k] for k, p in zip(names, opt.params)}
    density = (None if trainer.occ_grid is None
               else trainer.occ_grid.density.detach().clone())
    return {"losses": losses, "grads": grads, "update": update,
            "density": density}
