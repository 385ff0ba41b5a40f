"""Multi-scene batched training on one device: N scenes, one NeRF per
scene, trained in lock step.

Counterpart of the one-device half of ``nerfmlp_tpu/parallel/multi_scene.py``
(``create_multi_scene_state``, ``create_multi_scene_grids``,
``make_multi_scene_grid_update``, ``make_multi_scene_step``: ``:1-114``).
JAX stacks the per-scene states along a leading axis and ``jax.vmap``s the
single-scene update rule over it, so each fused-MLP ``pallas_call`` of a
step runs batched: one call with a leading grid axis over scenes. Here
the same: the per-scene nets form a
:class:`~nerfmlp_torch.ops.fused_mlp.NetStack`, the step renders all
scenes' rays in one pass (``parallel/train_step.py::make_stack_step_body``)
and every fused-MLP call of it is one launch of each kernel over all
scenes — a multi-scene step launches each kernel as often as a
single-scene step. Scenes share nothing but the launches: scene s's
update equals a single-scene step's on its own data, weights and draws.

The ("scene", "data") mesh of more devices than scenes (``make_scene_mesh``,
``make_multi_scene_dp_step``, ``make_multi_scene_dp_grid_update``) is not
ported (ROADMAP.md, Queue 1 item 18).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.mlp import NeRFMLP
from nerfmlp_torch.ops.fused_mlp import NetStack
from nerfmlp_torch.ops.occupancy import (
    OccupancyGrid, create_multi_scene_grids, update_grid,
)
from nerfmlp_torch.parallel.train_step import (
    Adam, ADAM_BETAS, ADAM_EPS, StackState, create_train_state,
    make_stack_step_body,
)

SCENE_SEED_STRIDE = 1000   # scene s is seeded tc.seed + 1000 s (JAX's :38)


def create_multi_scene_state(n_scenes: int, rc: RenderConfig,
                             tc: TrainConfig, device=None) -> StackState:
    """``n_scenes`` independently seeded train states, stacked: scene s's
    nets and generator are those of ``create_train_state`` seeded
    ``tc.seed + 1000 s``; one Adam over every scene's parameters. On
    ``device``, default ``cuda``."""
    states = [create_train_state(
        rc, dataclasses.replace(tc, seed=tc.seed + SCENE_SEED_STRIDE * s),
        device=device) for s in range(n_scenes)]
    params = {k: NetStack(tuple(st.params[k] for st in states))
              for k in states[0].params}
    adam = Adam([p for st in states for p in st.optimizer.params],
                betas=ADAM_BETAS, eps=ADAM_EPS)
    return StackState(step=0, params=params, optimizer=adam,
                      generators=tuple(st.generator for st in states))


def scene_params(state: StackState, s: int) -> Dict[str, NeRFMLP]:
    """Scene ``s``'s nets, the params dict a single-scene state holds (what
    ``train/checkpoint.py::save_params`` and the render CLIs take)."""
    return {k: stack.nets[s] for k, stack in state.params.items()}


def make_multi_scene_grid_update(rc: RenderConfig):
    """The per-scene refresh over stacked grids:
    ``update(grids, params, generators, decay) -> grids``, one batched
    query of S x ``occ_grid_size``^3 points (one forward launch), scene
    s's jitter from ``generators[s]`` and its sigma from its own net."""

    def update(grids: OccupancyGrid, params: Dict[str, NetStack],
               generators: Sequence[torch.Generator],
               decay: float) -> OccupancyGrid:
        return update_grid(grids, params, rc, tuple(generators), decay=decay)

    return update


def make_multi_scene_step(rc: RenderConfig, tc: TrainConfig,
                          with_bounds: bool = False):
    """The step over stacked states and (S, B, 9 | 12) batches, in place:
    ``step(state, batch) -> metrics``; with ``rc.use_occupancy`` a third
    argument, the stacked grids; with ``with_bounds`` a trailing (S, 2)
    [near, far] stack, so every scene samples its own depth range (the
    config's scalars are ignored). Metrics are (S,) device tensors: loss,
    psnr, grad_norm, total_loss."""
    body = make_stack_step_body(rc, tc)

    def step(state: StackState, batch: torch.Tensor, *extra):
        want = (1 if rc.use_occupancy else 0) + (1 if with_bounds else 0)
        if len(extra) != want:
            raise TypeError(f"the step takes {want} argument(s) after the "
                            f"batch (grids if use_occupancy, then bounds if "
                            f"with_bounds), got {len(extra)}")
        grids = extra[0] if rc.use_occupancy else None
        bounds = extra[-1] if with_bounds else None
        metrics = body(state, batch, grids, bounds)
        state.step += 1
        return metrics

    return step
