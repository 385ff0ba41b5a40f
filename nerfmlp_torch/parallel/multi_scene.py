"""Multi-scene batched training: N scenes, one NeRF per scene, trained in
lock step, on one device or over several.

Counterpart of ``nerfmlp_tpu/parallel/multi_scene.py``
(``create_multi_scene_state``, ``create_multi_scene_grids``,
``make_multi_scene_grid_update``, ``make_multi_scene_step``: ``:1-114``;
``make_scene_mesh``, ``make_multi_scene_dp_step``,
``make_multi_scene_dp_grid_update``: ``:125-216``).
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

Over N ranks (:func:`scene_layout`), as the JAX CLI lays scenes out:

  * **scenes per rank** (``n_scenes % N == 0``, JAX's ``shard_map`` over
    the scene axis): rank r holds scenes ``[r S/N, (r+1) S/N)`` as its own
    stack and steps it with the one-device step; nothing but the metrics
    crosses ranks (:func:`gather_scene_metrics`);
  * **("scene", "data")** (``N % n_scenes == 0``, more ranks than scenes):
    :func:`make_scene_mesh` splits the ranks into one group per scene;
    each rank holds its group's scene and steps on its rows of the
    scene's batch, the gradients averaged within the group
    (:func:`make_multi_scene_dp_step`); every rank of a group refreshes
    the scene's grid from the same seed, so the group's grids stay equal
    (:func:`make_multi_scene_dp_grid_update`).

Scene s is seeded ``tc.seed + 1000 s`` wherever it lives, so every layout
trains the nets the one-device stack trains.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.mlp import NeRFMLP
from nerfmlp_torch.ops.fused_mlp import NetStack
from nerfmlp_torch.ops.occupancy import (
    OccupancyGrid, create_multi_scene_grids, update_grid,
)
from nerfmlp_torch.parallel.mesh import Mesh, all_gather_rows
from nerfmlp_torch.parallel.train_step import (
    Adam, ADAM_BETAS, ADAM_EPS, StackState, create_train_state,
    make_stack_step_body,
)

SCENE_SEED_STRIDE = 1000   # scene s is seeded tc.seed + 1000 s (JAX's :38)


def create_multi_scene_state(n_scenes: int, rc: RenderConfig,
                             tc: TrainConfig, device=None,
                             first_scene: int = 0) -> StackState:
    """``n_scenes`` independently seeded train states, stacked: scene s's
    nets and generator are those of ``create_train_state`` seeded
    ``tc.seed + 1000 s``; one Adam over every scene's parameters. On
    ``device``, default ``cuda``. ``first_scene``: the index of the first
    (a rank's scenes of a larger set)."""
    states = [create_train_state(
        rc, dataclasses.replace(tc, seed=tc.seed + SCENE_SEED_STRIDE * s),
        device=device) for s in range(first_scene, first_scene + n_scenes)]
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
                          with_bounds: bool = False, mesh=None):
    """The step over stacked states and (S, B, 9 | 12) batches, in place:
    ``step(state, batch) -> metrics``; with ``rc.use_occupancy`` a third
    argument, the stacked grids; with ``with_bounds`` a trailing (S, 2)
    [near, far] stack, so every scene samples its own depth range (the
    config's scalars are ignored). Metrics are (S,) device tensors: loss,
    psnr, grad_norm, total_loss. ``mesh``: the data-parallel group of
    these scenes (:func:`make_multi_scene_dp_step`)."""
    body = make_stack_step_body(rc, tc, mesh)

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


# --------------------------------------------------------------------- #
# Over several ranks
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SceneMesh:
    """A rank's share of a multi-scene run: the global indices of the
    ``scenes`` it holds, the ``data`` mesh of its scene group (None when
    the scenes are its own alone) and the ``world`` mesh of every rank."""

    scenes: Tuple[int, ...]
    data: Optional[Mesh]
    world: Mesh


def make_scene_mesh(n_scenes: int, mesh: Mesh) -> SceneMesh:
    """The ("scene", "data") layout of ``mesh``'s ranks: one group of
    ``N / n_scenes`` consecutive ranks per scene, scene outermost, so a
    scene's gradient all-reduce stays within its group. Every rank must
    call this (the groups are made collectively)."""
    n = mesh.world_size
    if n % n_scenes:
        raise ValueError(f"{n} ranks not divisible by {n_scenes} scenes")
    per = n // n_scenes
    groups = [dist.new_group(list(range(g * per, (g + 1) * per)))
              for g in range(n_scenes)]
    g = mesh.rank // per
    data = Mesh(rank=mesh.rank % per, world_size=per, device=mesh.device,
                backend=mesh.backend, group=groups[g])
    return SceneMesh(scenes=(g,), data=data, world=mesh)


def scene_layout(n_scenes: int, mesh: Mesh) -> SceneMesh:
    """How ``n_scenes`` scenes lie on ``mesh``'s ranks, as the JAX CLI
    chooses (``scripts/train_multi_scene.py:96-176``): whole scenes per
    rank when the rank count divides the scene count, else the ("scene",
    "data") layout when the scene count divides the rank count; neither
    is refused."""
    n = mesh.world_size
    if n_scenes % n == 0:
        k = n_scenes // n
        return SceneMesh(scenes=tuple(range(mesh.rank * k,
                                            (mesh.rank + 1) * k)),
                         data=None, world=mesh)
    if n % n_scenes == 0:
        return make_scene_mesh(n_scenes, mesh)
    raise ValueError(f"{n_scenes} scenes vs {n} devices: need one to divide "
                     "the other")


def make_multi_scene_dp_step(rc: RenderConfig, tc: TrainConfig,
                             scene_mesh: SceneMesh,
                             with_bounds: bool = False):
    """The step of this rank's scenes (:func:`make_multi_scene_step`): on
    ``scene_mesh.data`` the batch is (S_rank, B / n_data, ...), the rank's
    rows of each of its scenes' batches (``shard_batch(..., axis=1)``),
    and each scene's gradients are averaged over its group."""
    return make_multi_scene_step(rc, tc, with_bounds, mesh=scene_mesh.data)


def make_multi_scene_dp_grid_update(rc: RenderConfig,
                                    scene_mesh: SceneMesh):
    """The grid refresh of this rank's scenes
    (:func:`make_multi_scene_grid_update`): every rank of a scene group
    refreshes its scene's grid with the scene's generators, which the
    caller seeds alike on the group's ranks, so the group's grids stay
    equal without a collective (JAX replicates the refresh within the
    group)."""
    del scene_mesh   # the layout needs no collective here
    return make_multi_scene_grid_update(rc)


def gather_scene_metrics(metrics: Dict[str, torch.Tensor],
                         scene_mesh: SceneMesh,
                         n_scenes: int) -> Dict[str, torch.Tensor]:
    """Every scene's metrics, (n_scenes,) in scene order, on every rank,
    from each rank's (S_rank,) metrics (one gather)."""
    keys = sorted(metrics)
    mine = torch.stack([metrics[k].float() for k in keys], dim=1)
    every = all_gather_rows(mine, scene_mesh.world)   # rank-major rows
    if scene_mesh.data is not None:   # a group's ranks hold the same rows
        every = every[::scene_mesh.data.world_size]
    return {k: every[:n_scenes, i] for i, k in enumerate(keys)}
