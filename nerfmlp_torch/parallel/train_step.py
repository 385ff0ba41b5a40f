"""The training step: render -> MSE -> backward -> Adam.

Counterpart of ``nerfmlp_tpu/parallel/train_step.py:30-127``
(``TrainState``, ``make_optimizer``, ``create_train_state``,
``loss_and_metrics``, ``make_step_fn``), single device. The update is
optax's, term by term:

  * Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias correction): ``torch.optim.Adam`` computes the same
    update;
  * the learning rate of update ``k`` (0-based: the number of updates
    before it) is ``lr * rate ** (k / steps)`` — optax's continuous
    ``exponential_decay`` — set on the optimizer before each update;
  * ``grad_clip`` is ``clip_by_global_norm``: ``g / max(|g|, c) * c``,
    i.e. ``g * min(1, c / |g|)`` (``torch.nn.utils.clip_grad_norm_``
    adds 1e-6 to the norm, so it is not used);
  * ``grad_norm`` is the global norm of the gradients before clipping.

Every net the config sends to the fused kernels is packed once per step
(``prepare_params``); the coarse and fine queries of the shared net then
run the forward kernel and, under ``backward()``, the backward kernel, and
autograd sums their gradients. With ``use_occupancy`` the step takes the
density grid (``occ_grid``) and queries the net that renders the final
image, once or twice; a net the loss does not reach (the coarse net under
``separate_fine``) gets a zero gradient, so Adam treats it as optax does.
The step never reads a value back to the host: metrics stay device
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.mlp import NeRFMLP, init_model
from nerfmlp_torch.ops.render import prepare_params, render_rays

ADAM_BETAS = (0.9, 0.999)   # optax.adam defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """Everything a step mutates: the update count, the nets, Adam and
    the generator that draws the stratified jitter and noise."""

    step: int
    params: Dict[str, NeRFMLP]     # {"coarse": net, ["fine": net]}
    optimizer: torch.optim.Adam
    generator: torch.Generator


def lr_at(tc: TrainConfig, count: int) -> float:
    """Learning rate of the update that follows ``count`` updates
    (optax ``exponential_decay``, not staircase)."""
    return tc.lr * tc.lr_decay_rate ** (count / tc.lr_decay_steps)


def make_optimizer(params: Dict[str, NeRFMLP],
                   tc: TrainConfig) -> torch.optim.Adam:
    """Adam over every net's parameters, optax's defaults; the learning
    rate is set per update by the step (:func:`lr_at`)."""
    return torch.optim.Adam(
        [p for net in params.values() for p in net.parameters()],
        lr=tc.lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def create_train_state(rc: RenderConfig, tc: TrainConfig,
                       device=None) -> TrainState:
    """Fresh nets (Flax-style init from ``tc.seed``; the fine net, with
    ``separate_fine``, from ``seed + 1``), Adam and a generator on
    ``device`` (default ``cuda``) seeded from ``tc.seed``."""
    dev = resolve_device(device)
    params = {"coarse": init_model(rc.model_config(), seed=tc.seed,
                                   device=dev)}
    if rc.separate_fine and rc.N_importance > 0:
        params["fine"] = init_model(rc.model_config(fine=True),
                                    seed=tc.seed + 1, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tc.seed)
    return TrainState(step=0, params=params,
                      optimizer=make_optimizer(params, tc), generator=gen)


def loss_and_metrics(params: Dict, batch: torch.Tensor,
                     generator: Optional[torch.Generator], rc: RenderConfig,
                     tc: TrainConfig, occ_grid=None, bounds=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: (B, 9) = [rays_o | rays_d | rgb], or (B, 12) with world
    viewdirs for NDC datasets. Returns the loss (fine MSE, plus the coarse
    MSE with ``coarse_loss``) and {loss: fine MSE, psnr: of the fine MSE}.
    ``occ_grid``: the density grid of ``use_occupancy``. ``bounds``:
    optional [near, far] overriding the config's."""
    rays_o, rays_d = batch[:, 0:3], batch[:, 3:6]
    viewdirs = batch[:, 6:9] if batch.shape[1] == 12 else None
    target = batch[:, -3:]
    near = far = None
    if bounds is not None:
        near, far = bounds[0], bounds[1]
    out = render_rays(params, rays_o, rays_d, generator, rc, near=near,
                      far=far, occ_grid=occ_grid, viewdirs=viewdirs)
    loss_fine = torch.mean((out["rgb_map"] - target) ** 2)
    loss = loss_fine
    if tc.coarse_loss and "rgb_map_coarse" in out:
        loss = loss + torch.mean((out["rgb_map_coarse"] - target) ** 2)
    psnr = -10.0 * torch.log10(torch.clamp(loss_fine.detach(), min=1e-10))
    return loss, {"loss": loss_fine.detach(), "psnr": psnr}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def make_step_fn(rc: RenderConfig, tc: TrainConfig):
    """The update rule ``step_fn(state, batch[, occ_grid]) -> metrics``:
    one step in place on ``state``. Metrics are device tensors: loss, psnr,
    grad_norm and total_loss."""

    def step_fn(state: TrainState, batch: torch.Tensor, occ_grid=None
                ) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        params = prepare_params(state.params, rc, backward=True)  # once a step
        loss, metrics = loss_and_metrics(params, batch, state.generator,
                                         rc, tc, occ_grid)
        loss.backward()
        grads = []
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    # Not reached by the loss: optax's zero gradient, so the
                    # moments decay and the update count stays shared.
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        gnorm = global_norm(grads)
        if tc.grad_clip > 0:
            clip = tc.grad_clip
            scale = torch.where(gnorm < clip, torch.ones_like(gnorm),
                                clip / gnorm)
            for g in grads:
                g.mul_(scale)
        for group in state.optimizer.param_groups:
            group["lr"] = lr_at(tc, state.step)
        state.optimizer.step()
        state.step += 1
        return dict(metrics, grad_norm=gnorm, total_loss=loss.detach())

    return step_fn
