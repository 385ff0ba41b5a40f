"""The training step: render -> MSE -> backward -> Adam.

Counterpart of ``nerfmlp_tpu/parallel/train_step.py:30-127``
(``TrainState``, ``make_optimizer``, ``create_train_state``,
``loss_and_metrics``, ``make_step_fn``), on one device or data-parallel
over ranks (``mesh``, below); and of that rule under ``jax.vmap`` over a
scene axis (:func:`make_stack_step_body`, for
``parallel/multi_scene.py``). The update is optax's, term by term:

  * Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias correction from Adam's own update count): :class:`Adam`,
    written with ``torch._foreach_*`` operations so that its state and
    every scalar it reads stay on the device;
  * the learning rate of update ``k`` (0-based: the number of updates
    before it) is ``lr * rate ** (k / steps)`` — optax's continuous
    ``exponential_decay`` — computed on the device from the state's step
    counter (:func:`lr_tensor`);
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

The step never reads a value back to the host and reads no host value
that changes between steps: the step count it needs lives in a device
counter, and metrics stay device tensors. So one step can be captured in
a CUDA graph and replayed (``train/graph.py``, ``steps_per_dispatch``).
The exception is :func:`nerfmlp_torch.check_numerics`: while it is on,
the step reads back whether the loss, a gradient or a parameter after the
update holds a NaN, and raises ``FloatingPointError`` naming it and the
step (``make_step_fn``'s ``train step N``); such a step runs eagerly.
Why a hand-written Adam and not ``torch.optim.Adam(capturable=True)``:
the capturable mode refuses CPU tensors, and the CPU path has to run the
very update that the graph replays.

Data parallelism (``mesh``, a :class:`~nerfmlp_torch.parallel.mesh.Mesh`
of N ranks; ``make_train_step(..., mesh=...)`` and ``make_pool_step``'s in
``nerfmlp_tpu/parallel/train_step.py:248-323``): every rank holds the
same nets and Adam state, and its step renders its B/N rays of the global
batch of B. The stratified and noise draws are made at the global shape
from the generator every rank holds in the same state, and each rank
keeps its rows (:class:`~nerfmlp_torch.ops.RankDraws`), so the N ranks
use what one device draws. After ``backward()`` the gradients and the two
losses go into one flat fp32 buffer for one ``all_reduce`` (sum), divided
by N: each rank's loss is the mean over its B/N rays, so this is the
gradient of the mean over all B, up to the order of one sum. The global
norm, the clip and Adam then see the global gradient, as in JAX, and
every rank gets the same bits, so the parameters stay equal across ranks.
PSNR is taken from the averaged loss; nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerfmlp_torch import (
    check_nan, numerics_checked, numerics_scope, resolve_device,
)
from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.mlp import NeRFMLP, init_model
from nerfmlp_torch.ops import RankDraws
from nerfmlp_torch.ops.fused_mlp import NetStack
from nerfmlp_torch.ops.render import prepare_params, render_rays

ADAM_BETAS = (0.9, 0.999)   # optax.adam defaults
ADAM_EPS = 1e-8


class Adam:
    """optax.adam over a fixed list of parameters: moments ``exp_avg`` and
    ``exp_avg_sq`` and the update count ``count`` (fp32, Adam's own: it
    drives the bias correction and restarts with fresh moments) live on
    the parameters' device, and :meth:`step` takes the learning rate as a
    device tensor, so an update reads nothing from the host. The state is
    always materialised (zeros before the first update), and loading
    writes into it in place, so a captured graph's pointers stay valid.
    ``state_dict`` has ``torch.optim.Adam``'s layout, and either class
    reads the other's."""

    def __init__(self, params, betas=ADAM_BETAS, eps=ADAM_EPS):
        self.params = list(params)
        self.betas, self.eps = tuple(betas), float(eps)
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grads, lr: torch.Tensor) -> None:
        """One update with ``grads`` (one per parameter) at learning rate
        ``lr``, a 0-d device tensor: optax's ``scale_by_adam`` then
        ``-lr``, in its order of operations."""
        b1, b2 = self.betas
        self.count.add_(1.0)
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1.0 - b2)
        bc1 = 1.0 - torch.pow(b1, self.count)
        bc2 = 1.0 - torch.pow(b2, self.count)
        denom = torch._foreach_div(self.exp_avg_sq, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.exp_avg, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    @torch.no_grad()
    def reset(self) -> None:
        """Fresh moments and count, in place."""
        self.count.zero_()
        for t in self.exp_avg + self.exp_avg_sq:
            t.zero_()

    def state_dict(self) -> Dict:
        """Copies, one ``step`` per parameter: ``torch.optim.Adam`` adds 1
        to each parameter's ``step`` in place, so a shared tensor would
        count once per parameter. The group holds every key of
        ``torch.optim.Adam``'s; its ``lr`` is that class's default, as the
        rate is set per update."""
        group = torch.optim.Adam([torch.zeros(())], betas=self.betas,
                                 eps=self.eps).state_dict()["param_groups"][0]
        group["params"] = list(range(len(self.params)))
        return {
            "state": {i: {"step": self.count.clone(), "exp_avg": m.clone(),
                          "exp_avg_sq": v.clone()}
                      for i, (m, v) in enumerate(zip(self.exp_avg,
                                                     self.exp_avg_sq))},
            "param_groups": [group],
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Copy a state in (this class's or ``torch.optim.Adam``'s, whose
        state is empty before its first update), in place."""
        state = sd["state"]
        if not state:
            self.reset()
            return
        if sorted(state) != list(range(len(self.params))):
            raise ValueError(f"optimizer state for {len(state)} parameters, "
                             f"this run has {len(self.params)}")
        for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq)):
            m.copy_(state[i]["exp_avg"])
            v.copy_(state[i]["exp_avg_sq"])
        self.count.fill_(float(state[0]["step"]))


@dataclasses.dataclass
class TrainState:
    """Everything a step mutates: the update count, the nets, Adam and
    the generator that draws the stratified jitter and noise.

    ``step`` is the host's count of updates; ``counter`` the same count as
    a () int64 tensor on the nets' device, which the step reads (learning
    rate, device-pool batch) and advances, so that a replayed graph
    counts too. Between steps they agree; :meth:`set_step` sets both."""

    step: int
    params: Dict[str, NeRFMLP]     # {"coarse": net, ["fine": net]}
    optimizer: Adam
    generator: torch.Generator
    counter: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.counter is None:
            dev = next(self.params["coarse"].parameters()).device
            self.counter = torch.zeros((), dtype=torch.int64, device=dev)
            self.counter.fill_(int(self.step))

    def set_step(self, step: int) -> None:
        self.step = int(step)
        self.counter.fill_(self.step)


def lr_at(tc: TrainConfig, count: int) -> float:
    """Learning rate of the update that follows ``count`` updates
    (optax ``exponential_decay``, not staircase), on the host: the log's."""
    return tc.lr * tc.lr_decay_rate ** (count / tc.lr_decay_steps)


def lr_tensor(tc: TrainConfig, counter: torch.Tensor) -> torch.Tensor:
    """:func:`lr_at` on the device, in fp32 as optax computes it, from the
    () integer ``counter``."""
    return tc.lr * torch.pow(tc.lr_decay_rate,
                             counter.to(torch.float32) / tc.lr_decay_steps)


def make_optimizer(params: Dict[str, NeRFMLP], tc: TrainConfig) -> Adam:
    """Adam over every net's parameters, optax's defaults; the learning
    rate comes with each update (:func:`lr_tensor`)."""
    return Adam([p for net in params.values() for p in net.parameters()],
                betas=ADAM_BETAS, eps=ADAM_EPS)


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
    return loss, {"loss": loss_fine.detach(), "psnr": psnr_of(loss_fine)}


def psnr_of(mse: torch.Tensor) -> torch.Tensor:
    """PSNR of an MSE (a tensor), floored at 1e-10 as JAX floors it."""
    return -10.0 * torch.log10(torch.clamp(mse.detach(), min=1e-10))


def _draws(generator, mesh):
    """The step's generator(s), or under a mesh the rank's share of the
    global draws (:class:`~nerfmlp_torch.ops.RankDraws`)."""
    if mesh is None:
        return generator
    return RankDraws(generator, mesh.rank, mesh.world_size)


def _all_reduce_mean(grads, extras, mesh):
    """(grads, extras) averaged over the ranks of ``mesh`` by ONE
    ``all_reduce`` of one flat fp32 buffer: the gradients (views of the
    buffer come back, shaped like ``grads``) and the 0-d ``extras`` after
    them. Without a mesh, both as they are."""
    if mesh is None:
        return grads, list(extras)
    from nerfmlp_torch.parallel.mesh import all_reduce_mean_

    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [e.reshape(1).float() for e in extras])
    all_reduce_mean_(flat, mesh)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out, list(flat[i:].unbind())


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def _grads(params) -> list:
    """Each parameter's gradient, in order; a parameter the loss does not
    reach gets optax's zero gradient, so its moments decay and the update
    count stays shared."""
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def _param_names(params: Dict) -> list:
    """``{net}.{parameter}`` of every parameter, in the optimizer's order
    (:func:`make_optimizer`)."""
    return [f"{key}.{name}" for key, net in params.items()
            for name, _ in net.named_parameters()]


def _clip(grads, gnorm: torch.Tensor, tc: TrainConfig) -> None:
    """``clip_by_global_norm(tc.grad_clip)`` of ``grads`` in place, from
    their norm ``gnorm``; nothing when ``grad_clip`` is 0."""
    if tc.grad_clip > 0:
        clip = tc.grad_clip
        scale = torch.where(gnorm < clip, torch.ones_like(gnorm), clip / gnorm)
        torch._foreach_mul_(grads, scale)


def make_step_body(rc: RenderConfig, tc: TrainConfig, mesh=None):
    """The update rule on the device, ``body(state, batch[, occ_grid[,
    bounds]]) -> metrics``: one step in place on the state's nets, Adam and
    counter, the host's ``state.step`` left alone. ``bounds``: an optional
    [near, far] pair (a (2,) tensor) overriding the config's, as JAX's
    ``step_fn`` takes it. It reads no host value that changes between
    steps and reads nothing back, so it can be captured in a CUDA graph.
    Metrics are device tensors: loss, psnr, grad_norm and total_loss.

    ``mesh``: a data-parallel :class:`~nerfmlp_torch.parallel.mesh.Mesh`;
    ``batch`` is then this rank's rows of the global batch
    (``parallel/mesh.py::shard_batch``), and the gradients and losses are
    averaged over the ranks before the clip (the module's docstring);
    metrics are the global batch's. A ("data", "model") mesh
    (``parallel/tensor_parallel.py``) takes the state of its
    ``shard_state``: ``batch`` is then this rank's rows over ``mesh.data``,
    the gradients are averaged over that sub-group only and the global
    norm sums each shard once over ``mesh.model``; the nets run on the
    module path."""

    model = mesh.model if mesh is not None and mesh.model_parallel > 1 \
        else None
    data = reduce_over = mesh
    if model is not None:
        # The ("data", "model") mesh of parallel/tensor_parallel.py: draws
        # and the gradient average over the data sub-group (none at one
        # data rank); the nets are model-rank shards, which the fused
        # kernels cannot take.
        from nerfmlp_torch.parallel.tensor_parallel import (
            param_splits, tp_global_norm, tp_render_config,
        )

        rc = tp_render_config(rc)
        data = mesh.data
        reduce_over = data if data.world_size > 1 else None

    def body(state: TrainState, batch: torch.Tensor, occ_grid=None,
             bounds=None) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        opt.zero_grad()
        checked = numerics_checked()
        names = _param_names(state.params) if checked else ()
        params = prepare_params(state.params, rc, backward=True)  # once a step
        loss, metrics = loss_and_metrics(params, batch,
                                         _draws(state.generator, data),
                                         rc, tc, occ_grid, bounds)
        check_nan([("the loss", loss)])
        loss.backward()
        grads, (fine, total) = _all_reduce_mean(
            _grads(opt.params), (metrics["loss"], loss.detach()), reduce_over)
        if checked:
            check_nan([(f"the gradient of {n}", g)
                       for n, g in zip(names, grads)])
        if mesh is not None:
            metrics = {"loss": fine, "psnr": psnr_of(fine)}
        gnorm = (global_norm(grads) if model is None else
                 tp_global_norm(grads, param_splits(state.params), model))
        _clip(grads, gnorm, tc)
        opt.step(grads, lr_tensor(tc, state.counter))
        if checked:
            check_nan([(f"the parameter {n} after the update", p)
                       for n, p in zip(names, opt.params)])
        state.counter.add_(1)
        return dict(metrics, grad_norm=gnorm, total_loss=total)

    return body


def make_step_fn(rc: RenderConfig, tc: TrainConfig, mesh=None):
    """One eager step, ``step_fn(state, batch[, occ_grid[, bounds]]) ->
    metrics``: :func:`make_step_body`'s update (over ``mesh``'s ranks,
    where given), then the host's step count."""
    body = make_step_body(rc, tc, mesh)

    def step_fn(state: TrainState, batch: torch.Tensor, occ_grid=None,
                bounds=None) -> Dict[str, torch.Tensor]:
        with numerics_scope(f"train step {state.step + 1}"):
            metrics = body(state, batch, occ_grid, bounds)
        state.step += 1
        return metrics

    return step_fn


# --------------------------------------------------------------------- #
# S scenes in lock step: the update rule under a scene axis
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class StackState:
    """S scenes' train states stacked (JAX's ``TrainState`` with a leading
    scene axis): ``params`` maps coarse / fine to a
    :class:`~nerfmlp_torch.ops.fused_mlp.NetStack` of one net per scene;
    one Adam over every scene's parameters, scene after scene, with one
    update count (every scene's is the same under ``vmap``); one generator
    per scene; the host's ``step`` and the device ``counter``, as in
    :class:`TrainState`."""

    step: int
    params: Dict[str, NetStack]
    optimizer: Adam
    generators: Tuple[torch.Generator, ...]
    counter: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.counter is None:
            net = self.params["coarse"].nets[0]
            self.counter = torch.zeros((), dtype=torch.int64,
                                       device=next(net.parameters()).device)
            self.counter.fill_(int(self.step))


def make_stack_step_body(rc: RenderConfig, tc: TrainConfig, mesh=None):
    """:func:`make_step_body`'s rule for S scenes at once, as JAX's
    ``jax.vmap`` of ``make_step_fn`` computes it: ``body(state, batch[,
    occ_grid[, bounds]]) -> metrics`` with ``batch`` (S, B, 9 | 12),
    ``occ_grid`` a stack of S grids, ``bounds`` an (S, 2) [near, far] per
    scene. One render of the S x B rays, scene-major, each scene's draws
    from its own generator: every fused-MLP call is one launch over all
    scenes. The loss is the sum of the scenes' own losses, so each net's
    gradient is its scene's alone; ``grad_norm`` and the clip are per
    scene (``vmap`` clips each scene alone); Adam runs over every scene's
    parameters with one count and learning rate. Metrics are (S,) device
    tensors. ``mesh``: the data-parallel group of these scenes (the
    ("scene", "data") layout, ``parallel/multi_scene.py``): ``batch`` is
    then (S, B / N, ...), this rank's rows of each scene's batch, and the
    gradients and losses are averaged over the group before the clip, as
    :func:`make_step_body` does."""

    def body(state: StackState, batch: torch.Tensor, occ_grid=None,
             bounds=None) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        opt.zero_grad()
        params = prepare_params(state.params, rc, backward=True)  # once a step
        n_scenes, b = batch.shape[:2]
        flat = batch.reshape(n_scenes * b, batch.shape[2])
        near = far = None
        if bounds is not None:   # per ray, from its scene's pair
            near, far = (bounds[:, i:i + 1].expand(n_scenes, b).reshape(-1)
                         for i in (0, 1))
        out = render_rays(params, flat[:, 0:3], flat[:, 3:6],
                          _draws(state.generators, mesh), rc, near=near,
                          far=far,
                          occ_grid=occ_grid,
                          viewdirs=flat[:, 6:9] if flat.shape[1] == 12
                          else None)
        target = batch[..., -3:]
        rgb = out["rgb_map"].view(n_scenes, b, 3)
        coarse = (out["rgb_map_coarse"].view(n_scenes, b, 3)
                  if tc.coarse_loss and "rgb_map_coarse" in out else None)
        # Each scene's mean over its own rays, as its step alone takes it.
        fine = [torch.mean((rgb[s] - target[s]) ** 2)
                for s in range(n_scenes)]
        losses = [f + torch.mean((coarse[s] - target[s]) ** 2)
                  if coarse is not None else f for s, f in enumerate(fine)]
        sum(losses).backward()
        grads, ext = _all_reduce_mean(
            _grads(opt.params),
            [f.detach() for f in fine] + [x.detach() for x in losses], mesh)
        fine, totals = ext[:n_scenes], ext[n_scenes:]
        per = len(opt.params) // n_scenes   # Adam's params, scene by scene
        gnorms = []
        for s in range(n_scenes):
            mine = grads[s * per:(s + 1) * per]
            gnorms.append(global_norm(mine))
            _clip(mine, gnorms[-1], tc)
        opt.step(grads, lr_tensor(tc, state.counter))
        state.counter.add_(1)
        return {"loss": torch.stack(fine),
                "psnr": torch.stack([psnr_of(f) for f in fine]),
                "grad_norm": torch.stack(gnorms),
                "total_loss": torch.stack(totals)}

    return body
