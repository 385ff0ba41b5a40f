"""Tensor parallelism for the NeRF MLP over a ("data", "model") mesh.

Counterpart of ``nerfmlp_tpu/parallel/tensor_parallel.py``. The JAX
package annotates the parameters' shardings in Megatron's column / row
alternation and lets GSPMD insert the collectives. Here the same rule
(:func:`spec_for`, JAX's ``_spec_for`` rule for rule) places each
parameter, and :class:`TPNeRFMLP` runs the net on this rank's shards with
the collectives written out, Megatron's way:

  * a column layer (even trunk layers, ``bottleneck``, ``view``) holds
    rows of ``weight`` (its output features) and of ``bias``: it takes
    the whole input and leaves its output split on the feature axis;
    backward sums the input's gradient over the model ranks;
  * a row layer (odd trunk layers, ``sigma``, ``rgb``, ``output``) holds
    columns of ``weight`` (its input features) and the whole ``bias``:
    it takes its share of the input features (sliced from a whole input,
    whose gradient is then gathered in backward) and sums its partial
    products over the model ranks (one ``all_reduce``), then adds the
    bias;
  * a layer whose split dimension does not divide by the model size (or
    is smaller) is replicated, as in JAX: for 8x256 with view directions
    at tp = 2, ``pts_linears.5`` (input 63 + 256 = 319). Its input is
    gathered whole first, as is a split activation before a
    concatenation (the skip, ``bottleneck || viewdirs``).

The rule is stated on flax kernels ``(in, out)``; ``nn.Linear.weight`` is
``(out, in)``, so a column layer splits ``weight`` dim 0 and a row layer
dim 1. Adam's moments follow their parameters (local shards; the
hand-written ``_foreach`` Adam runs on them unchanged). Gradients are
averaged over the "data" sub-group only; the global norm of the clip sums
each shard's squares once over the "model" sub-group and each replicated
parameter's once (every model rank holds its whole gradient). The fused
kernels have no path for sharded weights: the step runs the module path,
as the JAX Trainer turns its Pallas kernel off under TP.

Why collectives by hand and not DTensor: the concatenations of a split
activation with a whole one (the skip, the view head) have no DTensor
sharding strategy and would be redistributed by hand anyway, and gloo
(several ranks sharing one card, the CPU tests) cannot all-gather CUDA
tensors, which :func:`~nerfmlp_torch.parallel.mesh.all_gather_rows`
routes through the host. Every rank of a model group computes the same
replicated activations, so the collectives here are the only places
where a TP step's arithmetic parts from one process's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.models.mlp import NeRFMLP, run_layers
from nerfmlp_torch.parallel.mesh import Mesh, all_gather_rows, make_mesh

# Heads whose kernel is split on the OUTPUT feature axis (column); the
# other heads (sigma, rgb, output) on the INPUT axis (row). Trunk layers
# alternate by index.
_COL_HEADS = ("bottleneck", "view")


def check_tp(n_devices: int, model_parallel: int) -> None:
    """JAX's ``ValueError`` where ``n_devices`` ranks do not split into
    model groups of ``model_parallel``."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"tp={model_parallel}")


def make_tp_mesh(n_devices: int = 0, model_parallel: int = 2, device=None,
                 mesh: Optional[Mesh] = None) -> Mesh:
    """A ("data", "model") mesh over the ranks of the running process
    group (or of ``mesh``, a data-parallel mesh of the default group):
    ``n_devices`` ranks (0: all of them), the model axis innermost, so
    that rank = d * tp + m. Raises JAX's ``ValueError`` when the count
    does not divide by ``model_parallel`` — before it needs a group, so
    one process asked for tp > 1 fails the same way."""
    n = n_devices or (mesh.world_size if mesh is not None else
                      dist.get_world_size() if dist.is_initialized() else 1)
    check_tp(n, model_parallel)
    base = mesh if mesh is not None else make_mesh(n, device)
    if base.group is not None or base.world_size != n:
        raise ValueError(f"make_tp_mesh takes the default group's mesh of "
                         f"{n} ranks, not a sub-group's of "
                         f"{base.world_size}")
    tp, dp = model_parallel, n // model_parallel
    # Every rank creates every group, in the same order.
    data_groups = [dist.new_group([d * tp + m for d in range(dp)])
                   for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)])
                    for d in range(dp)]
    d, m = divmod(base.rank, tp)

    def sub(rank, world, group):
        return Mesh(rank=rank, world_size=world, device=base.device,
                    backend=base.backend, group=group)

    return dataclasses.replace(base, data=sub(d, dp, data_groups[m]),
                               model=sub(m, tp, model_groups[d]))


def _jax_layer(layer: str) -> str:
    """The flax layer name of a port module: ``pts_linears.3`` -> ``pts_3``,
    ``sigma_linear`` -> ``sigma``."""
    if layer.startswith("pts_linears."):
        return "pts_" + layer.split(".")[1]
    return layer[:-len("_linear")] if layer.endswith("_linear") else layer


def spec_for(name: str, shape, tp: int) -> Optional[int]:
    """The dimension of parameter ``name`` (``pts_linears.0.weight``,
    ``sigma_linear.bias``, ...) of ``shape`` split over ``tp`` model
    ranks, or None (replicated): JAX's ``_spec_for``
    (``nerfmlp_tpu/parallel/tensor_parallel.py:59-85``) on the transposed
    layout. A column layer's ``weight`` splits dim 0 and its bias too; a
    row layer's ``weight`` dim 1, its bias never; only where that
    dimension divides by ``tp`` and is at least ``tp``."""
    layer, kind = name.rsplit(".", 1)
    layer = _jax_layer(layer)

    def div(dim):
        return dim % tp == 0 and dim >= tp

    is_col = layer in _COL_HEADS or (
        layer.startswith("pts_") and int(layer[4:]) % 2 == 0)
    if kind == "weight" and len(shape) == 2:
        if is_col and div(shape[0]):
            return 0
        if not is_col and div(shape[1]):
            return 1
    elif kind == "bias" and len(shape) == 1:
        if is_col and div(shape[0]):
            return 0
    return None


def _local(t: torch.Tensor, dim: Optional[int], model: Mesh) -> torch.Tensor:
    """This model rank's shard of the whole tensor ``t`` along ``dim``."""
    if dim is None:
        return t
    per = t.shape[dim] // model.world_size
    return t.narrow(dim, model.rank * per, per)


def _gather(t: torch.Tensor, dim: Optional[int], model: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's shard ``t`` along
    ``dim`` (a copy of ``t`` where it is replicated)."""
    if dim is None:
        return t.clone()
    every = all_gather_rows(t.movedim(dim, 0), model)
    return every.movedim(0, dim).contiguous()


def _gather_features(t: torch.Tensor, model: Mesh) -> torch.Tensor:
    """(P, f) per model rank -> (P, tp * f), rank-major on the features."""
    return _gather(t, t.dim() - 1, model)


def _all_reduce_sum(t: torch.Tensor, model: Mesh) -> torch.Tensor:
    """The sum over the model ranks, in fp32 (or fp64 for fp64 ``t``), as
    a new tensor of ``t``'s dtype."""
    y = t.to(torch.promote_types(t.dtype, torch.float32), copy=True)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=model.group)
    return y.to(t.dtype)


class _Reduce(torch.autograd.Function):
    """A row layer's partial products summed over the model ranks; the
    gradient passes as it is (every rank holds the whole one)."""

    @staticmethod
    def forward(ctx, x, model):
        return _all_reduce_sum(x, model)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """A whole activation into a column layer: the same values; the
    gradient, which each rank holds only through its own columns, summed
    over the model ranks."""

    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.model), None


class _Gather(torch.autograd.Function):
    """Feature-split activations made whole; backward keeps this rank's
    features of the (whole, equal on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, model):
        ctx.model, ctx.width = model, x.shape[-1]
        return _gather_features(x, model)

    @staticmethod
    def backward(ctx, g):
        m, f = ctx.model.rank, ctx.width
        return g[..., m * f:(m + 1) * f].contiguous(), None


class _Split(torch.autograd.Function):
    """This rank's features of a whole activation, for a row layer;
    backward gathers every rank's gradient into the whole one."""

    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return _local(x, x.dim() - 1, model).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_features(g, ctx.model), None


class TPNeRFMLP(nn.Module):
    """A :class:`~nerfmlp_torch.models.mlp.NeRFMLP` held as this model
    rank's shards: the same module and parameter names, each parameter
    the slice :func:`spec_for` gives it (``split``: parameter name -> its
    split dimension or None), and a forward with the same signature that
    returns the whole ``[rgb, sigma]`` on every model rank."""

    def __init__(self, net: NeRFMLP, model: Mesh):
        super().__init__()
        self.cfg = net.cfg
        self.model = model
        self.split: Dict[str, Optional[int]] = {}
        for name, module in net.named_children():
            self.add_module(name, copy.deepcopy(module))
        with torch.no_grad():
            for name, p in list(self.named_parameters()):
                dim = spec_for(name, tuple(p.shape), model.world_size)
                self.split[name] = dim
                if dim is not None:
                    layer, kind = name.rsplit(".", 1)
                    setattr(self.get_submodule(layer), kind,
                            nn.Parameter(_local(p, dim, model).clone()))

    def _whole(self, h: torch.Tensor, split: bool) -> torch.Tensor:
        return _Gather.apply(h, self.model) if split else h

    def _dense(self, name: str, h: torch.Tensor, split: bool,
               dtype: torch.dtype):
        """One layer on input ``h`` (feature-split or whole): (output,
        whether it is feature-split)."""
        layer = self.get_submodule(name)
        w, b = layer.weight.to(dtype), layer.bias.to(dtype)
        dim = self.split[f"{name}.weight"]
        if dim == 1:                                     # row
            if not split:
                h = _Split.apply(h, self.model)
            return _Reduce.apply(F.linear(h, w), self.model) + b, False
        h = self._whole(h, split)
        if dim == 0:                                     # column
            h = _Copy.apply(h, self.model)
        return F.linear(h, w, b), dim == 0

    def forward(self, x: torch.Tensor, viewdirs: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32,
                remat: bool = False) -> torch.Tensor:
        """:meth:`NeRFMLP.forward` on the shards: raw ``[rgb, sigma]`` (or
        ``output_ch`` channels), whole on every model rank. ``remat`` as
        there: a recomputed run repeats its collectives, on every rank in
        the same order."""
        cfg = self.cfg

        def trunk(layers, x, state):
            h, split = state
            for i in layers:
                if i in cfg.skips:
                    h, split = torch.cat([x, self._whole(h, split)], -1), False
                h, split = self._dense(f"pts_linears.{i}", h, split,
                                       compute_dtype)
                h = F.relu(h)
            return h, split

        def last(layers, x, state, viewdirs):
            h, split = trunk(layers, x, state)
            if cfg.use_viewdirs and viewdirs is not None:
                sigma, s_split = self._dense("sigma_linear", h, split,
                                             compute_dtype)
                bottleneck, b_split = self._dense("bottleneck_linear", h,
                                                  split, compute_dtype)
                h = torch.cat([self._whole(bottleneck, b_split),
                               viewdirs.to(compute_dtype)], -1)
                h, split = self._dense("view_linear", h, False, compute_dtype)
                rgb, r_split = self._dense("rgb_linear", F.relu(h), split,
                                           compute_dtype)
                return torch.cat([self._whole(rgb, r_split),
                                  self._whole(sigma, s_split)], -1)
            out, split = self._dense("output_linear", h, split, compute_dtype)
            return self._whole(out, split)

        x = x.to(compute_dtype)
        return run_layers(trunk, last, cfg.depth, x, (x, False), viewdirs,
                          remat)

    @torch.no_grad()
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole net's state dict, gathered from the model ranks (a
        collective: every model rank calls it)."""
        return {name: _gather(p.detach(), self.split[name], self.model)
                for name, p in self.named_parameters()}

    @torch.no_grad()
    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """This rank's shards of a whole net's state dict, in place."""
        mine = dict(self.named_parameters())
        if set(sd) != set(mine):
            raise RuntimeError(f"state dict keys {sorted(sd)} do not match "
                               f"the net's {sorted(mine)}")
        for name, p in mine.items():
            whole = torch.as_tensor(sd[name])
            want = list(p.shape)
            if self.split[name] is not None:
                want[self.split[name]] *= self.model.world_size
            if list(whole.shape) != want:
                raise RuntimeError(f"size mismatch for {name}: "
                                   f"{tuple(whole.shape)} vs {tuple(want)}")
            p.copy_(_local(whole, self.split[name], self.model))

    def to_full(self) -> NeRFMLP:
        """The whole net as a :class:`NeRFMLP` on this rank's device (a
        collective)."""
        sd = self.full_state_dict()
        dev = next(iter(sd.values())).device
        net = NeRFMLP(self.cfg, generator=torch.Generator()).to(dev)
        net.load_state_dict(sd)
        return net


def param_splits(params: Dict) -> List[Optional[int]]:
    """Each parameter's split dimension (None: whole on every model rank),
    in the optimizer's order (``train_step.make_optimizer``)."""
    return [net.split[name] for net in params.values()
            for name, _ in net.named_parameters()]


def tp_global_norm(grads, splits, model: Mesh) -> torch.Tensor:
    """optax's ``global_norm`` of a net held in shards: each split
    gradient's squares summed over the model ranks (one ``all_reduce``),
    each whole one's counted once."""
    dev = grads[0].device
    split_sq = torch.zeros((), dtype=torch.float32, device=dev)
    whole_sq = torch.zeros((), dtype=torch.float32, device=dev)
    for g, dim in zip(grads, splits):
        sq = torch.sum(g.float() ** 2)
        if dim is None:
            whole_sq = whole_sq + sq
        else:
            split_sq = split_sq + sq
    dist.all_reduce(split_sq, op=dist.ReduceOp.SUM, group=model.group)
    return torch.sqrt(split_sq + whole_sq)


def shard_state(state, mesh: Mesh):
    """A one-device ``TrainState`` (the same on every rank) -> this rank's
    TP state: each net a :class:`TPNeRFMLP`, Adam's moments sliced as
    their parameters, the count, step, generator and counter kept."""
    from nerfmlp_torch.parallel.train_step import Adam, TrainState

    params = {k: TPNeRFMLP(net, mesh.model)
              for k, net in state.params.items()}
    full = state.optimizer
    opt = Adam([p for net in params.values() for p in net.parameters()],
               betas=full.betas, eps=full.eps)
    with torch.no_grad():
        opt.count.copy_(full.count)
        for dim, mine, whole in zip(param_splits(params) * 2,
                                    opt.exp_avg + opt.exp_avg_sq,
                                    full.exp_avg + full.exp_avg_sq):
            mine.copy_(_local(whole, dim, mesh.model))
    return TrainState(step=state.step, params=params, optimizer=opt,
                      generator=state.generator, counter=state.counter)


def gather_state(state):
    """This rank's TP state -> the whole ``TrainState`` (nets, Adam's
    moments and count; the step, generator and counter shared), as one
    process holds it: what a checkpoint saves (a collective)."""
    from nerfmlp_torch.parallel.train_step import Adam, TrainState

    params = {k: net.to_full() for k, net in state.params.items()}
    mine = state.optimizer
    opt = Adam([p for net in params.values() for p in net.parameters()],
               betas=mine.betas, eps=mine.eps)
    splits = param_splits(state.params)
    model = next(iter(state.params.values())).model
    with torch.no_grad():
        opt.count.copy_(mine.count)
        for dim, whole, local in zip(splits * 2, opt.exp_avg + opt.exp_avg_sq,
                                     mine.exp_avg + mine.exp_avg_sq):
            whole.copy_(_gather(local, dim, model))
    return TrainState(step=state.step, params=params, optimizer=opt,
                      generator=state.generator, counter=state.counter)


@torch.no_grad()
def load_full_state(state, params: Dict, opt_state: Optional[Dict]) -> None:
    """Whole nets' state dicts (``params``, by net name) and, where given,
    a whole Adam state (``Adam.state_dict`` layout) into this rank's TP
    ``state``, each sliced to this rank's shards, in place."""
    for key, net in state.params.items():
        net.load_full_state_dict(params[key])
    if opt_state is None:
        return
    model = next(iter(state.params.values())).model
    sliced = {"param_groups": opt_state["param_groups"], "state": {
        i: {"step": s["step"],
            "exp_avg": _local(torch.as_tensor(s["exp_avg"]), dim, model),
            "exp_avg_sq": _local(torch.as_tensor(s["exp_avg_sq"]), dim,
                                 model)}
        for (i, s), dim in zip(sorted(opt_state["state"].items()),
                               param_splits(state.params))}}
    if not opt_state["state"]:
        sliced["state"] = {}
    state.optimizer.load_state_dict(sliced)


def tp_render_config(rc: RenderConfig) -> RenderConfig:
    """``rc`` with the fused kernels off: they have no path for sharded
    weights, so a TP step runs the module path."""
    return dataclasses.replace(rc, use_kernel=False) if rc.use_kernel else rc


def make_tp_step(rc: RenderConfig, tc: TrainConfig, mesh: Mesh):
    """The train step on this rank of a ("data", "model") ``mesh``:
    ``step_fn(state, batch) -> metrics`` on a state from
    :func:`shard_state`, ``batch`` this rank's rows of the global batch
    (``shard_batch`` over ``mesh.data``). The module path, whatever
    ``rc.use_kernel`` says (:func:`tp_render_config`)."""
    from nerfmlp_torch.parallel.train_step import make_step_fn

    return make_step_fn(rc, tc, mesh)
