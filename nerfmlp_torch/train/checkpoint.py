"""Checkpoints: served weights, the resumable train state and the
metrics-JSON contract.

Counterpart of ``nerfmlp_tpu/train/checkpoint.py:40-262``. Formats:

  * ``.npy`` official weight lists and reference ``.pth``/``.pt`` state
    dicts are read by :func:`load_params_any`;
  * the Trainer writes ``torch.save`` files with the ``.pt`` suffix (the
    JAX package's names, ``.ckpt`` -> ``.pt``): ``model_{step}.pt``,
    ``model_best.pt``, ``model_final.pt`` hold parameters — the bare state
    dict of the shared net, which :func:`load_params_any` and the serve
    CLI read like any reference ``.pth``, or ``{"coarse": ..., "fine":
    ...}`` state dicts with a separate fine net; ``metrics_latest.pt`` and
    ``model_full_val_final.pt`` hold the whole train state (step, params,
    Adam state, generator state) beside a ``.history.json`` sidecar;
  * the JAX package's flax-msgpack ``.ckpt`` files (``train/flax_msgpack.py``)
    are read wherever a ``.pt`` is: parameter trees ``{"coarse", ["fine"]}``
    or one bare net, and whole train states (``opt_state`` present), whose
    optax Adam moments and count :func:`load_checkpoint` maps into the
    port's Adam. Flax ``Dense`` names and ``(in, out)`` kernels are mapped
    to the port's modules by ``models/convert.py``. :func:`save_ckpt`
    writes a tree in that format, which the JAX package reads.

Every write goes to a temporary name and is renamed into place, so a
crash never leaves a truncated file for auto-resume to find.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import ModelConfig
from nerfmlp_torch.models import convert
from nerfmlp_torch.train import flax_msgpack
from nerfmlp_torch.train.flax_msgpack import CheckpointCorruptError

STATE_FORMAT = "nerfmlp_torch.train_state/1"


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def save_params(path: str, params: Dict) -> None:
    """Parameters only: the shared net's bare state dict, or a dict of
    state dicts when there is a separate fine net."""
    if set(params) == {"coarse"}:
        obj = _cpu_state_dict(params["coarse"])
    else:
        obj = {k: _cpu_state_dict(net) for k, net in params.items()}
    _atomic_save(obj, path)


def save_checkpoint(path: str, state) -> None:
    """The whole train state (a parallel/train_step.py ``TrainState``)."""
    _atomic_save({
        "format": STATE_FORMAT,
        "step": int(state.step),
        "params": {k: _cpu_state_dict(n) for k, n in state.params.items()},
        "opt_state": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }, path)


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None,
                    fine_cfg: Optional[ModelConfig] = None) -> Dict:
    """A file the Trainer wrote, on the CPU: a train state (``format`` ==
    ``STATE_FORMAT``) or parameters. A JAX ``.ckpt`` comes back in the
    same layout for nets of ``cfg`` (``fine_cfg``: the fine net's, when it
    differs); its train state carries no generator state (``None``: a JAX
    PRNG key cannot seed a torch generator). Undecodable bytes raise
    :class:`CheckpointCorruptError`, a tree that does not fit the
    architecture ``ValueError``."""
    if not path.endswith(".ckpt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    cfg = cfg or ModelConfig()
    raw = read_ckpt(path)
    if "opt_state" not in raw:
        return {k: convert.state_dict_from_params(
            tree, fine_cfg or cfg if k == "fine" else cfg)
            for k, tree in _net_trees(raw, path).items()}
    trees = _net_trees(raw.get("params"), path)
    cfgs = {k: fine_cfg or cfg if k == "fine" else cfg for k in trees}
    count, mu, nu = _adam_state(raw["opt_state"], path)
    mu, nu = _net_trees(mu, path), _net_trees(nu, path)
    if not set(mu) == set(nu) == set(trees):
        raise ValueError(f"{path}: Adam moments for nets {sorted(mu)}, "
                         f"parameters for {sorted(trees)}")
    # The port's Adam holds the nets' parameters in this order (coarse,
    # fine; each net's modules as state_dict_from_params lists them, the
    # order NeRFMLP registers them).
    moments = [
        (m, v) for k in trees
        for m, v in zip(
            convert.state_dict_from_params(mu[k], cfgs[k]).values(),
            convert.state_dict_from_params(nu[k], cfgs[k]).values())]
    return {
        "format": STATE_FORMAT,
        "step": _int_leaf(raw.get("step"), path, "step"),
        "params": {k: convert.state_dict_from_params(t, cfgs[k])
                   for k, t in trees.items()},
        "opt_state": {"state": {
            i: {"step": torch.tensor(float(count)), "exp_avg": m,
                "exp_avg_sq": v} for i, (m, v) in enumerate(moments)}},
        "generator": None,
    }


def read_ckpt(path: str) -> Dict:
    """The tree of a flax-msgpack ``.ckpt`` (numpy leaves); raises
    :class:`CheckpointCorruptError` unless it decodes to a map."""
    raw = flax_msgpack.load(path)
    if not isinstance(raw, dict):
        raise CheckpointCorruptError(
            f"{path} decoded to {type(raw).__name__}, expected a dict")
    return raw


def save_ckpt(path: str, tree) -> None:
    """Write ``tree`` (numpy or tensor leaves) as a flax-msgpack ``.ckpt``,
    atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(flax_msgpack.encode(tree))
    os.replace(tmp, path)


def jax_params_tree(params: Dict) -> Dict:
    """``{"coarse": NeRFMLP, ...}`` -> the JAX package's param tree, keys
    sorted at every level as the JAX package writes them (it writes trees
    through ``jax.device_get``, which sorts dict keys)."""
    def srt(t):
        return {k: srt(t[k]) for k in sorted(t)} if isinstance(t, dict) else t

    return srt({k: convert.params_from_model(net) for k, net in
                params.items()})


def _net_trees(raw, path: str) -> Dict[str, Dict]:
    """``{"coarse": tree, ["fine": tree]}`` of a params map, which holds the
    nets under those keys or is one bare net."""
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: no parameter tree where one was expected")
    if "coarse" not in raw:
        raw = {"coarse": raw}
    extra = sorted(set(raw) - {"coarse", "fine"})
    if extra:
        raise ValueError(f"{path}: unexpected nets {extra} beside "
                         "'coarse' / 'fine'")
    return {k: {n: {leaf: _f32(v) for leaf, v in layer.items()}
                if isinstance(layer, dict) else layer
                for n, layer in raw[k].items()}
            for k in ("coarse", "fine") if k in raw}


def _f32(leaf):
    """A float32 numpy copy of a decoded leaf (bfloat16 leaves are
    tensors)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return leaf


def _int_leaf(leaf, path: str, what: str) -> int:
    try:
        return int(leaf)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{path}: {what} is {leaf!r}, not an integer") \
            from e


def _adam_state(opt_state, path: str):
    """(count, mu, nu) of the optax Adam state in a JAX train state's
    ``opt_state``, found by structure: ``opt_state/0/0`` for Adam alone,
    one level deeper behind the clip's empty state with ``grad_clip``."""
    found = []

    def walk(t):
        if isinstance(t, dict):
            if {"count", "mu", "nu"} <= set(t):
                found.append(t)
            else:
                for v in t.values():
                    walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"{path}: {len(found)} Adam states in opt_state, "
                         "expected one (optax.adam's count / mu / nu)")
    adam = found[0]
    return _int_leaf(adam["count"], path, "Adam's count"), adam["mu"], \
        adam["nu"]


def is_train_state(obj) -> bool:
    return isinstance(obj, dict) and obj.get("format") == STATE_FORMAT


def save_metrics_json(path: str, metrics_state: Dict) -> None:
    """Atomic write: live monitors poll this file while training writes
    it."""
    from nerfmlp_torch.train.metrics import convert_for_json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(convert_for_json(metrics_state), f, indent=2)
    os.replace(tmp, path)


def load_metrics_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_params_any(path: str, cfg: Optional[ModelConfig] = None,
                    device=None, with_step: bool = False,
                    fine_cfg: Optional[ModelConfig] = None):
    """``{"coarse": NeRFMLP, ["fine": NeRFMLP]}`` on ``device`` (default
    ``cuda``) from a ``.npy`` official weight list, a ``.pth``/``.pt``
    reference checkpoint (bare or composite state dict), a ``.pt`` the
    Trainer wrote or a ``.ckpt`` the JAX package wrote (parameters, or a
    whole train state whose parameters are taken). ``fine_cfg``: the fine
    net's architecture when it differs. A tree that does not fit the
    architecture raises ``ValueError`` naming the layer.

    ``with_step=True`` returns ``(params, step)``, the step read from the
    file name or, for a train state, from the state."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    step = step_from_filename(path)
    if path.endswith(".npy"):
        nets = {"coarse": convert.params_from_numpy(
            convert.load_npy_weights(path), cfg)}
    elif path.endswith(".ckpt"):
        raw = read_ckpt(path)
        if "opt_state" in raw:
            step = step or _int_leaf(raw.get("step"), path, "step")
            raw = raw["params"]
        nets = _net_trees(raw, path)
    elif path.endswith((".pth", ".pt")):
        try:
            raw = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            raw = None   # a composite reference dict: load_pth reads it
        if is_train_state(raw):
            step = step or int(raw["step"])
            raw = raw["params"]
        if isinstance(raw, dict) and "coarse" in raw:
            nets = {k: convert.params_from_state_dict(
                sd, fine_cfg or cfg if k == "fine" else cfg)
                for k, sd in raw.items()}
        else:
            nets = {"coarse": convert.load_pth(path, cfg)}
    else:
        raise ValueError(f"{path}: unknown checkpoint format "
                         "(.npy, .pth, .pt or .ckpt)")
    params = {k: convert.model_from_params(
        p, fine_cfg or cfg if k == "fine" else cfg, dev)
        for k, p in nets.items()}
    return (params, step) if with_step else params


def step_from_filename(path: str) -> int:
    """model_{step}.pt / model_{step}_latest.pt (or the JAX package's
    .ckpt names) -> step; 0 when the name carries no step."""
    stem = os.path.basename(path)
    for suffix in ("_latest.pt", ".pt", "_latest.ckpt", ".ckpt"):
        if stem.startswith("model_") and stem.endswith(suffix):
            digits = stem[len("model_"): -len(suffix)]
            if digits.isdigit():
                return int(digits)
    return 0


def step_in_checkpoint(path: str) -> int:
    """The step recorded inside a whole train state (``metrics_latest.pt``
    or ``.ckpt`` names none); 0 for any other file, or one that cannot be
    read."""
    if not path or not path.endswith((".pt", ".ckpt")) \
            or not os.path.exists(path):
        return 0
    try:
        if path.endswith(".ckpt"):
            raw = read_ckpt(path)
            return (_int_leaf(raw.get("step"), path, "step")
                    if "opt_state" in raw else 0)
        raw = load_checkpoint(path)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError,
            CheckpointCorruptError, ValueError):
        return 0
    return int(raw["step"]) if is_train_state(raw) else 0


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The most recent resumable checkpoint in a directory: the whole
    state ``metrics_latest.pt``, else the ``model_{step}.pt`` with the
    highest step (``model_best``/``model_final`` carry no step and are
    never picked: resuming them would renumber a finished run from 0)."""
    if not os.path.isdir(save_dir):
        return None
    cand = os.path.join(save_dir, "metrics_latest.pt")
    if os.path.exists(cand):
        return cand
    best = (None, 0)
    for name in os.listdir(save_dir):
        if name.startswith("model_") and name.endswith(".pt"):
            step = step_from_filename(name)
            if step > best[1]:
                best = (name, step)
    return os.path.join(save_dir, best[0]) if best[0] is not None else None
