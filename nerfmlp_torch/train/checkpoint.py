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
  * the JAX package's flax-msgpack ``.ckpt`` files are not read (ROADMAP.md,
    Queue 1 item 13).

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

STATE_FORMAT = "nerfmlp_torch.train_state/1"


def _ckpt_not_read(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: flax .ckpt files are not read by the PyTorch port yet "
        "(ROADMAP.md, Queue 1 item 13); convert it to .npy with "
        "scripts/convert_checkpoint.py"
    )


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


def load_checkpoint(path: str) -> Dict:
    """A file the Trainer wrote, on the CPU: a train state (``format`` ==
    ``STATE_FORMAT``) or parameters."""
    if path.endswith(".ckpt"):
        raise _ckpt_not_read(path)
    return torch.load(path, map_location="cpu", weights_only=True)


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
    reference checkpoint (bare or composite state dict), or a ``.pt`` the
    Trainer wrote (parameters, or a whole train state whose parameters are
    taken). ``fine_cfg``: the fine net's architecture when it differs.

    ``with_step=True`` returns ``(params, step)``, the step read from the
    file name or, for a train state, from the state."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    step = step_from_filename(path)
    if path.endswith(".npy"):
        nets = {"coarse": convert.params_from_numpy(
            convert.load_npy_weights(path), cfg)}
    elif path.endswith(".ckpt"):
        raise _ckpt_not_read(path)
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
                         "(.npy, .pth or .pt)")
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
    names none); 0 for any other file, or one that cannot be read."""
    if not path or not path.endswith(".pt") or not os.path.exists(path):
        return 0
    try:
        raw = load_checkpoint(path)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError):
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
