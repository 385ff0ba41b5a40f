"""Loading served weights from checkpoint files.

Counterpart of ``nerfmlp_tpu/train/checkpoint.py:89-147``
(``load_params_any``) and ``:210`` (``step_from_filename``) for the formats
this slice reads: official ``.npy`` weight lists and reference ``.pth``
files. The JAX package's flax-msgpack ``.ckpt`` files are not read yet.
Saving and resuming come with the training slice.
"""

from __future__ import annotations

import os
from typing import Optional

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import ModelConfig
from nerfmlp_torch.models import convert


def load_params_any(path: str, cfg: Optional[ModelConfig] = None,
                    device=None, with_step: bool = False):
    """``{"coarse": NeRFMLP}`` on ``device`` (default ``cuda``) from a
    ``.npy`` official weight list or a ``.pth``/``.pt`` reference
    checkpoint (bare or composite state dict). These files always hold one
    network, shared by the coarse and fine passes.

    ``with_step=True`` returns ``(params, step)`` with the step read from
    the file name."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    if path.endswith(".npy"):
        p = convert.params_from_numpy(convert.load_npy_weights(path), cfg)
    elif path.endswith((".pth", ".pt")):
        p = convert.load_pth(path, cfg)
    elif path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: flax .ckpt files are not read by the PyTorch port yet "
            "(ROADMAP.md, Queue 1 item 13); convert it to .npy with "
            "scripts/convert_checkpoint.py"
        )
    else:
        raise ValueError(f"{path}: unknown checkpoint format "
                         "(.npy, .pth or .pt)")
    params = {"coarse": convert.model_from_params(p, cfg, dev)}
    return (params, step_from_filename(path)) if with_step else params


def step_from_filename(path: str) -> int:
    """model_{step}.ckpt / model_{step}_latest.ckpt -> step; 0 when the
    name carries no step."""
    stem = os.path.basename(path)
    for prefix, suffix in (("model_", "_latest.ckpt"), ("model_", ".ckpt")):
        if stem.startswith(prefix) and stem.endswith(suffix):
            digits = stem[len(prefix): -len(suffix)]
            if digits.isdigit():
                return int(digits)
    return 0
