"""Weights carried across: JAX param trees, official ``.npy`` lists and
reference ``.pth`` files <-> :class:`NeRFMLP` modules. numpy only.

Three layouts meet here:

  * the JAX package's param tree ``{"pts_0": {"kernel", "bias"}, ...,
    "sigma"/"bottleneck"/"view"/"rgb" | "output"}`` with ``(in, out)``
    kernels (any leaf ``np.asarray`` accepts);
  * the official TF ``.npy`` object array: ``[kernel, bias, ...]`` in
    order trunk 0..D-1, bottleneck, view, rgb, sigma, with TF's ``(in,
    out)`` kernels — the same layout as the JAX tree;
  * the torch reference's state dict (the port's own module names),
    ``(out, in)`` weights: bare ``state_dict()`` or the composite
    ``{"model_state_dict": ...}`` training dict.

Counterpart of ``nerfmlp_tpu/models/import_tf.py:37-103`` and
``import_torch.py:58-166``. The skip concatenation order is the same in
every layout (encoded input first), so no row permutation is needed.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import ModelConfig
from nerfmlp_torch.models.mlp import NeRFMLP

_HEADS = {
    "sigma_linear": "sigma",
    "bottleneck_linear": "bottleneck",
    "view_linear": "view",
    "rgb_linear": "rgb",
    "output_linear": "output",
}


def layer_names(cfg: ModelConfig) -> Dict[str, str]:
    """Module name -> JAX param name, for this architecture."""
    names = {f"pts_linears.{i}": f"pts_{i}" for i in range(cfg.depth)}
    heads = (["sigma_linear", "bottleneck_linear", "view_linear", "rgb_linear"]
             if cfg.use_viewdirs else ["output_linear"])
    names.update({k: _HEADS[k] for k in heads})
    return names


def _official_order(cfg: ModelConfig) -> List[str]:
    return [f"pts_{i}" for i in range(cfg.depth)] + (
        ["bottleneck", "view", "rgb", "sigma"] if cfg.use_viewdirs
        else ["output"]
    )


def expected_shapes(cfg: Optional[ModelConfig] = None) -> List[tuple]:
    """``(in, out)`` kernel and bias shapes in official array order."""
    cfg = cfg or ModelConfig()
    shapes = []
    for i in range(cfg.depth):
        d_in = cfg.input_ch if i == 0 else cfg.width
        if i in cfg.skips:
            d_in = d_in + cfg.input_ch
        shapes += [(d_in, cfg.width), (cfg.width,)]
    if cfg.use_viewdirs:
        shapes += [(cfg.width, cfg.bottleneck_ch), (cfg.bottleneck_ch,)]
        shapes += [(cfg.bottleneck_ch + cfg.input_ch_views, cfg.view_width),
                   (cfg.view_width,)]
        shapes += [(cfg.view_width, 3), (3,)]
        shapes += [(cfg.width, 1), (1,)]
    else:
        shapes += [(cfg.width, cfg.output_ch), (cfg.output_ch,)]
    return shapes


def _checked(params: Mapping, cfg: ModelConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """Copy ``params`` to float32 numpy, failing loudly on a layer that is
    missing, extra or of the wrong shape for ``cfg``."""
    order = _official_order(cfg)
    exp = expected_shapes(cfg)
    missing = [n for n in order if n not in params]
    extra = sorted(set(params) - set(order))
    if missing or extra:
        raise ValueError(
            f"params do not match the architecture (depth={cfg.depth}, "
            f"use_viewdirs={cfg.use_viewdirs}): missing {missing}, extra "
            f"{extra} — pass the matching --netdepth/--netwidth"
        )
    out = {}
    for i, name in enumerate(order):
        k = np.asarray(params[name]["kernel"], dtype=np.float32)
        b = np.asarray(params[name]["bias"], dtype=np.float32)
        if k.shape != exp[2 * i] or b.shape != exp[2 * i + 1]:
            raise ValueError(
                f"layer {name}: kernel {k.shape} / bias {b.shape}, expected "
                f"{exp[2 * i]} / {exp[2 * i + 1]} — architecture mismatch"
            )
        out[name] = {"kernel": k, "bias": b}
    return out


def params_from_numpy(arrays: Sequence[np.ndarray],
                      cfg: Optional[ModelConfig] = None) -> Dict:
    """Official weight list -> JAX-layout param dict (numpy)."""
    cfg = cfg or ModelConfig()
    order = _official_order(cfg)
    if len(arrays) != 2 * len(order):
        raise ValueError(f"expected {2 * len(order)} arrays for this "
                         f"architecture, got {len(arrays)}")
    return _checked({n: {"kernel": arrays[2 * i], "bias": arrays[2 * i + 1]}
                     for i, n in enumerate(order)}, cfg)


def load_npy_weights(path: str) -> List[np.ndarray]:
    """An official ``.npy`` object-array checkpoint from disk."""
    return [np.asarray(a) for a in np.load(path, allow_pickle=True)]


def params_from_state_dict(state_dict: Mapping,
                           cfg: Optional[ModelConfig] = None) -> Dict:
    """Torch state dict (tensors or arrays, ``(out, in)``) -> JAX-layout
    param dict (``(in, out)``), validated against ``cfg``."""
    cfg = cfg or ModelConfig()
    names = layer_names(cfg)
    layers = {k.rsplit(".", 1)[0] for k in state_dict}
    missing = [k for k in names if f"{k}.weight" not in state_dict
               or f"{k}.bias" not in state_dict]
    extra = sorted(layers - set(names))
    if missing or extra:
        raise ValueError(
            f"state dict does not match the architecture (depth="
            f"{cfg.depth}, use_viewdirs={cfg.use_viewdirs}): missing "
            f"{missing}, extra {extra}"
        )

    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().to("cpu", torch.float32).numpy()
        return np.asarray(v, dtype=np.float32)

    return _checked({
        ours: {"kernel": arr(state_dict[f"{mod}.weight"]).T,
               "bias": arr(state_dict[f"{mod}.bias"])}
        for mod, ours in names.items()
    }, cfg)


def state_dict_from_params(params: Mapping, cfg: Optional[ModelConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """JAX-layout param dict -> torch state dict with the module names."""
    cfg = cfg or ModelConfig()
    p = _checked(params, cfg)
    sd = {}
    for mod, ours in layer_names(cfg).items():
        sd[f"{mod}.weight"] = torch.from_numpy(p[ours]["kernel"].T.copy())
        sd[f"{mod}.bias"] = torch.from_numpy(p[ours]["bias"].copy())
    return sd


def model_from_params(params: Mapping, cfg: Optional[ModelConfig] = None,
                      device=None) -> NeRFMLP:
    """JAX-layout param dict -> :class:`NeRFMLP` on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig()
    model = NeRFMLP(cfg)
    model.load_state_dict(state_dict_from_params(params, cfg))
    return model.to(dev)


def params_from_model(model: NeRFMLP) -> Dict:
    """:class:`NeRFMLP` -> JAX-layout param dict (numpy, ``(in, out)``)."""
    return params_from_state_dict(model.state_dict(), model.cfg)


def load_pth(path: str, cfg: Optional[ModelConfig] = None) -> Dict:
    """A reference ``.pth`` (bare state dict or composite training dict)
    -> JAX-layout param dict."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # Composite dicts carry plain-python metrics that strict
        # weights_only deserialization can reject on some torch versions.
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    if not isinstance(blob, Mapping):
        raise ValueError(f"{path} does not contain a torch state_dict")
    return params_from_state_dict(blob, cfg)
