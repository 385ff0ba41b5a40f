"""The NeRF MLP as a PyTorch module.

Architecture of ``nerfmlp_tpu/models/mlp.py:33-79``, with the layer names
of the original torch model (``pts_linears.{i}``, ``sigma_linear``,
``bottleneck_linear``, ``view_linear``, ``rgb_linear``, ``output_linear``)
so reference ``.pth`` state dicts load unchanged:

  * ``depth`` (8) Linear+ReLU trunk layers of ``width`` (256),
  * the encoded input is concatenated, ``cat([x, h])``, immediately before
    each layer in ``skips`` (5),
  * view-dependent head: sigma (256->1), bottleneck (256->256), view layer
    (256+27->128) + ReLU, rgb (128->3); output ``cat([rgb, sigma])`` —
    sigma LAST,
  * without viewdirs: a single output layer (256->output_ch).

Weights are initialised like Flax's ``nn.Dense`` (lecun-normal kernels from
a truncated normal, zero biases) from an explicit generator, so both
packages start training from the same distribution.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import ModelConfig

# Flax's variance_scaling truncated-normal correction: the std of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _linear(d_in: int, d_out: int) -> nn.Linear:
    # skip_init: the weights are set by reset_parameters from an explicit
    # generator, never from torch's global RNG.
    return torch.nn.utils.skip_init(nn.Linear, d_in, d_out)


class NeRFMLP(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dims = []
        for i in range(cfg.depth):
            d_in = cfg.input_ch if i == 0 else cfg.width
            if i in cfg.skips:
                d_in += cfg.input_ch
            dims.append(d_in)
        self.pts_linears = nn.ModuleList(
            [_linear(d, cfg.width) for d in dims]
        )
        if cfg.use_viewdirs:
            self.sigma_linear = _linear(cfg.width, 1)
            self.bottleneck_linear = _linear(cfg.width, cfg.bottleneck_ch)
            self.view_linear = _linear(
                cfg.bottleneck_ch + cfg.input_ch_views, cfg.view_width
            )
            self.rgb_linear = _linear(cfg.view_width, 3)
        else:
            self.output_linear = _linear(cfg.width, cfg.output_ch)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax ``nn.Dense`` defaults: lecun-normal (truncated) kernels,
        zero biases. ``generator`` must live on the parameters' device."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, viewdirs: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Raw outputs ``[rgb, sigma]`` (or ``output_ch`` channels).

        float32 runs true fp32 matmuls where TF32 is off (PyTorch's
        default; the package's entry points keep it so, see
        :func:`nerfmlp_torch.use_true_fp32`). bfloat16 casts inputs,
        weights and biases to bf16 like Flax's ``Dense(dtype=bf16)``.
        """
        cfg = self.cfg

        def dense(layer, h):
            return F.linear(h, layer.weight.to(compute_dtype),
                            layer.bias.to(compute_dtype))

        x = x.to(compute_dtype)
        h = x
        for i, layer in enumerate(self.pts_linears):
            if i in cfg.skips:
                h = torch.cat([x, h], dim=-1)
            h = F.relu(dense(layer, h))
        if cfg.use_viewdirs and viewdirs is not None:
            viewdirs = viewdirs.to(compute_dtype)
            sigma = dense(self.sigma_linear, h)
            bottleneck = dense(self.bottleneck_linear, h)
            h = torch.cat([bottleneck, viewdirs], dim=-1)
            h = F.relu(dense(self.view_linear, h))
            rgb = dense(self.rgb_linear, h)
            return torch.cat([rgb, sigma], dim=-1)
        return dense(self.output_linear, h)


def init_model(cfg: Optional[ModelConfig] = None, seed: int = 0,
               device=None) -> NeRFMLP:
    """A freshly initialised net on ``device`` (default ``cuda``).

    The weights are drawn on the CPU from ``torch.Generator().manual_seed
    (seed)`` and then moved, so one seed gives the same net on every
    device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return NeRFMLP(cfg or ModelConfig(), generator=gen).to(dev)
