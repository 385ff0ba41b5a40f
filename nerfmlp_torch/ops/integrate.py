"""Volume integration: raw network outputs -> pixel values.

Counterpart of ``nerfmlp_tpu/ops/integrate.py:26-95``:

  dists_i = z_{i+1} - z_i  (last = 1e10, or far_cap - z_last), * ||rays_d||
  rgb     = sigmoid(raw[..., :3])
  alpha   = 1 - exp(-relu(sigma + noise) * dists)
  T_i     = prod_{j<i} (1 - alpha_j + 1e-10)      (exclusive cumprod)
  w_i     = alpha_i * T_i
  rgb_map = sum w_i rgb_i  (+ (1 - acc) white background)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerfmlp_torch.ops import device_scalar, draw


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor with no zero
    entries. The forward is ``torch.cumprod``'s; the backward is the
    branch ``cumprod_backward`` takes when the input has no zero,
    ``reversed_cumsum(output * grad) / input``, bit for bit, without the
    check for zeros that reads a flag back to the host (a synchronisation
    that a CUDA graph cannot capture)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def composite_rays(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = True,
    far_cap=None,
) -> Dict[str, torch.Tensor]:
    """raw (N, S, 4), z_vals (N, S), rays_d (N, 3) -> maps.

    Returns rgb_map (N, 3), depth_map, disp_map, acc_map (N,) and weights
    (N, S). ``far_cap``: scalar or per-ray depth bounding the LAST
    interval instead of 1e10 (beyond an AABB exit nothing contributes).
    ``generator`` (or one per scene, :func:`~nerfmlp_torch.ops.draw`) draws
    the ``raw_noise_std`` noise.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    if far_cap is None:
        last = torch.full_like(dists[..., :1], 1e10)
    else:
        cap = device_scalar(far_cap, z_vals.dtype, z_vals.device)
        if cap.dim() == z_vals.dim() - 1:   # per-ray (N,) -> (N, 1)
            cap = cap[..., None]
        cap = cap.expand_as(z_vals[..., :1])
        last = torch.clamp(cap - z_vals[..., -1:], min=0.0)
    dists = torch.cat([dists, last], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if generator is None:
            raise ValueError("composite_rays(raw_noise_std>0) needs a generator")
        sigma = sigma + draw(generator, sigma.shape, sigma.device,
                             sigma.dtype, normal=True) * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)

    ones = torch.ones_like(alpha[..., :1])
    # Every factor is at least 1e-10: no zero.
    transmittance = _PositiveCumprod.apply(
        torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1))[..., :-1]
    weights = alpha * transmittance

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10),
                                 min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {
        "rgb_map": rgb_map,
        "depth_map": depth_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
    }
