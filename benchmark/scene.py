"""The inputs every cell makes from its seed, on the card: the scene's
training views and the initial weights. Both sides of the comparison
get these same tensors.

The scene is the hard analytic field of the repository's synthetic
benchmark scene (a checkered sphere, striped rods on a 0.9 lattice, a
textured slab with a sharp top edge), copied here so that the yardstick
does not move with the program. Its views are rendered on the card,
encoded to 8-bit sRGB and decoded back to linear colour, as a Blender
capture's PNGs reach the trainer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import nerf

# The sphere's two checker colours.
_SPHERE_RED, _SPHERE_GOLD = (0.9, 0.15, 0.1), (0.95, 0.85, 0.1)


def hard_field(p: torch.Tensor):
    """(density (N,), albedo (N, 3)) of the hard field at points (N, 3)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=p.device)

    r = torch.sqrt(x * x + y * y + z * z)
    s_sph = 60.0 * torch.exp(-((r / 0.55) ** 8))
    edge = torch.tanh(4.0 * torch.sin(20.0 * x) * torch.sin(20.0 * y)
                      * torch.sin(20.0 * z))
    t = (0.5 + 0.5 * edge)[:, None]
    c_sph = t * vec(_SPHERE_RED) + (1 - t) * vec(_SPHERE_GOLD)
    gx = torch.remainder(x + 1.35, 0.9) - 0.45
    gy = torch.remainder(y + 1.35, 0.9) - 0.45
    rod = 0.5 - 0.5 * torch.tanh((torch.sqrt(gx * gx + gy * gy) - 0.03)
                                 * 300.0)
    s_rod = (160.0 * rod * ((x.abs() < 1.15) & (y.abs() < 1.15))
             * (z.abs() < 0.85) * (r > 0.62))
    stripe = 0.5 + 0.5 * torch.tanh(4.0 * torch.sin(20.0 * z))
    c_rod = torch.stack([0.05 + 0.9 * stripe, 0.9 - 0.8 * stripe,
                         torch.full_like(stripe, 0.55)], -1)
    s_slab = (120.0 * ((x.abs() < 1.05) & (y.abs() < 1.05))
              * (0.5 - 0.5 * torch.tanh((z + 0.62) * 150.0))
              * (0.5 + 0.5 * torch.tanh((z + 0.8) * 150.0)))
    n1 = torch.sin(13.7 * x + 1.3) * torch.sin(17.9 * y + 0.7)
    n2 = torch.sin(31.4 * x - 2.1) * torch.sin(27.2 * y + 1.9)
    tex = torch.clamp(0.55 + 0.3 * n1 + 0.08 * n2, 0.0, 1.0)
    c_slab = torch.stack([tex, 0.55 * tex + 0.2, 0.35 + 0.25 * (1 - tex)],
                         -1)
    sigma = s_sph + s_rod + s_slab
    acc = (s_sph[:, None] * c_sph + s_rod[:, None] * c_rod
           + s_slab[:, None] * c_slab)
    albedo = acc / torch.clamp_min(sigma[:, None], 1e-8)
    return sigma, torch.where(sigma[:, None] > 1e-3, albedo, 1.0)


def look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world (4, 4) of a camera at ``eye`` looking at the origin,
    z up, looking down its -z axis."""
    fwd = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
        right, np.cross(fwd, right), fwd, eye)
    return c2w


@torch.no_grad()
def ground_truth(o: torch.Tensor, d: torch.Tensor, near: float, far: float,
                 n_samples: int, chunk: int = 1 << 16) -> torch.Tensor:
    """Linear rgb (N, 3) of the field along rays, marched at ``n_samples``
    even depths and composited over white."""
    t = torch.linspace(near, far, n_samples, device=o.device)
    dt = torch.cat([t[1:] - t[:-1], torch.full((1,), 1e10,
                                                device=o.device)])
    out = []
    for s in range(0, o.shape[0], chunk):
        oo, dd = o[s:s + chunk], d[s:s + chunk]
        pts = oo[:, None] + dd[:, None] * t[None, :, None]
        sigma, albedo = hard_field(pts.reshape(-1, 3))
        sigma = sigma.reshape(-1, n_samples)
        alpha = 1 - torch.exp(-sigma * dt * dd.norm(dim=-1, keepdim=True))
        trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                         1 - alpha[:, :-1] + 1e-10], -1), -1)
        w = alpha * trans
        rgb = (w[..., None] * albedo.reshape(-1, n_samples, 3)).sum(1)
        out.append(rgb + (1 - w.sum(-1, keepdim=True)))
    return torch.clamp(torch.cat(out), 0.0, 1.0)


def through_png(lin: torch.Tensor) -> torch.Tensor:
    """Linear colour -> 8-bit sRGB -> linear colour, in float32."""
    s = torch.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * torch.clamp_min(lin, 0.0031308) ** (1 / 2.4)
                    - 0.055)
    s = torch.round(torch.clamp(s, 0, 1) * 255.0) / 255.0
    return torch.where(s <= 0.04045, s / 12.92,
                       ((s + 0.055) / 1.055) ** 2.4)


class Scene:
    """The training views: ``all_rays_o``, ``all_rays_d``, ``all_rgbs``
    as (n H W, 3) float32 numpy arrays, view-major, and ``n_images``,
    ``H``, ``W``, ``focal``: the dataset interface the trainer reads."""

    def __init__(self, spec: Dict, seed: int, device):
        n, h, w = spec["n_views"], spec["H"], spec["W"]
        self.n_images, self.H, self.W = n, h, w
        self.focal = 0.5 * w / math.tan(0.5 * spec["camera_angle_x"])
        rng = np.random.default_rng(seed)
        radius = spec["radius"]
        o_all, d_all, c_all = [], [], []
        for k in range(n):
            theta = 2.0 * math.pi * k / n + rng.uniform(0, 0.3)
            phi = math.radians(rng.uniform(20.0, 50.0))
            eye = radius * np.array([math.cos(theta) * math.cos(phi),
                                     math.sin(theta) * math.cos(phi),
                                     math.sin(phi)])
            o, d = nerf.camera_rays(h, w, self.focal, look_at(eye), device)
            o_all.append(o)
            d_all.append(d)
            c_all.append(through_png(ground_truth(
                o, d, radius - 2.0, radius + 2.0, spec["gt_samples"])))
        self.all_rays_o = torch.cat(o_all).cpu().numpy()
        self.all_rays_d = torch.cat(d_all).cpu().numpy()
        self.all_rgbs = torch.cat(c_all).cpu().numpy()

    def __len__(self) -> int:
        return self.all_rays_o.shape[0]

    def pool(self) -> np.ndarray:
        """(n H W, 9) rows [origin | direction | colour]."""
        return np.concatenate([self.all_rays_o, self.all_rays_d,
                               self.all_rgbs], axis=1)


def make_weights(model: Dict, seed: int, device,
                 recipe: Dict) -> Dict[str, torch.Tensor]:
    """Weights of the net, by parameter name: every kernel from one
    truncated normal draw on the card (cut at 2 standard deviations,
    scaled to lecun-normal's variance, as Flax's Dense initialises), the
    biases zero; then ``recipe`` (:func:`shape_field`). A recipe with a
    ``seed`` draws from that seed, whatever the run's: one model for
    every run, as a deployment serves one model to every viewer."""
    if "seed" in recipe:
        seed = recipe["seed"]
    dims = _dims(model)
    total = sum(a * b for _, a, b in dims)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, n_in, n_out in dims:
        std = math.sqrt(1.0 / n_in) / 0.87962566103423978
        out[f"{name}.weight"] = (flat[at:at + n_in * n_out] * std).reshape(
            n_out, n_in)
        out[f"{name}.bias"] = torch.zeros(n_out, device=device)
        at += n_in * n_out
    return shape_field(out, model, recipe)


def shape_field(w: Dict[str, torch.Tensor], model: Dict,
                recipe: Dict) -> Dict[str, torch.Tensor]:
    """``smooth``, a net that stands for a trained one: the columns that
    read encoding band k are scaled by ``band_decay ** k`` (a field
    dominated by its low frequencies, as a trained radiance field is), and
    density is ``sigma_scale * (|w| . h - sigma_offset)``: positive kernel
    weights on the trunk's non-negative features make it about 0.37 +-
    0.05 over the box whatever the seed, so the offset carves solid
    regions out of empty space and every seed renders a comparable
    scene."""
    if recipe["recipe"] != "smooth":
        raise ValueError(f"unknown weight recipe {recipe['recipe']!r}")
    n_enc = 3 * (1 + 2 * model["pos_enc_L"])
    col = torch.ones(n_enc, device=w["pts_linears.0.weight"].device)
    for k in range(model["pos_enc_L"]):
        col[3 + 6 * k: 9 + 6 * k] = recipe["band_decay"] ** k
    for i in [0] + list(model["skips"]):
        key = f"pts_linears.{i}.weight"
        w[key] = torch.cat([w[key][:, :n_enc] * col, w[key][:, n_enc:]], 1)
    s = recipe["sigma_scale"]
    w["sigma_linear.weight"] = w["sigma_linear.weight"].abs() * s
    w["sigma_linear.bias"] = w["sigma_linear.bias"] - recipe["sigma_offset"] * s
    return w


def _dims(model: Dict):
    from benchmark import counts

    names = nerf.layer_names(model["depth"])
    return [(n, a, b) for n, (a, b) in zip(names, counts.layer_dims(model))]
