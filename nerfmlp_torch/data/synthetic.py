"""Procedural test scenes: two analytic radiance fields, their
ground-truth renders, and two scene writers.

Counterpart of ``nerfmlp_tpu/data/synthetic.py:25-393`` (numpy, so the
same seed writes the same images in both packages). ``make_synthetic_scene``
writes the ``transforms_{split}.json`` + PNG layout the Blender loader
reads; ``make_synthetic_llff_scene`` the ``poses_bounds.npy`` + ``images/``
layout the LLFF loader reads, with the cameras on a ring (``"360"``) or
clustered in front of the object (``"forward"``). PNGs come from the
port's standard-library writer (no imaging package is needed).

``render_analytic(..., device=)`` renders the ground truth with torch on
that device (the counterpart of the JAX package's jitted ``use_jax`` path,
``synthetic.py:228-256``): the fields and the march as plain tensor
functions in float32, in the numpy bodies' order of operations, over
fixed-size ray chunks with the tail padded. Trig in float32 differs from
numpy's by ulps, so its images agree with the numpy path's to a level of
8-bit sRGB, not bit for bit; ``device=None`` is the numpy path.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from nerfmlp_torch.data.blender import linear_to_srgb
from nerfmlp_torch.ops.rays import get_rays_np, look_at_matrix
from nerfmlp_torch.utils.image import save_png


def _scene_density_color(pts: np.ndarray):
    """Default analytic field: density (N,) and albedo (N, 3) at points —
    three soft spheres and a ground box, all inside |x| < 1.2."""
    f32 = np.float32
    blobs = [
        (np.array([0.0, 0.0, 0.0], f32), f32(0.45),
         np.array([0.9, 0.25, 0.2], f32), f32(18.0)),
        (np.array([0.55, 0.3, 0.2], f32), f32(0.3),
         np.array([0.2, 0.8, 0.3], f32), f32(15.0)),
        (np.array([-0.45, -0.35, 0.3], f32), f32(0.25),
         np.array([0.25, 0.35, 0.95], f32), f32(15.0)),
    ]
    pts = pts.astype(f32)
    sigma = np.zeros(pts.shape[0], dtype=f32)
    color_acc = np.zeros((pts.shape[0], 3), dtype=f32)
    for center, radius, color, peak in blobs:
        d2 = np.sum((pts - center) ** 2, axis=-1)
        s = peak * np.exp(-d2 / (2.0 * (radius / 2.0) ** 2))
        sigma = sigma + s
        color_acc = color_acc + s[:, None] * color
    inside = (
        (np.abs(pts[:, 0]) < 0.9)
        & (np.abs(pts[:, 1]) < 0.9)
        & (pts[:, 2] > -0.75)
        & (pts[:, 2] < -0.55)
    )
    s_box = np.where(inside, 25.0, 0.0).astype(np.float32)
    sigma = sigma + s_box
    color_acc = color_acc + s_box[:, None] * np.array(
        [0.85, 0.75, 0.4], dtype=np.float32
    )
    albedo = color_acc / np.maximum(sigma[:, None], 1e-8)
    albedo = np.where(sigma[:, None] > 1e-6, albedo, 1.0)
    return sigma, albedo.astype(np.float32)


def _hard_density_color(pts: np.ndarray):
    """Hard benchmark field: a checkered sphere, thin striped rods on a 0.9
    grid and a textured ground slab with a sharp top edge (the JAX
    package's r5 field, ``synthetic.py:69-177``, calibration notes there)."""
    f32 = np.float32
    pts = pts.astype(f32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    r = np.sqrt(x * x + y * y + z * z)
    s_sph = (f32(60.0) * np.exp(-((r / f32(0.55)) ** 8))).astype(f32)
    w = f32(20.0)
    edge = np.tanh(f32(4.0) * np.sin(w * x) * np.sin(w * y) * np.sin(w * z))
    t = (f32(0.5) + f32(0.5) * edge)[:, None].astype(f32)
    c_sph = t * np.array([0.9, 0.15, 0.1], f32) + (1 - t) * np.array(
        [0.95, 0.85, 0.1], f32
    )
    sigma = s_sph
    color_acc = s_sph[:, None] * c_sph

    gx = (x + f32(1.35)) % f32(0.9) - f32(0.45)
    gy = (y + f32(1.35)) % f32(0.9) - f32(0.45)
    d_rod = np.sqrt(gx * gx + gy * gy)
    rod_core = f32(0.5) - f32(0.5) * np.tanh(
        (d_rod - f32(0.03)) * f32(300.0)
    )
    in_lattice = (np.abs(x) < 1.15) & (np.abs(y) < 1.15)
    s_rod = (
        f32(160.0) * rod_core * in_lattice * (np.abs(z) < 0.85) * (r > 0.62)
    ).astype(f32)
    stripe = (f32(0.5) + f32(0.5) * np.tanh(
        f32(4.0) * np.sin(f32(20.0) * z)
    )).astype(f32)
    c_rod = np.stack(
        [f32(0.05) + f32(0.9) * stripe, f32(0.9) - f32(0.8) * stripe,
         np.full_like(stripe, f32(0.55))], axis=-1,
    )
    sigma = sigma + s_rod
    color_acc = color_acc + s_rod[:, None] * c_rod

    in_xy = (np.abs(x) < 1.05) & (np.abs(y) < 1.05)
    edge_top = f32(0.5) - f32(0.5) * np.tanh((z + f32(0.62)) * f32(150.0))
    edge_bot = f32(0.5) + f32(0.5) * np.tanh((z + f32(0.8)) * f32(150.0))
    s_slab = (f32(120.0) * in_xy * edge_top * edge_bot).astype(f32)
    n1 = np.sin(f32(13.7) * x + f32(1.3)) * np.sin(f32(17.9) * y + f32(0.7))
    n2 = np.sin(f32(31.4) * x - f32(2.1)) * np.sin(f32(27.2) * y + f32(1.9))
    tex = np.clip(
        f32(0.55) + f32(0.3) * n1 + f32(0.08) * n2, 0.0, 1.0
    ).astype(f32)
    c_slab = np.stack(
        [tex, f32(0.55) * tex + f32(0.2), f32(0.35) + f32(0.25) * (1 - tex)],
        axis=-1,
    )
    sigma = sigma + s_slab
    color_acc = color_acc + s_slab[:, None] * c_slab

    albedo = color_acc / np.maximum(sigma[:, None], 1e-8)
    albedo = np.where(sigma[:, None] > 1e-3, albedo, 1.0)
    return sigma.astype(f32), albedo.astype(np.float32)


def _scene_density_color_t(pts: torch.Tensor):
    """:func:`_scene_density_color` on a float32 tensor of points."""
    f32 = np.float32
    blobs = [((0.0, 0.0, 0.0), f32(0.45), (0.9, 0.25, 0.2), 18.0),
             ((0.55, 0.3, 0.2), f32(0.3), (0.2, 0.8, 0.3), 15.0),
             ((-0.45, -0.35, 0.3), f32(0.25), (0.25, 0.35, 0.95), 15.0)]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=pts.device)

    sigma = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    color_acc = torch.zeros((pts.shape[0], 3), dtype=torch.float32,
                            device=pts.device)
    for center, radius, color, peak in blobs:
        d2 = torch.sum((pts - vec(center)) ** 2, dim=-1)
        # The float32 scalar the numpy body divides by.
        s = peak * torch.exp(-d2 / float(2.0 * (radius / 2.0) ** 2))
        sigma = sigma + s
        color_acc = color_acc + s[:, None] * vec(color)
    inside = ((pts[:, 0].abs() < 0.9) & (pts[:, 1].abs() < 0.9)
              & (pts[:, 2] > -0.75) & (pts[:, 2] < -0.55))
    s_box = torch.where(inside, 25.0, 0.0)
    sigma = sigma + s_box
    color_acc = color_acc + s_box[:, None] * vec((0.85, 0.75, 0.4))
    albedo = color_acc / torch.clamp_min(sigma[:, None], 1e-8)
    albedo = torch.where(sigma[:, None] > 1e-6, albedo, 1.0)
    return sigma, albedo


def _hard_density_color_t(pts: torch.Tensor):
    """:func:`_hard_density_color` on a float32 tensor of points."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=pts.device)

    r = torch.sqrt(x * x + y * y + z * z)
    s_sph = 60.0 * torch.exp(-((r / 0.55) ** 8))
    w = 20.0
    edge = torch.tanh(4.0 * torch.sin(w * x) * torch.sin(w * y)
                      * torch.sin(w * z))
    t = (0.5 + 0.5 * edge)[:, None]
    c_sph = t * vec((0.9, 0.15, 0.1)) + (1 - t) * vec((0.95, 0.85, 0.1))
    sigma = s_sph
    color_acc = s_sph[:, None] * c_sph

    gx = torch.remainder(x + 1.35, 0.9) - 0.45
    gy = torch.remainder(y + 1.35, 0.9) - 0.45
    d_rod = torch.sqrt(gx * gx + gy * gy)
    rod_core = 0.5 - 0.5 * torch.tanh((d_rod - 0.03) * 300.0)
    in_lattice = (x.abs() < 1.15) & (y.abs() < 1.15)
    s_rod = 160.0 * rod_core * in_lattice * (z.abs() < 0.85) * (r > 0.62)
    stripe = 0.5 + 0.5 * torch.tanh(4.0 * torch.sin(20.0 * z))
    c_rod = torch.stack([0.05 + 0.9 * stripe, 0.9 - 0.8 * stripe,
                         torch.full_like(stripe, 0.55)], dim=-1)
    sigma = sigma + s_rod
    color_acc = color_acc + s_rod[:, None] * c_rod

    in_xy = (x.abs() < 1.05) & (y.abs() < 1.05)
    edge_top = 0.5 - 0.5 * torch.tanh((z + 0.62) * 150.0)
    edge_bot = 0.5 + 0.5 * torch.tanh((z + 0.8) * 150.0)
    s_slab = 120.0 * in_xy * edge_top * edge_bot
    n1 = torch.sin(13.7 * x + 1.3) * torch.sin(17.9 * y + 0.7)
    n2 = torch.sin(31.4 * x - 2.1) * torch.sin(27.2 * y + 1.9)
    tex = torch.clamp(0.55 + 0.3 * n1 + 0.08 * n2, 0.0, 1.0)
    c_slab = torch.stack([tex, 0.55 * tex + 0.2, 0.35 + 0.25 * (1 - tex)],
                         dim=-1)
    sigma = sigma + s_slab
    color_acc = color_acc + s_slab[:, None] * c_slab

    albedo = color_acc / torch.clamp_min(sigma[:, None], 1e-8)
    albedo = torch.where(sigma[:, None] > 1e-3, albedo, 1.0)
    return sigma, albedo


# The torch counterpart of each numpy field, for render_analytic(device=).
TORCH_FIELDS = {_scene_density_color: _scene_density_color_t,
                _hard_density_color: _hard_density_color_t}


FIELDS = {"default": _scene_density_color, "hard": _hard_density_color}


def _integrate_chunk(o, d, t, dists_t, field):
    """One chunk of analytic ground truth: march ``t`` along the rays and
    composite (the equations of ops/integrate.py::composite_rays)."""
    n_samples = t.shape[0]
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    sigma, albedo = field(pts.reshape(-1, 3))
    sigma = sigma.reshape(-1, n_samples)
    albedo = albedo.reshape(-1, n_samples, 3)
    dists = dists_t[None, :] * np.linalg.norm(d, axis=-1, keepdims=True)
    alpha = 1.0 - np.exp(-sigma * dists)
    trans = np.cumprod(
        np.concatenate(
            [np.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10],
            axis=-1,
        ),
        axis=-1,
    )
    weights = alpha * trans
    rgb = np.sum(weights[..., None] * albedo, axis=1)
    acc = np.sum(weights, axis=-1, keepdims=True)
    return rgb + (1.0 - acc)  # white background


def _integrate_chunk_t(o, d, t, dists_t, field):
    """:func:`_integrate_chunk` on tensors, ``field`` a torch field."""
    n_samples = t.shape[0]
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    sigma, albedo = field(pts.reshape(-1, 3))
    sigma = sigma.reshape(-1, n_samples)
    albedo = albedo.reshape(-1, n_samples, 3)
    dists = dists_t[None, :] * torch.linalg.norm(d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]),
                   1.0 - alpha[:, :-1] + 1e-10], dim=-1), dim=-1)
    weights = alpha * trans
    rgb = torch.sum(weights[..., None] * albedo, dim=1)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    return rgb + (1.0 - acc)


@torch.no_grad()
def _render_torch(rays_o, rays_d, t, dists_t, chunk, field, device):
    """The rays through :func:`_integrate_chunk_t` on ``device`` in chunks
    of exactly ``chunk`` rays (the tail padded with origin 0 and direction
    1, as the JAX path pads it); one copy to the host at the end."""
    if field not in TORCH_FIELDS:
        raise ValueError("render_analytic(device=...) renders the package's "
                         "fields only (FIELDS); pass device=None for another")
    device = torch.device(device)
    n = rays_o.shape[0]
    pad = -n % chunk
    o = torch.from_numpy(np.pad(rays_o, ((0, pad), (0, 0)))).to(device)
    d = torch.from_numpy(np.pad(rays_d, ((0, pad), (0, 0)),
                                constant_values=1.0)).to(device)
    t, dists_t = (torch.from_numpy(v).to(device) for v in (t, dists_t))
    out = torch.empty((n + pad, 3), dtype=torch.float32, device=device)
    for s in range(0, n + pad, chunk):
        out[s:s + chunk] = _integrate_chunk_t(o[s:s + chunk], d[s:s + chunk],
                                              t, dists_t, TORCH_FIELDS[field])
    return out[:n].cpu().numpy()


def render_analytic(
    pose: np.ndarray, H: int, W: int, focal: float, n_samples: int = 192,
    near: float = 2.0, far: float = 6.0, chunk: int = 16384, field=None,
    device=None,
) -> np.ndarray:
    """Ground-truth render of an analytic field (linear RGB, white
    background), in ray chunks that keep the working set small: in numpy
    with ``device=None``, else with torch on ``device``."""
    rays_o, rays_d = get_rays_np(H, W, focal, pose)
    rays_o = rays_o.reshape(-1, 3).astype(np.float32)
    rays_d = rays_d.reshape(-1, 3).astype(np.float32)
    t = np.linspace(near, far, n_samples, dtype=np.float32)
    dists_t = np.diff(t, append=np.float32(1e10)).astype(np.float32)
    field = field or _scene_density_color
    if device is not None:
        out = _render_torch(rays_o, rays_d, t, dists_t, chunk, field, device)
        return np.clip(out, 0.0, 1.0).reshape(H, W, 3)
    out = np.empty((rays_o.shape[0], 3), dtype=np.float32)
    for s in range(0, rays_o.shape[0], chunk):
        out[s:s + chunk] = _integrate_chunk(rays_o[s:s + chunk],
                                            rays_d[s:s + chunk], t, dists_t,
                                            field)
    return np.clip(out, 0.0, 1.0).reshape(H, W, 3)


def make_synthetic_scene(
    outdir: str,
    n_train: int = 12,
    n_val: int = 3,
    n_test: int = 3,
    img_wh: Tuple[int, int] = (64, 64),
    radius: float = 4.0,
    camera_angle_x: float = 0.6911112070083618,  # Lego's FOV
    seed: int = 0,
    field: str = "default",
    aa: int = 1,
    n_samples: int = 192,
    device=None,
) -> str:
    """Write transforms_{train,val,test}.json + sRGB PNGs under ``outdir``.

    ``field``: the "default" smooth scene or the "hard" benchmark field;
    ``aa``: supersample the ground truth aa x aa per pixel (box-downsampled
    in linear RGB); ``n_samples``: the ground-truth ray-march density;
    ``device``: render the ground truth with torch there (None: numpy)."""
    field_fn = FIELDS[field]
    rng = np.random.default_rng(seed)
    W, H = img_wh
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(outdir, split), exist_ok=True)
        frames = []
        for k in range(n):
            theta = 2.0 * np.pi * (k / max(n, 1)) + rng.uniform(0, 0.3)
            phi = np.deg2rad(rng.uniform(20.0, 50.0))
            eye = radius * np.array([
                np.cos(theta) * np.cos(phi),
                np.sin(theta) * np.cos(phi),
                np.sin(phi),
            ])
            pose = look_at_matrix(eye, np.zeros(3))
            img_linear = render_analytic(
                pose, H * aa, W * aa, focal * aa,
                near=radius - 2.0, far=radius + 2.0,
                field=field_fn, n_samples=n_samples, device=device,
            )
            if aa > 1:  # box-downsample in LINEAR RGB (then sRGB-encode)
                img_linear = img_linear.reshape(H, aa, W, aa, 3).mean(
                    axis=(1, 3))
            img_srgb = (linear_to_srgb(img_linear) * 255.0).round().astype(
                np.uint8)
            name = f"r_{k}"
            save_png(os.path.join(outdir, split, name + ".png"), img_srgb)
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(outdir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return outdir


def make_synthetic_llff_scene(
    outdir: str,
    n_images: int = 12,
    img_wh: Tuple[int, int] = (64, 48),
    style: str = "360",
    radius: float = 4.0,
    seed: int = 0,
) -> str:
    """Write an LLFF-layout scene (``poses_bounds.npy`` + ``images/``) of
    the default analytic field: ``style="360"`` puts the cameras on a ring
    around the object (the ``spherify`` workload), ``"forward"`` clusters
    them behind it looking down -z (the NDC forward-facing workload). The
    images are the linear renders, each stored with its ``hwf`` and its
    camera distance -/+ 1.5 as bounds."""
    rng = np.random.default_rng(seed)
    W, H = img_wh
    focal = 1.2 * W  # a long-ish lens, as captured LLFF scenes have

    img_dir = os.path.join(outdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for k in range(n_images):
        if style == "360":
            theta = 2.0 * np.pi * k / n_images
            phi = np.deg2rad(25.0 + 10.0 * rng.uniform())
            eye = radius * np.array([
                np.cos(theta) * np.cos(phi),
                np.sin(theta) * np.cos(phi),
                np.sin(phi),
            ])
        else:  # forward-facing: small offsets around (0, 0, radius)
            eye = np.array([
                0.35 * rng.uniform(-1, 1),
                0.35 * rng.uniform(-1, 1),
                radius + 0.15 * rng.uniform(-1, 1),
            ])
        pose = look_at_matrix(eye, np.zeros(3))
        dist = float(np.linalg.norm(eye))
        near_k, far_k = dist - 1.5, dist + 1.5
        img = render_analytic(pose, H, W, focal, near=near_k, far=far_k)
        save_png(os.path.join(img_dir, f"image{k:03d}.png"),
                 (np.clip(img, 0, 1) * 255).round().astype(np.uint8))
        # LLFF stores 3x5 [down | right | back | t | hwf] + 2 depth bounds
        # (the loader's axis swap inverts [right, up, back] to that).
        m = np.concatenate(
            [-pose[:3, 1:2], pose[:3, 0:1], pose[:3, 2:3], pose[:3, 3:4]],
            axis=1,
        )
        hwf = np.array([[H], [W], [focal]], dtype=np.float32)
        rows.append(np.concatenate(
            [np.concatenate([m, hwf], axis=1).ravel(), [near_k, far_k]]
        ))
    np.save(os.path.join(outdir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
    return outdir
