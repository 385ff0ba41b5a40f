"""Camera ray generation: pinhole, NDC reparameterization, look-at poses.

Counterpart of ``nerfmlp_tpu/ops/rays.py:24-175``. For pixel (i, j) with i
along width:

  dir_cam = [(i - W/2) / focal, -(j - H/2) / focal, -1]
  rays_d  = dir_cam @ R^T,   rays_o = t   (c2w = [R | t])

The tensor functions run on the pose's device; the numpy helpers
(``get_rays_np``, ``look_at_matrix``, ``pose_spherical``) are copied as
they are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_rays(H: int, W: int, focal: float, c2w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All rays of an HxW image on ``c2w``'s device: (rays_o, rays_d),
    each (H, W, 3)."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=c2w.dtype, device=c2w.device),
        torch.arange(W, dtype=c2w.dtype, device=c2w.device),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)],
        dim=-1,
    )
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, focal: float, c2w: np.ndarray):
    """Host-side numpy twin of :func:`get_rays`."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -np.ones_like(i)], axis=-1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to the near plane and project into NDC space (original
    NeRF appendix C, for forward-facing captures)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    sx = -1.0 / (W / (2.0 * focal))
    sy = -1.0 / (H / (2.0 * focal))
    o0 = sx * rays_o[..., 0] / rays_o[..., 2]
    o1 = sy * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = sx * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = sy * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def intersect_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, box_min,
                   box_max, near, far) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray [near, far] tightened to the axis-aligned scene box (slab
    test); rays that miss keep the global bounds."""
    box_min = torch.as_tensor(box_min, dtype=rays_o.dtype, device=rays_o.device)
    box_max = torch.as_tensor(box_max, dtype=rays_o.dtype, device=rays_o.device)
    near = torch.as_tensor(near, dtype=rays_o.dtype, device=rays_o.device)
    far = torch.as_tensor(far, dtype=rays_o.dtype, device=rays_o.device)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-10,
                              torch.full_like(rays_d, 1e-10), rays_d)
    t0 = (box_min - rays_o) * inv_d
    t1 = (box_max - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = t_far > torch.clamp(t_near, min=0.0)
    ray_near = torch.where(hit, torch.minimum(torch.maximum(t_near, near), far),
                           near)
    ray_far = torch.where(hit, torch.minimum(torch.maximum(t_far, near), far),
                          far)
    ray_far = torch.maximum(ray_far, ray_near + 1e-3)  # grazing hits
    return ray_near, ray_far


def look_at_matrix(eye: np.ndarray, target: np.ndarray, up: np.ndarray = None
                   ) -> np.ndarray:
    """Camera-to-world 4x4 for a camera at ``eye`` looking at ``target``
    (NeRF convention: the camera looks down its -Z axis)."""
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray([0.0, 0.0, 1.0] if up is None else up, dtype=np.float32)

    forward = eye - target  # camera +Z points away from the target
    forward = forward / (np.linalg.norm(forward) + 1e-12)
    right = np.cross(up, forward)
    if np.linalg.norm(right) < 1e-6:
        # View direction parallel to up: fall back to the coordinate axis
        # least aligned with the view direction.
        up = np.zeros(3, dtype=np.float32)
        up[int(np.argmin(np.abs(forward)))] = 1.0
        right = np.cross(up, forward)
    right = right / (np.linalg.norm(right) + 1e-12)
    true_up = np.cross(forward, right)

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return c2w


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """c2w on a sphere: azimuth ``theta``, elevation ``phi`` (degrees),
    distance ``radius``, looking at the origin (the Blender render poses)."""
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    rot_x = np.eye(4, dtype=np.float32)
    rot_x[1, 1] = rot_x[2, 2] = np.cos(phi)
    rot_x[1, 2], rot_x[2, 1] = -np.sin(phi), np.sin(phi)
    rot_y = np.eye(4, dtype=np.float32)
    rot_y[0, 0] = rot_y[2, 2] = np.cos(theta)
    rot_y[0, 2], rot_y[2, 0] = -np.sin(theta), np.sin(theta)
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return flip @ rot_y @ rot_x @ c2w
