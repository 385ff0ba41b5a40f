"""Rays for one camera pose, on the host or on the device.

Counterpart of ``nerfmlp_tpu/render_path.py:30-121`` (``rays_for_pose``
and ``rays_for_pose_device``); trajectory rendering comes with the
inference CLIs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.ops.rays import get_rays, get_rays_np, ndc_rays


def rays_for_pose(
    pose: np.ndarray,
    H: int,
    W: int,
    focal: float,
    cfg: RenderConfig,
    viewdirs_pose: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(rays_o, rays_d, viewdirs) flattened to (H*W, 3) numpy arrays.

    NDC configs get NDC-reparameterized o/d plus the WORLD directions from
    before the projection as viewdirs; metric configs get viewdirs None
    (the renderer normalizes rays_d). ``viewdirs_pose`` conditions the
    view branch on another camera's directions (the static-camera
    view-dependence trick) while the geometry rays stay ``pose``'s.
    """
    o, d = get_rays_np(H, W, focal, np.asarray(pose, dtype=np.float32))
    o = o.reshape(-1, 3).astype(np.float32).copy()
    d = d.reshape(-1, 3).astype(np.float32)
    vd_src = d
    if viewdirs_pose is not None:
        _, vd_src = get_rays_np(H, W, focal,
                                np.asarray(viewdirs_pose, dtype=np.float32))
        vd_src = vd_src.reshape(-1, 3).astype(np.float32)
    if not cfg.ndc and viewdirs_pose is None:
        return o, d, None
    vd = (vd_src / np.linalg.norm(vd_src, axis=-1, keepdims=True)).astype(
        np.float32)
    if not cfg.ndc:
        return o, d, vd
    o_n, d_n = ndc_rays(H, W, focal, 1.0, torch.from_numpy(o),
                        torch.from_numpy(d))
    return o_n.numpy(), d_n.numpy(), vd


def rays_for_pose_device(
    pose: np.ndarray,
    H: int,
    W: int,
    focal: float,
    cfg: RenderConfig,
    viewdirs_pose: Optional[np.ndarray] = None,
    device=None,
):
    """:func:`rays_for_pose` generated ON the device (default ``cuda``)
    from the 16-float pose, as tensors: only the pose is uploaded."""
    dev = resolve_device(device)
    c2w = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    o, d = get_rays(H, W, focal, c2w)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    vd_src = d
    if viewdirs_pose is not None:
        vd_c2w = torch.as_tensor(np.asarray(viewdirs_pose, np.float32),
                                 device=dev)
        vd_src = get_rays(H, W, focal, vd_c2w)[1].reshape(-1, 3)
    if not cfg.ndc and viewdirs_pose is None:
        return o, d, None
    vd = vd_src / torch.linalg.norm(vd_src, dim=-1, keepdim=True)
    if not cfg.ndc:
        return o, d, vd
    o_n, d_n = ndc_rays(H, W, focal, 1.0, o, d)
    return o_n, d_n, vd
