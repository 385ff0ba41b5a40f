"""Trajectory rendering: rays for one camera pose, on the host or on the
device, and ``render_path``, which renders a list of poses to rgb and
disparity frames (optionally downscaled, saved as PNGs and scored against
ground truth), with ``save_path_videos`` for their videos.

Counterpart of ``nerfmlp_tpu/render_path.py`` (``rays_for_pose``,
``rays_for_pose_device``, ``render_path``, ``save_path_videos``). Used by
the Trainer's video and test-set events, ``--render_only`` and the
``render_video`` CLI. With ``mesh`` every frame is rendered over several
devices (``parallel/render_parallel.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerfmlp_torch import numerics_scope, resolve_device
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


def params_device(params: Dict) -> torch.device:
    """The device the nets of ``params`` (modules or packed) live on."""
    net = next(iter(params.values()))
    return next(getattr(net, "net", net).parameters()).device


def render_path(
    params: Dict,
    poses: np.ndarray,
    hwf: Tuple[int, int, float],
    cfg: RenderConfig,
    gt_images: Optional[np.ndarray] = None,
    render_factor: int = 0,
    occ_grid=None,
    save_dir: Optional[str] = None,
    tile: int = 4096,
    verbose: bool = True,
    static_cam_pose: Optional[np.ndarray] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, Optional[list]]:
    """Render every pose on the nets' device; returns (rgbs (N, H, W, 3),
    disps (N, H, W), psnrs or None).

    * ``render_factor``: any non-zero value divides H, W and focal, and
      drops the ground-truth comparison (even 1, as the reference does).
    * ``gt_images`` (N, H, W, 3): per-frame PSNR, printed and returned.
    * ``save_dir``: ``{i:03d}.png`` rgb frames.
    * ``static_cam_pose``: every frame from this camera while the view
      branch follows the trajectory (the view-dependence video).
    * ``mesh``: a data-parallel mesh of ranks, a list of devices or their
      replicas: every frame is rendered over them
      (``parallel/render_parallel.py::render_image_sharded``, ``tile`` per
      device ``ceil(tile / n)``, at least 256, as JAX divides it); with
      ranks, every rank calls this and gets the frames, and rank 0 alone
      prints and writes the PNGs. One device, or ``None``: the local
      renderer.

    Rays are generated on the device from each 16-float pose
    (:func:`rays_for_pose_device`) and rendered by
    ``ops/render.py::render_image_maps`` with the nets packed once."""
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps
    from nerfmlp_torch.parallel.mesh import Mesh
    from nerfmlp_torch.parallel.render_parallel import (
        Replicas, data_parallel_mesh, render_image_sharded, replicate,
    )
    from nerfmlp_torch.train.metrics import psnr_images
    from nerfmlp_torch.utils.image import save_png

    dev = params_device(params)
    params = prepare_params(params, cfg)
    mesh = data_parallel_mesh(mesh)
    if mesh is not None and not isinstance(mesh, (Mesh, Replicas)):
        mesh = replicate(params, cfg, mesh, occ_grid)   # once for the path
    ranks = isinstance(mesh, Mesh)
    n_dev = (mesh.world_size if ranks else len(mesh.devices)) if mesh else 1
    main = not ranks or mesh.is_main
    verbose = verbose and main
    H, W, focal = hwf
    if render_factor:
        H, W = H // render_factor, W // render_factor
        focal = focal / render_factor
        gt_images = None
    if save_dir and main:
        os.makedirs(save_dir, exist_ok=True)
    rgbs, disps = [], []
    psnrs = [] if gt_images is not None else None
    poses = np.asarray(poses)
    for i, pose in enumerate(poses):
        if static_cam_pose is not None:
            o, d, vd = rays_for_pose_device(static_cam_pose, H, W, focal, cfg,
                                            viewdirs_pose=pose, device=dev)
        else:
            o, d, vd = rays_for_pose_device(pose, H, W, focal, cfg,
                                            device=dev)
        with numerics_scope(f"render_path frame {i}"):
            if mesh is None:
                out = render_image_maps(params, o, d, H, W, cfg, tile=tile,
                                        occ_grid=occ_grid, viewdirs=vd,
                                        maps=("rgb_map", "disp_map"))
            else:
                out = render_image_sharded(
                    params, o, d, H, W, cfg, mesh,
                    tile=max(256, -(-tile // n_dev)), occ_grid=occ_grid,
                    viewdirs=vd, maps=("rgb_map", "disp_map"))
        rgb = out["rgb_map"].float().cpu().numpy()
        disp = out["disp_map"].float().cpu().numpy()
        rgbs.append(rgb)
        disps.append(disp)
        line = f"render_path {i + 1}/{len(poses)}"
        if psnrs is not None:
            p = psnr_images(rgb, gt_images[i])
            psnrs.append(p)
            line += f" | PSNR {p:.2f}"
        if save_dir and main:
            save_png(os.path.join(save_dir, f"{i:03d}.png"), rgb)
        if verbose:
            print(line, flush=True)
    if psnrs and verbose:
        print(f"render_path mean PSNR over {len(psnrs)} frames: "
              f"{float(np.mean(psnrs)):.2f}", flush=True)
    return np.stack(rgbs), np.stack(disps), psnrs


def save_path_videos(base: str, rgbs: np.ndarray, disps: np.ndarray,
                     fps: int = 30) -> Tuple[str, str]:
    """Write ``<base>_rgb`` and ``<base>_disp`` videos (the disparity
    normalised by its maximum); returns the two paths written."""
    from nerfmlp_torch.utils.image import to8b, write_video

    rgb_path = write_video(base + "_rgb", to8b(rgbs), fps=fps)
    disp_path = write_video(
        base + "_disp", to8b(disps / max(float(np.max(disps)), 1e-8)),
        fps=fps)
    return rgb_path, disp_path
