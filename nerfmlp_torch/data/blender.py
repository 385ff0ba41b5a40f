"""Blender-synthetic dataset loader (NeRF ``transforms_{split}.json``
format) and its colour transfer functions.

Counterpart of ``nerfmlp_tpu/data/blender.py:31-162``: RGBA load, /255,
white-background compositing ``rgb*a + (1-a)``, sRGB -> linear, focal =
0.5 W / tan(0.5 camera_angle_x), and every ray of every image generated
up front and flattened (numpy). PNGs are read by the port's standard-
library decoder; an image stored at another size than ``img_wh`` is
resized by ``utils/image.py::resize_lanczos``, bit-equal to the JAX
loader's ``Image.resize(img_wh, LANCZOS)`` on its RGBA pixels.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """Standard sRGB -> linear transfer."""
    img = img.astype(np.float32)
    return np.where(
        img <= 0.04045, img / 12.92, np.power((img + 0.055) / 1.055, 2.4)
    )


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """Inverse transfer, for display."""
    img = np.clip(img.astype(np.float32), 0.0, 1.0)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * np.power(img, 1.0 / 2.4) - 0.055
    )


class BlenderDataset:
    """Images, poses, focal and flattened per-pixel rays for one split."""

    def __init__(
        self,
        datadir: str,
        split: str = "train",
        img_wh: Tuple[int, int] = (400, 400),
        white_bkgd: bool = True,
        apply_srgb_to_linear: bool = True,
        testskip: int = 1,
    ):
        self.datadir = datadir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.white_bkgd = white_bkgd
        with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
            self.meta = json.load(f)
        frames = self.meta["frames"]
        if testskip > 1 and split != "train":
            frames = frames[::testskip]
        images, poses = [], []
        for frame in frames:
            name = frame["file_path"].split("/")[-1]
            images.append(self._load_image(
                os.path.join(datadir, split, name + ".png")))
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
        W, H = self.img_wh
        self.images = (np.stack(images, axis=0) if images
                       else np.zeros((0, H, W, 3), np.float32))
        self.poses = (np.stack(poses, axis=0) if poses
                      else np.zeros((0, 4, 4), np.float32))
        self.apply_srgb_to_linear = apply_srgb_to_linear
        if apply_srgb_to_linear:
            self.images = srgb_to_linear(self.images)
        self.H, self.W = H, W
        self.focal = float(0.5 * W / np.tan(0.5 * self.meta["camera_angle_x"]))
        self._generate_rays()

    def _load_image(self, fname: str) -> np.ndarray:
        from nerfmlp_torch.utils.image import read_png, resize_lanczos

        px = read_png(fname)
        if px.shape[2] in (1, 2):  # grey (+ alpha)
            px = np.concatenate([np.repeat(px[..., :1], 3, axis=2),
                                 px[..., 1:]], axis=2)
        if px.shape[2] == 3:       # RGBA, as the JAX loader's convert()
            px = np.concatenate(
                [px, np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=2)
        px = resize_lanczos(px, self.img_wh)
        img = px.astype(np.float32) / 255.0
        rgb, alpha = img[..., :3], img[..., 3:]
        return rgb * alpha + (1.0 - alpha) if self.white_bkgd else rgb * alpha

    def _generate_rays(self) -> None:
        """Precompute all rays (pinhole camera, ops/rays.py::get_rays_np)."""
        from nerfmlp_torch.ops.rays import get_rays_np

        ro, rd = [], []
        for k in range(len(self.images)):
            o, d = get_rays_np(self.H, self.W, self.focal, self.poses[k])
            ro.append(o.reshape(-1, 3).astype(np.float32))
            rd.append(d.reshape(-1, 3).astype(np.float32))
        empty = np.zeros((0, 3), np.float32)
        self.all_rays_o = np.concatenate(ro, axis=0) if ro else empty
        self.all_rays_d = np.concatenate(rd, axis=0) if rd else empty
        self.all_rgbs = self.images.reshape(-1, 3)

    def __len__(self) -> int:
        return self.all_rays_o.shape[0]

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    def image_rays(self, idx: int):
        """(rays_o, rays_d, rgb) for one whole image — validation renders
        held-out images, not shuffled ray subsets."""
        n = self.H * self.W
        sl = slice(idx * n, (idx + 1) * n)
        return (
            self.all_rays_o[sl],
            self.all_rays_d[sl],
            self.all_rgbs[sl].reshape(self.H, self.W, 3),
        )

    def render_poses(self, n_frames: int = 40) -> np.ndarray:
        """The orbit the video events render: ``n_frames`` poses at
        elevation -30 deg, at the capture's mean camera radius (4.0 on
        real Blender scenes)."""
        from nerfmlp_torch.ops.rays import (
            blender_render_poses, mean_camera_radius,
        )

        return blender_render_poses(n_frames=n_frames,
                                    radius=mean_camera_radius(self.poses))

    def dynamic_near_far(self) -> Tuple[float, float]:
        """Scene bounds heuristic with spherical-camera detection: if all
        camera distances from the origin are (nearly) equal, [0.5R, 2R];
        otherwise min/max -/+ 0.5."""
        positions = self.poses[:, :3, 3]
        dists = np.linalg.norm(positions, axis=-1)
        if dists.std() < 0.01:
            center = positions.mean(axis=0)
            radius = float(np.linalg.norm(positions - center, axis=-1).max())
            return max(0.1, 0.5 * radius), 2.0 * radius
        return max(0.1, float(dists.min()) - 0.5), float(dists.max()) + 0.5
