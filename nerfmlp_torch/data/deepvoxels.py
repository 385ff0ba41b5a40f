"""DeepVoxels captures (Sitzmann et al.'s synthetic scenes).

Counterpart of ``nerfmlp_tpu/data/deepvoxels.py:1-188`` (numpy, so the
same capture gives the same poses, images and rays in both packages). The
layout is the public release's:

  ``basedir/{train|validation|test}/{scene}/``
    ``intrinsics.txt``  — line 1: ``f cx cy 0``; line 2: grid barycenter;
                          line 3: near plane; line 4: scale;
                          line 5: ``height width`` of the stored images
    ``pose/*.txt``      — 16 floats, a row-major 4x4 camera-to-world in
                          OpenCV axes (x right, y down, z forward)
    ``rgb/*.png``       — RGB images, the white background baked in

Poses go from OpenCV to OpenGL / NeRF axes (y up, z back) by negating the
y and z basis columns. Images are read by the port's PNG decoder and
resized by ``utils/image.py::resize_lanczos`` (Pillow's LANCZOS, bit for
bit) where the JAX loader calls PIL.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

# The CLIs' split names -> the release's directories.
_SPLIT_DIRS = {"train": "train", "val": "validation", "test": "test"}

# OpenCV -> OpenGL camera axes, applied to c2w's columns.
_CV_TO_GL = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def parse_intrinsics(path: str) -> dict:
    """A DeepVoxels ``intrinsics.txt`` (format in the module docstring)."""
    with open(path) as f:
        f_cx_cy = [float(v) for v in f.readline().split()]
        barycenter = np.array(
            [float(v) for v in f.readline().split()], dtype=np.float32
        )
        near_plane = float(f.readline())
        scale = float(f.readline())
        hw = [float(v) for v in f.readline().split()]
    return {
        "focal": f_cx_cy[0],
        "cx": f_cx_cy[1],
        "cy": f_cx_cy[2],
        "barycenter": barycenter,
        "near_plane": near_plane,
        "scale": scale,
        "height": int(hw[0]),
        "width": int(hw[1]),
    }


def load_pose(path: str) -> np.ndarray:
    """One ``pose/*.txt``: 16 floats, row-major 4x4 c2w (OpenCV axes)."""
    return np.loadtxt(path, dtype=np.float32).reshape(4, 4)


class DeepVoxelsDataset:
    """One split of a DeepVoxels scene, with the surface of BlenderDataset
    (``H``/``W``/``focal``/``poses``, flattened rays, ``render_poses``,
    ``dynamic_near_far``)."""

    def __init__(
        self,
        datadir: str,
        split: str = "train",
        img_wh: Tuple[int, int] = (512, 512),
        shape: str = "greek",
        white_bkgd: bool = True,  # baked into the images; unused
        apply_srgb_to_linear: bool = False,
        testskip: int = 1,
    ):
        self.datadir = datadir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.shape = shape

        base = os.path.join(datadir, _SPLIT_DIRS[split], shape)
        if not os.path.isdir(base):
            # Single-scene dumps drop the scene level.
            alt = os.path.join(datadir, _SPLIT_DIRS[split])
            if os.path.isdir(os.path.join(alt, "rgb")):
                base = alt
            else:
                raise FileNotFoundError(base)

        intr = parse_intrinsics(os.path.join(base, "intrinsics.txt"))
        W, H = self.img_wh
        self.H, self.W = H, W
        # The focal is calibrated at the stored size.
        self.focal = float(intr["focal"] * W / intr["width"])
        self.intrinsics = intr

        pose_files = sorted(glob.glob(os.path.join(base, "pose", "*.txt")))
        img_files = sorted(glob.glob(os.path.join(base, "rgb", "*.png")))
        if len(pose_files) != len(img_files):
            raise ValueError(
                f"pose/rgb count mismatch in {base}: "
                f"{len(pose_files)} poses vs {len(img_files)} images"
            )
        if testskip > 1 and split != "train":
            pose_files = pose_files[::testskip]
            img_files = img_files[::testskip]

        poses = [load_pose(p) @ _CV_TO_GL for p in pose_files]
        self.poses = np.stack(poses, axis=0).astype(np.float32)
        self.images = np.stack(
            [self._load_image(p) for p in img_files], axis=0
        )
        if apply_srgb_to_linear:
            from nerfmlp_torch.data.blender import srgb_to_linear

            self.images = srgb_to_linear(self.images)
        self._generate_rays()

    def _load_image(self, fname: str) -> np.ndarray:
        """(H, W, 3) float32 as ``Image.open(f).convert("RGB")`` and, at
        another size, a LANCZOS resize give it."""
        from nerfmlp_torch.utils.image import read_rgb, resize_lanczos

        px = resize_lanczos(read_rgb(fname), self.img_wh)
        return px.astype(np.float32) / 255.0

    def _generate_rays(self) -> None:
        from nerfmlp_torch.ops.rays import get_rays_np

        ro, rd = [], []
        for k in range(len(self.images)):
            o, d = get_rays_np(self.H, self.W, self.focal, self.poses[k])
            ro.append(o.reshape(-1, 3).astype(np.float32))
            rd.append(d.reshape(-1, 3).astype(np.float32))
        self.all_rays_o = np.concatenate(ro, axis=0)
        self.all_rays_d = np.concatenate(rd, axis=0)
        self.all_rgbs = self.images.reshape(-1, 3)

    def __len__(self) -> int:
        return self.all_rays_o.shape[0]

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    def image_rays(self, idx: int):
        n = self.H * self.W
        sl = slice(idx * n, (idx + 1) * n)
        return (
            self.all_rays_o[sl],
            self.all_rays_d[sl],
            self.all_rgbs[sl].reshape(self.H, self.W, 3),
        )

    def render_poses(self, n_frames: int = 40) -> np.ndarray:
        """An orbit at the captures' mean camera radius and mean
        elevation (the release's own trajectory file is not read)."""
        from nerfmlp_torch.ops.rays import (
            blender_render_poses, mean_camera_radius,
        )

        t = self.poses[:, :3, 3]
        radius = mean_camera_radius(self.poses)
        elev = float(
            np.degrees(np.arcsin(np.clip(t[:, 2] / np.maximum(
                np.linalg.norm(t, axis=-1), 1e-8), -1, 1))).mean()
        )
        return blender_render_poses(
            n_frames=n_frames, radius=radius, phi_deg=-abs(elev)
        )

    def dynamic_near_far(self) -> Tuple[float, float]:
        """Hemisphere bounds: ``R -/+ 1``, ``R`` the mean camera radius."""
        from nerfmlp_torch.ops.rays import mean_camera_radius

        hemi_r = mean_camera_radius(self.poses)
        return max(0.05, hemi_r - 1.0), hemi_r + 1.0
