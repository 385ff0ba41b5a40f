"""LLFF forward-facing captures, with NDC rays, and 360 captures through
``spherify``.

Counterpart of ``nerfmlp_tpu/data/llff.py:21-472`` (numpy, so the same
capture gives the same poses, bounds, images and rays in both packages).
The layout is COLMAP2LLFF's: ``poses_bounds.npy`` of shape (N, 17) — a
3x5 ``[down | right | back | t | hwf]`` pose and two depth bounds per
image — beside ``images/`` and its downsamples ``images_{factor}/``.

Images, PNG or JPEG, are read by the port's decoders
(``utils/image.py::read_rgb``; the JPEG pixels equal Pillow's) and resized
by ``utils/image.py::resize_lanczos`` (Pillow's LANCZOS, bit for bit),
where the JAX loader calls PIL. A missing ``images_{factor}/`` is minified
from ``images/`` as the JAX loader does it, but written as lossless PNG
(see :meth:`LLFFDataset._ensure_factor_dir`). The NDC projection runs
``ops/rays.py::ndc_rays`` on CPU tensors.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Tuple

import numpy as np
import torch

from nerfmlp_torch.utils.image import (
    IMAGE_EXTS, image_size, png_bytes, read_image, read_rgb, resize_lanczos,
)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-12)


def _viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Camera-to-world (3, 4) from a forward (+z back) axis, up hint, pos."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _focus_point(poses: np.ndarray) -> np.ndarray:
    """The point nearest, in summed squared distance, to every camera's
    optical axis: least squares over the projectors perpendicular to each
    axis (``lstsq``, so parallel axes give the min-norm point)."""
    d = poses[:, :3, 2]
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12)
    proj = np.eye(3)[None] - d[:, :, None] * d[:, None, :]  # (N, 3, 3)
    lhs = proj.mean(axis=0)
    rhs = (proj @ poses[:, :3, 3:4]).mean(axis=0)[:, 0]
    return np.linalg.lstsq(lhs, rhs, rcond=None)[0]


def spherify_poses(poses: np.ndarray, bounds: np.ndarray):
    """360-capture normalisation: recentre the rig on the point the cameras
    look at, scale the mean camera onto the unit sphere, and build a
    120-pose circle at the rig's mean height looking at the centre.

    Returns (poses (N, 4, 4), render_poses (120, 4, 4), bounds, scale)."""
    center = _focus_point(poses)
    up_raw = (poses[:, :3, 3] - center).mean(axis=0)
    if np.linalg.norm(up_raw) < 1e-6:
        # Cameras centred on the focus point: the cameras' mean up axis.
        up_raw = poses[:, :3, 1].sum(axis=0)
    up = _normalize(up_raw)
    x = _normalize(np.cross(np.array([0.1, 0.2, 0.3]), up))
    y = _normalize(np.cross(up, x))
    frame = np.eye(4, dtype=np.float32)
    frame[:3, 0], frame[:3, 1], frame[:3, 2], frame[:3, 3] = x, y, up, center
    poses = (np.linalg.inv(frame)[None] @ poses).astype(np.float32)

    rad = float(np.sqrt(np.mean(np.sum(poses[:, :3, 3] ** 2, axis=-1))))
    sc = 1.0 / rad
    poses[:, :3, 3] *= sc
    bounds = bounds * sc

    zh = float(poses[:, :3, 3].mean(axis=0)[2])
    radcircle = float(np.sqrt(max(1.0 - zh * zh, 1e-6)))
    render = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120, endpoint=False):
        pos = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh],
            dtype=np.float32,
        )
        back = _normalize(pos)  # camera +z points away from the origin
        right = _normalize(np.cross(back, np.array([0.0, 0.0, -1.0])))
        upv = _normalize(np.cross(back, right))
        p = np.eye(4, dtype=np.float32)
        p[:3, 0], p[:3, 1], p[:3, 2], p[:3, 3] = right, upv, back, pos
        render.append(p)
    return poses, np.stack(render), bounds, sc


def spiral_render_poses(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
) -> np.ndarray:
    """The forward-facing spiral around the average (recentred) pose: focus
    depth from the depth bounds, radii from the 90th percentile of the
    camera offsets."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :4] = _viewmatrix(
        _normalize(poses[:, :3, 2].sum(axis=0)),
        poses[:, :3, 1].sum(axis=0),
        poses[:, :3, 3].mean(axis=0),
    )
    up = _normalize(poses[:, :3, 1].sum(axis=0))
    close, far = float(bounds.min()) * 0.9, float(bounds.max()) * 5.0
    dt = 0.75
    focus = 1.0 / ((1.0 - dt) / close + dt / far)
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)

    out = []
    for th in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        offset = np.array(
            [np.cos(th), -np.sin(th), -np.sin(th * zrate)], dtype=np.float32
        ) * rads
        pos = c2w[:3, 3] + c2w[:3, :3] @ offset
        look = c2w[:3, 3] + c2w[:3, :3] @ np.array([0.0, 0.0, -focus],
                                                    np.float32)
        back = _normalize(pos - look)
        p = np.eye(4, dtype=np.float32)
        p[:3, :4] = _viewmatrix(back, up, pos)
        out.append(p)
    return np.stack(out)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Move the (N, 4, 4) c2w rig rigidly so that its average pose is the
    identity: cameras centred at the origin, looking down -z on average,
    the frame the NDC projection assumes."""
    center = poses[:, :3, 3].mean(axis=0)
    vec2 = _normalize(poses[:, :3, 2].sum(axis=0))
    up = poses[:, :3, 1].sum(axis=0)
    avg = np.eye(4, dtype=np.float32)
    avg[:3, :4] = _viewmatrix(vec2, up, center)
    return (np.linalg.inv(avg)[None] @ poses).astype(np.float32)


def _image_files(d: str):
    return sorted(f for f in os.listdir(d) if f.lower().endswith(IMAGE_EXTS))


class LLFFDataset:
    """A forward-facing (or, with ``spherify``, a 360) capture, with the
    surface of BlenderDataset (``all_rays_*``, ``image_rays``, ``n_images``,
    ``H``/``W``/``focal``, ``render_poses``, ``dynamic_near_far``) plus
    ``all_viewdirs`` / ``image_viewdirs``: the world-space unit directions
    taken before the NDC projection (None with metric rays)."""

    def __init__(
        self,
        datadir: str,
        split: str = "train",
        img_wh: Tuple[int, int] = (504, 378),
        white_bkgd: bool = False,   # real photos: no alpha; unused
        llffhold: int = 8,          # every Nth image is val / test
        use_ndc: bool = True,
        apply_srgb_to_linear: bool = False,
        bd_factor: float = 0.75,    # nearest depth bound -> 1 / bd_factor
        recenter: bool = True,
        spherify: bool = False,     # 360 capture: metric rays, a circle
        factor: int = 0,            # read images_{factor}/ (made if absent)
        keep_aspect: bool = True,   # snap H to the capture's aspect; False
                                    # honours a non-native img_wh (rays
                                    # then keep the squashed vertical FOV)
        **_,
    ):
        self.datadir = datadir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.spherify = spherify
        # NDC assumes a forward-facing rig looking down -z: spherify
        # implies metric rays.
        self.use_ndc = use_ndc and not spherify
        W, H = img_wh
        self.H, self.W = H, W

        pb = np.load(os.path.join(datadir, "poses_bounds.npy"))  # (N, 17)
        poses = pb[:, :15].reshape(-1, 3, 5)
        self.bounds = pb[:, 15:17]

        # [down, right, back] -> [right, up, back].
        poses = np.concatenate(
            [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2
        )
        hwf = poses[0, :, 4]
        orig_h, orig_w, orig_f = hwf
        # One focal serves both axes, so the size must keep the capture's
        # aspect: snap the height (square requests such as --quick_val_res
        # 256 256 are common), unless told to honour the size as given.
        if abs(H / W - orig_h / orig_w) > 0.01:
            if keep_aspect:
                H = max(1, int(round(W * orig_h / orig_w)))
                self.img_wh = (W, H)
                self.H = H
                print(f"(llff: snapped height to preserve the capture's "
                      f"aspect: {W}x{H}; pass keep_aspect=False to force "
                      f"the requested size)")
            else:
                warnings.warn(
                    f"llff: honoring non-native aspect {W}x{H} "
                    f"(capture is {int(orig_w)}x{int(orig_h)}) — vertical "
                    f"FOV will not match the resized GT"
                )
        self.focal = float(orig_f * W / orig_w)

        c2w = np.tile(np.eye(4, dtype=np.float32), (poses.shape[0], 1, 1))
        c2w[:, :3, :4] = poses[:, :, :4]

        # Scale so the nearest bound sits at 1 / bd_factor, then recentre:
        # the NDC projection's -z and [0, 1] conventions need both.
        if bd_factor:
            sc = 1.0 / (float(self.bounds.min()) * bd_factor)
            c2w[:, :3, 3] *= sc
            self.bounds = self.bounds * sc
        if recenter:
            c2w = recenter_poses(c2w)
        self._spherify_render_poses = None
        if spherify:
            c2w, self._spherify_render_poses, self.bounds, _ = spherify_poses(
                c2w, self.bounds
            )
        self.poses = c2w.astype(np.float32)
        # Near / far and the spiral come from the whole capture, before
        # the holdout, so that every split agrees.
        self._full_bounds = self.bounds.copy()
        self._full_poses = self.poses.copy()

        if factor and factor > 1:
            img_dir = self._ensure_factor_dir(datadir, factor)
        else:
            img_dir = self._pick_image_dir(datadir, W)
        if img_dir is None:
            raise FileNotFoundError(f"no images*/ directory under {datadir}")
        files = _image_files(img_dir)
        if len(files) != self.poses.shape[0]:
            raise ValueError(
                f"{len(files)} images vs {self.poses.shape[0]} poses"
            )

        idxs = np.arange(len(files))
        if llffhold <= 0 and split != "train":
            raise ValueError(
                f"llffhold={llffhold} leaves the '{split}' split empty — "
                f"holdout views come from every Nth image; use "
                f"llffhold >= 1"
            )
        hold = idxs[::llffhold] if llffhold > 0 else idxs[:0]
        keep = np.setdiff1d(idxs, hold) if split == "train" else hold
        self.poses = self.poses[keep]
        self.bounds = self.bounds[keep]

        imgs = [resize_lanczos(read_rgb(os.path.join(img_dir, files[i])),
                               self.img_wh).astype(np.float32) / 255.0
                for i in keep]
        self.images = (np.stack(imgs, axis=0) if imgs
                       else np.zeros((0, self.H, self.W, 3), np.float32))
        if apply_srgb_to_linear:
            from nerfmlp_torch.data.blender import srgb_to_linear

            self.images = srgb_to_linear(self.images)

        self._generate_rays()

    @staticmethod
    def _ensure_factor_dir(datadir: str, factor: int) -> str:
        """``images_{factor}/``, made from ``images/`` by a LANCZOS minify
        (to ``size // factor``, each image in its own channels) when it
        does not exist. Every image is written as lossless PNG,
        ``<stem>.png``: the JAX loader saves each under its own name, so
        Pillow re-encodes a JPEG at quality 75
        (``nerfmlp_tpu/data/llff.py:352-361``), and the port has no JPEG
        encoder (ROADMAP.md, Queue 3). Both loaders read either directory.
        Names whose stems collide, or whose order the new suffix would
        change, are refused. The directory is built in
        ``images_{factor}.tmp/`` and renamed on completion, so a killed
        or refused run leaves no partial directory. A pre-minified
        directory with no ``images/`` beside it is trusted; one whose image
        count differs from ``images/``'s, or one that holds no images but
        other files, is refused, never deleted."""
        out_dir = os.path.join(datadir, f"images_{factor}")
        src_dir = os.path.join(datadir, "images")

        def _n_imgs(d):
            return len(_image_files(d))

        if os.path.isdir(out_dir) and _n_imgs(out_dir):
            if not os.path.isdir(src_dir) or _n_imgs(out_dir) == _n_imgs(src_dir):
                return out_dir
            raise ValueError(
                f"{out_dir} has {_n_imgs(out_dir)} images but {src_dir} "
                f"has {_n_imgs(src_dir)} — the downsample dir looks "
                f"incomplete (killed minify run?) or images/ changed. "
                f"Delete {out_dir} to rebuild it, or fix images/."
            )
        if not os.path.isdir(src_dir):
            raise FileNotFoundError(
                f"--factor {factor}: neither {out_dir} nor {src_dir} exists"
            )
        names = _image_files(src_dir)
        outs = [os.path.splitext(f)[0] + ".png" for f in names]
        if len(set(outs)) != len(outs) or sorted(outs) != outs:
            raise ValueError(
                f"{src_dir}: the minified PNG names {outs} would collide or "
                f"sort in another order than {names}; rename the images")
        tmp_dir = out_dir + ".tmp"
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)
        if os.path.isdir(out_dir):
            if os.listdir(out_dir):
                raise ValueError(
                    f"{out_dir} exists but holds no recognized images "
                    f"(.png/.jpg/.jpeg) — delete it to rebuild from "
                    f"{src_dir}, or convert its contents"
                )
            shutil.rmtree(out_dir)
        os.makedirs(tmp_dir)
        try:
            for name, out in zip(names, outs):
                px = read_image(os.path.join(src_dir, name))
                px = resize_lanczos(px, (px.shape[1] // factor,
                                         px.shape[0] // factor))
                with open(os.path.join(tmp_dir, out), "wb") as f:
                    f.write(png_bytes(px))
        except BaseException:
            shutil.rmtree(tmp_dir)
            raise
        os.replace(tmp_dir, out_dir)
        return out_dir

    def render_poses(self, n_frames: int = 120) -> np.ndarray:
        """The video trajectory, from the whole capture (before the
        holdout): the circle of a spherified 360 capture, else the spiral
        around the average pose."""
        if self._spherify_render_poses is not None:
            rp = self._spherify_render_poses
            if n_frames != rp.shape[0]:
                idx = np.linspace(0, rp.shape[0], n_frames, endpoint=False)
                rp = rp[idx.astype(int)]
            return rp
        return spiral_render_poses(
            self._full_poses, self._full_bounds, n_frames=n_frames
        )

    @staticmethod
    def _pick_image_dir(datadir: str, want_w: int):
        """The narrowest ``images*/`` directory at least ``want_w`` wide,
        else the widest; widths from the first image's header.
        ``images_N.tmp`` (a minify in flight or killed) is never picked."""
        cands = []
        for name in sorted(os.listdir(datadir)):
            if name.endswith(".tmp"):
                continue
            if name == "images" or name.startswith("images_"):
                d = os.path.join(datadir, name)
                if not os.path.isdir(d):
                    continue
                files = _image_files(d)
                if not files:
                    continue
                cands.append((image_size(os.path.join(d, files[0]))[0], d))
        if not cands:
            return None
        big_enough = [c for c in cands if c[0] >= want_w]
        return min(big_enough)[1] if big_enough else max(cands)[1]

    def _generate_rays(self) -> None:
        from nerfmlp_torch.ops.rays import get_rays_np, ndc_rays

        ro, rd, vds = [], [], []
        for k in range(self.poses.shape[0]):
            o, d = get_rays_np(self.H, self.W, self.focal, self.poses[k])
            o = o.reshape(-1, 3).astype(np.float32)
            d = d.reshape(-1, 3).astype(np.float32)
            if self.use_ndc:
                # The view branch sees the world-space directions, taken
                # before the NDC projection.
                vds.append((d / np.linalg.norm(d, axis=-1, keepdims=True)
                            ).astype(np.float32))
                o_n, d_n = ndc_rays(self.H, self.W, self.focal, 1.0,
                                    torch.from_numpy(o.copy()),
                                    torch.from_numpy(d))
                o, d = o_n.numpy(), d_n.numpy()
            ro.append(o)
            rd.append(d)
        empty = np.zeros((0, 3), np.float32)
        self.all_rays_o = np.concatenate(ro, axis=0) if ro else empty
        self.all_rays_d = np.concatenate(rd, axis=0) if rd else empty
        # A view over the image stack, not a copy (as blender.py).
        self.all_rgbs = self.images.reshape(-1, 3)
        self.all_viewdirs = np.concatenate(vds, axis=0) if vds else None

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

    def image_viewdirs(self, idx: int):
        """World-space view directions of one image (None for metric rays)."""
        if self.all_viewdirs is None:
            return None
        n = self.H * self.W
        return self.all_viewdirs[idx * n: (idx + 1) * n]

    def dynamic_near_far(self) -> Tuple[float, float]:
        """NDC: [0, 1]; metric: the whole capture's bounds x 0.9 / x 1.0
        (the same for every split)."""
        if self.use_ndc:
            return 0.0, 1.0
        return (
            float(self._full_bounds.min() * 0.9),
            float(self._full_bounds.max() * 1.0),
        )
