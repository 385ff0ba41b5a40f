"""Render a camera trajectory (or the test split) to PNG frames and rgb /
disparity videos, on one GPU (or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/render_video.py``, with its flags:

  * the dataset's trajectory by default (Blender and DeepVoxels: the
    orbit at the captures' mean radius; LLFF: the spiral around the
    average pose, or the circle under ``--spherify``, from the whole
    capture), ``--flythrough`` for the looping fly-through (metric rays
    only);
  * ``--dataset_type llff`` with the LLFF flags of training
    (``--factor``, ``--llffhold``, ``--spherify``, ``--no_ndc``,
    ``--no_aspect_snap``): NDC rays unless metric, frames ``--size`` wide
    at the capture's aspect (504 -> 504x378 for a 4:3 capture); no white
    background (Blender and DeepVoxels composite on white);
  * ``--render_test``: the test split's poses, with per-frame PSNR against
    the ground truth (``psnr.json``);
  * ``--render_factor``: a downscale for fast previews;
  * the occupancy flags: a model trained with a grid renders with one
    built from its weights, as the render service builds it.

Videos are animated GIFs (``<out_dir>/<tag>_{rgb,disp}.gif``). Beside the
JAX CLI: ``--device``, ``--no_kernel`` (alias ``--no_pallas``) and
``--tile`` (default: 16,384 rays with ``--use_occupancy``, else 4,096).
``--shard_render`` is refused (ROADMAP.md, Queue 1 item 18).

Example:
    python -m nerfmlp_torch.scripts.render_video --datadir data/lego \\
        --ckpt logs/lego/model_final.pt --n_frames 40 --size 400
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_dataset_flag, add_device_flags, add_llff_flags,
    add_occupancy_flags, add_shard_flag, add_tile_flag, arch_fields,
    build_occ_grid, dataset_class, dataset_kwargs, load_params,
    occupancy_fields, refuse_shard_render, resolve_tile,
)


def build_parser():
    p = argparse.ArgumentParser(
        description="Render an orbit / fly-through / test-set video")
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True,
                   help=".pt, .pth, .npy or .ckpt weights")
    add_dataset_flag(p)
    p.add_argument("--out_dir", type=str, default="outputs/video")
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--render_factor", type=int, default=0,
                   help="downscale factor for fast previews")
    p.add_argument("--render_test", action="store_true",
                   help="render the test split's poses with per-frame PSNR "
                        "instead of a trajectory")
    p.add_argument("--flythrough", action="store_true",
                   help="looping orbit with altitude and distance variation")
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=64)
    p.add_argument("--near", type=float, default=None)
    p.add_argument("--far", type=float, default=None)
    p.add_argument("--separate_fine", action="store_true")
    add_device_flags(p)
    add_arch_flags(p)
    add_occupancy_flags(p)
    add_shard_flag(p)
    add_tile_flag(p)
    add_llff_flags(p)
    return p


def main(argv=None):
    """Returns {"rgbs", "disps", "psnrs", "videos", "cfg"}: the rendered
    frames, their PSNRs (``--render_test``), the two video paths and the
    render config."""
    p = build_parser()
    args = p.parse_args(argv)
    refuse_shard_render(args)
    DS = dataset_class(args.dataset_type)

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.ops.render import prepare_params
    from nerfmlp_torch.render_path import render_path, save_path_videos

    device = resolve_device(args.device)
    use_true_fp32()
    os.makedirs(args.out_dir, exist_ok=True)
    wh = (args.size, args.size)
    split = "test" if args.render_test else "train"
    kw = dataset_kwargs(args)
    try:
        ds = DS(args.datadir, split, img_wh=wh, **kw)
    except FileNotFoundError:
        if not args.render_test or args.dataset_type != "blender":
            raise
        print("(no test split; using val)")
        ds = DS(args.datadir, "val", img_wh=wh, **kw)
    ndc = bool(getattr(ds, "use_ndc", False))
    near, far = ds.dynamic_near_far()
    near = near if args.near is None else args.near
    far = far if args.far is None else args.far
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        near=near, far=far, perturb=False, ndc=ndc,
        # White composite for Blender and DeepVoxels; LLFF's real photos
        # have a background of their own.
        white_bkgd=args.dataset_type != "llff",
        separate_fine=args.separate_fine, use_kernel=args.use_kernel,
        compute_dtype="bfloat16" if args.use_kernel else "float32",
        **occupancy_fields(args), **arch_fields(args))
    params = prepare_params(load_params(args.ckpt, rc, device), rc)
    occ_grid = build_occ_grid(args, rc, params, p)

    if args.render_test:
        poses, gts, tag = ds.poses, ds.images, "test"
    elif args.flythrough:
        from nerfmlp_torch.ops.rays import flythrough_poses, mean_camera_radius

        if ndc:
            # A world-space orbit through the forward-facing projection
            # gives origins out of its range.
            p.error("--flythrough needs metric rays: forward-facing NDC "
                    "LLFF captures can't be orbited (use the default "
                    "spiral path, or --spherify for 360 captures)")
        poses = flythrough_poses(n_frames=args.n_frames,
                                 radius=mean_camera_radius(ds.poses))
        gts, tag = None, "flythrough"
    else:
        poses, gts, tag = ds.render_poses(n_frames=args.n_frames), None, "path"
    rgbs, disps, psnrs = render_path(
        params, poses, (ds.H, ds.W, ds.focal), rc, gt_images=gts,
        render_factor=args.render_factor, occ_grid=occ_grid,
        save_dir=os.path.join(args.out_dir, "frames"),
        tile=resolve_tile(args))
    videos = save_path_videos(os.path.join(args.out_dir, tag), rgbs, disps,
                              fps=args.fps)
    print(f"wrote {videos[0]} and {videos[1]}")
    if psnrs:
        report = {"per_frame_psnr": [round(float(x), 3) for x in psnrs],
                  "mean_psnr": round(float(np.mean(psnrs)), 3)}
        with open(os.path.join(args.out_dir, "psnr.json"), "w") as f:
            json.dump(report, f, indent=2)
        print(f"mean test PSNR {report['mean_psnr']:.2f} ({len(psnrs)} "
              "frames; psnr.json written)")
    return {"rgbs": rgbs, "disps": disps, "psnrs": psnrs, "videos": videos,
            "cfg": rc}


if __name__ == "__main__":
    main()
