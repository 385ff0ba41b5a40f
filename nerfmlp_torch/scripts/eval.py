"""Evaluate a checkpoint on a split: render every view and report
per-view and mean PSNR and SSIM, on one GPU or all of a host's (or,
with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/eval.py``, with its flags and its
JSON report (``--out``, default ``<ckpt>.eval.json``), ``--save_renders``
the occupancy flags and ``--dataset_type`` ``blender``, ``llff`` (with
the LLFF flags of training; no white background) or ``deepvoxels``
(``--shape``). Beside the JAX CLI: ``--device`` and
``--no_kernel`` (alias ``--no_pallas``). ``--shard_render`` renders each
view over all visible cards. Refused by name: ``--lpips`` (the ``lpips``
package and its pretrained AlexNet weights are not available to the
port).

Example:
    python -m nerfmlp_torch.scripts.eval --datadir data/lego --split test \\
        --img_wh 400 400 --ckpt logs/lego/model_final.pt
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_dataset_flag, add_device_flags, add_llff_flags,
    add_occupancy_flags, add_shard_flag, add_tile_flag, arch_fields,
    build_occ_grid, dataset_class, dataset_kwargs, load_params,
    occupancy_fields, render_frame,
)


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate a checkpoint on a split")
    p.add_argument("--datadir", type=str, required=True)
    add_dataset_flag(p)
    add_llff_flags(p)
    add_occupancy_flags(p)
    add_shard_flag(p)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--img_wh", type=int, nargs=2, default=[800, 800])
    p.add_argument("--ckpt", type=str, required=True,
                   help=".pt, .pth, .npy or .ckpt")
    p.add_argument("--out", type=str, default=None,
                   help="JSON report path (default: <ckpt>.eval.json)")
    p.add_argument("--save_renders", type=str, default=None,
                   help="optional dir for the rendered PNGs")
    p.add_argument("--lpips", action="store_true",
                   help="not ported: needs the lpips package and its "
                        "pretrained weights")
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=128)
    p.add_argument("--near", type=float, default=None)
    p.add_argument("--far", type=float, default=None)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--fp32_precision", type=str, default="highest",
                   choices=["highest", "high"])
    p.add_argument("--separate_fine", action="store_true",
                   help="checkpoint holds separate coarse/fine nets")
    add_device_flags(p)
    add_tile_flag(p)
    add_arch_flags(p)
    return p


def main(argv=None):
    """Returns the report written to the JSON file."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.lpips:
        raise SystemExit("--lpips: LPIPS needs the lpips package and its "
                         "pretrained AlexNet weights, which the PyTorch port "
                         "does not have")
    DS = dataset_class(args.dataset_type)

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.data import image_viewdirs
    from nerfmlp_torch.ops.render import prepare_params
    from nerfmlp_torch.train.metrics import psnr_images, ssim
    from nerfmlp_torch.utils.image import save_png

    device = resolve_device(args.device)
    use_true_fp32()
    ds = DS(args.datadir, args.split, img_wh=tuple(args.img_wh),
            **dataset_kwargs(args))
    near, far = ds.dynamic_near_far()
    near = near if args.near is None else args.near
    far = far if args.far is None else args.far
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance, near=near,
        far=far, perturb=False, raw_noise_std=0.0,
        compute_dtype=args.compute_dtype, fp32_precision=args.fp32_precision,
        use_kernel=args.use_kernel, separate_fine=args.separate_fine,
        ndc=bool(getattr(ds, "use_ndc", False)),
        white_bkgd=args.dataset_type != "llff", **occupancy_fields(args),
        **arch_fields(args))
    params = prepare_params(load_params(args.ckpt, rc, device), rc)
    occ_grid = build_occ_grid(args, rc, params, p)
    if args.save_renders:
        os.makedirs(args.save_renders, exist_ok=True)

    per_view = []
    t0 = time.time()
    for i in range(ds.n_images):
        o, d, gt = ds.image_rays(i)
        img = render_frame(args, params, o, d, ds.H, ds.W, rc,
                           occ_grid=occ_grid, viewdirs=image_viewdirs(ds, i))
        view = {"view": i, "psnr": psnr_images(img, gt), "ssim": ssim(img, gt)}
        per_view.append(view)
        print(f"view {i:3d}: PSNR {view['psnr']:6.2f} dB | SSIM "
              f"{view['ssim']:.4f}")
        if args.save_renders:
            save_png(os.path.join(args.save_renders,
                                  f"eval_{args.split}_{i}.png"), img)
    dt = time.time() - t0
    report = {
        "split": args.split,
        "n_views": ds.n_images,
        "resolution": list(args.img_wh),
        "mean_psnr": float(np.mean([v["psnr"] for v in per_view])),
        "mean_ssim": float(np.nanmean([v["ssim"] for v in per_view])),
        "mean_lpips": None,
        "sec_per_frame": dt / max(ds.n_images, 1),
        "per_view": per_view,
        "config": {"N_samples": args.N_samples,
                   "N_importance": args.N_importance, "near": near,
                   "far": far, "ckpt": args.ckpt},
    }
    out = args.out or (args.ckpt + ".eval.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nmean PSNR {report['mean_psnr']:.2f} dB | mean SSIM "
          f"{report['mean_ssim']:.4f} | {report['sec_per_frame']:.2f} "
          f"s/frame -> {out}")
    return report


if __name__ == "__main__":
    main()
