"""Render one view and write it beside its ground truth, [ground truth |
render], with the view's PSNR and SSIM, on one GPU (or, with ``--device
cpu``, on the CPU).

The PyTorch counterpart of ``scripts/compare_single_view.py``, with its
flags (``--dataset_type`` ``blender`` or ``llff``; LLFF is not composited
on white) and the occupancy flags. Beside the JAX CLI: ``--device``;
``--no_kernel`` (alias ``--no_pallas``) renders in float32 on the module
path unless ``--compute_dtype`` says otherwise, as there.

Example:
    python -m nerfmlp_torch.scripts.compare_single_view --datadir data/lego \\
        --ckpt logs/lego/model_final.pt --view_idx 0 --out cmp.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_dataset_flag, add_device_flags, add_occupancy_flags,
    arch_fields, build_occ_grid, dataset_class, load_params,
    occupancy_fields,
)


def build_parser():
    p = argparse.ArgumentParser(description="Render-vs-GT side-by-side")
    p.add_argument("--datadir", type=str, required=True)
    add_dataset_flag(p, choices=("blender", "llff"))
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--img_wh", type=int, nargs=2, default=[400, 400])
    p.add_argument("--ckpt", "--model_path", type=str, required=True)
    p.add_argument("--view_idx", type=int, default=0)
    p.add_argument("--out", "--output", type=str,
                   default="outputs/compare.png")
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=128)
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="default: bfloat16 with the kernel, float32 with "
                        "--no_kernel")
    p.add_argument("--fp32_precision", type=str, default="highest",
                   choices=["highest", "high"])
    p.add_argument("--separate_fine", action="store_true",
                   help="checkpoint holds separate coarse/fine nets")
    add_device_flags(p)
    add_arch_flags(p)
    add_occupancy_flags(p)
    return p


def main(argv=None):
    """Returns the view's (psnr, ssim)."""
    p = build_parser()
    args = p.parse_args(argv)
    DS = dataset_class(args.dataset_type)

    import torch

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.data import image_viewdirs
    from nerfmlp_torch.ops.render import prepare_params, render_image
    from nerfmlp_torch.train.metrics import psnr_images, ssim
    from nerfmlp_torch.utils.image import save_png

    device = resolve_device(args.device)
    use_true_fp32()
    ds = DS(args.datadir, args.split, img_wh=tuple(args.img_wh))
    near, far = ds.dynamic_near_far()
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance, near=near,
        far=far, perturb=False, use_kernel=args.use_kernel,
        separate_fine=args.separate_fine,
        compute_dtype=args.compute_dtype or (
            "bfloat16" if args.use_kernel else "float32"),
        fp32_precision=args.fp32_precision,
        ndc=bool(getattr(ds, "use_ndc", False)),
        white_bkgd=args.dataset_type != "llff",
        **occupancy_fields(args), **arch_fields(args))
    params = prepare_params(load_params(args.ckpt, rc, device), rc)
    occ_grid = build_occ_grid(args, rc, params, p)

    o, d, gt = ds.image_rays(args.view_idx)
    vd = image_viewdirs(ds, args.view_idx)

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    img = render_image(params, t(o), t(d), ds.H, ds.W, rc, viewdirs=t(vd),
                       occ_grid=occ_grid).float().cpu().numpy()
    scores = psnr_images(img, gt), ssim(img, gt)
    print(f"view {args.view_idx}: PSNR {scores[0]:.2f} dB | SSIM "
          f"{scores[1]:.4f}")
    side = np.concatenate([np.clip(gt, 0, 1), np.clip(img, 0, 1)], axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(args.out, (side * 255).round().astype(np.uint8))
    print(f"wrote {args.out} (left: ground truth, right: render)")
    return scores


if __name__ == "__main__":
    main()
