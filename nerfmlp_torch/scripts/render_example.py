"""Render views of a split from a checkpoint, on one GPU or all of a
host's (or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/render_example.py``, with its flags:
``.pt``/``.pth``/``.ckpt`` checkpoints and official ``.npy`` weight lists (64
importance samples by default for ``.npy``, 128 otherwise); bounds 2 / 6
for Blender unless ``--dynamic_bounds``, the dataset's own for LLFF
(NDC [0, 1] unless metric) and DeepVoxels, and ``--near``/``--far`` over
either; the LLFF flags of training (LLFF is never composited on white); ``--apply_gamma``,
``--brightness_boost``, ``--out_prefix``; the occupancy flags. PNGs are
written by the port's own encoder. Beside the JAX CLI: ``--device`` and
``--no_kernel`` (alias ``--no_pallas``). ``--shard_render`` renders each
view over all visible cards.

Example:
    python -m nerfmlp_torch.scripts.render_example --datadir data/lego \\
        --split test --img_wh 400 400 --ckpt logs/lego/model_best.pt
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_dataset_flag, add_device_flags, add_llff_flags,
    add_occupancy_flags, add_shard_flag, add_tile_flag, arch_fields,
    build_occ_grid, dataset_class, dataset_kwargs, load_params,
    occupancy_fields, render_frame,
)


def build_parser():
    p = argparse.ArgumentParser(description="Render NeRF views (PyTorch)")
    p.add_argument("--datadir", type=str, required=True)
    add_dataset_flag(p)
    add_llff_flags(p)
    add_shard_flag(p)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--img_wh", type=int, nargs=2, default=[800, 800])
    p.add_argument("--ckpt", "--model_path", type=str, required=True,
                   help=".pt/.pth/.npy/.ckpt checkpoint")
    p.add_argument("--out_dir", type=str, default="outputs/renders")
    p.add_argument("--out_prefix", type=str, default=None,
                   help="write {out_prefix}_{idx}.png instead of "
                        "{out_dir}/render_{split}_{i}.png")
    p.add_argument("--no_white_bkgd", action="store_true")
    p.add_argument("--use_fine_weights", action="store_true",
                   help="accepted for reference-command compatibility")
    p.add_argument("--num_views", type=int, default=1)
    p.add_argument("--view_idx", type=int, default=None)
    p.add_argument("--near", type=float, default=None,
                   help="explicit near bound (default: 2.0 for blender, "
                        "else the dataset's)")
    p.add_argument("--far", type=float, default=None,
                   help="explicit far bound (default: 6.0 for blender, "
                        "else the dataset's)")
    p.add_argument("--dynamic_bounds", action="store_true",
                   help="derive near/far from the camera poses")
    p.add_argument("--coord_scale", type=float, default=1.0)
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=None,
                   help="default: 64 for .npy official weights, 128 "
                        "otherwise")
    p.add_argument("--apply_gamma", "--gamma_correction",
                   action="store_true",
                   help="linear -> sRGB transfer on the output")
    p.add_argument("--brightness_boost", type=float, default=1.0)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="float32 (parity) or bfloat16 (speed)")
    p.add_argument("--fp32_precision", type=str, default="highest",
                   choices=["highest", "high"])
    p.add_argument("--separate_fine", action="store_true",
                   help="checkpoint holds separate coarse/fine nets")
    add_device_flags(p)
    add_occupancy_flags(p)
    add_tile_flag(p)
    add_arch_flags(p)
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    DS = dataset_class(args.dataset_type)

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.data import image_viewdirs
    from nerfmlp_torch.data.blender import linear_to_srgb
    from nerfmlp_torch.ops.render import prepare_params
    from nerfmlp_torch.utils.image import save_png

    device = resolve_device(args.device)
    use_true_fp32()
    os.makedirs(args.out_dir, exist_ok=True)
    ds = DS(args.datadir, args.split, img_wh=tuple(args.img_wh),
            **dataset_kwargs(args))
    n_importance = args.N_importance
    if n_importance is None:
        n_importance = 64 if args.ckpt.endswith(".npy") else 128
    near, far = 2.0, 6.0     # the Blender scenes' training bounds
    if args.dynamic_bounds or args.dataset_type in ("llff", "deepvoxels"):
        # NDC depths lie in [0, 1]; DeepVoxels' hemisphere is R -/+ 1.
        near, far = ds.dynamic_near_far()
    near = near if args.near is None else args.near
    far = far if args.far is None else args.far
    print(f"bounds: near={near:.3f} far={far:.3f} | "
          f"samples {args.N_samples}+{n_importance}")
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=n_importance, near=near,
        far=far, perturb=False, raw_noise_std=0.0,
        coord_scale=args.coord_scale, compute_dtype=args.compute_dtype,
        fp32_precision=args.fp32_precision, use_kernel=args.use_kernel,
        separate_fine=args.separate_fine,
        ndc=bool(getattr(ds, "use_ndc", False)),
        white_bkgd=args.dataset_type != "llff" and not args.no_white_bkgd,
        **occupancy_fields(args), **arch_fields(args))
    params = prepare_params(load_params(args.ckpt, rc, device), rc)
    occ_grid = build_occ_grid(args, rc, params, p)

    idxs = ([args.view_idx] if args.view_idx is not None
            else list(range(args.num_views)))
    written = []
    for i in idxs:
        k = i % ds.n_images     # past the split's size: cycle, not raise
        o, d, _ = ds.image_rays(k)
        img = render_frame(args, params, o, d, ds.H, ds.W, rc,
                           occ_grid=occ_grid, viewdirs=image_viewdirs(ds, k))
        img = np.clip(img * args.brightness_boost, 0.0, 1.0)
        if args.apply_gamma:
            img = linear_to_srgb(img)
        if args.out_prefix:
            tag = f"view{i}" if args.view_idx is not None else str(i)
            out = f"{args.out_prefix}_{tag}.png"
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        else:
            out = os.path.join(args.out_dir, f"render_{args.split}_{i}.png")
        save_png(out, (img * 255).round().astype(np.uint8))
        written.append(out)
        print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
