"""Serve renders from a resident checkpoint over HTTP, on one GPU.

The PyTorch counterpart of ``scripts/serve.py``, with the same flag names
for the parts ported plus ``--device``. Checkpoints are ``.npy`` official
weight lists or ``.pth``/``.pt`` reference files; camera defaults come from
``--focal``/``--near``/``--far`` (near/far default to the Blender 2/6).

A model trained with ``--use_occupancy`` is served with the same flag and
its ``--aabb``: the service builds a density grid from the loaded weights
at start-up (fixed seed) and rebuilds it on every weight swap; ``--tile``
then defaults to 16,384 rays (4,096 otherwise).

Example:
    python -m nerfmlp_torch.scripts.serve --ckpt model.pth --focal 555.5 \\
        --img_wh 400 400 --port 8008
    curl -s localhost:8008/render -d '{"theta": 30, "phi": -30, "radius": 4}' \\
        -o view.png
"""

from __future__ import annotations

import argparse


def build_service(args):
    """CLI args -> a ready (unwarmed) RenderService."""
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.serve import RenderService
    from nerfmlp_torch.train.checkpoint import load_params_any
    from nerfmlp_torch.utils.cli import occupancy_fields, resolve_tile

    W, H = args.img_wh
    n_importance = args.N_importance
    if n_importance is None:
        n_importance = 64 if args.ckpt.endswith(".npy") else 128
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=n_importance,
        near=float(args.near), far=float(args.far), perturb=False,
        raw_noise_std=0.0, coord_scale=args.coord_scale,
        compute_dtype=args.compute_dtype,
        fp32_precision=args.fp32_precision, use_kernel=args.use_kernel,
        separate_fine=args.separate_fine, white_bkgd=not args.no_white_bkgd,
        depth=args.netdepth, width=args.netwidth,
        depth_fine=args.netdepth_fine, width_fine=args.netwidth_fine,
        **occupancy_fields(args),
    )
    params, step = load_params_any(args.ckpt, rc.model_config(),
                                   device=args.device, with_step=True)
    print(f"loaded {args.ckpt} | {W}x{H} focal={args.focal:.2f} "
          f"near={rc.near:.3f} far={rc.far:.3f} "
          f"samples {rc.N_samples}+{rc.N_importance}"
          + (f" | occupancy {rc.occ_grid_size}^3 grid" if rc.use_occupancy
             else "")
          + f" | {args.device}")
    return RenderService(
        params, rc, H, W, args.focal, tile=resolve_tile(args),
        max_pixels=args.max_pixels, max_queue=args.max_queue,
        ckpt_path=args.ckpt, ckpt_step=step, device=args.device,
    )


def build_parser() -> argparse.ArgumentParser:
    from nerfmlp_torch.utils.cli import add_occupancy_flags

    p = argparse.ArgumentParser(
        description="Persistent NeRF render server (PyTorch, one GPU)")
    p.add_argument("--ckpt", "--model_path", type=str, required=True,
                   help=".npy/.pth/.pt checkpoint to serve")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default cuda)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--img_wh", type=int, nargs=2, default=[400, 400],
                   help="default render W H (per-request overridable)")
    p.add_argument("--focal", type=float, required=True,
                   help="default focal length in pixels")
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--no_white_bkgd", action="store_true")
    p.add_argument("--coord_scale", type=float, default=1.0)
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=None,
                   help="default: 64 for .npy official weights, 128 otherwise")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="serving defaults to bfloat16 (the kernel's type)")
    p.add_argument("--fp32_precision", type=str, default="high",
                   choices=["highest", "high"])
    p.add_argument("--no_kernel", "--no_pallas", dest="use_kernel",
                   action="store_false", default=True,
                   help="plain PyTorch module path instead of the fused kernel")
    p.add_argument("--separate_fine", action="store_true")
    add_occupancy_flags(p)
    p.add_argument("--tile", "--chunk", type=int, default=None,
                   help="rays per tile (default: 16384 with "
                        "--use_occupancy, else 4096)")
    p.add_argument("--max_pixels", type=int, default=4096 * 4096,
                   help="reject render requests above this pixel count")
    p.add_argument("--max_queue", type=int, default=8,
                   help="max renders rendering-or-waiting at once; excess "
                        "requests get 503 + Retry-After (0 = unbounded)")
    p.add_argument("--no_warmup", dest="warmup", action="store_false",
                   default=True,
                   help="skip the startup render (the first request pays it)")
    p.add_argument("--netdepth", type=int, default=8)
    p.add_argument("--netwidth", type=int, default=256)
    p.add_argument("--netdepth_fine", type=int, default=0)
    p.add_argument("--netwidth_fine", type=int, default=0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from nerfmlp_torch.serve import serve

    serve(build_service(args), host=args.host, port=args.port,
          warmup=args.warmup)


if __name__ == "__main__":
    main()
