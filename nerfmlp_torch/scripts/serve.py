"""Serve renders from a resident checkpoint over HTTP, on one GPU or all
of a host's.

The PyTorch counterpart of ``scripts/serve.py``, with the same flag names
for the parts ported plus ``--device``. Checkpoints are ``.npy`` official
weight lists, ``.pth``/``.pt`` reference files, the Trainer's ``.pt`` or
the JAX package's ``.ckpt``. Camera defaults come
from ``--focal``/``--near``/``--far``, or from a dataset (``--datadir``,
``--dataset_type``, ``--split``, ``--shape`` and the LLFF flags of
training, read as the render CLIs read them): its focal at ``--img_wh``
(give an LLFF capture's aspect: the frames keep ``--img_wh``, while the
loader's focal is the snapped size's), Blender's 2 / 6 bounds
or the dataset's own (LLFF: NDC [0, 1] unless metric; DeepVoxels: its
hemisphere), and NDC rays when the LLFF loader has them (``--spherify``
and ``--no_ndc`` turn them off). Without ``--datadir``, ``--focal``,
``--near`` and ``--far`` are required, but for Blender, whose bounds
default to 2 / 6; ``--dataset_type llff`` there means NDC rays unless
``--no_ndc`` / ``--spherify``. LLFF
is never composited on white. A request for an NDC model sends a
``c2w`` in the capture's recentred frame.

A model trained with ``--use_occupancy`` is served with the same flag and
its ``--aabb``: the service builds a density grid from the loaded weights
at start-up (fixed seed) and rebuilds it on every weight swap; ``--tile``
then defaults to 16,384 rays (4,096 otherwise).

``POST /mesh`` extracts a mesh of the served weights, at most
``--max_mesh_resolution`` nodes per axis (0 disables it; the box defaults
to ``--aabb``). ``--watch SECONDS`` polls ``--watch_dir`` — by default the
checkpoint's own directory when watching or when the checkpoint is a
Trainer's ``.pt`` or ``.ckpt`` — and swaps in every newer checkpoint a
Trainer (the port's or the JAX package's) writes there; ``POST /reload``
forces a swap.

Frames are sharded over every visible card by default, as in JAX
(``scripts/serve.py:127-140``): each frame's pixel grid is dealt over
them, the weights replicated once and on every swap; ``--n_devices N``
takes the first N cards, ``--no_shard_render`` serves on ``--device``
alone. One visible card (or ``--device cpu``) serves locally.

Example:
    python -m nerfmlp_torch.scripts.serve --ckpt model.pth --focal 555.5 \\
        --img_wh 400 400 --port 8008
    python -m nerfmlp_torch.scripts.serve --ckpt logs/fern/model_final.pt \\
        --dataset_type llff --datadir data/nerf_llff_data/fern --factor 8 \\
        --img_wh 504 378 --N_importance 64
    curl -s localhost:8008/render -d '{"theta": 30, "phi": -30, "radius": 4}' \\
        -o view.png
    python -m nerfmlp_torch.scripts.serve --ckpt logs/lego/model_final.pt \\
        --use_occupancy --aabb -1.5 -1.5 -1.2 1.5 1.5 1.5 --N_samples 16 \\
        --N_importance 48 --occ_dense_samples 64 --watch 5
    curl -s localhost:8008/mesh -d '{"resolution": 256}' -o lego.ply
"""

from __future__ import annotations

import argparse
import os


def camera_defaults(args, parser=None):
    """(H, W, focal, near, far, ndc) from the flags, or from the dataset
    under --datadir where a flag is not given (``scripts/serve.py:40-75``
    of the JAX CLI)."""
    from nerfmlp_torch.utils.cli import dataset_class, dataset_kwargs

    W, H = args.img_wh
    focal, near, far = args.focal, args.near, args.far
    # NDC must match training: without a dataset, NDC for LLFF unless
    # --no_ndc / --spherify; with one, the loader decides.
    ndc = (args.dataset_type == "llff" and not args.no_ndc
           and not args.spherify)
    if args.datadir is None:
        if args.dataset_type == "blender":     # the Blender scenes' bounds
            near = 2.0 if near is None else near
            far = 6.0 if far is None else far
        if None in (focal, near, far):
            msg = ("--focal/--near/--far must all be given when no "
                   "--datadir supplies camera defaults")
            if parser is not None:
                parser.error(msg)
            raise SystemExit(msg)
        return H, W, focal, near, far, ndc
    ds = dataset_class(args.dataset_type)(
        args.datadir, args.split, img_wh=(W, H), **dataset_kwargs(args))
    if args.dataset_type == "llff":
        ndc = ds.use_ndc
    if focal is None:
        focal = float(ds.focal)
    # Blender keeps its training bounds 2 / 6; LLFF and DeepVoxels take
    # the dataset's, as render_example does.
    d_near, d_far = ((2.0, 6.0) if args.dataset_type == "blender"
                     else ds.dynamic_near_far())
    return (H, W, focal, d_near if near is None else near,
            d_far if far is None else far, ndc)


def build_service(args, parser=None):
    """CLI args -> a ready (unwarmed) RenderService."""
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.serve import RenderService
    from nerfmlp_torch.train.checkpoint import load_params_any
    from nerfmlp_torch.utils.cli import occupancy_fields, resolve_tile

    H, W, focal, near, far, ndc = camera_defaults(args, parser)
    n_importance = args.N_importance
    if n_importance is None:
        n_importance = 64 if args.ckpt.endswith(".npy") else 128
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=n_importance,
        near=float(near), far=float(far), perturb=False, ndc=ndc,
        raw_noise_std=0.0, coord_scale=args.coord_scale,
        compute_dtype=args.compute_dtype,
        fp32_precision=args.fp32_precision, use_kernel=args.use_kernel,
        separate_fine=args.separate_fine,
        # Real LLFF photos are never composited on white.
        white_bkgd=args.dataset_type != "llff" and not args.no_white_bkgd,
        depth=args.netdepth, width=args.netwidth,
        depth_fine=args.netdepth_fine, width_fine=args.netwidth_fine,
        **occupancy_fields(args),
    )
    def reload_fn(path):
        # (params, step) in one decode.
        return load_params_any(path, rc.model_config(), device=args.device,
                               with_step=True)

    params, step = reload_fn(args.ckpt)
    print(f"loaded {args.ckpt} | {W}x{H} focal={focal:.2f} "
          f"near={rc.near:.3f} far={rc.far:.3f} "
          f"samples {rc.N_samples}+{rc.N_importance}"
          + (f" | occupancy {rc.occ_grid_size}^3 grid" if rc.use_occupancy
             else "")
          + (" | NDC rays" if ndc else "") + f" | {args.device}")
    watch_dir = args.watch_dir
    if watch_dir is None and (args.watch > 0 or not args.ckpt.endswith(
            (".npy", ".pth"))):
        # The checkpoint's own directory: the Trainer's --save_dir layout.
        watch_dir = os.path.dirname(os.path.abspath(args.ckpt))
    devices = serve_devices(args, parser)
    if devices:
        print(f"sharded frame rendering over {len(devices)} devices")
    return RenderService(
        params, rc, H, W, focal, tile=resolve_tile(args),
        max_pixels=args.max_pixels, max_queue=args.max_queue,
        max_mesh_resolution=args.max_mesh_resolution, reload_fn=reload_fn,
        watch_dir=watch_dir, ckpt_path=os.path.abspath(args.ckpt),
        ckpt_step=step, device=args.device, devices=devices,
    )


def serve_devices(args, parser=None):
    """The cards a frame shards over: with --shard_render (the default)
    on cuda, the first --n_devices visible ones (0: all), when that is
    more than one; else None (serve on --device)."""
    import torch

    from nerfmlp_torch.utils.cli import shard_devices

    visible = shard_devices(torch.device(args.device))
    n = args.n_devices or len(visible)
    if n > len(visible):
        msg = (f"--n_devices {n}: only {len(visible)} device(s) visible "
               f"for --device {args.device}")
        if parser is not None:
            parser.error(msg)
        raise SystemExit(msg)
    if not args.shard_render or n < 2:
        return None
    return visible[:n]


def build_parser() -> argparse.ArgumentParser:
    from nerfmlp_torch.utils.cli import (
        add_dataset_flag, add_llff_flags, add_occupancy_flags,
    )

    p = argparse.ArgumentParser(
        description="Persistent NeRF render server (PyTorch, one GPU or "
                    "several)")
    p.add_argument("--ckpt", "--model_path", type=str, required=True,
                   help=".npy/.pth/.pt/.ckpt checkpoint to serve")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default cuda)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--img_wh", type=int, nargs=2, default=[400, 400],
                   help="default render W H (per-request overridable)")
    p.add_argument("--focal", type=float, default=None,
                   help="default focal length in pixels; omit to read it "
                        "from --datadir")
    p.add_argument("--near", type=float, default=None,
                   help="default: the dataset's under --datadir (LLFF, "
                        "DeepVoxels), else 2.0 for Blender")
    p.add_argument("--far", type=float, default=None,
                   help="default: the dataset's under --datadir (LLFF, "
                        "DeepVoxels), else 6.0 for Blender")
    p.add_argument("--datadir", type=str, default=None,
                   help="dataset dir supplying the focal, bounds and ray "
                        "space (as the render CLIs read it)")
    add_dataset_flag(p)
    p.add_argument("--split", type=str, default="test")
    add_llff_flags(p)
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
    p.add_argument("--no_shard_render", dest="shard_render",
                   action="store_false", default=True,
                   help="serve frames on --device alone even when several "
                        "cards are visible (default: shard each frame's "
                        "pixel grid over all of them)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="cards for sharded serving (default: all visible)")
    p.add_argument("--tile", "--chunk", type=int, default=None,
                   help="rays per tile (default: 16384 with "
                        "--use_occupancy, else 4096)")
    p.add_argument("--max_pixels", type=int, default=4096 * 4096,
                   help="reject render requests above this pixel count")
    p.add_argument("--max_queue", type=int, default=8,
                   help="max renders rendering-or-waiting at once; excess "
                        "requests get 503 + Retry-After (0 = unbounded)")
    p.add_argument("--max_mesh_resolution", type=int, default=256,
                   help="POST /mesh grid-resolution cap (0 disables the "
                        "mesh route)")
    p.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                   help="poll the watch dir every SECONDS and swap in newer "
                        "checkpoints (0 = off; POST /reload always works)")
    p.add_argument("--watch_dir", type=str, default=None,
                   help="directory to watch (default: the --ckpt's dir)")
    p.add_argument("--no_warmup", dest="warmup", action="store_false",
                   default=True,
                   help="skip the startup render (the first request pays it)")
    p.add_argument("--netdepth", type=int, default=8)
    p.add_argument("--netwidth", type=int, default=256)
    p.add_argument("--netdepth_fine", type=int, default=0)
    p.add_argument("--netwidth_fine", type=int, default=0)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from nerfmlp_torch.serve import serve

    serve(build_service(args, parser), host=args.host, port=args.port,
          warmup=args.warmup, watch_interval=args.watch)


if __name__ == "__main__":
    main()
