"""Write a procedural test scene (no downloads needed), its ground truth
rendered on one GPU.

The PyTorch counterpart of ``scripts/make_synthetic_scene.py``, with its
flags; ``--device`` takes the place of ``--use_jax``: ``cuda`` (default)
renders the ground truth with torch on the card, ``cpu`` the same torch
path on the CPU, and ``numpy`` the numpy path (the JAX CLI's default),
which writes the same bytes as the JAX CLI without ``--use_jax``. The
torch path agrees with numpy to a level of 8-bit sRGB.

Example (the quality-certification scene):
    python -m nerfmlp_torch.scripts.make_synthetic_scene \\
        --outdir data/hard400 --field hard --img_wh 400 400 \\
        --n_train 48 --n_val 4 --n_test 8 --gt_samples 512
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Make a synthetic NeRF scene")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--img_wh", type=int, nargs=2, default=[128, 128])
    p.add_argument("--n_train", type=int, default=24)
    p.add_argument("--n_val", type=int, default=4)
    p.add_argument("--n_test", type=int, default=4)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--field", type=str, default="default",
                   choices=["default", "hard"],
                   help="analytic radiance field: the smooth default scene"
                        " or the hard high-frequency benchmark field")
    p.add_argument("--aa", type=int, default=1,
                   help="supersample the GT aa x aa per pixel")
    p.add_argument("--gt_samples", type=int, default=192,
                   help="GT ray-march samples (512 for the hard field's "
                        "thin geometry)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the ground truth is rendered: cuda (default),"
                        " cpu (the torch path) or numpy")
    p.add_argument("--format", type=str, default="blender",
                   choices=["blender", "llff"],
                   help="blender: transforms_*.json; llff: poses_bounds.npy"
                        " + images/")
    p.add_argument("--llff_style", type=str, default="360",
                   choices=["360", "forward"],
                   help="llff camera rig: 360 ring (--spherify workload) or"
                        " forward-facing cluster (NDC workload)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from nerfmlp_torch import resolve_device

    # No fallback: the default asks for the card, and raises without one.
    device = None if args.device == "numpy" else resolve_device(args.device)

    if args.format == "llff":
        # LLFF scenes are numpy renders in both packages (the JAX CLI never
        # passes use_jax to its LLFF writer).
        from nerfmlp_torch.data.synthetic import make_synthetic_llff_scene

        make_synthetic_llff_scene(
            args.outdir, n_images=args.n_train, img_wh=tuple(args.img_wh),
            style=args.llff_style, radius=args.radius, seed=args.seed,
        )
        print(f"wrote LLFF ({args.llff_style}) scene to {args.outdir} "
              f"({args.n_train} images @ {args.img_wh[0]}x{args.img_wh[1]})")
        return

    from nerfmlp_torch.data.synthetic import make_synthetic_scene

    make_synthetic_scene(
        args.outdir, n_train=args.n_train, n_val=args.n_val,
        n_test=args.n_test, img_wh=tuple(args.img_wh),
        radius=args.radius, seed=args.seed,
        field=args.field, aa=args.aa, n_samples=args.gt_samples,
        device=device,
    )
    print(f"wrote scene to {args.outdir} "
          f"({args.n_train} train / {args.n_val} val / {args.n_test} test "
          f"@ {args.img_wh[0]}x{args.img_wh[1]})")


if __name__ == "__main__":
    main()
