"""Extract a triangle mesh from a checkpoint's density field, on one GPU
(or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/extract_mesh.py``, with its flags
plus ``--device`` (default ``cuda``) and ``--no_kernel`` (alias
``--no_pallas``): query sigma on a grid over the box, surface the
``sigma > threshold`` level set by marching tetrahedra
(``ops/mesh.py``) and write ``.ply`` (binary or ascii, with vertex
colours and normals) or ``.obj``. Checkpoints are ``.pt`` files the
Trainer wrote, the JAX package's ``.ckpt``, reference ``.pth`` files or
official ``.npy`` weight lists. On the card the density grid and the colour bake go through the
forward kernel, one launch per chunk.

Example:
    python -m nerfmlp_torch.scripts.extract_mesh \\
        --ckpt logs/lego/model_final.pt --aabb -1.5 -1.5 -1.2 1.5 1.5 1.5 \\
        --resolution 256 --threshold 25 --out lego.ply
"""

from __future__ import annotations

import argparse
import math
import os
import time

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_device_flags, arch_fields, load_params,
)


def build_parser():
    p = argparse.ArgumentParser(
        description="Extract a density-isosurface mesh from a checkpoint")
    p.add_argument("--ckpt", type=str, required=True,
                   help=".pt, .pth, .npy or .ckpt checkpoint")
    p.add_argument("--out", type=str, default="mesh.ply",
                   help="output path; extension picks the format (.ply/.obj)")
    p.add_argument("--aabb", type=float, nargs=6, metavar="F",
                   default=[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
                   help="scene bounds xmin ymin zmin xmax ymax zmax (same "
                        "convention as the occupancy --aabb)")
    p.add_argument("--resolution", type=int, default=256,
                   help="density grid nodes per axis (cells = R-1)")
    p.add_argument("--threshold", type=float, default=25.0,
                   help="sigma iso level; surfaces density > threshold")
    p.add_argument("--no_color", dest="color", action="store_false",
                   default=True,
                   help="skip per-vertex RGB (one extra MLP pass over "
                        "surface vertices)")
    p.add_argument("--gamma", action="store_true",
                   help="encode baked colors to sRGB (the model outputs "
                        "linear radiance)")
    p.add_argument("--ascii", dest="binary", action="store_false",
                   default=True, help="ascii .ply instead of binary")
    p.add_argument("--density_chunk", type=int, default=65536,
                   help="grid points per density query")
    p.add_argument("--cell_chunk", type=int, default=16384,
                   help="surface cells per marching-tets batch")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="MLP eval dtype (bf16 is plenty for geometry)")
    p.add_argument("--fp32_precision", type=str, default="high",
                   choices=["high", "highest"])
    p.add_argument("--separate_fine", action="store_true",
                   help="checkpoint trained with a separate fine net")
    p.add_argument("--no_viewdirs", dest="use_viewdirs",
                   action="store_false", default=True)
    add_device_flags(p)
    add_arch_flags(p)
    return p


def main(argv=None):
    """Returns the mesh dict ``ops/mesh.py::extract_mesh`` gave."""
    p = build_parser()
    args = p.parse_args(argv)

    # Bad geometry fails before the density evaluation, as the JAX CLI and
    # the serve route check it.
    from nerfmlp_torch.ops.mesh import _check_aabb

    if not 2 <= args.resolution <= 1289:
        p.error("--resolution must be in [2, 1289]")
    try:
        _check_aabb(args.aabb)
    except (TypeError, ValueError) as e:
        p.error(str(e))
    if not math.isfinite(args.threshold):
        p.error("--threshold must be finite")

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.ops.mesh import extract_mesh, save_mesh

    device = resolve_device(args.device)
    use_true_fp32()
    # Near/far and the sample counts do not enter a field query; the
    # config carries the architecture, the encodings and the compute type.
    rc = RenderConfig(
        N_samples=64, N_importance=0, near=2.0, far=6.0, perturb=False,
        use_viewdirs=args.use_viewdirs, separate_fine=args.separate_fine,
        use_kernel=args.use_kernel, compute_dtype=args.compute_dtype,
        fp32_precision=args.fp32_precision, aabb=tuple(args.aabb),
        **arch_fields(args),
    )
    params = load_params(args.ckpt, rc, device)

    t0 = time.time()
    mesh = extract_mesh(
        params, rc, resolution=args.resolution, threshold=args.threshold,
        color=args.color, gamma=args.gamma,
        density_chunk=args.density_chunk, cell_chunk=args.cell_chunk,
    )
    dt = time.time() - t0
    n_v, n_f = mesh["verts"].shape[0], mesh["faces"].shape[0]
    print(f"sigma in [{mesh['sigma_min']:.3g}, {mesh['sigma_max']:.3g}] "
          f"at {args.resolution}^3; iso {args.threshold} -> "
          f"{n_v} verts, {n_f} faces in {dt:.1f}s on {device}")
    if n_f == 0:
        print("WARNING: empty mesh — try a threshold inside the sigma "
              "range above, or check --aabb covers the object")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_mesh(args.out, mesh, binary=args.binary)
    print(f"wrote {args.out} ({os.path.getsize(args.out)/1e6:.2f} MB)")
    return mesh


if __name__ == "__main__":
    main()
