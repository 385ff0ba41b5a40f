"""Novel views from custom look-at cameras with a focal zoom: four
scenarios of camera distance and focal multiplier, each with near / far
at its distance -/+ 1.5, on one GPU (or, with ``--device cpu``, on the
CPU).

The PyTorch counterpart of the repository's root ``zoom_example.py``, with
its flags, scenarios and ``{scenario}.png`` outputs, and the occupancy
flags. Beside the JAX script: ``--device``, and ``--no_kernel`` as an
alias of ``--no_pallas``.

Example:
    python -m nerfmlp_torch.scripts.zoom_example --datadir data/lego \\
        --ckpt logs/lego/model_final.pt --size 400
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_device_flags, add_occupancy_flags, arch_fields,
    build_occ_grid, load_params, occupancy_fields,
)

SCENARIOS = [
    # (name, camera position, focal multiplier)
    ("normal_distance", (2.0, 2.0, 2.0), 1.0),
    ("telephoto_zoom", (3.0, 3.0, 3.0), 2.5),
    ("extreme_closeup", (1.2, 1.2, 1.2), 1.5),
    ("detail_shot", (0.8, 1.5, 0.8), 3.0),
]


def build_parser():
    p = argparse.ArgumentParser(description="Zoom / custom-camera rendering")
    p.add_argument("--datadir", type=str, required=True,
                   help="dataset dir (for camera_angle_x)")
    p.add_argument("--ckpt", type=str, required=True,
                   help=".pt, .pth, .npy or .ckpt")
    p.add_argument("--out_dir", type=str, default="outputs/zoom_examples")
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=64)
    p.add_argument("--separate_fine", action="store_true",
                   help="checkpoint holds separate coarse/fine nets")
    add_device_flags(p)
    add_arch_flags(p)
    add_occupancy_flags(p)
    return p


def main(argv=None):
    """Returns the PNG paths written, one per scenario."""
    p = build_parser()
    args = p.parse_args(argv)

    import torch

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig
    from nerfmlp_torch.ops.rays import get_rays_np, look_at_matrix
    from nerfmlp_torch.ops.render import prepare_params, render_image
    from nerfmlp_torch.utils.image import save_png

    device = resolve_device(args.device)
    use_true_fp32()
    os.makedirs(args.out_dir, exist_ok=True)
    # Only the focal is needed: camera_angle_x, not the images.
    with open(os.path.join(args.datadir, "transforms_train.json")) as f:
        cam_angle_x = json.load(f)["camera_angle_x"]
    base_focal = 0.5 * args.size / np.tan(0.5 * cam_angle_x)
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        perturb=False, use_kernel=args.use_kernel,
        compute_dtype="bfloat16" if args.use_kernel else "float32",
        separate_fine=args.separate_fine, **occupancy_fields(args),
        **arch_fields(args))
    params = prepare_params(load_params(args.ckpt, rc, device), rc)
    occ_grid = build_occ_grid(args, rc, params, p)

    written = []
    for name, eye, fmul in SCENARIOS:
        eye = np.asarray(eye, dtype=np.float32)
        dist = float(np.linalg.norm(eye))
        near, far = max(0.1, dist - 1.5), dist + 1.5
        # y up, the reference script's look-at convention.
        pose = look_at_matrix(eye, np.zeros(3), up=np.array([0.0, 1.0, 0.0]))
        o, d = get_rays_np(args.size, args.size, base_focal * fmul, pose)
        o, d = (torch.as_tensor(np.ascontiguousarray(a.reshape(-1, 3)),
                                device=device) for a in (o, d))
        img = render_image(params, o, d, args.size, args.size, rc,
                           near=near, far=far,
                           occ_grid=occ_grid).float().cpu().numpy()
        out = os.path.join(args.out_dir, f"{name}.png")
        save_png(out, (np.clip(img, 0, 1) * 255).round().astype(np.uint8))
        written.append(out)
        print(f"{name}: dist {dist:.2f}, focal x{fmul}, near/far "
              f"{near:.2f}/{far:.2f} -> {out}")
    return written


if __name__ == "__main__":
    main()
