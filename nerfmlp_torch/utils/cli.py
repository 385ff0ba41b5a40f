"""Shared CLI plumbing: the architecture, occupancy, tile, shard and
dataset flags, ``--config FILE`` expansion, and what every
checkpoint-loading script does the same way — load the weights, build the
occupancy grid, pick the dataset, render one frame.

Counterpart of ``nerfmlp_tpu/utils/cli.py`` (``add_arch_flags``,
``arch_fields``, ``add_llff_flags``, ``dataset_kwargs``,
``add_occupancy_flags``, ``occupancy_fields``, ``add_tile_flag``,
``resolve_tile``, ``build_occ_grid``, ``add_shard_flag``,
``render_frame``, ``dataset_class``; ``params_template`` becomes
:func:`load_params`: the port reads a ``.ckpt`` without a template) and of
the config-file helpers in ``scripts/train.py:23-92`` (the oracle reads ``key
= value`` files through configargparse). ``--shard_render`` renders each
frame over every visible card (``parallel/render_parallel.py``).
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np


def add_arch_flags(p) -> None:
    """--netdepth/--netwidth/--netdepth_fine/--netwidth_fine. Defaults =
    the reference 8x256 architecture."""
    p.add_argument("--netdepth", type=int, default=8,
                   help="MLP trunk depth (oracle --netdepth)")
    p.add_argument("--netwidth", type=int, default=256,
                   help="MLP trunk width (oracle --netwidth)")
    p.add_argument("--netdepth_fine", type=int, default=0,
                   help="fine net trunk depth (0 = same as --netdepth)")
    p.add_argument("--netwidth_fine", type=int, default=0,
                   help="fine net trunk width (0 = same as --netwidth)")


def arch_fields(args) -> Dict[str, int]:
    """RenderConfig kwargs for the parsed architecture flags."""
    return {"depth": args.netdepth, "width": args.netwidth,
            "depth_fine": args.netdepth_fine,
            "width_fine": args.netwidth_fine}


def add_occupancy_flags(p) -> None:
    """--use_occupancy/--aabb/--occ_grid_size/--occ_dense_samples/
    --occ_one_shot for scripts that load a checkpoint: the coarse pass is
    replaced by a density grid built from the loaded weights."""
    p.add_argument("--use_occupancy", action="store_true",
                   help="occupancy-grid sampling (requires --aabb): build a "
                        "density grid from the checkpoint and place every "
                        "sample in occupied space")
    p.add_argument("--aabb", type=float, nargs=6, default=None,
                   metavar=("XMIN", "YMIN", "ZMIN", "XMAX", "YMAX", "ZMAX"),
                   help="scene box: tightens per-ray near/far; required "
                        "by --use_occupancy")
    p.add_argument("--occ_grid_size", type=int, default=64)
    p.add_argument("--occ_dense_samples", type=int, default=128)
    p.add_argument("--occ_one_shot", action="store_true",
                   help="draw every depth from the grid prior in one query "
                        "(default: grid-placed probes, then refinement "
                        "samples from their weights)")


def occupancy_fields(args) -> Dict:
    """RenderConfig kwargs for the parsed occupancy flags."""
    return {"use_occupancy": args.use_occupancy,
            "aabb": tuple(args.aabb) if args.aabb else None,
            "occ_grid_size": args.occ_grid_size,
            "occ_dense_samples": args.occ_dense_samples,
            "occ_one_shot": args.occ_one_shot}


def add_tile_flag(p) -> None:
    """--tile/--chunk: rays per tile, by default the sampling mode's
    (:func:`resolve_tile`)."""
    p.add_argument("--tile", "--chunk", type=int, default=None,
                   help="rays per tile (default: 16384 with "
                        "--use_occupancy, else 4096)")


def resolve_tile(args) -> int:
    """The parsed --tile, else rays per tile by sampling mode: 16,384 with
    --use_occupancy (16 + 48 samples, a shallower pipeline per ray), else
    4,096 (the JAX package's measured optima, kept as defaults)."""
    if args.tile is not None:
        return args.tile
    return 16384 if getattr(args, "use_occupancy", False) else 4096


def add_device_flags(p) -> None:
    """--device (default cuda) and --no_kernel (alias --no_pallas)."""
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--no_kernel", "--no_pallas", dest="use_kernel",
                   action="store_false", default=True,
                   help="plain PyTorch module path instead of the fused "
                        "kernels")


def add_dataset_flag(p, choices=("blender", "llff", "deepvoxels")) -> None:
    """--dataset_type, and --shape where DeepVoxels is one of the choices."""
    p.add_argument("--dataset_type", type=str, default="blender",
                   choices=list(choices))
    if "deepvoxels" in choices:
        p.add_argument("--shape", type=str, default="greek",
                       help="deepvoxels scene: armchair / cube / greek / "
                            "vase (oracle --shape)")


def add_llff_flags(p) -> None:
    """--no_ndc/--spherify/--factor/--llffhold/--no_aspect_snap: a script
    that loads a checkpoint builds the LLFF dataset as the checkpoint was
    trained (NDC or metric rays, spherified poses, image directory,
    holdout), or the geometry silently differs."""
    p.add_argument("--no_ndc", action="store_true",
                   help="LLFF: metric rays instead of NDC (match training)")
    p.add_argument("--spherify", action="store_true",
                   help="LLFF: a 360 capture (match training)")
    p.add_argument("--factor", type=int, default=0,
                   help="LLFF: read images_{factor}/, minified from "
                        "images/ when absent (0 = the narrowest images*/ "
                        "directory that covers the width)")
    p.add_argument("--llffhold", type=int, default=8,
                   help="LLFF: every Nth image is val/test (match training)")
    p.add_argument("--no_aspect_snap", action="store_true",
                   help="LLFF: honour a non-native-aspect --img_wh exactly "
                        "instead of snapping the height to the capture's "
                        "aspect (the vertical FOV then differs from the "
                        "resized ground truth)")


def dataset_kwargs(args) -> dict:
    """Loader kwargs for the parsed --dataset_type and its flags (with
    :func:`dataset_class` and :func:`add_llff_flags`)."""
    if args.dataset_type == "llff":
        return {
            "use_ndc": not args.no_ndc,
            "spherify": args.spherify,
            "factor": args.factor,
            "llffhold": args.llffhold,
            "keep_aspect": not getattr(args, "no_aspect_snap", False),
        }
    if args.dataset_type == "deepvoxels":
        return {"shape": args.shape}
    return {}


def add_shard_flag(p) -> None:
    """--shard_render for the scripts that load a checkpoint: each frame
    through :func:`nerfmlp_torch.parallel.render_image_sharded` (the pixel
    grid dealt over every visible card, the weights replicated) instead
    of the local tiled renderer; with one device the local renderer runs,
    with a note."""
    p.add_argument("--shard_render", action="store_true",
                   help="shard each frame's pixel grid over all visible "
                        "cards (the weights replicate, every card renders "
                        "its tiles)")


def shard_devices(dev) -> list:
    """The devices a frame shards over from ``dev``: every visible card
    for ``cuda``, else ``dev`` alone."""
    import torch

    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def dataset_class(dataset_type: str):
    """The loader class for a ``--dataset_type``: llff, deepvoxels, else
    blender."""
    if dataset_type == "llff":
        from nerfmlp_torch.data.llff import LLFFDataset

        return LLFFDataset
    if dataset_type == "deepvoxels":
        from nerfmlp_torch.data.deepvoxels import DeepVoxelsDataset

        return DeepVoxelsDataset
    from nerfmlp_torch.data.blender import BlenderDataset

    return BlenderDataset


def load_params(path: str, rc, device) -> Dict:
    """``{"coarse": ..., ["fine": ...]}`` nets of ``rc``'s architecture (the
    fine one's under ``separate_fine``) on ``device``, from a ``.npy``,
    ``.pth``, ``.pt`` or ``.ckpt`` file
    (``train/checkpoint.py::load_params_any``)."""
    from nerfmlp_torch.train.checkpoint import load_params_any

    return load_params_any(
        path, rc.model_config(), device=device,
        fine_cfg=rc.model_config(fine=True) if rc.separate_fine else None)


def build_occ_grid(args, rc, params, parser):
    """The density grid of a loaded checkpoint, or None without
    --use_occupancy: built from the weights exactly as the render service
    builds its grid (``serve.py::grid_from_weights``, ``GRID_SEED``).
    parser.error when --aabb is missing."""
    if not args.use_occupancy:
        return None
    if rc.aabb is None:
        parser.error("--use_occupancy requires --aabb")
    from nerfmlp_torch.serve import grid_from_weights

    grid = grid_from_weights(params, rc)
    print(f"occupancy grid {rc.occ_grid_size}^3 built from checkpoint")
    return grid


def render_frame(args, params, o, d, H, W, rc, occ_grid=None,
                 viewdirs=None):
    """One (H, W, 3) numpy frame of host rays (H*W, 3), rendered on the
    nets' device in tiles of :func:`resolve_tile` rays, or under
    ``--shard_render`` with more than one visible card over all of them
    (``--tile`` stays the rays per dispatch: each card's tile is ``ceil(tile
    / n)``, at least 256, as in ``nerfmlp_tpu/utils/cli.py:140-175``).
    ``params``: packed by the caller (``ops/render.py::prepare_params``)."""
    import torch

    from nerfmlp_torch.ops.render import render_image
    from nerfmlp_torch.render_path import params_device

    dev = params_device(params)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=dev)

    tile = resolve_tile(args)
    if getattr(args, "shard_render", False):
        devices = shard_devices(dev)
        if len(devices) > 1:
            from nerfmlp_torch.parallel.render_parallel import (
                render_image_sharded,
            )

            return render_image_sharded(
                params, t(o), t(d), H, W, rc, devices,
                tile=max(256, -(-tile // len(devices))), occ_grid=occ_grid,
                viewdirs=t(viewdirs))["rgb_map"].float().cpu().numpy()
        print("--shard_render: one visible device; using the local renderer")
    return render_image(params, t(o), t(d), H, W, rc,
                        tile=tile, occ_grid=occ_grid,
                        viewdirs=t(viewdirs)).float().cpu().numpy()


def bool_flag_names(parser):
    """Names of store_true/store_false options (no-argument actions)."""
    return frozenset(opt.lstrip("-") for a in parser._actions
                     if a.nargs == 0 for opt in a.option_strings)


def negation_flags(parser):
    """dest -> opt-out option for store_false actions (``use_kernel`` ->
    ``--no_kernel``), so config files can turn default-True flags off."""
    return {a.dest: a.option_strings[0] for a in parser._actions
            if a.nargs == 0 and a.const is False and a.option_strings}


def expand_config_files(argv, bool_flags=frozenset(), negations=None):
    """``--config FILE``: FILE holds ``key = value`` lines expanded into
    flags; explicit flags on the command line take precedence. For boolean
    flags "true/yes/1" mean present and "false/no/0" absent (or the
    opt-out flag of a default-True one); other values pass through."""
    negations = negations or {}
    argv = list(sys.argv[1:] if argv is None else argv)
    out = []
    i = 0
    while i < len(argv):
        if argv[i] != "--config":
            out.append(argv[i])
            i += 1
            continue
        if i + 1 >= len(argv):
            raise SystemExit("--config requires a file path argument")
        path = argv[i + 1]
        i += 2
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip()
                flag = [f"--{key}"]
                is_bool = key in bool_flags or key in negations
                if is_bool and val.lower() in ("true", "yes", "1"):
                    pass
                elif is_bool and val.lower() in ("false", "no", "0"):
                    if key in negations:
                        out = [negations[key]] + out
                    continue
                else:
                    flag += val.split()
                out = flag + out
    return out
