"""Shared CLI plumbing: the architecture and occupancy flags, the tile
default and ``--config FILE`` expansion.

Counterpart of ``nerfmlp_tpu/utils/cli.py:15-35`` (``add_arch_flags``,
``arch_fields``) and ``:58-133`` (``add_occupancy_flags``,
``occupancy_fields``, ``resolve_tile``; the grid that ``build_occ_grid``
makes there, the render service builds itself here), and of the
config-file helpers in ``scripts/train.py:23-92`` (the oracle reads
``key = value`` files through configargparse).
"""

from __future__ import annotations

import sys
from typing import Dict


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


def resolve_tile(args) -> int:
    """The parsed --tile, else rays per tile by sampling mode: 16,384 with
    --use_occupancy (16 + 48 samples, a shallower pipeline per ray), else
    4,096 (the JAX package's measured optima, kept as defaults)."""
    if args.tile is not None:
        return args.tile
    return 16384 if getattr(args, "use_occupancy", False) else 4096


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
