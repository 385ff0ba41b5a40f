"""Time the forward's and phase 1's layouts against each other, on one GPU.

    python -m nerfmlp_torch.scripts.layout_sweep [--nets 8x512h,1x1472h]
        [--iters 5] [--chosen] [--out FILE]

For each net (depth x width, ``h`` for hi_lo; the view head on, random
weights from seed 0) and each kernel (the forward, phase 1), every layout
the wrapper can build: each tile of ``FWD_TRIES`` / ``BWD_TRIES`` alone
and, below 64 points, in clusters of 64 / T CTAs that share each weight
stage by multicast, at each of ``STAGE_ROWS`` weight rows a stage with as
many stages as fit, where two fit at least. Each is timed
at the train fine call (131,072 points; CUDA events, median of
``--iters``, a GPU spin ahead of each timed call) and its result held to
the chosen layout's: the forward's output, the backward's flat gradient
(phase 1 then phases 2 and the reduction). The chosen layout's forward is
also held to the plain version (max abs error). One line a layout, the
chosen one marked, then the fastest; ``--chosen`` times the chosen
layouts alone; ``--out`` writes every record as a JSON line as it is
measured.
Needs no jax.
"""

import argparse
import dataclasses
import json
import subprocess
import warnings
from unittest import mock

import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp as fm
from nerfmlp_torch.scripts.bwd_ablate import call_inputs, device_ms

# The nets of chip_smoke.py's phases 4 and 16-18 whose layouts were in
# question, the flagship's first.
NETS = ("8x256", "8x256h", "8x288", "8x512", "8x640", "8x384h", "8x512h",
        "8x576h", "36x320", "509x64", "866x16", "600x16h", "1x1696",
        "2x1312", "5x864", "2x1024", "1x1472h", "3x960h", "5x752h")


def parse_net(spec: str):
    hi_lo = spec.endswith("h")
    depth, width = spec.rstrip("h").split("x")
    return int(depth), int(width), hi_lo


def candidates(mc, hi_lo: bool, kernel: str):
    """Every buildable layout of ``kernel`` ("fwd" or "phase1") for the
    net: the tries' tiles alone and in multicast clusters, at each stage size
    of at least 32 rows (16 where no larger stage fits), where two stages
    fit; phase 1's tables in device memory only where the tile holds no
    two stages with them in shared memory."""
    out = []
    tries = fm.FWD_TRIES if kernel == "fwd" else fm.BWD_TRIES
    for entry in tries[hi_lo]:
        for cluster in sorted({entry[1], 1, max(1, 64 // entry[0])}):
            rest = (entry[0], cluster, *entry[2:])
            if kernel == "phase1" and not entry[2] and any(
                    (l.rows, l.cluster) == rest[:2] for l in out):
                continue
            fits = []
            for kr in fm.STAGE_ROWS:
                lay = (fm._fwd_layout_at(mc, True, hi_lo, *rest, kr)
                       if kernel == "fwd"
                       else fm._bwd_layout_at(mc, True, hi_lo, *rest, kr))
                if lay.stages >= 2 and lay.smem <= fm.SMEM_LIMIT:
                    fits.append(lay)
            out += [l for l in fits if l.kr >= 32] or fits
    return out


def label(lay) -> str:
    where = ("" if not hasattr(lay, "prog_ints")
             or lay.prog_ints > fm.BWD_TABLES_BASE else " tables in memory")
    return (f"{lay.rows}-point tiles x {lay.cluster}, {lay.stages} stages "
            f"of {lay.kr} rows{where}")


def sweep(spec: str, iters: int, out=None, chosen_only: bool = False):
    depth, width, hi_lo = parse_net(spec)
    cfg = dataclasses.replace(RenderConfig(compute_dtype="bfloat16",
                                           use_kernel=True),
                              depth=depth, width=width)
    mc = cfg.model_config()
    net = init_model(mc, seed=0, device="cuda")
    n = 1024 * 128
    pts, dirs, g = call_inputs(n, cfg)
    dirs = dirs.to(torch.float32 if hi_lo else torch.bfloat16)
    records = []
    for kernel in ("fwd", "phase1"):
        chosen = (fm._fwd_layout(mc, True, hi_lo) if kernel == "fwd"
                  else fm._bwd_layout(mc, True, hi_lo))
        target = "_fwd_layout" if kernel == "fwd" else "_bwd_layout"
        lays = [chosen] if chosen_only else candidates(mc, hi_lo, kernel)
        lays.sort(key=lambda lay: lay != chosen)   # the chosen one first
        ref = None
        for lay in lays:
            with mock.patch.object(fm, target, lambda *a, lay=lay: lay):
                packed = fm.pack_params(net, cfg.pos_enc_L, True, hi_lo)
                with torch.no_grad():
                    if kernel == "fwd":
                        got = fm._launch(packed, pts, dirs)
                        ms = device_ms(lambda: fm._launch(packed, pts, dirs),
                                       iters)
                    else:
                        got = fm._launch_bwd(packed, pts, dirs, g)
                        ws = torch.empty(fm.ws_rows(n, packed.bwd_rows)
                                         * packed.ws_cols, device="cuda",
                                         dtype=torch.bfloat16)
                        ms = device_ms(lambda: fm.bwd_workspace(
                            packed, pts, dirs, g, ws), iters)
                        del ws
            rec = dict(net=spec, kernel=kernel, rows=lay.rows,
                       cluster=lay.cluster, stages=lay.stages, kr=lay.kr,
                       shared_tables=(None if kernel == "fwd" else
                                      lay.prog_ints > fm.BWD_TABLES_BASE),
                       smem=lay.smem, ms=ms, chosen=lay == chosen)
            if ref is None:
                ref = got
                if kernel == "fwd":
                    plain = fm.fused_nerf_mlp_plain(
                        net, pts, dirs.float(), cfg.pos_enc_L,
                        hi_lo=hi_lo)
                    rec["plain_max_abs_err"] = float((got - plain).abs()
                                                     .max())
            rec["max_abs_diff_to_chosen"] = float((got - ref).abs().max())
            records.append(rec)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            print(f"[sweep] {spec} {kernel} {label(lay)}"
                  f"{' (chosen)' if rec['chosen'] else ''}: {ms:.3f} ms, "
                  f"|diff| to the chosen {rec['max_abs_diff_to_chosen']:.3g}"
                  + (f", kernel vs plain {rec['plain_max_abs_err']:.3g}"
                     if "plain_max_abs_err" in rec else ""), flush=True)
            del packed, got
        best = min((r for r in records if r["kernel"] == kernel),
                   key=lambda r: r["ms"])
        print(f"[sweep] {spec} {kernel} fastest: {best['rows']} x "
              f"{best['cluster']}, {best['stages']} stages of {best['kr']} "
              f"rows, {best['ms']:.3f} ms", flush=True)
    del net
    torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nets", default=",".join(NETS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--chosen", action="store_true",
                    help="time only the layouts the wrapper chooses")
    ap.add_argument("--out", metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_sweep: needs a CUDA device")
    warnings.filterwarnings("ignore", message="netdepth=5")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[sweep] {card}", flush=True)
    out = open(args.out, "w") if args.out else None
    for spec in args.nets.split(","):
        sweep(spec, args.iters, out, args.chosen)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
