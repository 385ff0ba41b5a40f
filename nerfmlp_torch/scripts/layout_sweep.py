"""Time the fused MLP kernels' layouts against each other, on one GPU.

    python -m nerfmlp_torch.scripts.layout_sweep [--nets 8x512h,1x1472h]
        [--kernels fwd,phase1,phase2] [--iters 5] [--chosen] [--out FILE]

For each net (depth x width, ``h`` for hi_lo; the view head on, random
weights from seed 0) and each kernel, every layout the wrapper can build:
for the forward and phase 1, each tile of ``FWD_TRIES`` / ``BWD_TRIES`` at
each of ``STAGE_ROWS`` weight rows a stage with as many stages as fit,
where two fit at least; for phase 2, each (input features a unit, bytes a
stage) of ``P2_TRIES``, then at the chosen one the splits for half and
twice ``BWD_FILL_ITEMS`` items and rings of two and three stages. Each is
timed at the train fine call (131,072 points; CUDA events, median of
``--iters``, a GPU spin ahead of each timed call) and its result held to
the chosen layout's: the forward's output, the backward's flat gradient
(phase 1, phase 2 and the reduction; bit for bit where only phase 1's
layout differs, else the fp32 summation order of phase 2's splits moves
the last bits). The chosen layout's forward is also held to the plain
version (max abs error). One line a layout, the chosen one marked, then
the fastest; ``--chosen`` times the chosen layouts alone; ``--out`` writes
every record as a JSON line as it is measured.
Needs no jax.
"""

import argparse
import contextlib
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
KERNELS = ("fwd", "phase1", "phase2")


def parse_net(spec: str):
    hi_lo = spec.endswith("h")
    depth, width = spec.rstrip("h").split("x")
    return int(depth), int(width), hi_lo


def candidates(mc, hi_lo: bool, kernel: str):
    """Every buildable layout of ``kernel`` ("fwd" or "phase1") for the
    net: the tries' tiles at each stage size of at least 32 rows (16 where
    no larger stage fits), where two stages fit; phase 1's tables in
    device memory only where the tile holds no two stages with them in
    shared memory."""
    out = []
    tries = fm.FWD_TRIES if kernel == "fwd" else fm.BWD_TRIES
    for entry in tries[hi_lo]:
        entry = entry if isinstance(entry, tuple) else (entry,)
        if kernel == "phase1" and not entry[1] and any(
                lay.rows == entry[0] for lay in out):
            continue
        fits = []
        for kr in fm.STAGE_ROWS:
            lay = (fm._fwd_layout_at(mc, True, hi_lo, *entry, kr)
                   if kernel == "fwd"
                   else fm._bwd_layout_at(mc, True, hi_lo, *entry, kr))
            if lay.stages >= 2 and lay.smem <= fm.SMEM_LIMIT:
                fits.append(lay)
        out += [lay for lay in fits if lay.kr >= 32] or fits
    return out


def p2_candidates(mc, hi_lo: bool, chosen_only: bool):
    """Phase 2's layouts: {name: the module attributes to patch}, the
    chosen one first."""
    pick = fm._p2_pick(mc, True, hi_lo)
    out = {f"units of {pick[0]}, stages of {pick[1]} B (chosen)": {}}
    if chosen_only:
        return out
    for k, b in fm.P2_TRIES:
        if (k, b) != pick:
            out[f"units of {k}, stages of {b} B"] = {
                "_p2_pick": lambda *a, t=(k, b): t}
    for fill in (fm.BWD_FILL_ITEMS // 2, fm.BWD_FILL_ITEMS * 2):
        out[f"chosen, splits for {fill} items"] = {"BWD_FILL_ITEMS": fill}
    for stages in (2, 3):
        out[f"chosen, a ring of {stages} stages"] = {"P2_MAX_STAGES": stages}
    return out


def label(lay) -> str:
    where = ("" if not hasattr(lay, "prog_ints")
             or lay.prog_ints > fm.BWD_TABLES_BASE else " tables in memory")
    return (f"{lay.rows}-point tiles, {lay.stages} stages of {lay.kr} "
            f"rows{where}")


def sweep(spec: str, iters: int, kernels, out=None, chosen_only=False):
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

    def record(kernel, name, ms, got, ref, chosen, **extra):
        rec = dict(net=spec, kernel=kernel, layout=name, ms=ms,
                   chosen=chosen, **extra)
        rec["max_abs_diff_to_chosen"] = float((got - ref).abs().max())
        records.append(rec)
        if out is not None:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        print(f"[sweep] {spec} {kernel} {name}"
              f"{' (chosen)' if chosen and kernel != 'phase2' else ''}: "
              f"{ms:.3f} ms, |diff| to the chosen "
              f"{rec['max_abs_diff_to_chosen']:.3g}"
              + (f", kernel vs plain {rec['plain_max_abs_err']:.3g}"
                 if "plain_max_abs_err" in rec else ""), flush=True)

    for kernel in kernels:
        ref = None
        if kernel == "phase2":
            for name, patches in p2_candidates(mc, hi_lo,
                                               chosen_only).items():
                with contextlib.ExitStack() as stack:
                    for attr, value in patches.items():
                        stack.enter_context(mock.patch.object(fm, attr,
                                                              value))
                    packed = fm.pack_params(net, cfg.pos_enc_L, True, hi_lo)
                    rows = fm.ws_rows(n, packed.bwd_rows)
                    splits, split_rows = fm.bwd_splits(rows,
                                                       packed.bwd_units)
                    ws = torch.empty(rows * packed.ws_cols, device="cuda",
                                     dtype=torch.bfloat16)
                    part = torch.empty((splits, fm.part_stride(
                        packed.grad_total)), device="cuda")
                    fm.bwd_workspace(packed, pts, dirs, g, ws)
                    ms = device_ms(lambda: fm.weight_grads(
                        packed, ws, rows, split_rows, part), iters)
                    got = fm._launch_bwd(packed, pts, dirs, g)
                    hdr = fm.bwd_header(packed)
                    del ws, part
                ref = got if ref is None else ref
                record(kernel, name, ms, got, ref, not patches,
                       units=hdr["n_units"], splits=splits,
                       stages=hdr["p2_stages"], slot=hdr["p2_slot"])
                del packed, got
            best = min((r for r in records if r["kernel"] == kernel),
                       key=lambda r: r["ms"])
            print(f"[sweep] {spec} phase2 fastest: {best['layout']}, "
                  f"{best['ms']:.3f} ms", flush=True)
            continue
        chosen = (fm._fwd_layout(mc, True, hi_lo) if kernel == "fwd"
                  else fm._bwd_layout(mc, True, hi_lo))
        target = "_fwd_layout" if kernel == "fwd" else "_bwd_layout"
        lays = [chosen] if chosen_only else candidates(mc, hi_lo, kernel)
        lays.sort(key=lambda lay: lay != chosen)   # the chosen one first
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
            extra = {}
            if ref is None:
                ref = got
                if kernel == "fwd":
                    plain = fm.fused_nerf_mlp_plain(
                        net, pts, dirs.float(), cfg.pos_enc_L,
                        hi_lo=hi_lo)
                    extra["plain_max_abs_err"] = float((got - plain).abs()
                                                       .max())
            record(kernel, label(lay), ms, got, ref, lay == chosen,
                   rows=lay.rows, stages=lay.stages, kr=lay.kr,
                   shared_tables=(None if kernel == "fwd" else
                                  lay.prog_ints > fm.BWD_TABLES_BASE),
                   smem=lay.smem, **extra)
            del packed, got
        best = min((r for r in records if r["kernel"] == kernel),
                   key=lambda r: r["ms"])
        print(f"[sweep] {spec} {kernel} fastest: {best['layout']}, "
              f"{best['ms']:.3f} ms", flush=True)
    del net
    torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nets", default=",".join(NETS))
    ap.add_argument("--kernels", default=",".join(KERNELS))
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
        sweep(spec, args.iters, args.kernels.split(","), out, args.chosen)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
