"""How chip_smoke.py's training-dependent bars move with phase 2's split
length, on one GPU: the bars they replaced beside the bars that hold.

    python -m nerfmlp_torch.scripts.split_sensitivity [--rows 2048,4096,8192]

Run from the root of a checkout (it drives chip_smoke.py's phases). For each
cap on phase 2's split length (``BWD_MAX_SPLIT_ROWS``; it changes only the
fp32 summation order of the weight gradients): phase 6's turbo training
through the kernels, then phase 10's vertex bars on that model at 256^3 (the
kernel's density volume against its plain version's on the same points: the
signed difference, the grid points on either side of the threshold in one
volume only; the old bar, every kernel vertex within a cell diagonal of the
plain version's mesh, and the new one, ``chip_smoke.vertex_bar``), and phase
11's multi-scene bars: the train CLI's held-out PSNR per scene against
--no_kernel (the old bar, each scene within 2 dB, and the new ones, the
floors and the mean gap), and every scene of the stack against its solo
step (``chip_smoke.stack_gap``). Prints one line a bar and cap, with the
card. Needs no jax.
"""

import argparse
import dataclasses
from unittest import mock

import numpy as np

import chip_smoke as cs
from nerfmlp_torch import use_true_fp32
from nerfmlp_torch.ops import fused_mlp as fm
from nerfmlp_torch.ops import mesh as mesh_mod
from nerfmlp_torch.train.checkpoint import load_params_any


def mesh_bar(path):
    """Phase 10's vertex bar at 256^3 on the turbo weights at ``path``, both
    ways, with the two volumes' signed difference and threshold flips."""
    cfg = dataclasses.replace(cs.turbo_configs(2.0, 6.0)[0], perturb=False)
    params = load_params_any(path, cfg.model_config(), device="cuda")
    probe = mesh_mod.density_volume(params, cfg, resolution=cs.MESH_RES[0])
    lo, hi = float(probe.min()), float(probe.max())
    thr = cs.MESH_ISO if hi > cs.MESH_ISO else 0.5 * (lo + hi)
    g = cs.MESH_RES[1]
    vk = mesh_mod.density_volume(params, cfg, resolution=g)
    with cs.plain_forward():
        vp = mesh_mod.density_volume(params, cfg, resolution=g)
    d = (vk - vp).astype(np.float64)
    mk, _ = mesh_mod.mesh_from_volume(vk, cs.OCC_AABB, thr, device="cuda")
    mp, _ = mesh_mod.mesh_from_volume(vp, cs.OCC_AABB, thr, device="cuda")
    cell = ((np.asarray(cs.OCC_AABB[3:]) - np.asarray(cs.OCC_AABB[:3]))
            / (g - 1))
    diag = float(np.linalg.norm(cell))
    a = cs.nearest(mk, mp, 4 * diag)
    b = cs.nearest(mp, mk, 4 * diag)
    bar = cs.vertex_bar(vk, vp, thr, cs.OCC_AABB, mk, mp, a, b)
    old = "holds" if a.max() <= diag else "fails"
    new = "holds" if bar["ok"] else "fails"
    return (f"threshold {thr:.5f}; kernel - plain volume mean {d.mean():.3e}, "
            f"std {d.std():.3e}; above it in the kernel's volume only "
            f"{int(((vk > thr) & (vp <= thr)).sum())}, in the plain "
            f"version's only {int(((vp > thr) & (vk <= thr)).sum())}; old "
            f"bar {old}: kernel vertices to the plain mesh max {a.max():.3e}, "
            f"{int((a > diag).sum())} beyond a diagonal; plain to kernel max "
            f"{b.max():.3e}, {int((b > diag).sum())} beyond ({diag:.3e}); "
            f"new bar {new}: {cs.vertex_bar_line(bar)}")


def multi_scene_bars(dirs, data, train_psnr, card):
    """Phase 11's bars: the dense CLI runs' old per-scene gap and new
    floors and mean gap, then every scene of the stack against its solo
    step."""
    try:
        runs = cs.ms_cli_dense(dirs, data, train_psnr, card)
        gaps = [k - p for k, p in zip(runs["kernel"]["psnr"],
                                      runs["plain"]["psnr"])]
        old = "holds" if max(abs(x) for x in gaps) <= 2 * cs.PSNR_GAP \
            else "fails"
        line = (f"old per-scene bar (each within {2 * cs.PSNR_GAP} dB) "
                f"{old}, gaps {[round(x, 2) for x in gaps]}; new floors "
                f"and mean gap hold")
    except SystemExit as e:
        line = f"the dense CLI bars failed: {e}"
    try:
        cs.ms_against_solo(data, card)
        return line + "; stack_gap holds"
    except SystemExit as e:
        return line + f"; stack_gap fails: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="2048,4096,8192",
                    help="caps on phase 2's split length to try")
    args = ap.parse_args(argv)
    use_true_fp32()
    card = cs.smi_line()
    train_ds, val_ds = cs.make_scene()
    dirs, data = cs.ms_scenes()
    train_psnr = cs.phase_train(train_ds, val_ds)["val"]["psnr"]
    for rows in [int(r) for r in args.rows.split(",")]:
        with mock.patch.object(fm, "BWD_MAX_SPLIT_ROWS", rows):
            occ = cs.phase_occ_train(train_ds, val_ds)
            print(f"[split_sensitivity] splits of at most {rows} rows: "
                  f"turbo held-out PSNR {occ['val']['psnr']:.2f} dB; phase "
                  f"10's bar at {cs.MESH_RES[1]}^3: "
                  f"{mesh_bar(cs.save_turbo(occ))} | {card}", flush=True)
            print(f"[split_sensitivity] splits of at most {rows} rows: phase "
                  f"11: {multi_scene_bars(dirs, data, train_psnr, card)} | "
                  f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
