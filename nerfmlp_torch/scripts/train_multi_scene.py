"""Multi-scene batched training: N scenes, one NeRF per scene, trained in
lock step on one GPU or several (or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/train_multi_scene.py`` (BASELINE
config 5), with its flags and semantics: per-scene
``dynamic_near_far()`` bounds (printed), the white-background rule for
mixed LLFF + synthetic scenes (with its warning), 9-column batches widened
to 12 when any scene has world viewdirs, one ray loader per scene seeded by
its index, per-scene occupancy grids refreshed every ``--occ_update_every``
steps (decay 1 through ``occ_warmup_steps``, else 0.95), the ``iter ... |
mean loss ... | PSNR s0:... s1:...`` log line and per-scene final
checkpoints. Every fused-MLP call of a step is one launch of each kernel
over all scenes (``parallel/multi_scene.py``). Added: ``--device`` and
``--no_kernel`` (alias ``--no_pallas``), as the train CLI has them, and
``--n_devices``: 0, the default, means every visible card, as the JAX CLI
uses all devices (on the CPU, 1). On N > 1 ranks (one process per card,
or torchrun's) the scenes lie as in JAX (``scripts/train_multi_scene.py:
96-176``): whole scenes per rank when N divides the scene count, one
group of ranks per scene ("scene", "data") when the scene count divides
N, refused otherwise; rank 0 logs, and each scene's checkpoint is written
by the first rank of the ranks that hold it.

Checkpoints are the port's own format, ``torch.save`` files with the
``.pt`` suffix where the JAX CLI writes flax ``.ckpt`` files:
``model_{scene}_final.pt``, the scene's parameters as
``train/checkpoint.py::save_params`` writes them, which
``load_params_any``, the render CLIs and the server read. A scene is
named by its directory's basename (:func:`unique_scene_names`).

Example:
    python -m nerfmlp_torch.scripts.train_multi_scene \\
        --datadirs data/lego data/chair --img_wh 128 128 --iters 20000 \\
        --save_dir outputs/multi
"""

from __future__ import annotations

import argparse
import os

from nerfmlp_torch.utils.cli import add_occupancy_flags, occupancy_fields


def unique_scene_names(names):
    """Disambiguate duplicate scene basenames (e.g. /v1/lego and /v2/lego)
    so no per-scene checkpoint silently clobbers another's. Suffix
    candidates are checked against the ORIGINAL list and all assigned
    names — a rename must not collide with a literal pre-existing name
    either (dirs a_0, a, a once produced two "a_0" entries)."""
    orig = list(names)
    used = set()
    out = []
    for name in orig:
        cand = name
        if orig.count(name) > 1 or cand in used:
            k = 0
            cand = f"{name}_{k}"
            while cand in used or cand in orig:
                k += 1
                cand = f"{name}_{k}"
        used.add(cand)
        out.append(cand)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train one NeRF per scene, in lock step on one device "
                    "or several")
    p.add_argument("--datadirs", type=str, nargs="+", required=True)
    p.add_argument("--img_wh", type=int, nargs=2, default=[128, 128])
    p.add_argument("--batch_size", type=int, default=1024,
                   help="rays per scene per step")
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--save_dir", type=str, default="outputs/multi_scene")
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=128)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--n_devices", type=int, default=0,
                   help="ranks, one per card (0 = every visible card; "
                        "with --device cpu, 1)")
    p.add_argument("--no_kernel", "--no_pallas", dest="use_kernel",
                   action="store_false", default=True,
                   help="plain PyTorch module path instead of the fused "
                        "kernels")
    p.add_argument("--dataset_types", type=str, nargs="+", default=["blender"],
                   choices=["blender", "llff", "deepvoxels"],
                   help="one value for all scenes, or one per --datadir "
                        "(oracle --dataset_type, per scene)")
    p.add_argument("--spherify", action="store_true",
                   help="LLFF scenes: 360 capture (metric rays)")
    p.add_argument("--factor", type=int, default=0,
                   help="LLFF scenes: images_{factor}/ directory")
    p.add_argument("--shape", type=str, default="cube",
                   help="DeepVoxels scenes: object shape")
    add_occupancy_flags(p)
    p.add_argument("--occ_update_every", type=int, default=64,
                   help="training steps between per-scene grid refreshes")
    return p


def _refresh_generators(it: int, scenes, device):
    """Scene s's generator for the refresh before step ``it``, for each s
    of ``scenes``: the JAX CLI's ``fold_in(PRNGKey(17 + it), s)`` as a
    seed."""
    import torch

    gens = []
    for s in scenes:
        g = torch.Generator(device=device)
        g.manual_seed((17 + it) * 1_000_003 + s)
        gens.append(g)
    return gens


def main(argv=None):
    """Train; returns (state, grids) of a run in this process, or, from N
    spawned ranks, rank 0's {"loss", "psnr"} per scene after the last
    step and the checkpoints written."""
    p = build_parser()
    args = p.parse_args(argv)
    from nerfmlp_torch.parallel.mesh import launch, under_torchrun
    from nerfmlp_torch.scripts.train import n_ranks

    n = n_ranks(args)
    if n > 1 or under_torchrun():
        n_scenes = len(args.datadirs)
        if not under_torchrun() and n_scenes % n and n % n_scenes:
            p.error(f"{n_scenes} scenes vs {n} devices: need one to divide "
                    "the other")
        from nerfmlp_torch.scripts import train_multi_scene as this

        return launch(this.train_rank, 0 if under_torchrun() else n,
                      args=(args,), device=args.device)
    return run(args, p)


def train_rank(mesh, args):
    """One rank of a multi-rank run (:func:`run` on ``mesh``)."""
    return run(args, build_parser(), mesh)


def run(args, p, mesh=None):
    """The run ``args`` ask for: every scene in this process, or this
    rank's scenes of ``mesh`` (``parallel/multi_scene.py::scene_layout``).
    """
    import numpy as np
    import torch

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig, TrainConfig
    from nerfmlp_torch.data.pipeline import RayBatchLoader
    from nerfmlp_torch.parallel.mesh import barrier, shard_batch
    from nerfmlp_torch.parallel.multi_scene import (
        create_multi_scene_grids, create_multi_scene_state,
        gather_scene_metrics, make_multi_scene_grid_update,
        make_multi_scene_step, scene_layout, scene_params,
    )
    from nerfmlp_torch.train.checkpoint import save_params
    from nerfmlp_torch.utils.cli import dataset_class

    device = resolve_device(args.device) if mesh is None else mesh.device
    use_true_fp32()
    n_scenes = len(args.datadirs)
    layout = None if mesh is None else scene_layout(n_scenes, mesh)
    local = range(n_scenes) if layout is None else layout.scenes
    data = None if layout is None else layout.data
    types = args.dataset_types
    if len(types) == 1:
        types = types * n_scenes
    if len(types) != n_scenes:
        p.error(f"--dataset_types: got {len(types)} values for "
                f"{n_scenes} scenes (pass 1 or {n_scenes})")

    def load_scene(datadir, dtype):
        kwargs = {}
        if dtype == "llff":
            kwargs = {"spherify": args.spherify, "factor": args.factor}
        elif dtype == "deepvoxels":
            kwargs = {"shape": args.shape}
        return dataset_class(dtype)(
            datadir, "train", img_wh=tuple(args.img_wh), **kwargs
        )

    datasets = [load_scene(d, t) for d, t in zip(args.datadirs, types)]
    loaders = [RayBatchLoader.from_dataset(datasets[i], args.batch_size,
                                           seed=i) for i in local]
    # Per-scene [near, far]: each scene samples its own depth range (NDC
    # LLFF scenes live in [0, 1] while blender scenes sit at 2-6).
    bounds = np.asarray(
        [ds.dynamic_near_far() for ds in datasets], np.float32
    )
    for d, t, (nr, fr) in zip(args.datadirs, types, bounds):
        print(f"  {t:10s} {d}: near/far {nr:.2f}/{fr:.2f}")
    if layout is None:
        print(f"{n_scenes} scenes on 1 device ({device})")
    elif data is None:
        print(f"{n_scenes} scenes on {mesh.world_size} devices: "
              f"{len(local)} a rank ({device.type})")
    else:
        print(f"{n_scenes} scenes on {mesh.world_size} devices: scene x data "
              f"mesh {n_scenes} x {data.world_size} ({device.type})")

    # white_bkgd is structural (one shared RenderConfig): white composite
    # for blender/deepvoxels, off for LLFF real photos. Mixed batches take
    # the LLFF setting — warn, since blender scenes then train without
    # their white background.
    white_bkgd = all(t != "llff" for t in types)
    if not white_bkgd and any(t != "llff" for t in types):
        print("⚠️  mixed llff + synthetic scenes share one white_bkgd "
              "setting: using white_bkgd=False (llff semantics) for ALL "
              "scenes — synthetic scenes will train without their white "
              "background composite")
    if args.use_occupancy and args.aabb is None:
        p.error("--use_occupancy requires --aabb")
    rc = RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        near=float(bounds[:, 0].min()), far=float(bounds[:, 1].max()),
        perturb=True, white_bkgd=white_bkgd,
        compute_dtype=args.compute_dtype, use_kernel=args.use_kernel,
        occ_update_every=args.occ_update_every,
        **occupancy_fields(args),
    )
    tc = TrainConfig(batch_size=args.batch_size, iters=args.iters, lr=args.lr)

    # A scene group's ranks average its gradients (data None: no group).
    step = make_multi_scene_step(rc, tc, with_bounds=True, mesh=data)
    state = create_multi_scene_state(len(local), rc, tc, device=device,
                                     first_scene=local[0])
    bounds_dev = torch.from_numpy(bounds[list(local)]).to(device)

    # Per-scene occupancy grids, stacked, refreshed every
    # --occ_update_every steps from each scene's own current weights.
    grids = grid_update = None
    if rc.use_occupancy:
        grids = create_multi_scene_grids(len(local), rc, device=device)
        grid_update = make_multi_scene_grid_update(rc)
        print(f"occupancy sampling on: {args.occ_grid_size}^3 grids "
              f"per scene, refresh every {rc.occ_update_every} steps")

    # Mixed loaders can emit (B, 9) [o|d|rgb] and (B, 12) [o|d|viewdir|rgb]
    # rows; widen 9-col scenes with viewdirs = normalize(d) (exactly what
    # the step computes for them anyway) so the stack is rectangular.
    widen = any(ld.pool.shape[-1] == 12 for ld in loaders)

    def scene_batch(ld):
        b = ld.next_batch()
        if widen and b.shape[-1] == 9:
            d = b[:, 3:6]
            vd = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
            b = np.concatenate([b[:, :6], vd, b[:, 6:]], axis=-1)
        return b

    main_rank = mesh is None or mesh.is_main
    os.makedirs(args.save_dir, exist_ok=True)
    metrics = None
    for it in range(1, args.iters + 1):
        # (S_rank, B, F) global batches; a scene group's ranks each copy
        # their rows of them.
        batch = shard_batch(np.stack([scene_batch(ld) for ld in loaders]),
                            data, axis=1)
        extra = ()
        if grids is not None:
            if (it - 1) % rc.occ_update_every == 0:
                grids = grid_update(
                    grids, state.params,
                    _refresh_generators(it, local, device),
                    1.0 if it <= rc.occ_warmup_steps else 0.95)
            extra = (grids,)
        metrics = step(state,
                       torch.from_numpy(np.ascontiguousarray(batch)).to(
                           device), *extra, bounds_dev)
        if it % args.log_interval == 0:
            shown = (metrics if layout is None
                     else gather_scene_metrics(metrics, layout, n_scenes))
            losses = shown["loss"].cpu().numpy()
            psnrs = shown["psnr"].cpu().numpy()
            per = " ".join(f"s{i}:{p:.1f}" for i, p in enumerate(psnrs))
            if main_rank:
                print(f"iter {it:6d} | mean loss {losses.mean():.6f} | "
                      f"PSNR {per}", flush=True)

    # Per-scene final checkpoints.
    names = unique_scene_names([
        os.path.basename(os.path.normpath(d)) or f"scene_{i}"
        for i, d in enumerate(args.datadirs)
    ])
    paths = [os.path.join(args.save_dir, f"model_{name}_final.pt")
             for name in names]
    if data is None or data.is_main:   # one writer per scene
        for i, s in enumerate(local):
            save_params(paths[s], scene_params(state, i))
    barrier(mesh)
    print(f"saved {n_scenes} per-scene checkpoints to {args.save_dir}")
    if layout is None:
        return state, grids
    final = ({} if metrics is None else {
        k: v.cpu().numpy() for k, v in gather_scene_metrics(
            metrics, layout, n_scenes).items()})
    return {"loss": final.get("loss"), "psnr": final.get("psnr"),
            "checkpoints": paths}


if __name__ == "__main__":
    main()
