"""Train a NeRF on one GPU (or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/train.py``, with its flag names for
everything this port supports, plus:

  * ``--device`` (default ``cuda``);
  * ``--make_synthetic_scene``: write the analytic synthetic scene into
    ``--datadir`` first (at ``--img_wh``; 8 train, 2 val and 2 test views),
    so a run needs no dataset.

Flags of features not ported yet are refused by name, each naming its
ROADMAP item; the Blender loader reads images at their stored size only,
so ``--quick_val_res`` defaults to ``--img_wh`` and any other size is
refused too.

Example:
    python -m nerfmlp_torch.scripts.train --datadir /tmp/scene \\
        --make_synthetic_scene --img_wh 64 64 --iters 300 --save_dir /tmp/out
"""

from __future__ import annotations

import argparse
import os

from nerfmlp_torch.utils.cli import (
    add_arch_flags, arch_fields, bool_flag_names, expand_config_files,
    negation_flags,
)

_DEFAULT_SAVE_DIR = "outputs/checkpoints"

# Flags of the JAX CLI whose features this port does not have yet:
# name -> (argparse kwargs, what is missing). Any non-default value is
# refused.
_EVENTS = "in-training render events (ROADMAP.md, Queue 1 item 14)"
_DATASETS = "the LLFF and DeepVoxels loaders (ROADMAP.md, Queue 1 item 15)"
_NOT_PORTED = {
    "half_res": (dict(action="store_true"),
                 "resizing images (ROADMAP.md, Queue 1 item 20)"),
    "check_numerics": (dict(action="store_true"),
                       "numerics checking (ROADMAP.md, Queue 1 item 21)"),
    "profile_dir": (dict(type=str, default=""),
                    "profiling traces (ROADMAP.md, Queue 1 item 21)"),
    "compilation_cache": (dict(type=str, default=None),
                          "a compilation cache (PyTorch runs eagerly)"),
    "tensorboard": (dict(action="store_true"),
                    "TensorBoard logging (ROADMAP.md, Queue 1 item 21)"),
    "i_img": (dict(type=int, default=0), _EVENTS),
    "i_video": (dict(type=int, default=0), _EVENTS),
    "i_testset": (dict(type=int, default=0), _EVENTS),
    "render_factor": (dict(type=int, default=0), _EVENTS),
    "video_frames": (dict(type=int, default=0), _EVENTS),
    "render_only": (dict(action="store_true"), _EVENTS),
    "render_test": (dict(action="store_true"), _EVENTS),
    "i_mesh": (dict(type=int, default=0),
               "mesh extraction (ROADMAP.md, Queue 1 item 17)"),
    "n_devices": (dict(type=int, default=0),
                  "data parallelism (ROADMAP.md, Queue 1 item 18)"),
    "tensor_parallel": (dict(type=int, default=1),
                        "tensor parallelism (ROADMAP.md, Queue 1 item 18)"),
    "shape": (dict(type=str, default="greek"), _DATASETS),
    "spherify": (dict(action="store_true"), _DATASETS),
    "factor": (dict(type=int, default=0), _DATASETS),
    "llffhold": (dict(type=int, default=8), _DATASETS),
    "no_ndc": (dict(action="store_true"), _DATASETS),
    "no_aspect_snap": (dict(action="store_true"), _DATASETS),
    "remat": (dict(action="store_true"),
              "activation rematerialisation (the fused backward recomputes "
              "the forward already)"),
    "use_occupancy": (dict(action="store_true"),
                      "occupancy-grid sampling (ROADMAP.md, Queue 1 item 12)"),
    "occ_one_shot": (dict(action="store_true"),
                     "occupancy-grid sampling (ROADMAP.md, Queue 1 item 12)"),
}


def build_parser():
    p = argparse.ArgumentParser(
        description="Train NeRF with the PyTorch port (one GPU)")
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--make_synthetic_scene", action="store_true",
                   help="write the analytic synthetic scene into --datadir "
                        "first (at --img_wh; 8 train / 2 val / 2 test views)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--img_wh", type=int, nargs=2, default=None,
                   help="training resolution; must be the images' stored "
                        "size (default: the first training image's)")
    p.add_argument("--batch_size", "--N_rand", type=int, default=1024,
                   help="rays per step (oracle --N_rand)")
    p.add_argument("--iters", type=int, default=200000)
    p.add_argument("--lr", "--lrate", type=float, default=5e-4)
    p.add_argument("--lrate_decay", type=int, default=250,
                   help="exponential lr decay horizon in 1000s of steps")
    p.add_argument("--save_dir", type=str, default=_DEFAULT_SAVE_DIR)
    p.add_argument("--basedir", type=str, default="./logs")
    p.add_argument("--expname", type=str, default=None,
                   help="experiment name; sets save_dir=<basedir>/<expname>")
    p.add_argument("--quick_val_interval", type=int, default=1000)
    p.add_argument("--full_val_interval", type=int, default=10000)
    p.add_argument("--quick_val_res", type=int, nargs=2, default=None,
                   help="quick-validation resolution (default and only "
                        "value: the stored image size)")
    p.add_argument("--quick_val_subset", type=int, default=10)
    p.add_argument("--resume", "--ft_path", type=str, default=None,
                   help="checkpoint to resume from; by default the newest "
                        "checkpoint in --save_dir is auto-discovered")
    p.add_argument("--no_resume", "--no_reload", action="store_true",
                   help="start fresh even if --save_dir has checkpoints")
    add_arch_flags(p)
    p.add_argument("--N_samples", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=128)
    p.add_argument("--near", type=float, default=None,
                   help="override dynamic near")
    p.add_argument("--far", type=float, default=None,
                   help="override dynamic far")
    p.add_argument("--lindisp", action="store_true")
    p.add_argument("--perturb", type=float, default=1.0,
                   help="0 = deterministic (mid-bin) depth sampling")
    p.add_argument("--no_white_bkgd", action="store_true")
    p.add_argument("--white_bkgd", action="store_true",
                   help="accepted for oracle config compatibility")
    p.add_argument("--raw_noise_std", type=float, default=0.0)
    p.add_argument("--separate_fine", action="store_true")
    p.add_argument("--coarse_loss", action="store_true")
    p.add_argument("--i_embed", type=int, default=0,
                   help="0 = positional encoding, -1 = identity")
    p.add_argument("--pos_enc_L", "--multires", type=int, default=10)
    p.add_argument("--dir_enc_L", "--multires_views", type=int, default=4)
    p.add_argument("--no_viewdirs", dest="use_viewdirs", action="store_false",
                   default=True)
    p.add_argument("--use_viewdirs", dest="use_viewdirs", action="store_true",
                   default=argparse.SUPPRESS)
    p.add_argument("--testskip", type=int, default=1)
    p.add_argument("--chunk", type=int, default=4096,
                   help="ray tile for validation renders")
    p.add_argument("--netchunk", type=int, default=0,
                   help="accepted for oracle config compatibility")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="only 1: PyTorch runs eagerly (CUDA graphs are "
                        "ROADMAP.md, Queue 1 item 19)")
    p.add_argument("--device_pool", action="store_true", default=True,
                   help="keep the ray pool on the device (default)")
    p.add_argument("--no_device_pool", dest="device_pool",
                   action="store_false",
                   help="copy every batch from the host instead")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fp32_precision", type=str, default="highest",
                   choices=["highest", "high"])
    p.add_argument("--use_kernel", "--use_pallas", dest="use_kernel",
                   action="store_true", default=True,
                   help="fused MLP CUDA kernels (default)")
    p.add_argument("--no_kernel", "--no_pallas", dest="use_kernel",
                   action="store_false",
                   help="plain PyTorch module path instead of the kernels")
    p.add_argument("--seed", "--random_seed", type=int, default=0)
    p.add_argument("--dataset_type", type=str, default="blender",
                   choices=["blender", "llff", "deepvoxels"])
    p.add_argument("--precrop_iters", type=int, default=0)
    p.add_argument("--precrop_frac", type=float, default=0.5)
    p.add_argument("--no_batching", action="store_true")
    p.add_argument("--i_print", type=int, default=100,
                   help="console log interval")
    p.add_argument("--i_weights", type=int, default=10000,
                   help="periodic model_{step}.pt interval")
    p.add_argument("--mesh_resolution", type=int, default=128)
    p.add_argument("--mesh_threshold", type=float, default=25.0)
    p.add_argument("--aabb", type=float, nargs=6, default=None,
                   metavar=("XMIN", "YMIN", "ZMIN", "XMAX", "YMAX", "ZMAX"),
                   help="scene box: tighten per-ray near/far")
    p.add_argument("--occ_grid_size", type=int, default=64)
    p.add_argument("--occ_update_every", type=int, default=64)
    p.add_argument("--occ_warmup_steps", type=int, default=1024)
    p.add_argument("--occ_dense_samples", type=int, default=128)
    for name, (kw, what) in _NOT_PORTED.items():
        p.add_argument(f"--{name}", help=f"not ported: {what}", **kw)
    return p


def parse_args(argv=None):
    p = build_parser()
    return p.parse_args(
        expand_config_files(argv, bool_flag_names(p), negation_flags(p)))


def refuse_unported(args) -> None:
    """SystemExit naming the first flag whose feature is not ported."""
    p = build_parser()
    for name, (_, what) in _NOT_PORTED.items():
        if getattr(args, name) != p.get_default(name):
            raise SystemExit(f"--{name}: {what} is not ported to PyTorch "
                             "yet")
    if args.dataset_type != "blender":
        raise SystemExit(f"--dataset_type {args.dataset_type}: {_DATASETS} "
                         "are not ported to PyTorch yet")


def _stored_wh(datadir: str, split: str):
    """(W, H) of the split's first image, from its PNG header."""
    import json
    import struct

    with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
        name = json.load(f)["frames"][0]["file_path"].split("/")[-1]
    with open(os.path.join(datadir, split, name + ".png"), "rb") as f:
        head = f.read(24)
    return list(struct.unpack(">II", head[16:24]))


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    if args.expname and args.save_dir == _DEFAULT_SAVE_DIR:
        args.save_dir = os.path.join(args.basedir, args.expname)
    if args.i_embed == -1:
        args.pos_enc_L = 0
        args.dir_enc_L = 0
    if args.make_synthetic_scene and not os.path.exists(
            os.path.join(args.datadir, "transforms_train.json")):
        from nerfmlp_torch.data.synthetic import make_synthetic_scene

        wh = tuple(args.img_wh or (64, 64))
        make_synthetic_scene(args.datadir, n_train=8, n_val=2, n_test=2,
                             img_wh=wh, seed=args.seed)
        print(f"synthetic scene ({wh[0]}x{wh[1]}) -> {args.datadir}")
    if args.img_wh is None:
        args.img_wh = _stored_wh(args.datadir, args.split)
    if args.quick_val_res is None:
        args.quick_val_res = list(args.img_wh)

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig, TrainConfig
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.train.checkpoint import latest_checkpoint
    from nerfmlp_torch.train.loop import Trainer

    device = resolve_device(args.device)
    use_true_fp32()
    white = not args.no_white_bkgd
    dataset = BlenderDataset(args.datadir, split=args.split,
                             img_wh=tuple(args.img_wh), white_bkgd=white)
    val_ds = BlenderDataset(args.datadir, split="val",
                            img_wh=tuple(args.img_wh), white_bkgd=white,
                            testskip=args.testskip)
    quick_val_ds = (val_ds if list(args.quick_val_res) == list(args.img_wh)
                    else BlenderDataset(args.datadir, split="val",
                                        img_wh=tuple(args.quick_val_res),
                                        white_bkgd=white,
                                        testskip=args.testskip))
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "args.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k} = {v}\n")

    near, far = dataset.dynamic_near_far()
    near = near if args.near is None else args.near
    far = far if args.far is None else args.far
    print(f"Dynamic near: {near}, far: {far}")
    if args.separate_fine and not args.coarse_loss:
        print("⚠️  --separate_fine requires the coarse loss term; enabling "
              "--coarse_loss")
        args.coarse_loss = True

    rc = RenderConfig(
        pos_enc_L=args.pos_enc_L, dir_enc_L=args.dir_enc_L,
        use_viewdirs=args.use_viewdirs, **arch_fields(args),
        N_samples=args.N_samples, N_importance=args.N_importance,
        near=near, far=far, white_bkgd=white, perturb=args.perturb > 0,
        raw_noise_std=args.raw_noise_std, lindisp=args.lindisp,
        separate_fine=args.separate_fine, compute_dtype=args.compute_dtype,
        use_kernel=args.use_kernel, fp32_precision=args.fp32_precision,
        aabb=tuple(args.aabb) if args.aabb else None,
        occ_grid_size=args.occ_grid_size,
        occ_update_every=args.occ_update_every,
        occ_warmup_steps=args.occ_warmup_steps,
        occ_dense_samples=args.occ_dense_samples,
    )
    tc = TrainConfig(
        batch_size=args.batch_size, iters=args.iters, lr=args.lr,
        lr_decay_steps=args.lrate_decay * 1000,
        coarse_loss=args.coarse_loss, seed=args.seed,
        quick_val_interval=args.quick_val_interval,
        full_val_interval=args.full_val_interval,
        quick_val_subset=args.quick_val_subset,
        log_interval=args.i_print, ckpt_interval=args.i_weights,
        precrop_iters=args.precrop_iters, precrop_frac=args.precrop_frac,
        no_batching=args.no_batching, mesh_resolution=args.mesh_resolution,
        mesh_threshold=args.mesh_threshold, chunk=args.chunk,
        steps_per_dispatch=args.steps_per_dispatch,
        device_pool=args.device_pool,
    )
    trainer = Trainer(rc, tc, dataset, val_ds, quick_val_ds,
                      save_dir=args.save_dir, device=device)
    resume_path = args.resume
    if resume_path is None and not args.no_resume:
        resume_path = latest_checkpoint(args.save_dir)
        if resume_path:
            print(f"Auto-discovered checkpoint: {resume_path} (use "
                  "--no_resume to start fresh)")
    if resume_path:
        trainer.resume(resume_path)
    metrics = trainer.train()
    print(f"✅ done — final PSNR {metrics.get('final_val', {}).get('psnr')}")
    return metrics


if __name__ == "__main__":
    main()
