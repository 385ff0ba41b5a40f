"""Train a NeRF on one GPU (or, with ``--device cpu``, on the CPU).

The PyTorch counterpart of ``scripts/train.py``, with its flag names for
everything this port supports, plus:

  * ``--device`` (default ``cuda``);
  * ``--make_synthetic_scene``: write the analytic synthetic scene into
    ``--datadir`` first (at ``--img_wh``; 8 train, 2 val and 2 test views),
    so a run needs no dataset.

``--dataset_type`` takes ``blender``, ``llff`` (with ``--factor``,
``--llffhold``, ``--spherify``, ``--no_ndc``, ``--no_aspect_snap``; NDC
rays by default, no white background) and ``deepvoxels`` (``--shape``).
``--img_wh`` defaults to, for Blender, the first training image's stored
size (the JAX CLI's default is 1024x1024), for LLFF with ``--factor`` the
native size of ``images_{factor}/``, else 504x378, and for DeepVoxels
512x512; ``--half_res`` halves a Blender scene's stored size and is
ignored, with a warning, elsewhere. The shipped ``configs/*.txt`` run as
they are, given ``--datadir``. Videos are animated GIFs. Flags of
features not ported yet are refused by name, each naming its ROADMAP
item.

Examples:
    python -m nerfmlp_torch.scripts.train --datadir /tmp/scene \\
        --make_synthetic_scene --img_wh 64 64 --iters 300 --save_dir /tmp/out
    python -m nerfmlp_torch.scripts.train \\
        --config configs/lego_turbo_bf16.txt --datadir data/lego
    python -m nerfmlp_torch.scripts.train \\
        --config configs/fern.txt --datadir data/nerf_llff_data/fern
    python -m nerfmlp_torch.scripts.train --config ... --render_only \\
        [--render_test]     # renders the newest checkpoint, no training
"""

from __future__ import annotations

import argparse
import os

from nerfmlp_torch.utils.cli import (
    add_arch_flags, add_dataset_flag, add_llff_flags, add_occupancy_flags,
    arch_fields, bool_flag_names, dataset_class, dataset_kwargs,
    expand_config_files, negation_flags, occupancy_fields,
)

_DEFAULT_SAVE_DIR = "outputs/checkpoints"

# Flags of the JAX CLI whose features this port does not have yet:
# name -> (argparse kwargs, what is missing). Any non-default value is
# refused.
_NOT_PORTED = {
    "check_numerics": (dict(action="store_true"),
                       "numerics checking (ROADMAP.md, Queue 1 item 21)"),
    "profile_dir": (dict(type=str, default=""),
                    "profiling traces (ROADMAP.md, Queue 1 item 21)"),
    "compilation_cache": (dict(type=str, default=None),
                          "a compilation cache (PyTorch runs eagerly)"),
    "tensorboard": (dict(action="store_true"),
                    "TensorBoard logging (ROADMAP.md, Queue 1 item 21)"),
    "n_devices": (dict(type=int, default=0),
                  "data parallelism (ROADMAP.md, Queue 1 item 18)"),
    "tensor_parallel": (dict(type=int, default=1),
                        "tensor parallelism (ROADMAP.md, Queue 1 item 18)"),
    "remat": (dict(action="store_true"),
              "activation rematerialisation (the fused backward recomputes "
              "the forward already)"),
}


def build_parser():
    p = argparse.ArgumentParser(
        description="Train NeRF with the PyTorch port (one GPU)")
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--make_synthetic_scene", action="store_true",
                   help="write the analytic synthetic Blender scene into "
                        "--datadir first (at --img_wh; 8 train / 2 val / 2 "
                        "test views)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--img_wh", type=int, nargs=2, default=None,
                   help="training resolution (default: Blender, the first "
                        "training image's stored size; LLFF, images_"
                        "{factor}/'s with --factor, else 504x378; "
                        "DeepVoxels, 512x512); other sizes are resized "
                        "with LANCZOS")
    p.add_argument("--half_res", action="store_true",
                   help="train at half the images' stored size (Blender "
                        "only; overrides --img_wh)")
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
    p.add_argument("--quick_val_res", type=int, nargs=2, default=[256, 256])
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
                   help="K > 1: run the steps in windows of up to K with no "
                        "Python between them (on cuda, a captured CUDA "
                        "graph of the step replayed; windows end at every "
                        "log / validation / checkpoint / event / grid "
                        "refresh step)")
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
    add_dataset_flag(p)
    add_llff_flags(p)
    p.add_argument("--precrop_iters", type=int, default=0)
    p.add_argument("--precrop_frac", type=float, default=0.5)
    p.add_argument("--no_batching", action="store_true")
    p.add_argument("--i_print", type=int, default=100,
                   help="console log interval")
    p.add_argument("--i_weights", type=int, default=10000,
                   help="periodic model_{step}.pt interval")
    p.add_argument("--i_img", type=int, default=0,
                   help="held-out frame val_{step}.png every N steps")
    p.add_argument("--i_video", type=int, default=0,
                   help="orbit rgb + disparity videos every N steps (0 = off)")
    p.add_argument("--i_testset", type=int, default=0,
                   help="render the test split with per-frame PSNR every N "
                        "steps (0 = off)")
    p.add_argument("--render_factor", type=int, default=0,
                   help="downscale factor of the render events")
    p.add_argument("--video_frames", type=int, default=0,
                   help="frames of the --i_video trajectory (0 = the "
                        "dataset's: 40 Blender / DeepVoxels, 120 LLFF)")
    p.add_argument("--render_only", action="store_true",
                   help="no training: render the orbit (or, with "
                        "--render_test, the test split) from the loaded "
                        "checkpoint to save_dir/renderonly_*")
    p.add_argument("--render_test", action="store_true",
                   help="with --render_only: the test split's poses, with "
                        "per-frame PSNR")
    p.add_argument("--i_mesh", type=int, default=0,
                   help="write a density-isosurface .ply of the current "
                        "weights every N steps (0 = off; needs --aabb)")
    p.add_argument("--mesh_resolution", type=int, default=128,
                   help="grid nodes per axis for --i_mesh snapshots")
    p.add_argument("--mesh_threshold", type=float, default=25.0,
                   help="sigma iso level for --i_mesh snapshots")
    add_occupancy_flags(p)
    p.add_argument("--occ_update_every", type=int, default=64,
                   help="refresh the density grid every N steps")
    p.add_argument("--occ_warmup_steps", type=int, default=1024,
                   help="refreshes up to this step only add density "
                        "(decay 1; 0.95 after)")
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


def _stored_wh(datadir: str, split: str):
    """[W, H] of a Blender split's first image, from its PNG header."""
    import json

    from nerfmlp_torch.utils.image import png_size

    with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
        name = json.load(f)["frames"][0]["file_path"].split("/")[-1]
    return list(png_size(os.path.join(datadir, split, name + ".png")))


def _default_wh(args):
    """The training resolution when --img_wh is not given, per dataset
    type (the JAX CLI's ``scripts/train.py:347-370``, with Blender's
    stored size in place of its 1024x1024)."""
    if args.dataset_type == "llff" and args.factor:
        from nerfmlp_torch.data.llff import LLFFDataset, _image_files
        from nerfmlp_torch.utils.image import image_size

        img_dir = LLFFDataset._ensure_factor_dir(args.datadir, args.factor)
        wh = list(image_size(os.path.join(img_dir,
                                          _image_files(img_dir)[0])))
        print(f"--factor {args.factor}: native resolution {wh[0]}x{wh[1]}")
        return wh
    if args.dataset_type == "llff":
        return [504, 378]
    if args.dataset_type == "deepvoxels":
        return [512, 512]
    return _stored_wh(args.datadir, args.split)


def _render_only(args, trainer, rc, dataset, test_ds, render_poses,
                 resumed):
    """Render the orbit (or the test split) from the loaded state into
    ``renderonly_{path|test}_{step:06d}/``; no training."""
    from nerfmlp_torch.render_path import render_path, save_path_videos

    if not resumed:
        print("⚠️  --render_only with no checkpoint found in "
              f"{args.save_dir}: rendering from the random init")
    start = int(trainer.history["step"])
    suffix = "test" if args.render_test else "path"
    out_dir = os.path.join(args.save_dir, f"renderonly_{suffix}_{start:06d}")
    kw = dict(render_factor=args.render_factor, occ_grid=trainer.occ_grid,
              save_dir=out_dir, tile=args.chunk)
    if args.render_test:
        rgbs, _, psnrs = render_path(
            trainer.state.params, test_ds.poses,
            (test_ds.H, test_ds.W, test_ds.focal), rc,
            gt_images=test_ds.images, **kw)
    else:
        rgbs, disps, psnrs = render_path(
            trainer.state.params, render_poses,
            (dataset.H, dataset.W, dataset.focal), rc, **kw)
        save_path_videos(os.path.join(out_dir, "video"), rgbs, disps)
    print(f"✅ render_only done: {len(rgbs)} frames -> {out_dir}")
    return {"render_only": out_dir, "psnrs": psnrs}


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    if args.expname and args.save_dir == _DEFAULT_SAVE_DIR:
        args.save_dir = os.path.join(args.basedir, args.expname)
    if args.i_embed == -1:
        args.pos_enc_L = 0
        args.dir_enc_L = 0
    if args.make_synthetic_scene and args.dataset_type != "blender":
        raise SystemExit("--make_synthetic_scene writes a Blender scene; "
                         f"not one for --dataset_type {args.dataset_type}")
    if args.make_synthetic_scene and not os.path.exists(
            os.path.join(args.datadir, "transforms_train.json")):
        from nerfmlp_torch.data.synthetic import make_synthetic_scene

        wh = tuple(args.img_wh or (64, 64))
        make_synthetic_scene(args.datadir, n_train=8, n_val=2, n_test=2,
                             img_wh=wh, seed=args.seed)
        print(f"synthetic scene ({wh[0]}x{wh[1]}) -> {args.datadir}")
    if args.img_wh is None:
        args.img_wh = _default_wh(args)
    if args.half_res and args.dataset_type == "blender":
        # Half the first train frame's stored size (the reference's
        # load_blender half_res), read from its PNG header.
        w, h = _stored_wh(args.datadir, "train")
        args.img_wh = [max(1, w // 2), max(1, h // 2)]
        print(f"--half_res: training at {args.img_wh[0]}x{args.img_wh[1]}")
    elif args.half_res:
        print("⚠️  --half_res is blender-only; use --factor for llff — "
              "ignored")

    from nerfmlp_torch import resolve_device, use_true_fp32
    from nerfmlp_torch.config import RenderConfig, TrainConfig
    from nerfmlp_torch.train.checkpoint import latest_checkpoint
    from nerfmlp_torch.train.loop import Trainer

    device = resolve_device(args.device)
    use_true_fp32()
    DS = dataset_class(args.dataset_type)
    ds_kw = dataset_kwargs(args)
    if args.dataset_type == "llff":
        # Real photos have no alpha to composite: white backgrounds are a
        # Blender (and DeepVoxels) behaviour.
        args.no_white_bkgd = True
    white = not args.no_white_bkgd
    dataset = DS(args.datadir, split=args.split, img_wh=tuple(args.img_wh),
                 white_bkgd=white, **ds_kw)
    # (The LLFF loader takes testskip and ignores it: its holdout is
    # llffhold.)
    val_ds = DS(args.datadir, split="val", img_wh=tuple(args.img_wh),
                white_bkgd=white, testskip=args.testskip, **ds_kw)
    quick_val_ds = DS(args.datadir, split="val",
                      img_wh=tuple(args.quick_val_res), white_bkgd=white,
                      testskip=args.testskip, **ds_kw)
    # The render events' inputs, loaded only when asked for.
    render_poses = None
    if args.i_video or (args.render_only and not args.render_test):
        render_poses = dataset.render_poses(
            **({"n_frames": args.video_frames} if args.video_frames else {}))
    test_ds = None
    if args.i_testset or (args.render_only and args.render_test):
        try:
            test_ds = DS(args.datadir, split="test",
                         img_wh=tuple(args.img_wh), white_bkgd=white,
                         testskip=args.testskip, **ds_kw)
        except OSError as e:
            print(f"⚠️  --i_testset: no test split ({e}); falling back to "
                  "val")
            test_ds = val_ds
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
        ndc=bool(getattr(dataset, "use_ndc", False)),
        separate_fine=args.separate_fine, compute_dtype=args.compute_dtype,
        use_kernel=args.use_kernel, fp32_precision=args.fp32_precision,
        **occupancy_fields(args),
        occ_update_every=args.occ_update_every,
        occ_warmup_steps=args.occ_warmup_steps,
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
        device_pool=args.device_pool, i_video=args.i_video,
        i_testset=args.i_testset, i_img=args.i_img,
        render_factor=args.render_factor, i_mesh=args.i_mesh,
    )
    trainer = Trainer(rc, tc, dataset, val_ds, quick_val_ds,
                      save_dir=args.save_dir, device=device,
                      render_poses=render_poses, test_ds=test_ds)
    resume_path = args.resume
    if resume_path is None and not args.no_resume:
        resume_path = latest_checkpoint(args.save_dir)
        if resume_path:
            print(f"Auto-discovered checkpoint: {resume_path} (use "
                  "--no_resume to start fresh)")
    if resume_path:
        trainer.resume(resume_path)
    if args.render_only:
        return _render_only(args, trainer, rc, dataset, test_ds, render_poses,
                            bool(resume_path))
    metrics = trainer.train()
    print(f"✅ done — final PSNR {metrics.get('final_val', {}).get('psnr')}")
    return metrics


if __name__ == "__main__":
    main()
