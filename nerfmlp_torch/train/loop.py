"""The training loop: logging, quick/full validation, layered checkpoints,
resume and the metrics JSON.

Counterpart of ``nerfmlp_tpu/train/loop.py:61-1123`` (``Trainer``), its
main path on one device: the train state, the host loader and the device
ray pool; ``train()`` with the log interval and precrop; quick and full
validation on whole held-out images (PSNR, SSIM); best, final, periodic
and latest checkpoints; auto-resume; the metrics JSON in the reference
schema; occupancy-grid sampling, with the grid refreshed on the JAX
Trainer's schedule and rebuilt on resume; the in-training render events
(``i_video``: orbit videos, ``i_testset``: test-set sweeps with per-frame
PSNR, ``i_img``: held-out frames, ``render_factor``; ``i_mesh``:
density-isosurface ``.ply`` snapshots); ``steps_per_dispatch``
K > 1: windows of up to K steps with no Python between them, a captured
CUDA graph of the step replayed (``train/graph.py``), the windows ending
at every step where the host has work, as the JAX Trainer's scan windows
do (:func:`dispatch_window`). At K = 1, the default, the loop calls
``step_fn`` once a step on the pool's batch or the host batch copied
straight in: a window of one step gains nothing from a graph, and the
static batch buffer and slot counter a window reads would only add a
copy and an index to every step. Left out, and refused when asked for:
TensorBoard, ``profile_dir`` and tensor parallelism (each raises a
``NotImplementedError`` naming its ROADMAP item).

The hot loop never waits for the card: loss and PSNR stay device tensors,
summed on the device, and are read back at log and validation steps
only.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from nerfmlp_torch import resolve_device, use_true_fp32
from nerfmlp_torch.config import TRAIN_NOT_PORTED, RenderConfig, TrainConfig
from nerfmlp_torch.data import image_viewdirs
from nerfmlp_torch.data.device_pool import DeviceRayPool
from nerfmlp_torch.data.pipeline import RayBatchLoader
from nerfmlp_torch.parallel.train_step import (
    create_train_state, lr_at, make_step_body, make_step_fn,
)
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train.graph import StepWindows
from nerfmlp_torch.train.metrics import (
    calculate_etc, format_time_duration, get_memory_usage_gb, psnr_images,
    ssim,
)


def dispatch_window(
    step: int, iters: int, max_w: int, intervals, stop_steps=()
) -> int:
    """Size of the dispatch window starting at ``step`` (1-based, inclusive).

    The window [step, step+w-1] may contain a host-action step ONLY at its
    last position, so every ``step % interval == 0`` event block fires on
    exactly the same steps as single-step dispatch. ``intervals``: active
    periods whose multiples need host work (logging, validation,
    checkpoints, render events, occupancy refresh). ``stop_steps``: one-off
    boundaries (the precrop transition). Zero/None entries are ignored.
    (The JAX package's ``nerfmlp_tpu/train/loop.py:38-58``, copied.)
    """
    w = min(max_w, iters - step + 1)
    for ivl in intervals:
        if ivl:
            nxt = ((step + ivl - 1) // ivl) * ivl  # next multiple >= step
            w = min(w, nxt - step + 1)
    for s in stop_steps:
        if s and step <= s:
            w = min(w, s - step + 1)
    return max(w, 1)


def check_supported(tc: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for every requested feature this port
    does not have yet, naming its ROADMAP item — none is ignored."""
    defaults = TrainConfig()
    for name, what in TRAIN_NOT_PORTED.items():
        if getattr(tc, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"TrainConfig.{name}={getattr(tc, name)!r}: {what} is not "
                "ported to PyTorch yet")


class Trainer:
    """End-to-end trainer for one scene on one device.

    ``train_ds``/``val_ds``/``quick_val_ds`` are Blender, LLFF or
    DeepVoxels datasets (``all_rays_*``, ``image_rays``, ``n_images``,
    ``H``/``W``; an NDC dataset's batches carry its world-space viewdirs,
    and so do its held-out renders, through ``image_viewdirs``).
    ``render_poses``: the c2w trajectory of the ``i_video`` event (the
    CLI passes the dataset's own: an orbit, or an LLFF spiral rendered
    through ``rc.ndc``);
    ``test_ds``: the held-out split of the ``i_testset`` event.
    ``device``: default ``cuda``; ``"cpu"`` runs the plain versions of the
    kernels. Starting a Trainer keeps TF32 off process-wide
    (:func:`nerfmlp_torch.use_true_fp32`). With ``steps_per_dispatch`` K >
    1 the steps run in windows (``self.windows``): on ``cuda`` a CUDA
    graph of one step, captured at the first window of each batch source
    and replayed; on the CPU the same step body, eagerly."""

    # iteration_times cap: past it the oldest half is folded into the
    # dropped counters, so the JSON stays bounded.
    _ITER_TIMES_CAP = 20_000
    # The grid refreshes' jitter: a generator seeded from this and the step.
    _OCC_SEED = 17

    def __init__(self, rc: RenderConfig, tc: TrainConfig, train_ds,
                 val_ds=None, quick_val_ds=None,
                 save_dir: str = "outputs/checkpoints", verbose: bool = True,
                 device=None, render_poses=None, test_ds=None):
        check_supported(tc)
        if rc.use_occupancy and rc.aabb is None:
            raise ValueError("use_occupancy requires RenderConfig.aabb")
        self.device = resolve_device(device)
        use_true_fp32()
        self.rc = rc
        self.tc = tc
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.quick_val_ds = quick_val_ds if quick_val_ds is not None else val_ds
        self.save_dir = save_dir
        self.verbose = verbose
        self.render_poses = render_poses
        self.test_ds = test_ds
        self._mesh_warned = False
        os.makedirs(save_dir, exist_ok=True)

        self.state = create_train_state(rc, tc, self.device)
        self.step_fn = make_step_fn(rc, tc)
        # Occupancy-grid sampling state (ops/occupancy.py): derived from the
        # nets, refreshed in train() and rebuilt on resume (in place: a
        # captured step reads its density), not saved.
        self.occ_grid = None
        if rc.use_occupancy:
            from nerfmlp_torch.ops.occupancy import create_grid

            self.occ_grid = create_grid(rc.occ_grid_size, device=self.device)
        # The running [loss, psnr] sums between validations, on the device.
        self._sums = torch.zeros(2, device=self.device)
        self.loader = RayBatchLoader.from_dataset(
            train_ds, tc.batch_size, seed=tc.seed, image_mode=tc.no_batching)
        # The device pool: no host->device copy per step. The host loader
        # still covers precrop (per-image central crops), --no_batching
        # and pools smaller than one batch.
        self.pool = None
        if tc.device_pool:
            if tc.no_batching:
                self._log("(device_pool ignored: --no_batching samples "
                          "per-image on host)")
            elif len(self.loader) < tc.batch_size:
                self._log("(device_pool ignored: ray pool smaller than one "
                          "batch — host with-replacement sampling)")
            else:
                self.pool = DeviceRayPool(self.loader.pool, tc.batch_size,
                                          seed=tc.seed, device=self.device)
        self.windows = None
        if tc.steps_per_dispatch > 1:
            self.windows = StepWindows(self.state, make_step_body(rc, tc),
                                       tc.steps_per_dispatch, self._sums,
                                       pool=self.pool, occ_grid=self.occ_grid)

        # Metric histories (the reference schema, its train.py:457-467).
        self.history: Dict = {
            "step": 0,
            "train_losses": [],
            "train_psnrs": [],
            "quick_val_losses": [],
            "quick_val_psnrs": [],
            "quick_val_ssims": [],
            "full_val_losses": [],
            "full_val_psnrs": [],
            "full_val_ssims": [],
            "val_steps": [],
            "full_val_steps": [],
            "iteration_times": [],
            "iteration_times_dropped": 0,
            "iteration_times_dropped_sum": 0.0,
            "testset_psnrs": [],
            "testset_steps": [],
            "best_val_psnr": 0.0,
        }

    # ------------------------------------------------------------------ #

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def _occ_update(self, seed_step: int, decay: float) -> None:
        """One refresh of the density grid from the current nets, its
        jitter drawn from a generator seeded by ``seed_step``."""
        from nerfmlp_torch.ops.occupancy import update_grid

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._OCC_SEED * 1_000_003 + seed_step)
        new = update_grid(self.occ_grid, self.state.params, self.rc, gen,
                          decay=decay)
        self.occ_grid.density.copy_(new.density)

    def _render_view(self, dataset, idx: int) -> tuple:
        """Deterministic render of one held-out view, and its ground
        truth: ((H, W, 3) numpy, (H, W, 3) numpy)."""
        from nerfmlp_torch.ops.render import prepare_params, render_image

        o, d, gt = dataset.image_rays(idx)
        vd = image_viewdirs(dataset, idx)
        t = lambda a: torch.as_tensor(a, device=self.device)
        params = prepare_params(self.state.params, self.rc)
        img = render_image(params, t(o), t(d), dataset.H, dataset.W, self.rc,
                           tile=self.tc.chunk, occ_grid=self.occ_grid,
                           viewdirs=None if vd is None else t(vd))
        return img.float().cpu().numpy(), gt

    def _validate(self, dataset, n_images: Optional[int] = None):
        """Render whole held-out images; mean PSNR/SSIM/MSE over them, or
        None when there is nothing to validate."""
        n = dataset.n_images if n_images is None else min(n_images,
                                                           dataset.n_images)
        if n <= 0:
            return None
        mses, psnrs, ssims = [], [], []
        for i in range(n):
            img, gt = self._render_view(dataset, i)
            mses.append(float(np.mean((img - gt) ** 2)))
            psnrs.append(psnr_images(img, gt))
            ssims.append(ssim(img, gt))
        return {"loss": float(np.mean(mses)), "psnr": float(np.mean(psnrs)),
                "ssim": float(np.nanmean(ssims))}

    def _save_val_image(self, step: int) -> None:
        """One held-out render, ``val_{step:06d}.png`` (the ``i_img``
        frames). Best-effort: a failure is logged, training goes on."""
        if self.val_ds is None:
            return
        try:
            from nerfmlp_torch.utils.image import save_png

            img, _ = self._render_view(self.val_ds, 0)
            save_png(os.path.join(self.save_dir, f"val_{step:06d}.png"), img)
        except Exception as e:
            self._log(f"(val image dump skipped: {e})")

    def _video_event(self, step: int) -> None:
        """The orbit as rgb and disparity videos,
        ``<expname>_spiral_{step:06d}_{rgb,disp}.gif``, and with view
        directions the static-camera ``_rgb_still`` video. Best-effort."""
        try:
            from nerfmlp_torch.render_path import (
                render_path, save_path_videos,
            )
            from nerfmlp_torch.utils.image import to8b, write_video

            ds = self.train_ds
            kw = dict(render_factor=self.tc.render_factor,
                      occ_grid=self.occ_grid, verbose=False,
                      tile=self.tc.chunk)
            rgbs, disps, _ = render_path(self.state.params, self.render_poses,
                                         (ds.H, ds.W, ds.focal), self.rc, **kw)
            expname = os.path.basename(os.path.normpath(self.save_dir))
            base = os.path.join(self.save_dir, f"{expname}_spiral_{step:06d}")
            rgb_path, disp_path = save_path_videos(base, rgbs, disps)
            self._log(f"🎬 i_video @ {step:,}: {rgb_path}, {disp_path}")
            if self.rc.use_viewdirs:
                stills, _, _ = render_path(
                    self.state.params, self.render_poses,
                    (ds.H, ds.W, ds.focal), self.rc,
                    static_cam_pose=np.asarray(self.render_poses)[0], **kw)
                still_path = write_video(base + "_rgb_still", to8b(stills))
                self._log(f"🎬 i_video @ {step:,}: {still_path} (static cam)")
        except Exception as e:
            self._log(f"(i_video event failed: {e})")

    def _testset_event(self, step: int) -> None:
        """Every test pose rendered to ``testset_{step:06d}/{i:03d}.png``
        with per-frame PSNR; the mean goes to ``history["testset_psnrs"]``.
        Under ``render_factor`` the frames are smaller and the ground truth
        is sampled with the same stride, so PSNR is still recorded.
        Best-effort."""
        try:
            from nerfmlp_torch.render_path import render_path

            out_dir = os.path.join(self.save_dir, f"testset_{step:06d}")
            ds = self.test_ds
            H, W, focal = ds.H, ds.W, ds.focal
            gt = ds.images
            rf = int(self.tc.render_factor or 0)
            if rf > 1:
                H, W, focal = H // rf, W // rf, focal / rf
                gt = gt[:, : H * rf: rf, : W * rf: rf]
            _, _, psnrs = render_path(
                self.state.params, ds.poses, (H, W, focal), self.rc,
                gt_images=gt, tile=self.tc.chunk, occ_grid=self.occ_grid,
                save_dir=out_dir, verbose=False)
            if psnrs:
                mean_p = float(np.mean(psnrs))
                self.history["testset_psnrs"].append(mean_p)
                self.history["testset_steps"].append(step)
                self._log(f"🧪 i_testset @ {step:,}: {len(psnrs)} views -> "
                          f"{out_dir} | mean PSNR {mean_p:.2f} (min "
                          f"{min(psnrs):.2f} / max {max(psnrs):.2f})")
            else:
                self._log(f"🧪 i_testset @ {step:,}: frames -> {out_dir}")
        except Exception as e:
            self._log(f"(i_testset event failed: {e})")

    def _mesh_event(self, step: int) -> None:
        """A density-isosurface ``<expname>_mesh_{step:06d}.ply`` of the
        current weights (``ops/mesh.py``), packed from them here: under
        ``steps_per_dispatch`` the replays update the nets in place, so no
        earlier packing is current. Without ``rc.aabb`` it warns once and
        skips. Best-effort."""
        try:
            if self.rc.aabb is None:
                if not self._mesh_warned:
                    self._mesh_warned = True
                    self._log("(i_mesh skipped: needs --aabb scene bounds)")
                return
            from nerfmlp_torch.ops.mesh import extract_mesh, save_ply

            mesh = extract_mesh(self.state.params, self.rc,
                                resolution=self.tc.mesh_resolution,
                                threshold=self.tc.mesh_threshold)
            expname = os.path.basename(os.path.normpath(self.save_dir))
            path = os.path.join(self.save_dir,
                                f"{expname}_mesh_{step:06d}.ply")
            save_ply(path, mesh["verts"], mesh["faces"],
                     colors=mesh.get("colors"), normals=mesh["normals"])
            self._log(f"🔺 i_mesh @ {step:,}: {len(mesh['verts'])} verts / "
                      f"{len(mesh['faces'])} faces (iso "
                      f"{self.tc.mesh_threshold:g}, sigma_max "
                      f"{mesh['sigma_max']:.3g}) -> {path}")
        except Exception as e:
            self._log(f"(i_mesh event failed: {e})")

    def quick_validate(self) -> Optional[Dict[str, float]]:
        return self._validate(self.quick_val_ds, self.tc.quick_val_subset)

    def full_validate(self) -> Optional[Dict[str, float]]:
        return self._validate(self.val_ds)

    # ------------------------------------------------------------------ #

    def resume(self, path: str) -> bool:
        """Restore the state and metric histories from a checkpoint: a
        whole train state (``metrics_latest.pt``, or the JAX package's
        ``metrics_latest.ckpt`` / ``model_full_val_final.ckpt``: its
        params, step and optax Adam state; its PRNG key cannot seed a torch
        generator, which is seeded from the config's seed as on a fresh
        run), or parameters only (``model_{step}.pt`` / ``.ckpt``: step
        from the file name, fresh Adam moments; the learning rate follows
        the step). A missing or undecodable file warns and starts fresh;
        an architecture mismatch raises."""
        if not os.path.exists(path):
            self._log(f"⚠️  resume checkpoint not found: {path} — starting "
                      "fresh")
            return False
        try:
            raw = ckpt.load_checkpoint(path, self.rc.model_config(),
                                       self.rc.model_config(fine=True))
        except (OSError, RuntimeError, EOFError,
                ckpt.CheckpointCorruptError) as e:
            self._log(f"⚠️  resume failed to decode {path} ({e}) — starting "
                      "fresh")
            return False
        st = self.state
        # Everything is written into the live tensors, so a captured step
        # (steps_per_dispatch) stays valid and a run resumes at any K.
        if ckpt.is_train_state(raw):
            self._load_params(raw["params"], path)
            st.optimizer.load_state_dict(raw["opt_state"])
            if raw["generator"] is None:
                st.generator.manual_seed(self.tc.seed)
                self._log(f"⚠️  {path} holds a JAX PRNG key, not a torch "
                          f"generator state — draws reseeded from seed "
                          f"{self.tc.seed}, as on a fresh run")
            else:
                st.generator.set_state(raw["generator"])
            st.set_step(int(raw["step"]))
        else:
            self._load_params(raw if "coarse" in raw else {"coarse": raw},
                              path)
            st.set_step(ckpt.step_from_filename(path))
            st.optimizer.reset()
            if st.step == 0 and os.path.basename(path) not in (
                    "model_0.pt", "model_0.ckpt"):
                self._log(
                    f"⚠️  cannot infer the training step from "
                    f"'{os.path.basename(path)}' — resuming at step 0 with "
                    "the initial learning rate")
            self._log(f"⚠️  {path} holds params only — optimizer moments "
                      f"reset, learning rate at step {st.step:,}")
        hist_path = path.rsplit(".", 1)[0] + ".history.json"
        if os.path.exists(hist_path):
            self.history.update(ckpt.load_metrics_json(hist_path))
        else:
            self._log(f"⚠️  no history sidecar at {hist_path} — metric "
                      "histories start empty (step comes from the state)")
        self.history["step"] = max(int(self.history.get("step", 0)), st.step)
        if self.occ_grid is not None:
            # The grid is derived state: one refresh with decay 0 rebuilds
            # it from the restored nets (an EMA step on the fresh grid
            # would not).
            self._occ_update(0, 0.0)
        self._log(f"🔄 resumed from {path} at step {st.step:,} (best "
                  f"quick-val PSNR {self.history['best_val_psnr']:.2f})")
        return True

    def _load_params(self, sds: Dict, path: str) -> None:
        if set(sds) != set(self.state.params):
            raise ValueError(
                f"{path}: checkpoint nets {sorted(sds)} do not match this "
                f"run's {sorted(self.state.params)} — pass the run's "
                "original --separate_fine flag")
        for key, net in self.state.params.items():
            try:
                net.load_state_dict(sds[key])
            except RuntimeError as e:
                raise ValueError(
                    f"{path}: checkpoint does not match this architecture "
                    f"({e}) — pass the run's original --netdepth/--netwidth "
                    "flags") from e

    def _save_resumable(self, name: str = "metrics_latest.pt",
                        history: Optional[Dict] = None) -> None:
        path = os.path.join(self.save_dir, name)
        ckpt.save_checkpoint(path, self.state)
        ckpt.save_metrics_json(path.rsplit(".", 1)[0] + ".history.json",
                               self.history if history is None else history)

    def _save_params(self, name: str) -> None:
        ckpt.save_params(os.path.join(self.save_dir, name), self.state.params)

    # ------------------------------------------------------------------ #

    def train(self, iters: Optional[int] = None) -> Dict:
        tc, rc = self.tc, self.rc
        iters = tc.iters if iters is None else iters
        start_step = int(self.history["step"])
        start_time = time.time()
        dev = self.device
        sums = self._sums          # [loss, psnr] since the last validation
        sums.zero_()
        run_count = 0
        self._log(
            f"Training: {len(self.train_ds):,} rays | batch {tc.batch_size} | "
            f"{iters:,} iters | near/far {rc.near:.2f}/{rc.far:.2f} | "
            f"samples {rc.N_samples}+{rc.N_importance} | "
            f"kernel={rc.use_kernel} dtype={rc.compute_dtype} | {dev}")
        precrop = tc.precrop_iters > 0 and start_step < tc.precrop_iters
        if precrop:
            self.loader.set_precrop(tc.precrop_frac)
            self._log(f"🎯 precrop: central {tc.precrop_frac:.0%} crop for "
                      f"the first {tc.precrop_iters:,} iters")
        if self.pool is not None:
            self._log(f"📍 device ray pool: {len(self.pool):,} rays on "
                      f"{dev}, {self.pool.steps_per_epoch:,} steps/epoch")
        windowed = self.windows is not None
        if windowed:
            # Windows end exactly at every step where the blocks below need
            # host work, so the events fire on the same steps as at K = 1 —
            # but for i_mesh, which the JAX Trainer's windows leave out too
            # (nerfmlp_tpu/train/loop.py:642-649): at K > 1 a mesh is
            # written only where a window happens to end on its multiple.
            intervals = [tc.log_interval, tc.ckpt_interval, tc.i_video,
                         tc.i_testset, tc.i_img]
            if self.quick_val_ds is not None:
                intervals.append(tc.quick_val_interval)
            if self.val_ds is not None:
                intervals.append(tc.full_val_interval)
            if self.occ_grid is not None:
                intervals.append(rc.occ_update_every)
            self._log(f"🔁 steps_per_dispatch {tc.steps_per_dispatch}: "
                      + ("CUDA-graph replays" if dev.type == "cuda"
                         else "eager windows on the CPU"))

        t_prev = time.time()
        step = start_step
        while step < iters:
            s = step + 1   # the first step of this window
            if tc.precrop_iters > 0 and s == tc.precrop_iters + 1:
                self.loader.set_precrop(1.0)
                self._log(f"🎯 precrop off at iter {s:,}")
            w = 1
            if windowed:
                w = dispatch_window(s, iters, tc.steps_per_dispatch,
                                    intervals, stop_steps=(tc.precrop_iters,))
            pool_active = self.pool is not None and s > tc.precrop_iters
            if pool_active:
                # A window reads one epoch's stack: it ends at the reshuffle.
                spe = self.pool.steps_per_epoch
                w = min(w, spe - ((s - 1) % spe))
                self.pool.ensure_epoch(self.pool.epoch_of(s - 1))
            occ_args = ()
            if self.occ_grid is not None:
                if (s - 1) % rc.occ_update_every == 0:
                    # Decay 1 during warmup: cells only accumulate, so the
                    # whole box stays sampled until the model has placed
                    # density.
                    self._occ_update(
                        s, 1.0 if s <= rc.occ_warmup_steps else 0.95)
                occ_args = (self.occ_grid,)
            if windowed and pool_active:
                metrics = self.windows.run_pool(w)
            elif windowed:
                metrics = self.windows.run_host(np.stack(
                    [self.loader.next_batch() for _ in range(w)]))
            else:
                if pool_active:
                    batch = self.pool.batch(s - 1)
                else:
                    batch = torch.from_numpy(self.loader.next_batch()).to(
                        dev, non_blocking=True)
                metrics = self.step_fn(self.state, batch, *occ_args)
                sums.add_(torch.stack((metrics["loss"], metrics["psnr"])))
            run_count += w
            step = s + w - 1
            self.history["step"] = step

            now = time.time()
            it = self.history["iteration_times"]
            it.extend([(now - t_prev) / w] * w)
            t_prev = now
            if len(it) > self._ITER_TIMES_CAP:
                drop = len(it) // 2
                self.history["iteration_times_dropped"] += drop
                self.history["iteration_times_dropped_sum"] += float(
                    np.sum(it[:drop]))
                del it[:drop]

            if tc.log_interval and step % tc.log_interval == 0:
                med_t = float(np.median(it[-200:]))
                self._log(
                    f"{datetime.now().strftime('%Y-%m-%d %H:%M:%S')} | "
                    f"Iter {step:,} | Loss: {float(metrics['loss']):.6f} | "
                    f"PSNR: {float(metrics['psnr']):.2f} | "
                    f"LR: {lr_at(tc, step):.2e} | "
                    f"Grad: {float(metrics['grad_norm']):.4f} | "
                    f"Mem: {get_memory_usage_gb():.1f}GB | "
                    f"Time: {med_t * 1e3:.1f}ms (median)")

            if (tc.quick_val_interval and step % tc.quick_val_interval == 0
                    and self.quick_val_ds is not None):
                run_loss, run_psnr = sums.tolist()
                self._quick_val_block(step, iters, start_time, run_loss,
                                      run_psnr, run_count)
                sums.zero_()
                run_count = 0
                t_prev = time.time()

            if (tc.full_val_interval and step % tc.full_val_interval == 0
                    and self.val_ds is not None and step < iters):
                fv = self.full_validate()
                if fv is not None:
                    self.history["full_val_losses"].append(fv["loss"])
                    self.history["full_val_psnrs"].append(fv["psnr"])
                    self.history["full_val_ssims"].append(fv["ssim"])
                    self.history["full_val_steps"].append(step)
                    self._log(f"📋 FULL VAL @ {step:,}: loss "
                              f"{fv['loss']:.6f} | PSNR {fv['psnr']:.2f} | "
                              f"SSIM {fv['ssim']:.4f}")
                    self._save_val_image(step)
                t_prev = time.time()

            if tc.ckpt_interval and step % tc.ckpt_interval == 0:
                self._save_params(f"model_{step}.pt")

            # Render events, never on the last step (the end-of-run
            # artefacts come from the final model).
            if step < iters:
                if (tc.i_video and step % tc.i_video == 0
                        and self.render_poses is not None):
                    self._video_event(step)
                    t_prev = time.time()
                if (tc.i_testset and step % tc.i_testset == 0
                        and self.test_ds is not None):
                    self._testset_event(step)
                    t_prev = time.time()
                if tc.i_mesh and step % tc.i_mesh == 0:
                    self._mesh_event(step)
                    t_prev = time.time()
                if tc.i_img and step % tc.i_img == 0:
                    self._save_val_image(step)
                    t_prev = time.time()

        # Final saves + full validation.
        self._save_params("model_final.pt")
        if tc.i_img and iters > start_step:
            # The in-loop frames stop one interval early; the time-lapse
            # they feed ends on the final model.
            self._save_val_image(iters)
        final = {}
        if self.val_ds is not None:
            final = self.full_validate() or {}
            self._log(
                f"🏁 FINAL full validation: loss "
                f"{final.get('loss', float('nan')):.6f} | PSNR "
                f"{final.get('psnr', float('nan')):.2f} | SSIM "
                f"{final.get('ssim', float('nan')):.4f}")
            # The whole state beside the final-val numbers (the reference's
            # model_full_val_final.pth).
            self._save_resumable(
                "model_full_val_final.pt",
                dict(self.history, full_val_loss=final.get("loss"),
                     full_val_psnr=final.get("psnr"),
                     full_val_ssim=final.get("ssim")))
        self._save_resumable()
        comprehensive = dict(self.history, final_val=final,
                             config=self._config_dict(),
                             total_training_time=time.time() - start_time)
        ckpt.save_metrics_json(
            os.path.join(self.save_dir, "comprehensive_metrics.json"),
            comprehensive)
        return comprehensive

    def _quick_val_block(self, step, iters, start_time, run_loss, run_psnr,
                         run_count):
        h = self.history
        avg_loss = run_loss / max(run_count, 1)
        avg_psnr = run_psnr / max(run_count, 1)
        h["train_losses"].append(avg_loss)
        h["train_psnrs"].append(avg_psnr)
        qm = self.quick_validate()
        if qm is None:
            self._log(f"Iter {step:,} | quick val skipped (no val images)")
            self._save_resumable()
            return
        h["quick_val_losses"].append(qm["loss"])
        h["quick_val_psnrs"].append(qm["psnr"])
        h["quick_val_ssims"].append(qm["ssim"])
        h["val_steps"].append(step)
        conv = ""
        if len(h["quick_val_losses"]) > 5:
            prev_l = h["quick_val_losses"][-6]
            prev_p = h["quick_val_psnrs"][-6]
            impr = 100 * (prev_l - qm["loss"]) / (abs(prev_l) + 1e-8)
            conv = (f" | ΔLoss(5): {impr:+.2f}% | ΔPSNR(5): "
                    f"{qm['psnr'] - prev_p:+.2f}dB")
        self._log(
            f"{datetime.now().strftime('%Y-%m-%d %H:%M:%S')} | Iter "
            f"{step:,} | Avg Train Loss: {avg_loss:.6f} | Avg Train PSNR: "
            f"{avg_psnr:.2f} | Quick Val Loss: {qm['loss']:.6f} | Quick Val "
            f"PSNR: {qm['psnr']:.2f} | Quick Val SSIM: {qm['ssim']:.4f}{conv}")
        etc = calculate_etc(step, iters, start_time, h["iteration_times"])
        if etc:
            self._log(
                f"📊 Progress: {etc['progress_percent']:.1f}% | ETA: "
                f"{format_time_duration(etc['remaining_time'])} "
                f"({etc['completion_time'].strftime('%Y-%m-%d %H:%M:%S')}) | "
                f"Avg: {etc['median_iter_time'] * 1e3:.1f}ms/iter (median)"
                + (" ⚠️ ETA may be unstable" if etc["eta_unstable"] else ""))
        if qm["psnr"] > h["best_val_psnr"]:
            h["best_val_psnr"] = qm["psnr"]
            self._save_params("model_best.pt")
            self._log(f"🏆 Best model saved at iter {step:,} with quick val "
                      f"PSNR {qm['psnr']:.2f}")
        self._save_resumable()
        snapshot = dict(self.history, config=self._config_dict())
        ckpt.save_metrics_json(
            os.path.join(self.save_dir, "metrics_latest.json"), snapshot)
        # Layered per-step snapshots, the newest few kept.
        ckpt.save_metrics_json(
            os.path.join(self.save_dir, f"metrics_{step}_latest.json"),
            snapshot)
        self._save_params(f"model_{step}_latest.pt")
        self._prune_step_snapshots(keep=5)
        self._log("-" * 80)

    def _prune_step_snapshots(self, keep: int) -> None:
        """Keep only the newest ``keep`` metrics_{step}_latest.json and
        model_{step}_latest.pt files."""
        for pattern in (r"metrics_(\d+)_latest\.json",
                        r"model_(\d+)_latest\.pt"):
            snaps = sorted(
                (int(m.group(1)), name) for name in os.listdir(self.save_dir)
                for m in [re.fullmatch(pattern, name)] if m)
            for _, name in snaps[:-keep]:
                try:
                    os.remove(os.path.join(self.save_dir, name))
                except OSError:
                    pass

    def _config_dict(self) -> Dict:
        """The reference's flat config keys plus the full configs."""
        q, v = self.quick_val_ds, self.val_ds
        return {
            "quick_val_res": ([int(q.W), int(q.H)]
                              if q is not None and hasattr(q, "W") else None),
            "full_val_res": ([int(v.W), int(v.H)]
                             if v is not None and hasattr(v, "W") else None),
            "quick_val_subset": self.tc.quick_val_subset,
            "quick_val_interval": self.tc.quick_val_interval,
            "full_val_interval": self.tc.full_val_interval,
            "batch_size": self.tc.batch_size,
            "learning_rate": self.tc.lr,
            "total_iterations": self.tc.iters,
            "render": dataclasses.asdict(self.rc),
            "train": dataclasses.asdict(self.tc),
        }
