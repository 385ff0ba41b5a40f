"""The training loop: logging, quick/full validation, layered checkpoints,
resume and the metrics JSON.

Counterpart of ``nerfmlp_tpu/train/loop.py:61-1123`` (``Trainer``), its
main path on one device or data-parallel over several: the train state,
the host loader and the device ray pool; ``train()`` with the log
interval and precrop; quick and full validation on whole held-out images
(PSNR, SSIM); best, final, periodic and latest checkpoints; auto-resume;
the metrics JSON in the reference schema; occupancy-grid sampling, with the grid refreshed on the JAX
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
copy and an index to every step. Data parallelism (``mesh``, the JAX
Trainer's ``mesh=`` of ``nerfmlp_tpu/train/loop.py:76-152``): every rank
builds the same Trainer and steps on its rows of each global batch (pool
or host), the gradients averaged over the ranks
(``parallel/train_step.py``); the occupancy grid is refreshed on every
rank from the same seed, so the grids stay equal; validation and the
render events render each frame over the ranks
(``parallel/render_parallel.py``); rank 0 alone logs and writes files
(checkpoints, metrics, PNGs, videos, meshes), and the others wait at a
barrier after each write. Tensor parallelism (a ("data", "model")
``mesh`` of ``parallel/tensor_parallel.py::make_tp_mesh``, the JAX
Trainer's ``:112-145``): each rank holds its shards of the nets and of
Adam's moments and steps on its rows over the "data" sub-group, through
the module path (the fused kernels have no path for sharded weights);
occupancy sampling is refused, ``device_pool`` and ``steps_per_dispatch``
are ignored, as in JAX; every rank renders validation and the events
locally with the gathered nets, and checkpoints hold the gathered nets
and moments, in a one-process run's layout.

While a ``torch.profiler`` profile runs (``profile_dir``'s or a
caller's), the loop records spans (``utils/spans.py``): one
``train.window`` a loop iteration (grouped by its first step), inside it
``train.epoch`` (the pool's reshuffle), ``train.occ_update`` (a grid
refresh), ``train.batch`` (the pool or host batch and its copy),
``train.dispatch`` (enqueueing the step or window) and ``train.log`` (the
log step's read-backs), then ``train.save`` around the final saves.

The Trainer's extras (``nerfmlp_tpu/train/loop.py:103-110``, ``:613``,
``:636-640``, ``:715-737``, ``:894-904``): ``TrainConfig.profile_dir``
writes a ``torch.profiler`` trace (CPU and, on ``cuda``, CUDA activities)
of steps 10-29 of each ``train()`` call, counted from where it starts, as
a Chrome trace, one file per rank, each step a ``train step N`` range (the
``train.dispatch`` span) among the ranges of the spans above, by their
names; it is closed after the loop if the run ends inside the window.
Where the JAX Trainer logs "(profiler unavailable)" and carries on, a
profiler that fails to start or stop raises here: no trace is lost
without a word.
``tensorboard_dir``: the JAX Trainer's TensorBoard tags at its cadence
(``train/*`` at each log step, ``val/*`` scalars, ``params/*`` histograms
and the ``val/*`` images at each quick validation, ``test/psnr`` at each
test-set event), written by rank 0; where ``torch.utils.tensorboard``
does not import, asking for it raises. Under ``profile_dir`` or
:func:`nerfmlp_torch.check_numerics` the steps run one by one, not in
``steps_per_dispatch`` windows: a graph replay hides the step boundaries
from the trace, and a check cannot raise inside a captured graph.

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

from nerfmlp_torch import (
    numerics_checked, numerics_scope, resolve_device, use_true_fp32,
)
from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data import image_viewdirs
from nerfmlp_torch.data.device_pool import DeviceRayPool
from nerfmlp_torch.data.pipeline import RayBatchLoader
from nerfmlp_torch.parallel.mesh import barrier, replicate_, shard_batch
from nerfmlp_torch.parallel.render_parallel import (
    data_parallel_mesh, render_image_sharded,
)
from nerfmlp_torch.parallel.train_step import (
    create_train_state, lr_at, make_step_body, make_step_fn,
)
from nerfmlp_torch.train import checkpoint as ckpt
from nerfmlp_torch.train.graph import StepWindows
from nerfmlp_torch.train.metrics import (
    calculate_etc, format_time_duration, get_memory_usage_gb, psnr_images,
    ssim,
)
from nerfmlp_torch.utils.spans import span


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


class Trainer:
    """End-to-end trainer for one scene, on one device or data-parallel
    over the ranks of ``mesh``.

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
    and replayed; on the CPU the same step body, eagerly.

    ``tensorboard_dir``: where rank 0 writes TensorBoard events (the
    train CLI's ``<save_dir>/tb``), or None.

    ``mesh``: a :class:`~nerfmlp_torch.parallel.mesh.Mesh` of ranks, each
    running this Trainer on ``mesh.device`` (``device`` must be None or
    that device's type); ``tc.batch_size`` is the global batch, a
    multiple of the rank count. A mesh of one rank runs the step's
    collective too (JAX's one-device mesh), and renders locally. K > 1
    under gloo on ``cuda`` is refused: gloo's collectives cannot be
    captured in a CUDA graph."""

    # iteration_times cap: past it the oldest half is folded into the
    # dropped counters, so the JSON stays bounded.
    _ITER_TIMES_CAP = 20_000
    # The grid refreshes' jitter: a generator seeded from this and the step.
    _OCC_SEED = 17

    def __init__(self, rc: RenderConfig, tc: TrainConfig, train_ds,
                 val_ds=None, quick_val_ds=None,
                 save_dir: str = "outputs/checkpoints", verbose: bool = True,
                 device=None, render_poses=None, test_ds=None, mesh=None,
                 tensorboard_dir: Optional[str] = None):
        if rc.use_occupancy and rc.aabb is None:
            raise ValueError("use_occupancy requires RenderConfig.aabb")
        self.mesh = mesh
        self.verbose = verbose
        # A mesh with a "model" axis > 1 takes the tensor-parallel step.
        self._tp = mesh is not None and mesh.model_parallel > 1
        self.is_main = self.mesh is None or self.mesh.is_main
        if self._tp:
            if rc.use_occupancy:
                raise ValueError(
                    "tensor parallelism + occupancy sampling is not wired; "
                    "drop --use_occupancy or --tensor_parallel")
            if rc.use_kernel:
                # The fused kernels have no path for sharded weights (the
                # JAX Trainer turns its Pallas kernel off alike).
                rc = dataclasses.replace(rc, use_kernel=False)
                self._log("(tensor parallelism: fused kernels disabled — "
                          "sharded weights take the module path)")
        # The ranks that split each global batch (the "data" sub-group
        # under tensor parallelism).
        self._data_mesh = mesh.data if self._tp else mesh
        if mesh is not None:
            if device is not None and (torch.device(device).type
                                       != mesh.device.type):
                raise ValueError(f"device {device} on a mesh of "
                                 f"{mesh.device.type} ranks")
            device = mesh.device
            shard_batch(np.empty(tc.batch_size), self._data_mesh)  # B % N
            if (tc.steps_per_dispatch > 1 and mesh.device.type == "cuda"
                    and mesh.backend != "nccl" and not self._tp):
                raise ValueError(
                    f"steps_per_dispatch={tc.steps_per_dispatch} under "
                    f"{mesh.backend} on cuda: its collectives go through the "
                    "host and cannot be captured in a CUDA graph; use nccl "
                    "or steps_per_dispatch 1")
        # Frames render over the ranks (validation, i_img, the events).
        self.render_mesh = data_parallel_mesh(self.mesh)
        self.device = resolve_device(device)
        use_true_fp32()
        self.rc = rc
        self.tc = tc
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.quick_val_ds = quick_val_ds if quick_val_ds is not None else val_ds
        self.save_dir = save_dir
        self.render_poses = render_poses
        self.test_ds = test_ds
        self._mesh_warned = False
        if self.is_main:
            os.makedirs(save_dir, exist_ok=True)
        self._tb = None
        if tensorboard_dir and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    f"TensorBoard logging needs torch.utils.tensorboard, "
                    f"which does not import here ({e}): install the "
                    f"tensorboard package, or train without it") from e
            self._tb = SummaryWriter(tensorboard_dir)
        # View 0 of the last validation, with the TensorBoard maps:
        # (dataset, maps, gt), reused by the images logged after it.
        self._last_val = None

        self.state = create_train_state(rc, tc, self.device)
        self._replicate(self.mesh)
        self._full = None     # (step, the gathered state) under TP
        if self._tp:
            from nerfmlp_torch.parallel.tensor_parallel import shard_state

            self.state = shard_state(self.state, self.mesh)
        self.step_fn = make_step_fn(rc, tc, self.mesh)
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
            if self._tp:
                self._log("(device_pool ignored under tensor parallelism)")
            elif tc.no_batching:
                self._log("(device_pool ignored: --no_batching samples "
                          "per-image on host)")
            elif len(self.loader) < tc.batch_size:
                self._log("(device_pool ignored: ray pool smaller than one "
                          "batch — host with-replacement sampling)")
            else:
                self.pool = DeviceRayPool(self.loader.pool, tc.batch_size,
                                          seed=tc.seed, device=self.device,
                                          mesh=self.mesh)
        self.windows = None
        if tc.steps_per_dispatch > 1 and self._tp:
            self._log("(steps_per_dispatch ignored under tensor parallelism)")
        elif tc.steps_per_dispatch > 1:
            self.windows = StepWindows(self.state,
                                       make_step_body(rc, tc, self.mesh),
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
        if self.verbose and self.is_main:
            print(msg, flush=True)

    def _replicate(self, mesh) -> None:
        """The first rank's nets, Adam state and step counter into every
        rank's of ``mesh`` (nothing without one). Every rank builds and
        resumes the same state; this makes them equal bit for bit
        whatever the devices. Under tensor parallelism a resumed state is
        replicated over the "data" sub-group, whose ranks hold the same
        shards."""
        if mesh is None:
            return
        st = self.state
        opt = st.optimizer
        replicate_([p.data for p in opt.params] + opt.exp_avg
                   + opt.exp_avg_sq + [opt.count, st.counter], mesh)

    def full_state(self):
        """The train state as one process holds it: under tensor
        parallelism gathered from the model ranks (a collective every rank
        makes at the same step; kept until the next step), else the
        state itself."""
        if not self._tp:
            return self.state
        if self._full is None or self._full[0] != self.state.step:
            from nerfmlp_torch.parallel.tensor_parallel import gather_state

            self._full = (self.state.step, gather_state(self.state))
        return self._full[1]

    def full_params(self) -> Dict:
        """The nets as one process holds them (:meth:`full_state`)."""
        return self.full_state().params

    def _sync(self) -> None:
        """The ranks wait here for rank 0's writes (nothing without a
        mesh)."""
        barrier(self.mesh)

    def _host_batch(self) -> np.ndarray:
        """This rank's rows of the loader's next global batch."""
        return shard_batch(self.loader.next_batch(), self._data_mesh)

    def _occ_update(self, seed_step: int, decay: float) -> None:
        """One refresh of the density grid from the current nets, its
        jitter drawn from a generator seeded by ``seed_step``."""
        from nerfmlp_torch.ops.occupancy import update_grid

        with span("train.occ_update"):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._OCC_SEED * 1_000_003 + seed_step)
            new = update_grid(self.occ_grid, self.state.params, self.rc, gen,
                              decay=decay)
            self.occ_grid.density.copy_(new.density)

    def _render_view(self, dataset, idx: int, maps=("rgb_map",)) -> tuple:
        """Deterministic render of one held-out view, and its ground
        truth: ({map: numpy}, (H, W, 3) numpy)."""
        from nerfmlp_torch.ops.render import prepare_params, render_image_maps

        o, d, gt = dataset.image_rays(idx)
        vd = image_viewdirs(dataset, idx)
        t = lambda a: torch.as_tensor(a, device=self.device)
        params = prepare_params(self.full_params(), self.rc)
        with numerics_scope(f"the render of view {idx}"):
            if self.render_mesh is not None:
                # The JAX Trainer's per-device tile: the chunk over the
                # ranks.
                out = render_image_sharded(
                    params, t(o), t(d), dataset.H, dataset.W, self.rc,
                    self.render_mesh,
                    tile=max(256, -(-self.tc.chunk // self.mesh.world_size)),
                    occ_grid=self.occ_grid,
                    viewdirs=None if vd is None else t(vd), maps=maps)
            else:
                out = render_image_maps(
                    params, t(o), t(d), dataset.H, dataset.W, self.rc,
                    tile=self.tc.chunk, occ_grid=self.occ_grid,
                    viewdirs=None if vd is None else t(vd), maps=maps)
        return {k: v.float().cpu().numpy() for k, v in out.items()}, gt

    def _tb_extra_maps(self) -> tuple:
        """The coarse pass's TensorBoard extras (the JAX Trainer's
        ``_tb_extra_maps``): only with TensorBoard and a coarse pass to
        show (a fine pass, no occupancy grid)."""
        if (self._tb is not None and self.rc.N_importance > 0
                and not self.rc.use_occupancy):
            return ("rgb_map_coarse", "disp_map_coarse", "z_std")
        return ()

    def _validate(self, dataset, n_images: Optional[int] = None):
        """Render whole held-out images; mean PSNR/SSIM/MSE over them, or
        None when there is nothing to validate. View 0's maps are kept for
        the TensorBoard images."""
        n = dataset.n_images if n_images is None else min(n_images,
                                                           dataset.n_images)
        self._last_val = None
        if n <= 0:
            return None
        maps = ("rgb_map",) + self._tb_extra_maps()
        mses, psnrs, ssims = [], [], []
        for i in range(n):
            out, gt = self._render_view(dataset, i, maps)
            img = out["rgb_map"]
            if i == 0:
                self._last_val = (dataset, out, gt)
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

            img = self._render_view(self.val_ds, 0)[0]["rgb_map"]
            if self.is_main:
                save_png(os.path.join(self.save_dir, f"val_{step:06d}.png"),
                         img)
        except Exception as e:
            self._log(f"(val image dump skipped: {e})")
        self._sync()

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
                      tile=self.tc.chunk, mesh=self.render_mesh)
            rgbs, disps, _ = render_path(self.full_params(), self.render_poses,
                                         (ds.H, ds.W, ds.focal), self.rc, **kw)
            expname = os.path.basename(os.path.normpath(self.save_dir))
            base = os.path.join(self.save_dir, f"{expname}_spiral_{step:06d}")
            if self.is_main:
                rgb_path, disp_path = save_path_videos(base, rgbs, disps)
                self._log(f"🎬 i_video @ {step:,}: {rgb_path}, {disp_path}")
            if self.rc.use_viewdirs:
                stills, _, _ = render_path(
                    self.full_params(), self.render_poses,
                    (ds.H, ds.W, ds.focal), self.rc,
                    static_cam_pose=np.asarray(self.render_poses)[0], **kw)
                if self.is_main:
                    still_path = write_video(base + "_rgb_still",
                                             to8b(stills))
                    self._log(f"🎬 i_video @ {step:,}: {still_path} "
                              "(static cam)")
        except Exception as e:
            self._log(f"(i_video event failed: {e})")
        self._sync()

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
                self.full_params(), ds.poses, (H, W, focal), self.rc,
                gt_images=gt, tile=self.tc.chunk, occ_grid=self.occ_grid,
                save_dir=out_dir, verbose=False, mesh=self.render_mesh)
            if psnrs:
                mean_p = float(np.mean(psnrs))
                self.history["testset_psnrs"].append(mean_p)
                self.history["testset_steps"].append(step)
                if self._tb is not None:
                    self._tb.add_scalar("test/psnr", mean_p, step)
                self._log(f"🧪 i_testset @ {step:,}: {len(psnrs)} views -> "
                          f"{out_dir} | mean PSNR {mean_p:.2f} (min "
                          f"{min(psnrs):.2f} / max {max(psnrs):.2f})")
            else:
                self._log(f"🧪 i_testset @ {step:,}: frames -> {out_dir}")
        except Exception as e:
            self._log(f"(i_testset event failed: {e})")
        self._sync()

    def _mesh_event(self, step: int) -> None:
        """A density-isosurface ``<expname>_mesh_{step:06d}.ply`` of the
        current weights (``ops/mesh.py``), packed from them here: under
        ``steps_per_dispatch`` the replays update the nets in place, so no
        earlier packing is current. Without ``rc.aabb`` it warns once and
        skips. Best-effort. Over a data-parallel mesh each rank queries
        its share of the chunks (``extract_mesh(mesh=)``, the JAX
        Trainer's ``render_mesh``) and rank 0 writes the file; otherwise
        rank 0 alone extracts it (under tensor parallelism from the
        gathered nets)."""
        try:
            if self.rc.aabb is None:
                if not self._mesh_warned:
                    self._mesh_warned = True
                    self._log("(i_mesh skipped: needs --aabb scene bounds)")
                return
            from nerfmlp_torch.ops.mesh import extract_mesh, save_ply

            params = self.full_params()
            if self.render_mesh is None and not self.is_main:
                return
            mesh = extract_mesh(params, self.rc,
                                resolution=self.tc.mesh_resolution,
                                threshold=self.tc.mesh_threshold,
                                mesh=self.render_mesh)
            if not self.is_main:
                return
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
        finally:
            self._sync()

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
        self._full = None
        if ckpt.is_train_state(raw):
            self._load_params(raw["params"], path, raw["opt_state"])
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
        self._replicate(self._data_mesh)
        if self.occ_grid is not None:
            # The grid is derived state: one refresh with decay 0 rebuilds
            # it from the restored nets (an EMA step on the fresh grid
            # would not).
            self._occ_update(0, 0.0)
        self._log(f"🔄 resumed from {path} at step {st.step:,} (best "
                  f"quick-val PSNR {self.history['best_val_psnr']:.2f})")
        return True

    def _load_params(self, sds: Dict, path: str,
                     opt_state: Optional[Dict] = None) -> None:
        """The nets' state dicts ``sds`` (and Adam's ``opt_state``, where
        given) into the live state; under tensor parallelism each rank
        keeps its shards of them."""
        if set(sds) != set(self.state.params):
            raise ValueError(
                f"{path}: checkpoint nets {sorted(sds)} do not match this "
                f"run's {sorted(self.state.params)} — pass the run's "
                "original --separate_fine flag")
        try:
            if self._tp:
                from nerfmlp_torch.parallel.tensor_parallel import (
                    load_full_state,
                )

                load_full_state(self.state, sds, opt_state)
                return
            for key, net in self.state.params.items():
                net.load_state_dict(sds[key])
        except RuntimeError as e:
            raise ValueError(
                f"{path}: checkpoint does not match this architecture "
                f"({e}) — pass the run's original --netdepth/--netwidth "
                "flags") from e
        if opt_state is not None:
            self.state.optimizer.load_state_dict(opt_state)

    def _save_resumable(self, name: str = "metrics_latest.pt",
                        history: Optional[Dict] = None) -> None:
        state = self.full_state()
        if not self.is_main:
            return
        path = os.path.join(self.save_dir, name)
        ckpt.save_checkpoint(path, state)
        ckpt.save_metrics_json(path.rsplit(".", 1)[0] + ".history.json",
                               self.history if history is None else history)

    def _save_params(self, name: str) -> None:
        params = self.full_params()
        if self.is_main:
            ckpt.save_params(os.path.join(self.save_dir, name), params)

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
        if windowed and (tc.profile_dir or numerics_checked()):
            self._log("(steps_per_dispatch disabled while "
                      + ("profiling: the trace wants per-step dispatch "
                         "boundaries)" if tc.profile_dir else
                         "checking numerics: a captured graph cannot "
                         "raise)"))
            windowed = False
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
        trace = None      # the open profiler trace: (profile, first step)
        while step < iters:
            s = step + 1   # the first step of this window
            if tc.profile_dir and s - start_step == 10:
                trace = (self._start_trace(), s)
            elif trace is not None and s - start_step == 30:
                self._stop_trace(*trace, s - 1)
                trace = None
            with span("train.window", group=s):
                if tc.precrop_iters > 0 and s == tc.precrop_iters + 1:
                    self.loader.set_precrop(1.0)
                    self._log(f"🎯 precrop off at iter {s:,}")
                w = 1
                if windowed:
                    w = dispatch_window(s, iters, tc.steps_per_dispatch,
                                        intervals,
                                        stop_steps=(tc.precrop_iters,))
                pool_active = self.pool is not None and s > tc.precrop_iters
                if pool_active:
                    # A window reads one epoch's stack: it ends at the
                    # reshuffle.
                    spe = self.pool.steps_per_epoch
                    w = min(w, spe - ((s - 1) % spe))
                    with span("train.epoch"):
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
                    with span("train.dispatch"):
                        metrics = self.windows.run_pool(w)
                elif windowed:
                    with span("train.batch"):
                        batches = np.stack([self._host_batch()
                                            for _ in range(w)])
                    with span("train.dispatch"):
                        metrics = self.windows.run_host(batches)
                else:
                    with span("train.batch"):
                        if pool_active:
                            batch = self.pool.batch(s - 1)
                        else:
                            batch = torch.from_numpy(
                                np.ascontiguousarray(self._host_batch())).to(
                                dev, non_blocking=True)
                    with span("train.dispatch", label=f"train step {s}"):
                        metrics = self.step_fn(self.state, batch, *occ_args)
                        sums.add_(torch.stack((metrics["loss"],
                                               metrics["psnr"])))
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
                    with span("train.log"):
                        self._log_step(step, metrics, it)

                if (tc.quick_val_interval and step % tc.quick_val_interval == 0
                        and self.quick_val_ds is not None):
                    run_loss, run_psnr = sums.tolist()
                    self._quick_val_block(step, iters, start_time, run_loss,
                                          run_psnr, run_count)
                    self._sync()
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
                                  f"{fv['loss']:.6f} | PSNR "
                                  f"{fv['psnr']:.2f} | SSIM "
                                  f"{fv['ssim']:.4f}")
                        self._save_val_image(step)
                    t_prev = time.time()

                if tc.ckpt_interval and step % tc.ckpt_interval == 0:
                    self._save_params(f"model_{step}.pt")
                    self._sync()

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

        if trace is not None:
            # The run ended inside the trace window: close it, so the
            # trace is written.
            self._stop_trace(*trace, step)
        # Final saves + full validation.
        with span("train.save"):
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
        with span("train.save"):
            self._save_resumable()
            comprehensive = dict(self.history, final_val=final,
                                 config=self._config_dict(),
                                 total_training_time=time.time() - start_time)
            if self.is_main:
                ckpt.save_metrics_json(
                    os.path.join(self.save_dir, "comprehensive_metrics.json"),
                    comprehensive)
        if self._tb is not None:
            self._tb.flush()
        self._sync()
        return comprehensive

    def _start_trace(self):
        """A started ``torch.profiler`` profile of the CPU and, on
        ``cuda``, the card."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_trace(self, prof, first: int, last: int) -> str:
        """Stop ``prof`` (steps ``first``-``last``) and write its Chrome
        trace into ``profile_dir``, one file per rank."""
        prof.stop()
        rank = self.mesh.rank if self.mesh is not None else 0
        os.makedirs(self.tc.profile_dir, exist_ok=True)
        path = os.path.join(self.tc.profile_dir,
                            f"train_steps_{first:06d}-{last:06d}"
                            f".rank{rank}.pt.trace.json")
        prof.export_chrome_trace(path)
        self._log(f"🧪 profiler trace (steps {first}-{last}) -> {path}")
        return path

    def _log_step(self, step: int, metrics: Dict, it) -> None:
        """The log line (and TensorBoard's train scalars) at a log step:
        reads the step's metrics back, so it waits for the card."""
        tc = self.tc
        med_t = float(np.median(it[-200:]))
        if self._tb is not None:
            for key in ("loss", "psnr", "grad_norm"):
                self._tb.add_scalar(f"train/{key}", float(metrics[key]), step)
            self._tb.add_scalar("train/lr", lr_at(tc, step), step)
        self._log(
            f"{datetime.now().strftime('%Y-%m-%d %H:%M:%S')} | "
            f"Iter {step:,} | Loss: {float(metrics['loss']):.6f} | "
            f"PSNR: {float(metrics['psnr']):.2f} | "
            f"LR: {lr_at(tc, step):.2e} | "
            f"Grad: {float(metrics['grad_norm']):.4f} | "
            f"Mem: {get_memory_usage_gb():.1f}GB | "
            f"Time: {med_t * 1e3:.1f}ms (median)")

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
        if self._tb is not None:
            for key in ("loss", "psnr", "ssim"):
                self._tb.add_scalar(f"val/{key}", qm[key], step)
            self._tb_histograms_and_image(step)
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
        if not self.is_main:
            return
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

    def _tb_histograms_and_image(self, step: int) -> None:
        """Parameter histograms (the JAX tree's paths, ``params/coarse/
        pts_linears_0/kernel``), the held-out render and its ground truth,
        and with a coarse pass its rgb, disparity and ``z_std`` (the JAX
        Trainer's ``_tb_histograms_and_image``), from the validation's
        view 0 where it rendered one. Best-effort: a failure is logged."""
        try:
            tree = ckpt.jax_params_tree(self.full_params())
            for net, layers in tree.items():
                for layer, leaves in layers.items():
                    for leaf, value in leaves.items():
                        self._tb.add_histogram(
                            f"params/{net}/{layer}/{leaf}",
                            np.asarray(value), step)
            ds = self.quick_val_ds
            if ds is None:
                return
            if self._last_val is not None and self._last_val[0] is ds:
                _, maps, gt = self._last_val
            else:
                maps, gt = self._render_view(
                    ds, 0, ("rgb_map",) + self._tb_extra_maps())
            self._tb.add_image("val/render", np.clip(maps["rgb_map"], 0, 1),
                               step, dataformats="HWC")
            self._tb.add_image("val/gt", gt, step, dataformats="HWC")
            if "rgb_map_coarse" in maps:
                self._tb.add_image("val/rgb0",
                                   np.clip(maps["rgb_map_coarse"], 0, 1),
                                   step, dataformats="HWC")
                disp0 = maps["disp_map_coarse"]
                disp0 = disp0 / max(float(np.max(disp0)), 1e-8)
                self._tb.add_image("val/disp0", disp0[..., None], step,
                                   dataformats="HWC")
                self._tb.add_histogram("val/z_std", maps["z_std"], step)
        except Exception as e:
            self._log(f"(tensorboard histogram/image logging failed: {e})")

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
