"""Data-parallel runs that return what a check compares.

Each function here runs as one rank of :func:`~nerfmlp_torch.parallel.mesh.
launch` (``fn(mesh, ...)``), or, with ``mesh=None``, as the one-process run
it is held against, and returns plain numbers and numpy arrays (what a
spawned rank can hand back). The CPU tests and ``chip_smoke.py`` drive
them: they live in the package so that spawned ranks import only the
package.

  * :func:`dp_steps`: steps of the train step on global batches (with
    ``tensor_parallel``, on a ("data", "model") mesh);
  * :func:`dp_trainer`: the Trainer, validated before and after training,
    with the files each rank wrote counted (with ``tensor_parallel``, the
    TP Trainer);
  * :func:`dp_frame`: one frame rendered over the ranks;
  * :func:`multi_scene_steps`: the multi-scene step in every layout;
  * :func:`mesh_over_ranks`: a mesh extracted over the ranks.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.parallel.mesh import all_gather_rows, shard_batch


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in params])


def _ranks_bit_equal(flat: torch.Tensor, mesh, group: int = 1,
                     stride: int = 0) -> bool:
    """Whether every rank holds the same bits of ``flat`` as the first
    rank of its run of ``group`` consecutive ranks (all ranks: the world
    size), or (``stride`` > 0) as the rank ``r % stride``: the ranks of
    one data group of a ("data", "model") mesh."""
    if mesh is None:
        return True
    every = all_gather_rows(flat[None], mesh)
    first = (lambda r: r % stride) if stride else (lambda r: r - r % group)
    return all(torch.equal(every[r], every[first(r)])
               for r in range(mesh.world_size))


def dp_steps(mesh, rc, tc, batches: Sequence[np.ndarray],
             nets: Optional[Dict] = None, device=None,
             tensor_parallel: int = 1) -> Dict:
    """``len(batches)`` steps of ``make_step_fn(rc, tc, mesh)`` from
    ``create_train_state`` (or the state dicts ``nets``, by net name), each
    on this rank's rows of a global (B, F) batch. Returns the metrics per
    step, the first step's gradient (Adam's first moment over 1 - b1:
    every layout's is scaled alike), the final parameters (state dicts as
    numpy) and whether the ranks' parameters are bit-equal, and the
    forward kernel's and the backward's launches in the steps.

    ``tensor_parallel`` T > 1: the ranks as a ("data", "model") mesh of
    N / T x T (``parallel/tensor_parallel.py``), each step on the rows of
    this rank's data group; the gradient and parameters come back
    gathered whole, and ``shard_shapes`` holds this rank's shape of every
    coarse parameter. Bit-equality is then over the ranks of each data
    group (the same model rank)."""
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.parallel.train_step import (
        ADAM_BETAS, create_train_state, make_step_fn,
    )

    dev = mesh.device if mesh is not None else resolve_device(device)
    state = create_train_state(rc, tc, dev)
    if nets is not None:
        for key, sd in nets.items():
            state.params[key].load_state_dict(
                {k: torch.as_tensor(v) for k, v in sd.items()})
    data = mesh
    if tensor_parallel > 1:
        from nerfmlp_torch.parallel.tensor_parallel import (
            gather_state, make_tp_mesh, shard_state,
        )

        mesh = make_tp_mesh(mesh.world_size, tensor_parallel, mesh=mesh)
        state, data = shard_state(state, mesh), mesh.data
    step = make_step_fn(rc, tc, mesh)
    out = {k: [] for k in ("loss", "psnr", "grad_norm", "total_loss")}
    grads0 = None
    kernels = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
               fused_mlp.weight_grads, fused_mlp.reduce_partials)
    before = [k.launches for k in kernels]
    for b in batches:
        rows = shard_batch(np.asarray(b, np.float32), data)
        m = step(state, torch.from_numpy(np.ascontiguousarray(rows)).to(dev))
        for k in out:
            out[k].append(float(m[k]))
        if grads0 is None:
            moments = (gather_state(state) if tensor_parallel > 1
                       else state).optimizer.exp_avg
            grads0 = (_flat(moments) / (1.0 - ADAM_BETAS[0])).cpu().numpy()
    launches = [k.launches - b for k, b in zip(kernels, before)]
    opt = state.optimizer
    same = _ranks_bit_equal(torch.cat([_flat(opt.params), _flat(opt.exp_avg),
                                       _flat(opt.exp_avg_sq)]), mesh)
    shards = {}
    if tensor_parallel > 1:
        same = _ranks_bit_equal(torch.cat([_flat(opt.params),
                                           _flat(opt.exp_avg)]), mesh,
                                group=0, stride=tensor_parallel)
        shards = {n: tuple(p.shape)
                  for n, p in state.params["coarse"].named_parameters()}
        state = gather_state(state)
    return dict(
        out, grads0=grads0, launches=launches, shard_shapes=shards,
        params={k: {n: v.detach().cpu().numpy()
                    for n, v in net.state_dict().items()}
                for k, net in state.params.items()},
        ranks_bit_equal=same)


@contextlib.contextmanager
def _count_writes(counts: Dict[str, int]):
    """Count this process's calls of the Trainer's file writers (the
    checkpoint module's and the image module's), by name, while inside."""
    from nerfmlp_torch.train import checkpoint as ckpt
    from nerfmlp_torch.utils import image

    patched = [(ckpt, n) for n in ("save_params", "save_checkpoint",
                                   "save_metrics_json")]
    patched += [(image, n) for n in ("save_png", "write_video")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in patched]

    def counting(name, fn):
        def wrapper(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    try:
        for mod, n, fn in saved:
            setattr(mod, n, counting(n, fn))
        yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def dp_trainer(mesh, rc, tc, scene_dir: str, wh, save_dir: str,
               device=None, test_split: bool = False,
               render_poses=None, tensor_parallel: int = 1) -> Dict:
    """A Trainer on the Blender scene in ``scene_dir`` (train / val at
    ``wh``; the test split too with ``test_split``): full validation
    before training, ``tc.iters`` steps, full validation after. Returns
    both validations, the history, the files each rank wrote (rank 0's
    result holds every rank's count, in rank order), the kernels'
    launches per rank in ``train()`` and in its steps alone (eager steps
    and windows; not the renders), rank 0's median host time a step
    (``step_ms``, from the history), the final parameters (flat) and
    whether the ranks' parameters are bit-equal. ``tensor_parallel`` T >
    1: the TP Trainer on a ("data", "model") mesh of the ranks; the
    parameters come back gathered whole, bit-equality over each data
    group."""
    from nerfmlp_torch.data.blender import BlenderDataset
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.train.loop import Trainer

    dev = mesh.device if mesh is not None else resolve_device(device)
    if tensor_parallel > 1:
        from nerfmlp_torch.parallel.tensor_parallel import make_tp_mesh

        mesh = make_tp_mesh(mesh.world_size, tensor_parallel, mesh=mesh)
    ds = BlenderDataset(scene_dir, "train", img_wh=tuple(wh))
    val = BlenderDataset(scene_dir, "val", img_wh=tuple(wh))
    test = BlenderDataset(scene_dir, "test", img_wh=tuple(wh)) \
        if test_split else None
    counters = (fused_mlp.fused_nerf_mlp, fused_mlp.bwd_workspace,
                fused_mlp.weight_grads, fused_mlp.reduce_partials)
    counts: Dict[str, int] = {}
    in_steps = [0] * len(counters)

    def counted(fn):
        def wrapper(*a, **kw):
            before = [c.launches for c in counters]
            out = fn(*a, **kw)
            for i, c in enumerate(counters):
                in_steps[i] += c.launches - before[i]
            return out
        return wrapper

    with _count_writes(counts):
        tr = Trainer(rc, tc, ds, val_ds=val, quick_val_ds=val,
                     save_dir=save_dir, verbose=False, device=dev,
                     render_poses=render_poses, test_ds=test, mesh=mesh)
        tr.step_fn = counted(tr.step_fn)
        if tr.windows is not None:
            tr.windows.run_pool = counted(tr.windows.run_pool)
            tr.windows.run_host = counted(tr.windows.run_host)
        before = tr.full_validate()
        for c in counters:
            c.launches = 0
        tr.train()
        launches = [c.launches for c in counters]
        after = tr.full_validate()
    writes = torch.tensor([float(sum(counts.values()))], device=dev)
    launch_t = torch.tensor([launches + in_steps], dtype=torch.float64,
                            device=dev)
    if mesh is not None:
        writes = all_gather_rows(writes, mesh)
        launch_t = all_gather_rows(launch_t, mesh)
    keep = ("train_losses", "quick_val_psnrs", "full_val_psnrs",
            "testset_psnrs", "step")
    return {"before": before, "after": after,
            "history": {k: tr.history[k] for k in keep},
            "writes": writes.cpu().numpy().astype(int).tolist(),
            "launches": launch_t[:, :4].cpu().numpy().astype(int).tolist(),
            "step_launches": launch_t[:, 4:].cpu().numpy().astype(int)
            .tolist(),
            "render_mesh": tr.render_mesh is not None,
            "step_ms": 1e3 * float(np.median(tr.history["iteration_times"])),
            "params": _flat([p for net in tr.full_params().values()
                             for p in net.parameters()]).cpu().numpy(),
            "ranks_bit_equal": _ranks_bit_equal(
                _flat(tr.state.optimizer.params), mesh,
                stride=mesh.model_parallel if tensor_parallel > 1 else 0)}


def dp_frame(mesh, rc, nets: Dict, rays_o, rays_d, H: int, W: int,
             tile: int, occ_density=None, viewdirs=None, near=None,
             maps=("rgb_map", "disp_map")) -> Dict[str, np.ndarray]:
    """One frame through ``render_image_sharded`` over the ranks of
    ``mesh``, each rank holding the nets of the state dicts ``nets`` (by
    net name, ``rc``'s architecture) and the grid ``occ_density``."""
    from nerfmlp_torch.models.mlp import NeRFMLP
    from nerfmlp_torch.ops.occupancy import OccupancyGrid
    from nerfmlp_torch.parallel.render_parallel import render_image_sharded

    params = {}
    for key, sd in nets.items():
        net = NeRFMLP(rc.model_config(fine=key == "fine")).to(mesh.device)
        net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        params[key] = net
    grid = None if occ_density is None else OccupancyGrid(
        density=torch.as_tensor(occ_density, device=mesh.device))
    out = render_image_sharded(params, rays_o, rays_d, H, W, rc, mesh,
                               tile=tile, occ_grid=grid, viewdirs=viewdirs,
                               near=near, maps=tuple(maps))
    return {k: v.cpu().numpy() for k, v in out.items()}


def multi_scene_steps(mesh, rc, tc, batches: Sequence[np.ndarray],
                      n_scenes: int, device=None,
                      refresh_seed: Optional[int] = None) -> Dict:
    """The multi-scene step on (n_scenes, B, F) global batches: every
    scene in one stack (``mesh=None``), or this rank's scenes of the
    layout ``parallel/multi_scene.py::scene_layout`` picks. With
    ``rc.use_occupancy`` each scene's grid is refreshed once first (decay
    0.95), scene s's jitter from a generator seeded ``refresh_seed + s``.
    Returns every scene's metrics per step (scene order), every scene's
    final flat parameters and grid, and whether the ranks holding a scene
    hold the same parameter bits."""
    from nerfmlp_torch.ops.occupancy import create_multi_scene_grids
    from nerfmlp_torch.parallel.multi_scene import (
        create_multi_scene_state, gather_scene_metrics,
        make_multi_scene_dp_grid_update, make_multi_scene_dp_step,
        make_multi_scene_grid_update, make_multi_scene_step, scene_layout,
    )

    dev = mesh.device if mesh is not None else resolve_device(device)
    layout = None if mesh is None else scene_layout(n_scenes, mesh)
    local = list(range(n_scenes) if layout is None else layout.scenes)
    data = None if layout is None else layout.data
    state = create_multi_scene_state(len(local), rc, tc, device=dev,
                                     first_scene=local[0])
    grids = None
    if rc.use_occupancy:
        update = (make_multi_scene_grid_update(rc) if layout is None
                  else make_multi_scene_dp_grid_update(rc, layout))
        gens = [torch.Generator(device=dev).manual_seed(refresh_seed + s)
                for s in local]
        grids = update(create_multi_scene_grids(len(local), rc, device=dev),
                       state.params, gens, 0.95)
    step = (make_multi_scene_step(rc, tc) if layout is None
            else make_multi_scene_dp_step(rc, tc, layout))
    metrics = []
    for b in batches:
        rows = shard_batch(np.asarray(b, np.float32)[local], data, axis=1)
        m = step(state, torch.from_numpy(np.ascontiguousarray(rows)).to(dev),
                 *(() if grids is None else (grids,)))
        if layout is not None:
            m = gather_scene_metrics(m, layout, n_scenes)
        metrics.append({k: v.cpu().numpy() for k, v in m.items()})
    per = len(state.optimizer.params) // len(local)
    flat = torch.stack([_flat(state.optimizer.params[i * per:(i + 1) * per])
                        for i in range(len(local))])
    dens = (grids.density.reshape(len(local), -1) if grids is not None
            else flat[:, :0])
    group = 1 if data is None else data.world_size
    same = True
    if layout is not None:
        same = _ranks_bit_equal(flat.reshape(-1), mesh, group)
        flat = all_gather_rows(flat, mesh)[::group][:n_scenes]
        dens = all_gather_rows(dens, mesh)[::group][:n_scenes]
    return {"metrics": {k: np.stack([m[k] for m in metrics])
                        for k in metrics[0]},
            "params": flat.cpu().numpy(), "grids": dens.cpu().numpy(),
            "group_bit_equal": same}


def mesh_over_ranks(mesh, rc, nets: Dict, resolution: int,
                    threshold: float, density_chunk: int = 65536) -> Dict:
    """``extract_mesh`` over the ranks of ``mesh`` (each rank holding the
    nets of the state dicts ``nets``, by net name), its volume too (the
    same dealing, ``density_volume(mesh=)``), and the forward kernel's
    launches on each rank in the extraction (all-gathered). Returns numpy
    arrays."""
    from nerfmlp_torch.models.mlp import NeRFMLP
    from nerfmlp_torch.ops import fused_mlp
    from nerfmlp_torch.ops.mesh import density_volume, extract_mesh

    params = {}
    for key, sd in nets.items():
        net = NeRFMLP(rc.model_config(fine=key == "fine"),
                      generator=torch.Generator()).to(mesh.device)
        net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        params[key] = net
    before = fused_mlp.fused_nerf_mlp.launches
    out = extract_mesh(params, rc, resolution=resolution,
                       threshold=threshold, density_chunk=density_chunk,
                       mesh=mesh)
    launches = torch.tensor([[float(fused_mlp.fused_nerf_mlp.launches
                                    - before)]], device=mesh.device)
    vol = density_volume(params, rc, resolution=resolution,
                         chunk=density_chunk, mesh=mesh)
    return dict({k: v for k, v in out.items()}, volume=vol,
                launches=all_gather_rows(launches, mesh).cpu().numpy()
                .astype(int).ravel().tolist())
