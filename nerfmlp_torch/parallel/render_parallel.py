"""Whole frames rendered over several devices.

Counterpart of ``nerfmlp_tpu/parallel/render_parallel.py:35-134``. Rays
are independent, so a frame scales by dealing its pixel grid over the
devices and gathering the tiles: the parameters (and the occupancy grid)
are replicated, and every ray's samples stay on its device. As in JAX,
``tile`` is the PER-DEVICE tile: rays are padded to a multiple of ``tile``
x the device count, and super-tile ``i`` gives device ``j`` its rays
``[(i n + j) tile, (i n + j + 1) tile)``, which it renders with the local
renderer (``ops/render.py::render_image_maps``). Each ray is computed as
the local renderer computes it in a tile of its own size, so on one kind
of card the frame is the local one, bit for bit.

Two ways to hold the devices:

  * a :class:`~nerfmlp_torch.parallel.mesh.Mesh` of ranks (the Trainer's):
    each rank renders its own tiles with its own replica, and the tiles
    are gathered to every rank (``all_gather_rows``; gloo through the
    host);
  * a list of devices driven from this one process (the CLIs and the
    server, JAX's single controller), or their :class:`Replicas`, made
    once per weights by :func:`replicate`: the devices' tiles are queued
    one device after the other, and gathered on the rays' device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.parallel.mesh import Mesh, all_gather_rows


@dataclasses.dataclass(frozen=True)
class Replicas:
    """Nets (packed as ``cfg`` sends them to the kernels) and occupancy
    grid placed on each device of ``devices`` (a device may repeat)."""

    devices: Tuple[torch.device, ...]
    params: Dict[torch.device, Dict]
    grids: Dict[torch.device, object]


def _params_device(params: Dict) -> torch.device:
    net = next(iter(params.values()))
    return next(getattr(net, "net", net).parameters()).device


def replicate(params: Dict, cfg: RenderConfig, devices: Sequence,
              occ_grid=None) -> Replicas:
    """``params`` (modules or packed) and ``occ_grid`` on every device of
    ``devices``: the nets' own device reuses them; another gets a copy of
    the modules, packed there."""
    from nerfmlp_torch.ops.fused_mlp import PackedMLP
    from nerfmlp_torch.ops.occupancy import OccupancyGrid
    from nerfmlp_torch.ops.render import prepare_params

    devices = tuple(torch.device(d) for d in devices)
    home = _params_device(params)
    reps, grids = {}, {}
    for dev in devices:
        if dev in reps:
            continue
        if dev == home:
            reps[dev] = prepare_params(params, cfg)
            grids[dev] = occ_grid
            continue
        nets = {k: copy.deepcopy(net.net if isinstance(net, PackedMLP)
                                 else net).to(dev)
                for k, net in params.items()}
        reps[dev] = prepare_params(nets, cfg)
        grids[dev] = None if occ_grid is None else OccupancyGrid(
            density=occ_grid.density.to(dev))
    return Replicas(devices=devices, params=reps, grids=grids)


def data_parallel_mesh(mesh):
    """``mesh`` if frames can shard over it: a :class:`Mesh` of more than
    one rank with no "model" axis, or more than one device (a sequence or
    :class:`Replicas`); else ``None`` (render locally: under tensor
    parallelism each rank renders with the gathered nets, as JAX's
    ``data_parallel_mesh`` keeps a ("data", "model") mesh's render local)."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return (mesh if mesh.world_size > 1 and mesh.model_parallel == 1
                else None)
    devices = mesh.devices if isinstance(mesh, Replicas) else tuple(mesh)
    return mesh if len(devices) > 1 else None


def _as_tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
        a, torch.Tensor) else a, dtype=torch.float32, device=device)


def _deal(t: Optional[torch.Tensor], n_dev: int, tile: int, j: int):
    """Device ``j``'s rays of a padded (n_super * n_dev * tile, ...) array:
    its tile of every super-tile, in order. 0-d and None pass through."""
    if t is None or t.dim() == 0:
        return t
    n_super = t.shape[0] // (n_dev * tile)
    return t.reshape((n_super, n_dev, tile) + t.shape[1:])[:, j].reshape(
        (n_super * tile,) + t.shape[1:])


def render_image_sharded(
    params: Dict,
    rays_o,
    rays_d,
    H: int,
    W: int,
    cfg: RenderConfig,
    mesh,
    tile: int = 4096,
    near=None,
    far=None,
    occ_grid=None,
    viewdirs=None,
    maps: Tuple[str, ...] = ("rgb_map",),
) -> Dict[str, torch.Tensor]:
    """(H*W, 3) rays (tensors or numpy) -> the requested (H, W, ...) maps,
    rendered over ``mesh``: a :class:`Mesh` of ranks (each renders its
    tiles with its own ``params`` and ``occ_grid``; every rank gets the
    frame, on its device), or a sequence of devices / their
    :class:`Replicas` (``params`` and ``occ_grid`` copied to them, or
    taken from the replicas; the frame lands on the rays' device, or the
    first device for host rays). ``tile``: rays per device per super-tile.
    Deterministic, as ``render_image_maps`` is; ``near`` / ``far``:
    scalars or per-ray."""
    from nerfmlp_torch.ops.render import prepare_params, render_image_maps

    ranks = isinstance(mesh, Mesh)
    if ranks:
        n_dev, out_dev = mesh.world_size, mesh.device
        params = prepare_params(params, cfg)
    else:
        if not isinstance(mesh, Replicas):
            mesh = replicate(params, cfg, mesh, occ_grid)
        n_dev = len(mesh.devices)
        out_dev = (rays_o.device if isinstance(rays_o, torch.Tensor)
                   else mesh.devices[0])
    cfg = dataclasses.replace(cfg, perturb=False, raw_noise_std=0.0)
    rays_o, rays_d = _as_tensor(rays_o, out_dev), _as_tensor(rays_d, out_dev)
    viewdirs = _as_tensor(viewdirs, out_dev)
    n_rays = rays_o.shape[0]
    super_tile = tile * n_dev
    pad = -(-n_rays // super_tile) * super_tile - n_rays
    # Padded lanes as the local renderer pads them: o = 0, a valid
    # direction, near 1 / far 2.
    down = torch.tensor([0.0, 0.0, -1.0], device=out_dev).expand(pad, 3)
    rays_o = torch.cat([rays_o, torch.zeros_like(down)])
    rays_d = torch.cat([rays_d, down])
    if viewdirs is not None:
        viewdirs = torch.cat([viewdirs, down])

    def bound(b, fill):
        if b is None:
            return None
        b = _as_tensor(b, out_dev)
        return b if b.dim() == 0 else torch.cat([b, b.new_full((pad,),
                                                               fill)])

    near, far = bound(near, 1.0), bound(far, 2.0)

    shapes = {}   # each map's shape per ray

    def render_on(j: int, dev, nets, grid) -> torch.Tensor:
        """Device ``j``'s tiles, (rows, C) with the maps side by side."""
        mine = [None if t is None else _deal(t, n_dev, tile, j).to(dev)
                for t in (rays_o, rays_d, near, far, viewdirs)]
        o, d, nr, fr, vd = mine
        out = render_image_maps(nets, o, d, o.shape[0], 1, cfg, tile=tile,
                                near=nr, far=fr, occ_grid=grid, viewdirs=vd,
                                maps=tuple(maps))
        shapes.update({k: tuple(v.shape[2:]) for k, v in out.items()})
        return torch.cat([out[k].reshape(o.shape[0], -1).float()
                          for k in maps], dim=1)

    if ranks:
        local = render_on(mesh.rank, mesh.device, params, occ_grid)
        every = all_gather_rows(local, mesh)          # rank-major
    else:
        every = torch.cat([
            render_on(j, dev, mesh.params[dev], mesh.grids[dev]).to(out_dev)
            for j, dev in enumerate(mesh.devices)])
    cols = every.shape[1]
    # Rank-major (device, super-tile, tile) back to pixel order.
    flat = every.reshape(n_dev, -1, tile, cols).transpose(0, 1).reshape(
        -1, cols)[:n_rays]
    result, c = {}, 0
    for key in maps:
        width = int(np.prod(shapes[key], dtype=np.int64))
        result[key] = flat[:, c:c + width].reshape((H, W) + shapes[key])
        c += width
    return result
