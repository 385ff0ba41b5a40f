"""Occupancy-grid sampling: a cached density grid in place of the coarse
MLP pass.

Counterpart of ``nerfmlp_tpu/ops/occupancy.py``:

  1. a G^3 grid of densities over the scene box (``RenderConfig.aabb``),
     refreshed every ``occ_update_every`` training steps by querying the
     net's sigma at jittered cell centres (:func:`update_grid`);
  2. at render time, ``occ_dense_samples`` stratified depths per ray are
     scored by a grid lookup (:func:`occupancy_weights`, no MLP), and the
     inverse-CDF sampler places the real samples in occupied space
     (``ops/render.py``).

Several scenes trained together (``parallel/multi_scene.py``) keep one
grid per scene, stacked: a (S, G, G, G) density
(:func:`create_multi_scene_grids`). Their lookups take scene-major rays,
scene s's rows in grid s, and a refresh queries all S x G^3 cell points
in one batched call, each scene's with its own net and its own jitter.

The grid is model state, not a parameter: no gradient flows through it.
Random jitter comes from an explicit ``torch.Generator``, or is passed in
as ``jitter`` so tests can feed both packages the same numbers. A refresh
runs without autograd on nets packed by ``prepare_params`` (its forward
kernel alone on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.ops import device_constant

# The constant view direction of a density query: sigma does not depend
# on it, and the net's view head needs one.
_QUERY_DIR = (0.0, 0.0, -1.0)


@dataclasses.dataclass
class OccupancyGrid:
    """Density field over the box: a (G, G, G) fp32 tensor on its device;
    (S, G, G, G) for a stack of one grid per scene."""

    density: torch.Tensor

    @property
    def resolution(self) -> int:
        return self.density.shape[-1]

    @property
    def n_scenes(self) -> int:
        """Grids of the stack, 1 for a single grid."""
        return self.density.shape[0] if self.density.dim() == 4 else 1


def create_grid(resolution: int = 64, init_density: float = 0.02,
                device=None) -> OccupancyGrid:
    """A fresh grid just above the default occupancy threshold (1e-2), so
    early training samples everywhere, while an empty cell decays below it
    within ~14 refreshes (0.95^14 * 0.02 < 1e-2). On ``device``, default
    ``cuda`` (:func:`nerfmlp_torch.resolve_device`)."""
    return OccupancyGrid(density=torch.full((resolution,) * 3, init_density,
                                            dtype=torch.float32,
                                            device=resolve_device(device)))


def create_multi_scene_grids(n_scenes: int, rc: RenderConfig,
                             device=None) -> OccupancyGrid:
    """Stacked fresh per-scene grids, (n_scenes, G, G, G), G =
    ``rc.occ_grid_size`` (:func:`create_grid`'s density)."""
    return OccupancyGrid(density=torch.stack([
        create_grid(rc.occ_grid_size, device=device).density
        for _ in range(n_scenes)]))


def _box(aabb, device):
    """The box's (min, max) corners on ``device``, copied once
    (:func:`~nerfmlp_torch.ops.device_constant`)."""
    return tuple(device_constant(tuple(float(v) for v in corner),
                                 torch.float32, torch.device(device))
                 for corner in (aabb[:3], aabb[3:]))


def _cell_centers(resolution: int, aabb,
                  jitter: Optional[torch.Tensor], device) -> torch.Tensor:
    """(G^3, 3) points: cell corners ("ij" order) plus ``jitter`` (G^3, 3)
    in [0, 1), or the cell centres when None; (S G^3, 3) for S scenes'
    jitter, scene-major."""
    box_min, box_max = _box(aabb, device)
    idx = torch.arange(resolution, dtype=torch.float32, device=device)
    ii, jj, kk = torch.meshgrid(idx, idx, idx, indexing="ij")
    cells = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)
    if jitter is not None and jitter.shape[0] != cells.shape[0]:
        cells = cells.repeat(jitter.shape[0] // cells.shape[0], 1)
    offset = 0.5 if jitter is None else jitter
    pts01 = (cells + offset) / resolution
    return box_min + pts01 * (box_max - box_min)


def update_grid(grid: OccupancyGrid, params: Dict, cfg: RenderConfig,
                generator: Optional[torch.Generator] = None,
                decay: float = 0.95,
                jitter: Optional[torch.Tensor] = None) -> OccupancyGrid:
    """One refresh: ``max(density * decay, relu(sigma(x)))`` at jittered
    cell centres (NerfAcc's rule). ``params`` is the renderer's dict; sigma
    comes from the net the occupancy path renders with, at its own
    architecture, through one query of G^3 points with one sample each and
    the constant direction [0, 0, -1]. ``jitter``: (G^3, 3) uniforms, else
    drawn from ``generator`` on the grid's device.

    A stack of grids takes the renderer's dict of stacked nets and one
    generator per scene (or (S G^3, 3) jitter, scene-major): one query of
    S x G^3 points, scene s's cells through its own net — one launch of
    the forward kernel for every scene."""
    from nerfmlp_torch.ops.encoding import positional_encoding
    from nerfmlp_torch.ops.render import _final_net, _query_mlp, prepare_params

    from nerfmlp_torch.ops import draw

    g = grid.resolution
    dev = grid.density.device
    n = grid.n_scenes * g ** 3
    if jitter is None:
        if generator is None:
            raise ValueError("update_grid needs a generator or jitter")
        jitter = draw(generator, (n, 3), dev)
    pts = _cell_centers(g, cfg.aabb, jitter.to(dev), dev)
    with torch.no_grad():
        # The net the occupancy render path queries: the fine net under
        # separate_fine, else the shared one.
        net, fine = _final_net(prepare_params(params, cfg), cfg)
        dirs_enc = None
        if cfg.use_viewdirs:
            const_dir = device_constant(_QUERY_DIR, torch.float32,
                                        dev).expand(n, 3)
            dirs_enc = positional_encoding(const_dir, cfg.dir_enc_L)
        raw = _query_mlp(net, pts[:, None, :], dirs_enc, cfg, fine=fine)
        sigma = torch.relu(raw[:, 0, 3]).reshape(grid.density.shape)
        return OccupancyGrid(density=torch.maximum(grid.density * decay,
                                                   sigma))


def build_grid(params: Dict, cfg: RenderConfig,
               generator: Optional[torch.Generator] = None,
               resolution: int = 64, refreshes: int = 4,
               jitters: Optional[Sequence[torch.Tensor]] = None
               ) -> OccupancyGrid:
    """A grid from trained weights, for a process with no training loop
    (serving): zero density, then the running max over ``refreshes``
    jittered queries (``update_grid`` with decay 1), so cells the model
    leaves empty skip. ``jitters``: one (G^3, 3) tensor per refresh, else
    drawn from ``generator``. The grid lies on the nets' device."""
    from nerfmlp_torch.ops.fused_mlp import PackedMLP
    from nerfmlp_torch.ops.render import _final_net, prepare_params

    params = prepare_params(params, cfg)   # packed once for all refreshes
    net, _ = _final_net(params, cfg)
    net = net.net if isinstance(net, PackedMLP) else net
    grid = OccupancyGrid(density=torch.zeros(
        (resolution,) * 3, dtype=torch.float32,
        device=next(net.parameters()).device))
    for i in range(refreshes if jitters is None else len(jitters)):
        grid = update_grid(grid, params, cfg, generator, decay=1.0,
                           jitter=None if jitters is None else jitters[i])
    return grid


def lookup(grid: OccupancyGrid, pts: torch.Tensor, aabb) -> torch.Tensor:
    """Nearest-cell density at (..., 3) points; 0 outside the box (the
    upper faces are outside: ``< 1``). A stack of S grids takes
    scene-major points: leading row i in grid i // (rows / S)."""
    box_min, box_max = _box(aabb, pts.device)
    g = grid.resolution
    pts01 = (pts - box_min) / (box_max - box_min)
    inside = ((pts01 >= 0.0) & (pts01 < 1.0)).all(dim=-1)
    # Truncating cast, as the reference's astype(int32).
    cells = torch.clamp((pts01 * g).to(torch.int32), 0, g - 1).long()
    flat = (cells[..., 0] * g + cells[..., 1]) * g + cells[..., 2]
    if grid.n_scenes > 1:
        rows = pts.shape[0]
        scene = torch.arange(rows, device=pts.device) // (rows // grid.n_scenes)
        flat = flat + (scene * g ** 3).view((rows,) + (1,) * (flat.dim() - 1))
    dens = grid.density.reshape(-1)[flat]
    return torch.where(inside, dens, torch.zeros_like(dens))


def occupancy_weights(grid: OccupancyGrid, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, z_vals: torch.Tensor,
                      cfg: RenderConfig,
                      occ_threshold: float = 1e-2) -> torch.Tensor:
    """Sampling prior over dense depths (N, M): 1 + 1e-3 at occupied cells,
    1e-3 at empty ones; a ray that crosses no occupied cell gets uniform
    weights (else the inverse CDF would follow numerical noise)."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dens = lookup(grid, pts, cfg.aabb)
    occ = (dens > occ_threshold).float()
    any_hit = (occ > 0).any(dim=-1, keepdim=True)
    return torch.where(any_hit, occ + 1e-3, torch.ones_like(occ))
