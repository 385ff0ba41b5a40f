"""Volume rendering: the ray -> pixel pipeline, as functions on tensors.

Counterpart of ``nerfmlp_tpu/ops/render.py``:

  * :func:`render_rays` — one batched pass over rays: stratified samples
    -> MLP -> composite, then (with ``N_importance``) inverse-CDF samples
    -> MLP -> merge by depth -> composite;
  * :func:`render_image_maps` / :func:`render_image` — whole-image
    inference as a host loop over fixed-size ray tiles.

``params`` is ``{"coarse": net, ["fine": net]}`` where a net is a
:class:`~nerfmlp_torch.models.mlp.NeRFMLP` or its kernel layout
(:class:`~nerfmlp_torch.ops.fused_mlp.PackedMLP`, see
:func:`prepare_params`). One shared net serves coarse and fine by default;
``RenderConfig.separate_fine`` switches to the two-net scheme.
Occupancy-grid sampling is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.ops.encoding import positional_encoding
from nerfmlp_torch.ops.fused_mlp import (
    PackedMLP, backward_fits, fused_nerf_mlp, kernel_fits, pack_params,
)
from nerfmlp_torch.ops.integrate import composite_rays
from nerfmlp_torch.ops.sampling import sample_pdf, stratified_sample

_OCCUPANCY = ("occupancy-grid sampling is not ported yet "
              "(ROADMAP.md, Queue 1 item 12)")


def _final_net(params: Dict, cfg: RenderConfig):
    """(net, is_fine) for the network that renders the final image."""
    net = params.get("fine") if cfg.separate_fine else None
    return (net if net is not None else params["coarse"]), net is not None


def _dtype(cfg: RenderConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _hi_lo(cfg: RenderConfig) -> bool:
    return _dtype(cfg) == torch.float32 and cfg.fp32_precision == "high"


def uses_kernel(cfg: RenderConfig, fine: bool = False,
                backward: bool = False) -> bool:
    """Whether ``cfg`` routes a net's queries through the fused kernels:
    bf16 (or fp32 'high', the kernels' hi_lo mode) and an architecture
    within the forward kernel's Hopper budget — and, for a query that is
    differentiated (``backward``), the backward's too, so that a net
    trains either wholly through the kernels or wholly on the module
    path. fp32 'highest' stays on the module path."""
    mc = cfg.model_config(fine=fine)
    hi_lo = _hi_lo(cfg)
    return (cfg.use_kernel
            and (_dtype(cfg) == torch.bfloat16 or hi_lo)
            and kernel_fits(mc, cfg.use_viewdirs, hi_lo)
            and (not backward or backward_fits(mc, cfg.use_viewdirs, hi_lo)))


def prepare_params(params: Dict, cfg: RenderConfig,
                   backward: bool = False) -> Dict:
    """Pack every net that ``cfg`` sends to the kernels (``backward``: to
    train through them), once (at service build, weight swap and train
    step, not per tile or call). Other nets pass through."""
    out = {}
    for key, net in params.items():
        fine = key == "fine" and cfg.separate_fine
        if isinstance(net, PackedMLP) or not uses_kernel(cfg, fine, backward):
            out[key] = net
        else:
            out[key] = pack_params(net, cfg.pos_enc_L, cfg.use_viewdirs,
                                   _hi_lo(cfg))
    return out


def _query_mlp(net, pts: torch.Tensor, viewdirs_enc: Optional[torch.Tensor],
               cfg: RenderConfig, fine: bool = False) -> torch.Tensor:
    """Encode points + run the MLP. pts (N, S, 3) -> raw (N, S, 4).

    ``viewdirs_enc``: (N, E) per-ray encoded directions, broadcast over
    the samples, or None. ``fine`` selects the fine net's architecture."""
    n_rays, n_samples, _ = pts.shape
    if cfg.coord_scale != 1.0:
        pts = pts * cfg.coord_scale
    flat = pts.reshape(n_rays * n_samples, 3)
    mc = cfg.model_config(fine=fine)
    dirs = None
    if viewdirs_enc is not None:
        dirs = viewdirs_enc[:, None, :].expand(
            n_rays, n_samples, viewdirs_enc.shape[-1]
        ).reshape(n_rays * n_samples, -1)
    if uses_kernel(cfg, fine, backward=torch.is_grad_enabled()):
        raw = fused_nerf_mlp(net, flat, dirs, cfg, mc=mc)
    else:
        module = net.net if isinstance(net, PackedMLP) else net
        enc = positional_encoding(flat, cfg.pos_enc_L)
        raw = module(enc, dirs, compute_dtype=_dtype(cfg))
    return raw.float().reshape(n_rays, n_samples, 4)


def _merge_by_depth(z_c, raw_c, z_f, raw_f):
    """Merge (z, raw) pairs into depth order: a stable sort of
    ``cat([z_c, z_f])`` and a gather. Stability keeps the reference's tie
    order — coarse before fine, and among fine samples the earlier index
    first (the TPU's one-hot rank contraction, ``render.py:124-171``)."""
    z = torch.cat([z_c, z_f], dim=-1)
    raw = torch.cat([raw_c, raw_f], dim=1)
    z_sorted, order = torch.sort(z, dim=-1, stable=True)
    raw_sorted = torch.gather(
        raw, 1, order[..., None].expand(-1, -1, raw.shape[-1])
    )
    return z_sorted, raw_sorted


def render_rays(
    params: Dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: RenderConfig,
    near=None,
    far=None,
    viewdirs: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Coarse(+fine) render of (N, 3) ray batches.

    Fine maps under ``rgb_map`` etc., plus ``*_coarse`` companions and
    ``z_std`` with hierarchical sampling. ``near``/``far``: scalars or
    per-ray tensors (default: the config). ``viewdirs``: optional (N, 3)
    world-space view directions (required for NDC rays), else
    normalize(rays_d). ``generator`` drives ``perturb``/``raw_noise_std``.
    """
    if cfg.use_occupancy:
        raise NotImplementedError(_OCCUPANCY)
    n_rays = rays_o.shape[0]
    near = cfg.near if near is None else near
    far = cfg.far if far is None else far
    far_cap = None
    if cfg.aabb is not None:
        from nerfmlp_torch.ops.rays import intersect_aabb

        # The last sample sits at the box exit: cap its interval at the
        # pre-tightening far instead of 1e10.
        far_cap = far
        near, far = intersect_aabb(rays_o, rays_d, cfg.aabb[:3], cfg.aabb[3:],
                                   near, far)

    viewdirs_enc = None
    if cfg.use_viewdirs:
        if cfg.ndc and viewdirs is None:
            raise ValueError(
                "cfg.ndc with use_viewdirs requires explicit world-space "
                "viewdirs: normalizing NDC-space rays_d conditions the view "
                "branch on the wrong directions"
            )
        vd = rays_d if viewdirs is None else viewdirs
        vd = vd / (torch.linalg.norm(vd, dim=-1, keepdim=True) + 1e-8)
        viewdirs_enc = positional_encoding(vd, cfg.dir_enc_L)

    # --- Coarse pass -----------------------------------------------------
    z_vals = stratified_sample(
        generator, n_rays, cfg.N_samples, near, far,
        perturb=cfg.perturb, lindisp=cfg.lindisp, device=rays_o.device,
    )
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    raw = _query_mlp(params["coarse"], pts, viewdirs_enc, cfg)
    coarse = composite_rays(raw, z_vals, rays_d, generator=generator,
                            raw_noise_std=cfg.raw_noise_std,
                            white_bkgd=cfg.white_bkgd, far_cap=far_cap)
    if cfg.N_importance <= 0:
        return {k: coarse[k]
                for k in ("rgb_map", "depth_map", "disp_map", "acc_map")}

    # --- Fine pass (hierarchical importance sampling) --------------------
    z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(
        generator, z_mids, coarse["weights"][..., 1:-1], cfg.N_importance,
        det=not cfg.perturb,
    ).detach()

    fine_net, is_fine = _final_net(params, cfg)
    if not is_fine:
        # Shared net: the coarse raw outputs at z_vals are exactly what the
        # fine pass would recompute there — query only the new depths and
        # merge into depth order.
        pts_new = rays_o[:, None, :] + rays_d[:, None, :] * z_samples[..., None]
        raw_new = _query_mlp(fine_net, pts_new, viewdirs_enc, cfg)
        z_vals_fine, raw_fine = _merge_by_depth(z_vals, raw, z_samples, raw_new)
    else:
        z_vals_fine, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                                    dim=-1)
        pts_fine = (rays_o[:, None, :]
                    + rays_d[:, None, :] * z_vals_fine[..., None])
        raw_fine = _query_mlp(fine_net, pts_fine, viewdirs_enc, cfg, fine=True)
    fine = composite_rays(raw_fine, z_vals_fine, rays_d, generator=generator,
                          raw_noise_std=cfg.raw_noise_std,
                          white_bkgd=cfg.white_bkgd, far_cap=far_cap)
    return {
        "rgb_map": fine["rgb_map"],
        "depth_map": fine["depth_map"],
        "disp_map": fine["disp_map"],
        "acc_map": fine["acc_map"],
        "rgb_map_coarse": coarse["rgb_map"],
        "depth_map_coarse": coarse["depth_map"],
        "disp_map_coarse": coarse["disp_map"],
        "acc_map_coarse": coarse["acc_map"],
        "z_std": torch.std(z_samples, dim=-1, correction=0),
    }


def render_image_maps(
    params: Dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    H: int,
    W: int,
    cfg: RenderConfig,
    tile: int = 4096,
    near=None,
    far=None,
    viewdirs: Optional[torch.Tensor] = None,
    maps: Tuple[str, ...] = ("rgb_map",),
) -> Dict[str, torch.Tensor]:
    """Whole-image inference: (H*W, 3) rays -> requested (H, W, ...) maps.

    Deterministic (perturb and noise forced off). Rays are padded to a
    multiple of ``tile`` and rendered tile by tile on the rays' device,
    without autograd; per-ray near/far tensors are padded like the rays."""
    if cfg.use_occupancy:
        raise NotImplementedError(_OCCUPANCY)
    cfg = dataclasses.replace(cfg, perturb=False, raw_noise_std=0.0)
    n_rays = rays_o.shape[0]
    n_tiles = -(-n_rays // tile)
    pad = n_tiles * tile - n_rays
    # Pad with a valid direction: no 0-norm viewdirs on padded lanes.
    down = torch.tensor([0.0, 0.0, -1.0], device=rays_d.device,
                        dtype=rays_d.dtype).expand(pad, 3)
    rays_o = torch.cat([rays_o, torch.zeros_like(down)], dim=0)
    rays_d = torch.cat([rays_d, down], dim=0)
    if viewdirs is not None:
        viewdirs = torch.cat([viewdirs, down], dim=0)

    def bound(b, default, fill):
        b = torch.as_tensor(default if b is None else b, dtype=torch.float32,
                            device=rays_o.device)
        if b.dim() == 0:
            return b
        return torch.cat([b, b.new_full((pad,), fill)])

    near_t = bound(near, cfg.near, 1.0)
    far_t = bound(far, cfg.far, 2.0)

    def piece(t, i):
        return t if t is None or t.dim() == 0 else t[i * tile:(i + 1) * tile]

    outs = []
    with torch.no_grad():
        for i in range(n_tiles):
            out = render_rays(
                params, piece(rays_o, i), piece(rays_d, i), None, cfg,
                near=piece(near_t, i), far=piece(far_t, i),
                viewdirs=piece(viewdirs, i),
            )
            outs.append({k: out[k] for k in maps})
    result = {}
    for key in maps:
        flat = torch.cat([o[key] for o in outs], dim=0)[:n_rays]
        result[key] = flat.reshape((H, W) + tuple(flat.shape[1:]))
    return result


def render_image(params: Dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 H: int, W: int, cfg: RenderConfig, tile: int = 4096,
                 near=None, far=None,
                 viewdirs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H*W, 3) rays -> (H, W, 3) rgb (see :func:`render_image_maps`)."""
    return render_image_maps(params, rays_o, rays_d, H, W, cfg, tile=tile,
                             near=near, far=far, viewdirs=viewdirs,
                             maps=("rgb_map",))["rgb_map"]
