"""The plain reference of the NeRF step and frame, in float32 PyTorch.

Written from the equations of Mildenhall et al. (ECCV 2020) and of the
NerfAcc occupancy grid (Li et al., arXiv:2210.04847) as the recipes of
this benchmark's configurations state them, independent of the program
under test: no import of it, no call into it. Every function takes plain
tensors; the caller keeps TF32 off (:func:`true_fp32`).

``quant``, where a function takes it, rounds the operands of every matrix
product (the precision control: :mod:`benchmark.reference.fp8`); ``None``
is plain float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

Quant = Optional[Callable]


def true_fp32() -> None:
    """Float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ #
# The network
# ------------------------------------------------------------------ #
def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)],
    each block over all of x's channels; no factor of pi."""
    parts = [x]
    for k in range(n_freqs):
        f = float(2.0 ** k)
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def layer_names(depth: int):
    """The net's dense layers in order: the trunk, then the heads."""
    return ([f"pts_linears.{i}" for i in range(depth)]
            + ["sigma_linear", "bottleneck_linear", "view_linear",
               "rgb_linear"])


def _dense(w: Dict, name: str, h: torch.Tensor, quant: Quant):
    weight, bias = w[f"{name}.weight"], w[f"{name}.bias"]
    if quant is not None:
        return quant(h, weight) + bias
    return h @ weight.t() + bias


def mlp(w: Dict, x_enc: torch.Tensor, d_enc: torch.Tensor, depth: int,
        skips=(5,), quant: Quant = None) -> torch.Tensor:
    """(N, 4) raw outputs [rgb logits, sigma] of the view-dependent NeRF
    net: ``depth`` ReLU layers with the encoded point concatenated before
    each layer of ``skips``; sigma from the trunk, rgb from a bottleneck
    joined with the encoded direction through one ReLU layer."""
    h = x_enc
    for i in range(depth):
        if i in skips:
            h = torch.cat([x_enc, h], dim=-1)
        h = torch.relu(_dense(w, f"pts_linears.{i}", h, quant))
    sigma = _dense(w, "sigma_linear", h, quant)
    b = _dense(w, "bottleneck_linear", h, quant)
    v = torch.relu(_dense(w, "view_linear", torch.cat([b, d_enc], -1), quant))
    return torch.cat([_dense(w, "rgb_linear", v, quant), sigma], dim=-1)


def query(w: Dict, cfg: Dict, pts: torch.Tensor, dirs: torch.Tensor,
          quant: Quant = None, chunk: int = 1 << 20) -> torch.Tensor:
    """raw (N, S, 4) of the net at points (N, S, 3), each ray's unit
    direction (N, 3) broadcast over its samples; in chunks of points."""
    n, s, _ = pts.shape
    flat = pts.reshape(n * s, 3)
    d = encode(dirs, cfg["dir_enc_L"])[:, None, :].expand(n, s, -1)
    d = d.reshape(n * s, -1)
    out = [mlp(w, encode(flat[i:i + chunk], cfg["pos_enc_L"]),
               d[i:i + chunk], cfg["depth"], tuple(cfg["skips"]), quant)
           for i in range(0, n * s, chunk)]
    return torch.cat(out).reshape(n, s, 4)


# ------------------------------------------------------------------ #
# Sampling and compositing
# ------------------------------------------------------------------ #
def unit_steps(n: int, device) -> torch.Tensor:
    """i / (n - 1) for i < n, in float32, ending at exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * (
        torch.ones((), device=device) / (n - 1))
    t[-1] = 1.0
    return t


def per_ray(v, n: int, device) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v.expand(n)[:, None] if v.dim() == 0 else v.reshape(n, 1)


def stratified(n_rays: int, n: int, near, far, u: Optional[torch.Tensor],
               device) -> torch.Tensor:
    """Depths linear in [near, far]; with ``u`` each jittered uniformly
    inside its stratum, whose edges are the midpoints."""
    t = unit_steps(n, device)
    z = per_ray(near, n_rays, device) * (1 - t) + per_ray(far, n_rays,
                                                          device) * t
    z = z.expand(n_rays, n)
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               u: Optional[torch.Tensor], stratified_u: bool = False
               ) -> torch.Tensor:
    """Inverse-CDF depths over the piecewise-constant density ``weights``
    (+1e-5) between ``bins``. ``u`` None: evenly spaced u over [0, 1];
    ``stratified_u``: u jittered inside n equal strata of [0, 1)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    -1)
    if u is None:
        u = unit_steps(n, cdf.device).expand(cdf.shape[0], n)
    elif stratified_u:
        u = torch.arange(n, dtype=torch.float32, device=cdf.device) / n \
            + u / n
    m = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo, hi = torch.clamp(idx - 1, min=0), torch.clamp(idx, max=m - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    denom = c_hi - c_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b_lo + (u - c_lo) / denom * (b_hi - b_lo)


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor,
              white_bkgd: bool, far_cap=None) -> Dict[str, torch.Tensor]:
    """Alpha compositing: alpha_i = 1 - exp(-relu(sigma_i) dist_i), the
    last interval 1e10 long (or up to ``far_cap``), distances scaled by
    |d|, T_i = prod_{j<i} (1 - alpha_j + 1e-10)."""
    d = z[:, 1:] - z[:, :-1]
    if far_cap is None:
        last = torch.full_like(d[:, :1], 1e10)
    else:
        cap = per_ray(far_cap, z.shape[0], z.device)
        last = torch.clamp(cap - z[:, -1:], min=0.0)
    d = torch.cat([d, last], -1) * torch.linalg.norm(rays_d, dim=-1)[:, None]
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * d)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    wts = alpha * trans
    rgb = (wts[..., None] * torch.sigmoid(raw[..., :3])).sum(1)
    acc = wts.sum(-1)
    if white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "weights": wts}


def merge_by_depth(z_a, raw_a, z_b, raw_b):
    """Both sample sets in depth order (ties: the first set first)."""
    z = torch.cat([z_a, z_b], -1)
    raw = torch.cat([raw_a, raw_b], 1)
    z, order = torch.sort(z, dim=-1, stable=True)
    return z, raw.gather(1, order[..., None].expand(-1, -1, 4))


def box_bounds(rays_o, rays_d, aabb, near: float, far: float):
    """Per-ray [near, far] clipped to the box by the slab test; a ray that
    misses keeps [near, far]; at least 1e-3 long."""
    lo = torch.tensor(aabb[:3], dtype=torch.float32, device=rays_o.device)
    hi = torch.tensor(aabb[3:], dtype=torch.float32, device=rays_o.device)
    inv = 1.0 / torch.where(rays_d.abs() < 1e-10,
                            torch.full_like(rays_d, 1e-10), rays_d)
    t0, t1 = (lo - rays_o) * inv, (hi - rays_o) * inv
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    hit = t_far > torch.clamp(t_near, min=0.0)
    n = torch.where(hit, t_near.clamp(near, far), torch.full_like(t_near,
                                                                  near))
    f = torch.where(hit, t_far.clamp(near, far), torch.full_like(t_far, far))
    return n, torch.maximum(f, n + 1e-3)


# ------------------------------------------------------------------ #
# The occupancy grid
# ------------------------------------------------------------------ #
def grid_points(g: int, aabb, jitter: torch.Tensor) -> torch.Tensor:
    """The G^3 cells (i, j, k in row-major order) at their jittered
    positions inside the box."""
    idx = torch.arange(g, dtype=torch.float32, device=jitter.device)
    cells = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"),
                        -1).reshape(-1, 3)
    lo = torch.tensor(aabb[:3], dtype=torch.float32, device=jitter.device)
    hi = torch.tensor(aabb[3:], dtype=torch.float32, device=jitter.device)
    return lo + (cells + jitter) / g * (hi - lo)


def grid_refresh(density: torch.Tensor, w: Dict, cfg: Dict,
                 jitter: torch.Tensor, decay: float,
                 quant: Quant = None) -> torch.Tensor:
    """max(density * decay, relu(sigma)) at the jittered cells, sigma
    queried along the direction (0, 0, -1)."""
    g = density.shape[-1]
    pts = grid_points(g, cfg["aabb"], jitter)
    dirs = torch.tensor([[0.0, 0.0, -1.0]], device=pts.device).expand(
        pts.shape[0], 3)
    with torch.no_grad():
        sigma = torch.relu(query(w, cfg, pts[:, None], dirs, quant)[:, 0, 3])
    return torch.maximum(density * decay, sigma.reshape(density.shape))


def occupancy_prior(density: torch.Tensor, pts: torch.Tensor, aabb,
                    threshold: float) -> torch.Tensor:
    """1 + 1e-3 where the point's cell (nearest, truncated) is occupied,
    1e-3 where not, 0 density outside the box (upper faces outside); a
    ray that meets no occupied cell gets uniform weights."""
    g = density.shape[-1]
    lo = torch.tensor(aabb[:3], dtype=torch.float32, device=pts.device)
    hi = torch.tensor(aabb[3:], dtype=torch.float32, device=pts.device)
    p01 = (pts - lo) / (hi - lo)
    inside = ((p01 >= 0) & (p01 < 1)).all(-1)
    c = torch.clamp((p01 * g).to(torch.int32), 0, g - 1).long()
    dens = density.reshape(-1)[(c[..., 0] * g + c[..., 1]) * g + c[..., 2]]
    occ = (torch.where(inside, dens, torch.zeros_like(dens))
           > threshold).float()
    hit = occ.bool().any(-1, keepdim=True)
    return torch.where(hit, occ + 1e-3, torch.ones_like(occ))


# ------------------------------------------------------------------ #
# A batch of rays
# ------------------------------------------------------------------ #
def render(w: Dict, cfg: Dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
           draw: Optional[Callable], density: Optional[torch.Tensor] = None,
           quant: Quant = None) -> torch.Tensor:
    """rgb (N, 3) of the recipe's render: ``draw(shape)`` gives the
    uniforms in the order the recipe consumes them (None: deterministic
    depths). Hierarchical: N_samples stratified, N_importance more from
    the coarse weights, the net queried at the new depths only and
    merged. Occupancy (``density``): occ_dense_samples stratified depths
    scored by the grid, N_samples probes from that prior, N_importance
    more from the probes' weights, merged."""
    n = rays_o.shape[0]
    dev = rays_o.device
    dirs = rays_d / (torch.linalg.norm(rays_d, dim=-1, keepdim=True) + 1e-8)
    near, far, cap = cfg["near"], cfg["far"], None
    if cfg.get("aabb") is not None:
        cap = far
        near, far = box_bounds(rays_o, rays_d, cfg["aabb"], near, far)

    def u(shape):
        return None if draw is None else draw(shape)

    def at(z):
        return rays_o[:, None] + rays_d[:, None] * z[..., None]

    white = cfg["white_bkgd"]
    if cfg.get("use_occupancy"):
        m = cfg["occ_dense_samples"]
        z_dense = stratified(n, m, near, far, u((n, m)), dev)
        prior = occupancy_prior(density, at(z_dense), cfg["aabb"],
                                cfg["occ_threshold"])
        w_int = 0.5 * (prior[:, 1:] + prior[:, :-1])
        ns, ni = cfg["N_samples"], cfg["N_importance"]
        z_p = sample_pdf(z_dense, w_int, ns, u((n, ns)),
                         stratified_u=True).detach()
        raw_p = query(w, cfg, at(z_p), dirs, quant)
        probe = composite(raw_p, z_p, rays_d, white, cap)
        mids = 0.5 * (z_p[:, 1:] + z_p[:, :-1])
        z_n = sample_pdf(mids, probe["weights"][:, 1:-1].detach(), ni,
                         u((n, ni))).detach()
        z, raw = merge_by_depth(z_p, raw_p, z_n,
                                query(w, cfg, at(z_n), dirs, quant))
        return composite(raw, z, rays_d, white, cap)["rgb"]
    ns, ni = cfg["N_samples"], cfg["N_importance"]
    z_c = stratified(n, ns, near, far, u((n, ns)), dev)
    raw_c = query(w, cfg, at(z_c), dirs, quant)
    coarse = composite(raw_c, z_c, rays_d, white, cap)
    mids = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    z_f = sample_pdf(mids, coarse["weights"][:, 1:-1], ni,
                     u((n, ni))).detach()
    z, raw = merge_by_depth(z_c, raw_c, z_f,
                            query(w, cfg, at(z_f), dirs, quant))
    return composite(raw, z, rays_d, white, cap)["rgb"]


# ------------------------------------------------------------------ #
# The update
# ------------------------------------------------------------------ #
class Adam:
    """Adam as optax's ``adam`` then ``-lr``: b1 0.9, b2 0.999, eps 1e-8
    outside the root, bias correction from the update count; the rate of
    update k (k updates before it) is lr * rate ** (k / steps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 rate: float, steps: float):
        self.lr, self.rate, self.steps = lr, rate, steps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict) -> None:
        lr = self.lr * self.rate ** (self.count / self.steps)
        self.count += 1
        bc1 = 1 - 0.9 ** self.count
        bc2 = 1 - 0.999 ** self.count
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + 1e-8)
            params[k].sub_(lr * upd)


def clip_by_global_norm(grads: Dict, clip: float) -> None:
    """g * min(1, clip / |g|) over all gradients together; off at 0."""
    if clip <= 0:
        return
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in
                         grads.values()))
    if norm > clip:
        for g in grads.values():
            g.mul_(clip / norm)


def train_step(w: Dict, opt: Adam, cfg: Dict, batch: torch.Tensor,
               draw: Callable, density=None, quant: Quant = None,
               clip: float = 0.0):
    """One step in place on ``w``: the mean squared error of the rendered
    colour against the batch's last three columns, its gradient by
    autograd, the clip, Adam. Returns (loss, the gradients as Adam got
    them)."""
    for v in w.values():
        v.requires_grad_(True)
        v.grad = None
    rgb = render(w, cfg, batch[:, 0:3], batch[:, 3:6], draw, density, quant)
    loss = torch.mean((rgb - batch[:, -3:]) ** 2)
    loss.backward()
    grads = {k: v.grad.detach().clone() for k, v in w.items()}
    for v in w.values():
        v.requires_grad_(False)
        v.grad = None
    clip_by_global_norm(grads, clip)
    opt.step(w, grads)
    return loss.item(), grads


# ------------------------------------------------------------------ #
# Cameras
# ------------------------------------------------------------------ #
def pose_spherical(theta_deg: float, phi_deg: float, radius: float
                   ) -> np.ndarray:
    """The Blender test orbit's camera-to-world (4, 4) float32: azimuth
    theta, elevation phi, distance radius, looking at the origin, built
    in float32 in the order flip @ rot_y @ rot_x @ translate (rays on a
    box face flip in or out of the box with their last bit)."""
    f32 = np.float32
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    t = np.eye(4, dtype=f32)
    t[2, 3] = radius
    rx = np.eye(4, dtype=f32)
    rx[1, 1] = rx[2, 2] = np.cos(ph)
    rx[1, 2], rx[2, 1] = -np.sin(ph), np.sin(ph)
    ry = np.eye(4, dtype=f32)
    ry[0, 0] = ry[2, 2] = np.cos(th)
    ry[0, 2], ry[2, 0] = -np.sin(th), np.sin(th)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], dtype=f32)
    return flip @ ry @ rx @ t


def camera_rays(h: int, w: int, focal: float, c2w, device):
    """(H W, 3) origins and directions of a pinhole camera looking down its
    -z axis, pixel (i, j) through ((i - W/2) / f, -(j - H/2) / f, -1),
    turned by the camera's rotation in one float32 product."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs = torch.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal,
                        -torch.ones_like(i)], -1)
    d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3]).reshape(-1, 3)
    return c2w[:3, 3].expand(d.shape), d
