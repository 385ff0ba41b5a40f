"""Ray-depth sampling: stratified coarse bins + inverse-CDF fine sampling.

Counterpart of ``nerfmlp_tpu/ops/sampling.py:22-130``: the same ``+1e-5``
on the weights, the same denominator floor (below 1e-5 it becomes 1), and
the same right-side search, ``#{j : cdf_j <= u}``. The TPU's one-hot
contractions become ``torch.searchsorted(..., right=True)`` and
``torch.gather``. Random draws come from an explicit ``torch.Generator`` (or one per scene
for scene-major rays, :func:`nerfmlp_torch.ops.draw`), or are passed in as
``u`` so tests can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerfmlp_torch.ops import device_scalar, draw


def _linspace01(n: int, device) -> torch.Tensor:
    """The float32 values of ``jnp.linspace(0, 1, n)``: ``i * fl(1/(n-1))``
    with the end exactly 1. ``torch.linspace`` lands an ulp away at some
    points, and a bf16 rounding downstream can turn that ulp into a
    visible difference from the reference."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.ones((), dtype=torch.float32, device=device) / (n - 1)
    t = torch.arange(n, device=device, dtype=torch.float32) * step
    t[-1:].fill_(1.0)   # a fill on the device: no host copy (graph-safe)
    return t


def _per_ray(v, n_rays: int, device) -> torch.Tensor:
    v = device_scalar(v, torch.float32, device)
    return v.expand(n_rays)[:, None] if v.dim() == 0 else v.reshape(n_rays, 1)


def stratified_sample(
    generator: Optional[torch.Generator],
    n_rays: int,
    n_samples: int,
    near,
    far,
    perturb: bool = True,
    lindisp: bool = False,
    u: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Coarse z-values, (n_rays, n_samples).

    Linear in depth, or in disparity with ``lindisp``. With ``perturb``
    each z is drawn uniformly inside its stratum (edges at the midpoints),
    from ``u`` when given, else from ``generator``. ``near``/``far`` are
    scalars or per-ray (n_rays,) tensors; ``device`` defaults to theirs.
    """
    if device is None:
        device = next((v.device for v in (near, far, u)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    t_vals = _linspace01(n_samples, device)
    near = _per_ray(near, n_rays, device)
    far = _per_ray(far, n_rays, device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    z_vals = z_vals.expand(n_rays, n_samples)
    if perturb:
        if u is None:
            if generator is None:
                raise ValueError(
                    "stratified_sample(perturb=True) needs a generator or u")
            u = draw(generator, z_vals.shape, device)
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * u
    return z_vals


def sample_pdf(
    generator: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    stratified: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` new z-values per ray.

    ``bins``: (..., M) bin positions; ``weights``: (..., M-1) unnormalised
    mass per interval. ``det`` spaces u evenly over [0, 1]; otherwise u
    comes from ``u`` or ``generator`` — jittered within CDF strata (so the
    samples come out sorted) when ``stratified``.
    """
    weights = weights + 1e-5  # no NaNs on empty rays
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., M)
    m = cdf.shape[-1]
    if bins.shape[-1] != m:
        raise ValueError(f"sample_pdf: bins last dim {bins.shape[-1]} must be "
                         f"weights last dim + 1 ({m})")
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = _linspace01(n_samples, cdf.device).to(cdf.dtype).expand(shape)
    else:
        if u is None:
            if generator is None:
                raise ValueError("sample_pdf(det=False) needs a generator or u")
            u = draw(generator, shape, cdf.device, cdf.dtype)
        if stratified:
            base = torch.arange(n_samples, device=cdf.device,
                                dtype=cdf.dtype) / n_samples
            u = base + u / n_samples
    return _invert_cdf(bins, cdf, u)


def _invert_cdf(bins: torch.Tensor, cdf: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Depths where the piecewise-linear CDF over ``bins`` reaches ``u``.
    In a bin holding little mass ``t`` divides by that mass, so an ulp of
    the CDF moves a depth by ulp / mass of the bin's width."""
    m = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
