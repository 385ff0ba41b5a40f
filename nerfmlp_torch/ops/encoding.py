"""Positional (Fourier-feature) encoding.

gamma(x) = [x, sin(f_0 x), cos(f_0 x), ..., sin(f_{L-1} x), cos(f_{L-1} x)]

with NO pi multiplier. Frequency bands are ``2**linspace(0, L-1, L)``
(log sampling, the default) or ``linspace(2^0, 2^(L-1), L)`` (linear).
Counterpart of ``nerfmlp_tpu/ops/encoding.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nerfmlp_torch.ops import device_constant


@functools.lru_cache(maxsize=None)
def frequency_bands(num_freqs: int, log_sampling: bool = True) -> np.ndarray:
    """Frequency bands as float32 host constants (read-only: the cache
    hands the same array to every caller)."""
    if num_freqs <= 0:
        bands = np.zeros((0,), dtype=np.float32)
    elif log_sampling:
        bands = 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs)
    else:
        bands = np.linspace(2.0 ** 0.0, 2.0 ** (num_freqs - 1), num_freqs)
    bands = bands.astype(np.float32)
    bands.setflags(write=False)
    return bands


def band_tensor(num_freqs: int, log_sampling: bool, dtype: torch.dtype,
                device) -> torch.Tensor:
    """:func:`frequency_bands` on ``device`` in ``dtype``, copied once
    (:func:`~nerfmlp_torch.ops.device_constant`; the fp32 bands are exact
    Python floats, so the tensor holds the same bits)."""
    return device_constant(
        tuple(float(b) for b in frequency_bands(num_freqs, log_sampling)),
        dtype, device)


def encoded_dim(input_dim: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dim * ((1 if include_input else 0) + 2 * num_freqs)


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """gamma(x): (..., D) -> (..., D * ((include_input) + 2L)).

    Layout ``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]`` where
    each block spans the full D input channels.
    """
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    bands = band_tensor(num_freqs, log_sampling, x.dtype, x.device)
    xb = x[..., None, :] * bands[:, None]                 # (..., L, D)
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., L, 2, D)
    enc = sc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
