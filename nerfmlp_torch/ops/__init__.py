"""PyTorch ops: encoding, sampling, compositing, rays, rendering and the
fused MLP kernel."""

from __future__ import annotations

import functools

import torch


def device_scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """``v`` (a Python number or a tensor) as a tensor of ``dtype`` on
    ``device``. A number is filled on the device, where ``torch.as_tensor``
    would copy it from pageable host memory: such a copy waits for the
    device's queue and cannot be captured in a CUDA graph."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device)
    return torch.full((), v, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant (a tuple of numbers) on ``device``, copied from the
    host once per (values, type, device), for the reason
    :func:`device_scalar` gives. Read-only, shared by every caller."""
    return torch.tensor(values, dtype=dtype, device=device)
