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


def draw(generator, shape, device, dtype: torch.dtype = torch.float32,
         normal: bool = False) -> torch.Tensor:
    """``torch.rand`` (``normal``: ``torch.randn``) of ``shape`` from
    ``generator``, or from a sequence of generators, one per scene: each
    draws its own scene's equal share of the leading (scene-major) rows, so
    a scene's numbers depend on neither the other scenes nor their count."""
    fn = torch.randn if normal else torch.rand
    if generator is None or isinstance(generator, torch.Generator):
        return fn(shape, generator=generator, device=device, dtype=dtype)
    gens = tuple(generator)
    if shape[0] % len(gens):
        raise ValueError(f"{shape[0]} rows do not split into {len(gens)} "
                         f"equal scenes")
    part = (shape[0] // len(gens),) + tuple(shape[1:])
    return torch.cat([fn(part, generator=g, device=device, dtype=dtype)
                      for g in gens])


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant (a tuple of numbers) on ``device``, copied from the
    host once per (values, type, device), for the reason
    :func:`device_scalar` gives. Read-only, shared by every caller."""
    return torch.tensor(values, dtype=dtype, device=device)
