"""PyTorch ops: encoding, sampling, compositing, rays, rendering and the
fused MLP kernel."""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class RankDraws:
    """The draws of one data-parallel rank: ``generator`` (one, or one per
    scene) is in the same state on every rank; each draw is made at the
    global shape, ``world_size`` times this rank's rows (per scene), and
    the rank keeps its own contiguous rows, ``rank``-th of ``world_size``.
    So N ranks use the numbers one device draws for the whole batch, as
    JAX draws at the global shape and shards the result."""

    generator: object
    rank: int
    world_size: int


def draw(generator, shape, device, dtype: torch.dtype = torch.float32,
         normal: bool = False) -> torch.Tensor:
    """``torch.rand`` (``normal``: ``torch.randn``) of ``shape`` from
    ``generator``, or from a sequence of generators, one per scene: each
    draws its own scene's equal share of the leading (scene-major) rows, so
    a scene's numbers depend on neither the other scenes nor their count.
    A :class:`RankDraws` draws the global shape and keeps its rank's rows
    (of each scene's share)."""
    fn = torch.randn if normal else torch.rand
    rank, world = 0, 1
    if isinstance(generator, RankDraws):
        rank, world = generator.rank, generator.world_size
        generator = generator.generator
    if generator is None or isinstance(generator, torch.Generator):
        if world == 1:
            return fn(shape, generator=generator, device=device, dtype=dtype)
        gens = (generator,)
    else:
        gens = tuple(generator)
    if shape[0] % len(gens):
        raise ValueError(f"{shape[0]} rows do not split into {len(gens)} "
                         f"equal scenes")
    rows = shape[0] // len(gens)
    part = (rows * world,) + tuple(shape[1:])
    return torch.cat([fn(part, generator=g, device=device,
                         dtype=dtype)[rank * rows:(rank + 1) * rows]
                      for g in gens])


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant (a tuple of numbers) on ``device``, copied from the
    host once per (values, type, device), for the reason
    :func:`device_scalar` gives. Read-only, shared by every caller."""
    return torch.tensor(values, dtype=dtype, device=device)
