"""What the recipe draws, worked out again from the seeds: the training
batches and the uniforms of each step.

The recipes sample their rays as the NeRF reference's loader does:

* ``no_batching`` (and while the central crop is on): each batch is one
  image drawn uniformly, then ``batch`` of its pixels without
  replacement, from ``numpy.random.default_rng(seed)`` in that order;
  the crop is the central ``2 * int(H // 2 * frac)`` by ``2 * int(W // 2 *
  frac)`` block;
* otherwise the pool of every ray lives on the card and is permuted once
  an epoch by ``torch.randperm`` from a generator on the card seeded with
  ``SeedSequence([seed, epoch])``'s first word; step s takes the (s mod
  steps per epoch)-th run of ``batch`` rows.

The step's uniforms come from one generator on the card seeded with the
run's seed, drawn in the order the render consumes them (see
``nerf.render``); a grid refresh at step s draws its jitter from a
generator seeded ``17 * 1000003 + s``.
"""

from __future__ import annotations

import numpy as np
import torch

GRID_SEED_BASE = 17 * 1_000_003


class HostBatches:
    """The per-image batches of a (n_images, H, W) pool of rows."""

    def __init__(self, pool: np.ndarray, shape, batch: int, seed: int):
        self.pool, self.shape, self.batch = pool, shape, batch
        self.rng = np.random.default_rng(seed)

    def _pixels(self, n: int) -> np.ndarray:
        if self.batch <= n:
            return self.rng.choice(n, self.batch, replace=False)
        return self.rng.integers(0, n, self.batch)

    def next(self, crop: float) -> np.ndarray:
        n_img, h, w = self.shape
        img = int(self.rng.integers(0, n_img))
        if crop >= 1.0:
            return self.pool[img * h * w + self._pixels(h * w)]
        dh, dw = max(1, int(h // 2 * crop)), max(1, int(w // 2 * crop))
        flat = self._pixels(2 * dh * 2 * dw)
        rows = h // 2 - dh + flat // (2 * dw)
        cols = w // 2 - dw + flat % (2 * dw)
        return self.pool[img * h * w + rows * w + cols]


def pool_batch(pool: torch.Tensor, batch: int, seed: int,
               step: int) -> torch.Tensor:
    """The rows of 1-based ``step`` from the on-card pool."""
    spe = pool.shape[0] // batch
    epoch, k = divmod(step - 1, spe)
    word = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    gen = torch.Generator(device=pool.device).manual_seed(word)
    perm = torch.randperm(pool.shape[0], generator=gen,
                          device=pool.device)[:spe * batch]
    return pool[perm[k * batch:(k + 1) * batch]]


class Uniforms:
    """torch.rand draws, in order, from a generator on ``device``."""

    def __init__(self, seed: int, device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)
