"""Device-resident ray pool: no host->device copy per train step.

Counterpart of ``nerfmlp_tpu/data/device_pool.py:41-115``. The flattened
(N, F) pool is copied to the card once. Per epoch, one on-device
``torch.randperm`` from a CUDA ``torch.Generator`` seeded from (seed,
epoch) — the JAX package's ``fold_in(PRNGKey(seed), epoch)`` — gathers it
into a (steps_per_epoch, B, F) batch stack; rays past the last full batch
sit the epoch out, as in the host loader. A resumed run rebuilds the
exact stack of the epoch it stopped in. The train step reads batch
``step % steps_per_epoch`` of the stack: the host picks it
(:meth:`DeviceRayPool.batch`), or the step picks it on the device from its
step counter (:meth:`DeviceRayPool.batch_at`). Every epoch is written into
the same stack tensor, so a CUDA graph that captured it reads each new
epoch; the reshuffle runs between graph replays, never inside one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerfmlp_torch import resolve_device
from nerfmlp_torch.parallel.mesh import shard_batch, shard_rows


def epoch_seed(seed: int, epoch: int) -> int:
    """A generator seed for (seed, epoch), distinct per pair."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


class DeviceRayPool:
    """The (N, F) ray pool in device memory, re-shuffled into a
    (steps_per_epoch, batch, F) stack once per epoch. ``mesh``: a
    data-parallel :class:`~nerfmlp_torch.parallel.mesh.Mesh`, whose rank
    reads its rows of each batch (``batch_size`` is the global batch)."""

    def __init__(self, pool: np.ndarray, batch_size: int, seed: int = 0,
                 device=None, mesh=None):
        n, _ = pool.shape
        if n < batch_size:
            raise ValueError(
                f"ray pool ({n}) smaller than one batch ({batch_size}); "
                "use the host loader's with-replacement fallback")
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            shard_rows(batch_size, mesh)   # refuses a batch that won't split
        self.batch_size = int(batch_size)
        self.steps_per_epoch = n // batch_size
        self.seed = int(seed)
        self._flat = torch.as_tensor(pool, dtype=torch.float32).to(self.device)
        self.epoch: int = -1
        self.stack: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self._flat.shape[0]

    def epoch_of(self, completed_steps: int) -> int:
        """Which epoch the step AFTER ``completed_steps`` samples from."""
        return completed_steps // self.steps_per_epoch

    def ensure_epoch(self, epoch: int) -> torch.Tensor:
        """The batch stack for ``epoch``, reshuffled if needed: a randperm
        of the whole pool on the device, from a generator seeded by (seed,
        epoch)."""
        if epoch != self.epoch:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(epoch_seed(self.seed, epoch))
            n_use = self.steps_per_epoch * self.batch_size
            perm = torch.randperm(self._flat.shape[0], generator=gen,
                                  device=self.device)[:n_use]
            stack = self._flat[perm].reshape(
                self.steps_per_epoch, self.batch_size, -1)
            if self.stack is None:
                self.stack = stack
            else:
                self.stack.copy_(stack)   # in place: graphs hold its pointer
            self.epoch = epoch
        return self.stack

    def batch(self, completed_steps: int) -> torch.Tensor:
        """The batch of the step after ``completed_steps`` (this rank's
        rows of it under a mesh)."""
        stack = self.ensure_epoch(self.epoch_of(completed_steps))
        return shard_batch(stack[completed_steps % self.steps_per_epoch],
                           self.mesh)

    def batch_at(self, counter: torch.Tensor) -> torch.Tensor:
        """The batch of the step after ``counter`` updates, ``counter`` a
        () integer tensor on the device: picked there, from the stack of
        the current epoch (the caller keeps it current); this rank's rows
        of it under a mesh."""
        idx = torch.remainder(counter, self.steps_per_epoch).reshape(1)
        return shard_batch(self.stack.index_select(0, idx)[0], self.mesh)
