"""Host-side ray batching over the flattened pool.

Counterpart of ``nerfmlp_tpu/data/pipeline.py:23-165`` (numpy, so the same
seed gives the same batches in both packages): ``auto_tune_batch_size``
and ``RayBatchLoader`` with its global and per-image modes and precrop.
The JAX package's ``prefetch_to_device`` has no counterpart: the Trainer
copies a host batch to the card itself, and by default draws batches from
the device-resident pool (data/device_pool.py) instead.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def auto_tune_batch_size(
    n_rays: int,
    max_mem_gb: float = 16.0,
    min_batch: int = 256,
    max_batch: int = 16384,
    total_samples: int = 256,
) -> int:
    """A train batch size from an activation-memory model: peak
    activations per ray ~ total_samples * (enc 63 + trunk 8*256 + heads
    ~0.7k) floats for forward + backward + optimizer; the largest
    power-of-two batch under the budget, clipped to [min, max]."""
    floats_per_ray = total_samples * (63 + 8 * 256 + 700) * 3
    bytes_per_ray = floats_per_ray * 4
    b = int(max_mem_gb * 1e9 / max(bytes_per_ray, 1))
    b = 1 << max(b.bit_length() - 1, 0)
    return int(np.clip(b, min_batch, max_batch))


class RayBatchLoader:
    """Infinite shuffled batches over a flattened ray pool: numpy (batch,
    9) arrays laid out [rays_o | rays_d | rgb] ((batch, 12) with world
    viewdirs for NDC datasets).

    Global mode (default): batches walk a per-epoch permutation of ALL
    images' rays. Per-image mode (``image_mode``, the oracle's
    ``--no_batching``): each batch comes from one random image — also used
    while precrop restricts sampling to each image's central crop."""

    def __init__(self, rays_o: np.ndarray, rays_d: np.ndarray,
                 rgbs: np.ndarray, batch_size: int, seed: int = 0,
                 image_shape=None, image_mode: bool = False, viewdirs=None):
        assert rays_o.shape == rays_d.shape == rgbs.shape
        cols = [rays_o.astype(np.float32), rays_d.astype(np.float32)]
        if viewdirs is not None:
            cols.append(viewdirs.astype(np.float32))
        cols.append(rgbs.astype(np.float32))
        if image_mode and image_shape is None:
            raise ValueError("image_mode requires image_shape (use from_dataset)")
        self.pool = np.concatenate(cols, axis=-1)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._warned_small_pool = False
        self.image_shape = image_shape
        self.image_mode = image_mode
        self.precrop_frac: float = 1.0
        self._perm = None
        self._cursor = 0
        self.epoch = 0

    @classmethod
    def from_dataset(cls, dataset, batch_size: int, seed: int = 0,
                     image_mode: bool = False):
        shape = (dataset.n_images, dataset.H, dataset.W)
        return cls(dataset.all_rays_o, dataset.all_rays_d, dataset.all_rgbs,
                   batch_size, seed=seed, image_shape=shape,
                   image_mode=image_mode,
                   viewdirs=getattr(dataset, "all_viewdirs", None))

    def __len__(self) -> int:
        return self.pool.shape[0]

    def set_precrop(self, frac: float) -> None:
        """Restrict sampling to the central ``frac`` of each image;
        frac=1.0 disables."""
        if self.image_shape is None:
            raise ValueError("precrop requires image_shape (use from_dataset)")
        self.precrop_frac = float(frac)

    def _sample_pixels(self, n: int) -> np.ndarray:
        """batch_size draws from range(n) without replacement (with
        replacement only when the batch exceeds the pixel pool)."""
        if self.batch_size <= n:
            return self.rng.choice(n, self.batch_size, replace=False)
        return self.rng.integers(0, n, self.batch_size)

    def _crop_indices(self, img_idx: int) -> np.ndarray:
        _, H, W = self.image_shape
        if self.precrop_frac >= 1.0:
            return img_idx * H * W + self._sample_pixels(H * W)
        dh = max(1, int(H // 2 * self.precrop_frac))
        dw = max(1, int(W // 2 * self.precrop_frac))
        flat = self._sample_pixels(2 * dh * 2 * dw)
        rows = H // 2 - dh + flat // (2 * dw)
        cols = W // 2 - dw + flat % (2 * dw)
        return img_idx * H * W + rows * W + cols

    def next_batch(self) -> np.ndarray:
        if self.image_mode or self.precrop_frac < 1.0:
            img_idx = int(self.rng.integers(0, self.image_shape[0]))
            return self.pool[self._crop_indices(img_idx)]
        if self.pool.shape[0] < self.batch_size:
            if not self._warned_small_pool:
                print(f"(ray pool {self.pool.shape[0]} < batch "
                      f"{self.batch_size}: sampling with replacement)")
                self._warned_small_pool = True
            idx = self.rng.integers(0, self.pool.shape[0], self.batch_size)
            return self.pool[idx]
        if self._perm is None or self._cursor + self.batch_size > len(self._perm):
            self._reshuffle()
        idx = self._perm[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return self.pool[idx]

    def _reshuffle(self) -> None:
        self._perm = self.rng.permutation(self.pool.shape[0])
        self._cursor = 0
        self.epoch += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()
