"""Quality metrics and timing/ETA utilities, numpy only.

A copy of ``nerfmlp_tpu/train/metrics.py:25-161``: PSNR in closed form,
SSIM as the uniform-window (7x7) Wang et al. SSIM on whole images, the
reference's median-based ETA, and ``convert_for_json`` (here for torch
tensors too).
"""

from __future__ import annotations

import time
from datetime import datetime, timedelta
from typing import Dict, List, Optional

import numpy as np


def psnr(mse: float, data_range: float = 1.0) -> float:
    mse = max(float(mse), 1e-12)
    return 10.0 * np.log10(data_range**2 / mse)


def psnr_images(pred: np.ndarray, target: np.ndarray) -> float:
    return psnr(float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2)))


def _box_valid(x: np.ndarray, size: int, axis: int) -> np.ndarray:
    """Valid-mode box mean along one axis via cumulative sums (O(HW);
    the naive per-row convolve is ~1000x more Python overhead at 400^2)."""
    c = np.cumsum(x, axis=axis, dtype=np.float64)
    zero_shape = list(x.shape)
    zero_shape[axis] = 1
    c = np.concatenate([np.zeros(zero_shape), c], axis=axis)
    hi = np.take(c, range(size, c.shape[axis]), axis=axis)
    lo = np.take(c, range(0, c.shape[axis] - size), axis=axis)
    return (hi - lo) / size


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Separable valid-window box means — the interior values skimage's
    uniform_filter keeps after its crop-to-valid."""
    return _box_valid(_box_valid(img, size, 0), size, 1)


def ssim(
    img1: np.ndarray,
    img2: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
) -> float:
    """Mean SSIM over a (H, W, C) image pair (uniform window)."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    h, w = img1.shape[:2]
    win_size = min(win_size, h if h % 2 else h - 1, w if w % 2 else w - 1)
    if win_size < 3:
        return float("nan")

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # skimage uses sample (ddof=1)-style normalization cov_norm = n/(n-1).
    n = win_size**2
    cov_norm = n / (n - 1)

    vals = []
    for c in range(img1.shape[2]):
        x, y = img1[..., c], img2[..., c]
        ux = _uniform_filter(x, win_size)
        uy = _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
        b1, b2 = ux**2 + uy**2 + c1, vx + vy + c2
        vals.append(np.mean((a1 * a2) / (b1 * b2)))
    return float(np.mean(vals))


def get_memory_usage_gb() -> float:
    """Process RSS in GB (reference: train.py:55-58 via psutil)."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / 1e9
    except Exception:
        return 0.0


def format_time_duration(seconds: float) -> str:
    if seconds < 60:
        return f"{seconds:.0f}s"
    if seconds < 3600:
        return f"{seconds / 60:.1f}m"
    if seconds < 86400:
        return f"{seconds / 3600:.1f}h"
    return f"{seconds / 86400:.1f}d"


def calculate_etc(
    step: int,
    total_iters: int,
    start_time: float,
    iteration_times: List[float],
    window: int = 200,
) -> Optional[Dict]:
    """Robust ETA: median step time over a recent window, with the
    mean-vs-median instability flag and 1-year cap (train.py:80-119)."""
    if step <= 0 or not iteration_times:
        return None
    recent = iteration_times[-window:]
    median_t = float(np.median(recent))
    mean_t = float(np.mean(recent))
    remaining = max(0.0, (total_iters - step) * median_t)
    remaining = min(remaining, 365 * 24 * 3600.0)  # clamp to [0, 1 year]
    return {
        "progress_percent": 100.0 * step / total_iters,
        "median_iter_time": median_t,
        "mean_iter_time": mean_t,
        "remaining_time": remaining,
        "completion_time": datetime.now() + timedelta(seconds=remaining),
        "elapsed": time.time() - start_time,
        "eta_unstable": mean_t > 3.0 * median_t,
    }


def convert_for_json(obj):
    """numpy scalars and arrays, torch tensors -> plain python."""
    if isinstance(obj, dict):
        return {k: convert_for_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [convert_for_json(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if hasattr(obj, "tolist") and not isinstance(obj, (str, bytes)):
        return obj.tolist()   # torch tensors, on any device
    return obj
