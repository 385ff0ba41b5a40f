"""Blender-synthetic colour transfer functions.

Counterpart of ``nerfmlp_tpu/data/blender.py:31-45``; the dataset loader
comes with the training slice.
"""

from __future__ import annotations

import numpy as np


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """Standard sRGB -> linear transfer."""
    img = img.astype(np.float32)
    return np.where(
        img <= 0.04045, img / 12.92, np.power((img + 0.055) / 1.055, 2.4)
    )


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """Inverse transfer, for display."""
    img = np.clip(img.astype(np.float32), 0.0, 1.0)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * np.power(img, 1.0 / 2.4) - 0.055
    )
