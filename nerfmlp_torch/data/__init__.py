"""Datasets and ray batching (counterpart of ``nerfmlp_tpu/data``): the
Blender, LLFF and DeepVoxels loaders, the synthetic scene writers, the
host loader (the device ray pool is ``data/device_pool.py``)."""

from nerfmlp_torch.data.blender import (
    BlenderDataset, linear_to_srgb, srgb_to_linear,
)
from nerfmlp_torch.data.deepvoxels import DeepVoxelsDataset
from nerfmlp_torch.data.llff import LLFFDataset
from nerfmlp_torch.data.pipeline import RayBatchLoader, auto_tune_batch_size
from nerfmlp_torch.data.synthetic import (
    make_synthetic_llff_scene, make_synthetic_scene,
)

__all__ = [
    "BlenderDataset",
    "DeepVoxelsDataset",
    "LLFFDataset",
    "RayBatchLoader",
    "auto_tune_batch_size",
    "image_viewdirs",
    "make_synthetic_llff_scene",
    "make_synthetic_scene",
    "srgb_to_linear",
    "linear_to_srgb",
]


def image_viewdirs(dataset, idx: int):
    """World-space per-pixel view directions for one image, or ``None``
    for metric datasets (only NDC/LLFF loaders carry them — the view
    branch must see pre-NDC world directions)."""
    fn = getattr(dataset, "image_viewdirs", None)
    return fn(idx) if fn is not None else None
