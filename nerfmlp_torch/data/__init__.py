"""Datasets and ray batching (counterpart of ``nerfmlp_tpu/data``)."""


def image_viewdirs(dataset, idx: int):
    """World-space per-pixel view directions for one image, or ``None``
    for metric datasets (only NDC/LLFF loaders carry them — the view
    branch must see pre-NDC world directions)."""
    fn = getattr(dataset, "image_viewdirs", None)
    return fn(idx) if fn is not None else None
