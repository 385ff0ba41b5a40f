"""Ground truth rendered on a GPU (``render_analytic(..., device="cuda")``,
nerfmlp_torch/data/synthetic.py) against the numpy path: one 128x128 view
of each field at 512 samples.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_synthetic_gt_gpu.py --noconftest -q

Without a GPU every case skips. chip_smoke.py's phase 12 builds the
400x400 certification scene on the card and holds two of its views the
same way.
"""

import numpy as np
import pytest
import torch

from nerfmlp_torch.data import synthetic as syn
from nerfmlp_torch.data.blender import linear_to_srgb
from nerfmlp_torch.ops.rays import look_at_matrix


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["default", "hard"])
def test_ground_truth_on_the_card_matches_numpy(field):
    """At most 2 levels of 8-bit sRGB anywhere and 1 level on 99.9% of
    values; 1e-4 in linear RGB at the 99.9th percentile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pose = look_at_matrix(np.array([3.0, 1.5, 2.0]), np.zeros(3))
    kw = dict(n_samples=512, near=2.0, far=6.0, field=syn.FIELDS[field])
    got = syn.render_analytic(pose, 128, 128, 160.0, device="cuda", **kw)
    want = syn.render_analytic(pose, 128, 128, 160.0, **kw)
    gap = np.abs(got - want)
    assert np.quantile(gap, 0.999) <= 1e-4, gap.max()
    lv = np.abs((linear_to_srgb(got) * 255).round()
                - (linear_to_srgb(want) * 255).round())
    assert lv.max() <= 2 and (lv <= 1).mean() >= 0.999, lv.max()
