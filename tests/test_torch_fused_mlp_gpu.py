"""The fused MLP CUDA kernel against its plain version, on a GPU.

Imports neither jax nor the JAX package, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_fused_mlp_gpu.py --noconftest -q

Without a GPU every case skips. chip_smoke.py repeats the check at the
serving path's full size.
"""

import numpy as np
import pytest
import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import fused_mlp
from nerfmlp_torch.ops.encoding import positional_encoding


@pytest.mark.cuda
@pytest.mark.parametrize("use_viewdirs, dtype, tol", [
    (True, "bfloat16", 1e-2),   # a flipped bf16 rounding cascades
    (False, "bfloat16", 1e-2),
    (True, "float32", 1e-4),    # hi_lo: fp32 summation order only
])
def test_kernel_matches_plain_on_gpu(use_viewdirs, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cfg = RenderConfig(compute_dtype=dtype, fp32_precision="high",
                       use_kernel=True, use_viewdirs=use_viewdirs)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    rng = np.random.default_rng(0)
    n = 1000  # not a multiple of the kernel's 64-point tile
    pts = torch.from_numpy((rng.normal(size=(n, 3)) * 3).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    pts = pts.cuda()
    dirs = positional_encoding(d, 4).cuda() if use_viewdirs else None
    before = fused_mlp.fused_nerf_mlp.launches
    got = fused_mlp.fused_nerf_mlp(net, pts, dirs, cfg)
    want = fused_mlp.fused_nerf_mlp_plain(net, pts, dirs, cfg.pos_enc_L,
                                          hi_lo=dtype == "float32")
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_mlp.launches == before + 1
    assert got.shape == want.shape == (n, 4)
    assert float((got - want).abs().max() / want.abs().max()) <= tol
