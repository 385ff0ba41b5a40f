"""nerfmlp_torch: the NeRF framework in PyTorch, for NVIDIA Hopper GPUs.

A port of ``nerfmlp_tpu`` that keeps its layout and names: each module here
has a counterpart of the same path there. It imports ``torch`` and never
``jax`` or ``nerfmlp_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no explicit device they raise.

The fused encode+MLP forward and its backward are hand-written CUDA
kernels (``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_bwd.cu``), built from
the sources at first use.
"""

from __future__ import annotations

import torch

__version__ = "0.2.0"


def use_true_fp32() -> None:
    """Keep fp32 matrix products and convolutions in true fp32 on the card
    (TF32 off; PyTorch's default for matmuls, not for cuDNN), process-wide.
    The package's entry points call it once where they start a run — the
    render service, the Trainer, the CLIs — so that the fp32 paths match
    the reference; library functions never change this global setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and there is
    no GPU: nothing falls back to the CPU without the caller saying so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
