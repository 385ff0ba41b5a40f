"""nerfmlp_torch: the NeRF framework in PyTorch, for NVIDIA Hopper GPUs.

A port of ``nerfmlp_tpu`` that keeps its layout and names: each module here
has a counterpart of the same path there. It imports ``torch`` and never
``jax`` or ``nerfmlp_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no explicit device they raise.

The fused encode+MLP forward is a hand-written CUDA kernel
(``csrc/fused_mlp_fwd.cu``), built from the sources at first use.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


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
