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

import contextlib
import threading

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


# The process-wide NaN check (check_numerics) and, per thread, what the
# running code is doing, for the error message.
_numerics = {"on": False}
_scope = threading.local()


def check_numerics(on: bool = True) -> None:
    """Turn the NaN checks on (or off), process-wide: the port's
    ``jax_debug_nans`` (the train CLI's ``--check_numerics``). While on,
    the fused MLP's wrappers check every kernel's output (and the plain
    versions theirs), the renderer every MLP query's, and the train step
    the loss, every gradient and every parameter after the update; the
    first NaN raises ``FloatingPointError`` naming the tensor and the
    step or render (:func:`numerics_scope`). Each check reads one flag
    back from the device. While off, nothing is checked and nothing syncs.
    A captured CUDA graph cannot raise: the Trainer runs its steps one by
    one while this is on."""
    _numerics["on"] = bool(on)


def numerics_checked() -> bool:
    return _numerics["on"]


def numerics_where() -> list:
    """The labels of the :func:`numerics_scope` blocks this thread is in."""
    return list(getattr(_scope, "stack", []))


@contextlib.contextmanager
def numerics_scope(label: str):
    """Name what runs inside (``"train step 12"``, ``"coarse call"``) in
    the errors of the NaN checks, innermost last."""
    stack = _scope.__dict__.setdefault("stack", [])
    stack.append(label)
    try:
        yield
    finally:
        stack.pop()


def check_nan(named) -> None:
    """With the checks on, raise ``FloatingPointError`` for the first of
    ``named`` — (name, tensor) pairs — that holds a NaN: one read-back for
    all of them. Nothing while off."""
    if not _numerics["on"]:
        return
    named = [(n, t) for n, t in named if t is not None]
    if not named:
        return
    flags = torch.stack([torch.isnan(t.detach()).any() for _, t in named])
    if bool(flags.any()):
        name = named[int(flags.to(torch.uint8).argmax())][0]
        where = ", ".join(numerics_where())
        raise FloatingPointError(f"NaN in {name}"
                                 + (f" ({where})" if where else ""))
