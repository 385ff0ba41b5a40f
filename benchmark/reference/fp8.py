"""Matrix products with rounded operands, for the reference's ``quant``.

``fp8_linear`` is the precision control, the step below the bfloat16 that
the configurations state: each operand is scaled by its largest magnitude
onto e4m3's range (448), rounded to ``float8_e4m3fn`` and scaled back, as
fp8 training does per tensor; in the backward the incoming gradient is
rounded to ``e5m2`` the same way. ``bf16_linear`` rounds to bfloat16, the
stated precision itself (the calibration's yardstick of what rounding
alone moves). The products accumulate in float32.
"""

from __future__ import annotations

import torch

_RANGE = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` through ``dtype``; an 8-bit float at a per-tensor scale."""
    if dtype not in _RANGE:
        return x.to(dtype).to(torch.float32)
    amax = x.detach().abs().amax()
    scale = _RANGE[dtype] / torch.clamp(amax, min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _RoundedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, fwd, bwd):
        hq, wq = round_to(h, fwd), round_to(w, fwd)
        ctx.save_for_backward(hq, wq)
        ctx.bwd = bwd
        return hq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        hq, wq = ctx.saved_tensors
        gq = round_to(g, ctx.bwd)
        return (gq @ wq, gq.reshape(-1, gq.shape[-1]).t()
                @ hq.reshape(-1, hq.shape[-1]), None, None)


def fp8_linear(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w.T`` with both operands in e4m3 and the gradient in e5m2."""
    return _RoundedLinear.apply(h, w, torch.float8_e4m3fn,
                                torch.float8_e5m2)


def bf16_linear(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w.T`` with the operands and the gradient in bfloat16."""
    return _RoundedLinear.apply(h, w, torch.bfloat16, torch.bfloat16)
