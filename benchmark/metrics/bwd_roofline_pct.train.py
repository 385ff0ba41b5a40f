"""The backward's share of its roofline: the least time of the backward
function's own work (dX and dW) of every differentiated call of the
traced steps over the device time of its kernels (phase 1, phase 2, the
reduction)."""

from benchmark import counts


def read(ctx):
    w = ctx["work"]
    if w["mode"] != "train":
        return None
    return counts.roofline_pct(ctx["trace"].kernels(), "bwd", w["bwd_calls"],
                               ctx["model"])
