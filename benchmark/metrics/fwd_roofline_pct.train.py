"""The forward kernel's share of its roofline in training: the least time
of every forward call of the traced steps and grid refreshes over the
kernel's device time."""

from benchmark import counts


def read(ctx):
    w = ctx["work"]
    if w["mode"] != "train":
        return None
    return counts.roofline_pct(ctx["trace"].kernels(), "fwd", w["fwd_calls"],
                               ctx["model"])
