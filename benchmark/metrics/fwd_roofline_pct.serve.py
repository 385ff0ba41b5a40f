"""The forward kernel's share of its roofline in frames: the least time of
every forward call of the traced frames (whole tiles) over the kernel's
device time."""

from benchmark import counts


def read(ctx):
    w = ctx["work"]
    if w["mode"] != "serve":
        return None
    return counts.roofline_pct(ctx["trace"].kernels(), "fwd", w["fwd_calls"],
                               ctx["model"])
