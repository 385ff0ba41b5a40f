"""Frames' share of the card's peak: the forward operations of the traced
frames' rays (no padding) over the traced window's length."""

from benchmark import counts


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    if w["mode"] != "serve" or not w["frames"] or not t.kernels():
        return None
    flops = w["frames"] * counts.frame_useful_flops(
        ctx["model"], ctx["render"], w["pixels"])
    return counts.mfu_pct(flops, ctx["window_s"])
