"""The training step's share of the card's peak: useful operations (3 x
the forward's, at the evaluations a ray needs; no grid refresh, no
recompute) of the traced window's rays over its length."""

from benchmark import counts


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    if w["mode"] != "train" or not w["steps"] or not t.kernels():
        return None
    flops = counts.train_useful_flops(ctx["model"], ctx["render"], w["rays"])
    return counts.mfu_pct(flops, ctx["window_s"])
