"""Device ms a training step spends in kernels other than the fused MLP's
(sampling, compositing, the loss, Adam, the grid)."""

from benchmark import counts


def read(ctx):
    w, k = ctx["work"], ctx["trace"].kernels()
    if w["mode"] != "train" or not w["steps"] or not k:
        return None
    return 1e3 * counts.other_seconds(k) / w["steps"]
