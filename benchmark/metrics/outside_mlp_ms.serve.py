"""Device ms a frame spends in kernels other than the fused MLP's (rays,
sampling, the grid's lookups, compositing, frame assembly)."""

from benchmark import counts


def read(ctx):
    w, k = ctx["work"], ctx["trace"].kernels()
    if w["mode"] != "serve" or not w["frames"] or not k:
        return None
    return 1e3 * counts.other_seconds(k) / w["frames"]
