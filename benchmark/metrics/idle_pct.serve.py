"""Share of the traced frames' window in which the card runs nothing."""


def read(ctx):
    t = ctx["trace"]
    if ctx["work"]["mode"] != "serve" or not t.kernels():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
