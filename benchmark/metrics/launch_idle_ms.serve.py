"""Device idle ms a traced frame inside its ``serve.render`` span: the
card waiting for the host's tile loop to launch its work."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    if ctx["work"]["mode"] != "serve" or s is None or not spans.frames(s):
        return None
    return 1e3 * spans.idle_in(s, ("serve.render",)) / spans.frames(s)
