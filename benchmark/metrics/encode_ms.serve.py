"""Host ms a traced frame spends encoding its body (``serve.encode``:
brightness, clip, gamma, to 8 bits, the PNG), from the program's spans."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    if ctx["work"]["mode"] != "serve" or s is None or not spans.frames(s):
        return None
    return 1e3 * spans.seconds(s, "serve.encode") / spans.frames(s)
