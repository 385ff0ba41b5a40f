"""Host ms a traced frame spends enqueueing its render (``serve.render``:
the rays and the tile loop's launches, up to the last; nothing waits for
the card there), from the program's spans."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    if ctx["work"]["mode"] != "serve" or s is None or not spans.frames(s):
        return None
    return 1e3 * spans.seconds(s, "serve.render") / spans.frames(s)
