"""Points sent to the net per useful ray of the traced frames, padding
included: the program's ``mlp.points`` over its ``serve.rays``."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    if ctx["work"]["mode"] != "serve" or s is None:
        return None
    rays = s["counts"].get("serve.rays", 0)
    return s["counts"].get("mlp.points", 0) / rays if rays else None
