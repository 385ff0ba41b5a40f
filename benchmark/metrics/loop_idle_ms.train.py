"""Device idle ms a traced step inside the training loop's host stages
other than the dispatch (``train.epoch``, ``train.occ_update``,
``train.batch``, ``train.log``; self time). The final saves, once a
call, are left out."""

from benchmark import spans


def read(ctx):
    s, w = spans.of(ctx), ctx["work"]
    if w["mode"] != "train" or s is None or not w["steps"]:
        return None
    return 1e3 * spans.idle_in(s, spans.LOOP) / w["steps"]
