"""The program's spans and counters of a traced run
(``nerfmlp_torch/utils/spans.py``), set on the trace's clock beside the
device's intervals.

The program records spans and counters only while a profiler runs, so in
a ``--trace 1`` run they cover the traced window. :func:`of` drains them
once a run and caches the result in the readers' ``ctx``, so that every
reader sees the same spans. A span is stamped with ``time.time_ns()``;
the Chrome trace's ``ts`` is microseconds after its
``baseTimeNanoseconds``, which every profile of a process shares (the
wall clock rounded down to Kineto's three-month period), so one tiny
profile of its own gives it. Spans are then clipped to the window, and
the device's idle time is worked out inside each span as self time: idle
under a child span goes to the child. The first call prints that idle
summed by span name, and the rest as unattributed, and, where frames
were served on a card, whether each ``serve.copy`` span holds its
frame's last ``cudaMemcpyAsync``: a check of the shared clock.

A program without spans (no such module, or nothing recorded) gives None,
and the readers of these spans then report nothing; so does a run whose
store overflowed (``spans.dropped``), whose sums would fall short.
"""

from __future__ import annotations

import bisect
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

FRAME = "serve.request"
# The loop's host stages a step, other than the dispatch; the final saves
# (``train.save``) are left out: they come once a call, not once a step.
LOOP = ("train.epoch", "train.occ_update", "train.batch", "train.log")


def base_ns() -> int:
    """The trace clock's zero: ``baseTimeNanoseconds`` of a tiny profile's
    Chrome trace (0 where a trace gives absolute times)."""
    with tempfile.TemporaryDirectory(prefix="bench_base_") as tmp:
        path = os.path.join(tmp, "base.json")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pass
        prof.export_chrome_trace(path)
        with open(path) as f:
            found = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read())
    return int(found.group(1)) if found else 0


def gaps(traced) -> List[Tuple[float, float]]:
    """The window's idle intervals (us): the complement of its busy ones."""
    edges = ([traced.t_start]
             + [x for ab in traced.busy_intervals() for x in ab]
             + [traced.t_end])
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


class Idle:
    """Idle seconds inside any interval, from sorted disjoint gaps."""

    def __init__(self, gaps: List[Tuple[float, float]]):
        self.starts = [a for a, _ in gaps]
        self.gaps = gaps
        self.cum = [0.0]
        for a, b in gaps:
            self.cum.append(self.cum[-1] + b - a)

    def upto(self, t: float) -> float:
        k = bisect.bisect_right(self.starts, t)
        if not k:
            return 0.0
        a, b = self.gaps[k - 1]
        return self.cum[k - 1] + min(t, b) - a

    def between(self, t0: float, t1: float) -> float:
        return max(0.0, self.upto(t1) - self.upto(t0)) * 1e-6


def on_trace_clock(recorded: Dict, base: int, t_start: float,
                   t_end: float) -> List[Dict]:
    """The drained spans as dicts with ``t0`` / ``t1`` in trace us,
    clipped to [t_start, t_end]; those wholly outside are left out."""
    out = []
    for s in recorded["spans"]:
        t0 = max((s.start_ns - base) * 1e-3, t_start)
        t1 = min((s.end_ns - base) * 1e-3, t_end)
        if t1 >= t0:
            out.append({"id": s.id, "parent": s.parent, "group": s.group,
                        "name": s.name, "t0": t0, "t1": t1})
    return out


def self_idle(spans: List[Dict], idle: Idle) -> Dict[int, float]:
    """{span id: device idle seconds inside it and in none of its
    children} (children nest inside their parent: one thread)."""
    own = {s["id"]: idle.between(s["t0"], s["t1"]) for s in spans}
    out = dict(own)
    for s in spans:
        if s["parent"] in out:
            out[s["parent"]] -= own[s["id"]]
    return out


def attribute(recorded: Dict, traced, base: int) -> Dict:
    """``{"spans", "counts", "idle" (self idle s by span id), "idle_s"
    (the window's), "unattributed_s"}`` of drained spans."""
    spans = on_trace_clock(recorded, base, traced.t_start, traced.t_end)
    g = gaps(traced)
    idle = Idle(g)
    by_id = self_idle(spans, idle)
    total = sum(b - a for a, b in g) * 1e-6
    roots = sum(idle.between(s["t0"], s["t1"]) for s in spans
                if s["parent"] not in by_id)
    return {"spans": spans, "counts": dict(recorded["counts"]),
            "idle": by_id, "idle_s": total,
            "unattributed_s": total - roots}


def clock_check(spans: List[Dict], host_ops) -> Optional[Tuple[int, int]]:
    """(frames whose ``serve.copy`` span holds the frame's last
    ``cudaMemcpyAsync``, frames with one), or None where none has."""
    copies = sorted((t, t + d) for n, t, d in host_ops
                    if n == "cudaMemcpyAsync")
    held = seen = 0
    for req in (s for s in spans if s["name"] == FRAME):
        inside = [c for c in copies if req["t0"] <= c[0] <= req["t1"]]
        box = [s for s in spans if s["name"] == "serve.copy"
               and s["group"] == req["group"]]
        if inside and box:
            seen += 1
            a, b = inside[-1]
            held += any(s["t0"] <= a and b <= s["t1"] for s in box)
    return (held, seen) if seen else None


def of(ctx: Dict) -> Optional[Dict]:
    """The run's spans (see :func:`attribute`), drained and worked out at
    the first call and cached in ``ctx``; None where the program records
    none."""
    if "spans" not in ctx:
        ctx["spans"] = _load(ctx["trace"])
    return ctx["spans"]


def _load(traced) -> Optional[Dict]:
    try:
        from nerfmlp_torch.utils import spans as program
    except ImportError:
        return None
    recorded = program.drain()
    if not recorded["spans"] and not recorded["counts"]:
        return None
    if recorded["counts"].get("spans.dropped"):
        print(f"[bench] {recorded['counts']['spans.dropped']} spans dropped "
              "past the store's bound: no span metric", flush=True)
        return None
    out = attribute(recorded, traced, base_ns())
    report(out, traced)
    return out


def report(out: Dict, traced) -> None:
    tot: Dict[str, float] = defaultdict(float)
    for s in out["spans"]:
        tot[s["name"]] += out["idle"][s["id"]]
    parts = [f"{k} {v}"
             for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]
    parts.append(f"unattributed {out['unattributed_s']}")
    print(f"[bench] idle by span (s, of {out['idle_s']} idle): "
          + ", ".join(parts), flush=True)
    check = clock_check(out["spans"], traced.host_ops)
    if check is not None:
        print(f"[bench] clock check: {check[0]} of {check[1]} serve.copy "
              "spans hold their frame's last cudaMemcpyAsync", flush=True)


def frames(out: Dict) -> int:
    return sum(1 for s in out["spans"] if s["name"] == FRAME)


def seconds(out: Dict, name: str) -> float:
    """The summed length of the spans called ``name``."""
    return sum(s["t1"] - s["t0"] for s in out["spans"]
               if s["name"] == name) * 1e-6


def idle_in(out: Dict, names: Iterable[str]) -> float:
    """The device's idle seconds in the self time of spans so called."""
    names = set(names)
    return sum(out["idle"][s["id"]] for s in out["spans"]
               if s["name"] in names)
