"""Spans and counters at the program's layer boundaries, recorded while a
``torch.profiler`` profile runs, on its Chrome trace's host clock.

``with span("serve.render"):`` times a block; ``count("mlp.points", n)``
adds to a counter; ``drain()`` hands over what was kept and clears it.
Both record only while a profiler is running (``torch.profiler.profile``
sets ``torch.autograd.profiler._is_profiler_enabled`` whatever activities
it traces): otherwise :func:`span` returns one shared null context and
:func:`count` returns at once, so an untraced run pays one flag read a
call and no clock read.

A span is stamped with ``time.time_ns()``, the clock of the trace's host
events (an event's ``ts * 1000 + baseTimeNanoseconds``), so a reader can
set it beside the device's intervals even where the profile traces CUDA
activity alone and holds none of the program's ranges. It also enters
``torch.profiler.record_function`` under its name (or ``label``), so a
trace that records CPU activity shows the same ranges. Its parent is the
innermost span open on the same thread; spans of one request or training
window share a ``group``: the root's ``group=`` argument, else its id.
The store keeps at most ``LIMIT`` spans; past that the counter
``spans.dropped`` counts what was lost.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

LIMIT = 100_000


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    group: int
    name: str
    start_ns: int
    end_ns: int


_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_spans: List[Span] = []
_counts: Dict[str, int] = {}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "label", "group", "id", "parent", "start", "mark")

    def __init__(self, name, label, group):
        self.name, self.label, self.group = name, label, group

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        if self.group is None:
            self.group = stack[-1].group if stack else self.id
        stack.append(self)
        self.start = time.time_ns()
        self.mark = torch.profiler.record_function(self.label or self.name)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        self.mark.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        rec = Span(self.id, self.parent, self.group, self.name, self.start,
                   end)
        with _lock:
            if len(_spans) < LIMIT:
                _spans.append(rec)
            else:
                _counts["spans.dropped"] = _counts.get("spans.dropped", 0) + 1
        return False


def span(name: str, group: Optional[int] = None,
         label: Optional[str] = None):
    """A context manager that records the block as span ``name`` while a
    profiler runs; ``label`` names its ``record_function`` range instead
    of ``name``."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, label, group)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def drain() -> Dict:
    """``{"spans": [Span, ...], "counts": {name: n}}`` kept since the last
    drain, in the order the spans closed; clears the store."""
    global _spans, _counts
    with _lock:
        out = {"spans": _spans, "counts": _counts}
        _spans, _counts = [], {}
    return out
