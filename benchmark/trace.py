"""The traced window: ``torch.profiler`` over the card's activity, its
Chrome trace read back into device intervals, kernel times by name and
the longest idle gaps by what the host was doing.

Only CUDA activity is traced (kernels, copies, and the runtime calls the
host makes): recording every CPU operator as well doubles the frame time
of the host-bound cells, and every share read from such a window would
measure the profiler. An idle gap is named by the runtime call the host
was in when it began (``host`` where it was in none: Python, the PNG
encoder, the loader).
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "benchmark.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Traced:
    """``with Traced(device, path) as t:`` profiles the block; afterwards
    ``t.device_ops`` and ``t.host_ops`` hold what ran in it and
    ``t.window_s`` its length on the trace's clock."""

    def __init__(self, device, path: str):
        self.device, self.path = torch.device(device), path

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA
                if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        sync(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function(WINDOW)
        self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.host_s = time.perf_counter() - self.t0
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        if exc[0] is not None:
            return False
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        self._read(events)
        return False

    def _read(self, events) -> None:
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW]
        if win:
            self.t_start = float(win[0]["ts"])
            self.t_end = self.t_start + float(win[0]["dur"])
        else:   # no host annotations traced: the host clock's length
            self.t_start = min((float(e["ts"]) for e in xs), default=0.0)
            self.t_end = self.t_start + self.host_s * 1e6
        self.window_s = (self.t_end - self.t_start) * 1e-6
        self.device_ops = [(e["name"], float(e["ts"]), float(e["dur"]),
                            e.get("cat"))
                           for e in xs if e.get("cat") in _DEVICE_CATS]
        self.host_ops = [(e["name"], float(e["ts"]), float(e["dur"]))
                         for e in xs if e.get("cat") in _HOST_CATS
                         and e.get("name") != WINDOW]

    # -------------------------------------------------------------- #
    def kernels(self) -> List[Tuple[str, float, float]]:
        """(name, start us, duration us) of every kernel in the window."""
        return [(n, t, d) for n, t, d, c in self.device_ops
                if c == "kernel" and self.t_start <= t < self.t_end]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity inside the window, in us."""
        spans = sorted((max(t, self.t_start), min(t + d, self.t_end))
                       for _, t, d, _ in self.device_ops
                       if t + d > self.t_start and t < self.t_end)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_ops_top(self, n: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        tot: Dict[str, float] = defaultdict(float)
        for name, t, d, _ in self.device_ops:
            if self.t_start <= t < self.t_end:
                tot[short(name)] += d * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps_top(self, n: int = 10) -> List[List]:
        """The device's idle time summed by the innermost host op running
        where each gap starts ("host" where none is)."""
        busy = self.busy_intervals()
        edges = ([self.t_start] + [x for ab in busy for x in ab]
                 + [self.t_end])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        ops = sorted(self.host_ops, key=lambda o: o[1])
        tot: Dict[str, float] = defaultdict(float)
        active, i = [], 0
        for a, b in gaps:     # in time order: one sweep over the ops
            while i < len(ops) and ops[i][1] <= a:
                active.append(ops[i])
                i += 1
            active = [o for o in active if o[1] + o[2] > a]
            name = min(active, key=lambda o: o[2])[0] if active else "host"
            tot[short(name)] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]


def short(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:100]
