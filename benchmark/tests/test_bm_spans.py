"""The readers of the program's spans (``benchmark/spans.py`` and the five
metrics on it) on synthetic spans and a synthetic traced window: the
trace's clock, per-frame means, the device's idle time inside spans as
self time, one drain shared by every reader of a run, and nothing from a
program that records no spans."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark import spans as bench_spans
from nerfmlp_torch.utils import spans as program
from nerfmlp_torch.utils.spans import Span

BASE = 1_000_000_000_000   # ns: the trace's zero
US = 1_000                 # ns a microsecond


class FakeTraced:
    """A window [0, 1000] us, the device busy over ``busy`` (us)."""

    def __init__(self, busy, host_ops=()):
        self.t_start, self.t_end, self.window_s = 0.0, 1000.0, 1e-3
        self.busy, self.host_ops = busy, list(host_ops)

    def busy_intervals(self):
        return list(self.busy)


def sp(i, parent, group, name, t0, t1):
    return Span(i, parent, group, name, BASE + t0 * US, BASE + t1 * US)


def frames():
    """Two frames, [0, 400] and [500, 900] us, each request > wait,
    render, copy, encode."""
    out = []
    for g, o in ((1, 0), (2, 500)):
        r = 10 * g
        out += [sp(r + 1, r, g, "serve.wait", o, o + 10),
                sp(r + 2, r, g, "serve.render", o + 10, o + 210),
                sp(r + 3, r, g, "serve.copy", o + 210, o + 300),
                sp(r + 4, r, g, "serve.encode", o + 300, o + 400),
                sp(r, None, g, "serve.request", o, o + 400)]
    counts = {"serve.rays": 160_000, "mlp.points": 192 * 163_840}
    return {"spans": out, "counts": counts}


# Busy in each frame from 50 to 250 and 260 to 300 us after its start:
# idle 10 in wait, 40 in render, 10 in copy, 100 in encode; between the
# frames 100 and after them 100 unattributed.
BUSY = [(o + 50, o + 250) for o in (0, 500)] + [(o + 260, o + 300)
                                                 for o in (0, 500)]
BUSY.sort()


@pytest.fixture
def drained(monkeypatch):
    """The program's drain and the clock's zero, faked; counts drains."""
    calls = []

    def install(recorded):
        def drain():
            calls.append(1)
            out = recorded if len(calls) == 1 else {"spans": [],
                                                    "counts": {}}
            return out
        monkeypatch.setattr(program, "drain", drain)
        monkeypatch.setattr(bench_spans, "base_ns", lambda: BASE)
        return calls
    return install


def ctx_of(traced, mode="serve", steps=0):
    return {"trace": traced, "window_s": traced.window_s,
            "work": {"mode": mode, "frames": 2, "steps": steps}}


def test_idle_by_span_is_self_time(drained):
    drained(frames())
    out = bench_spans.of(ctx_of(FakeTraced(BUSY)))
    by_name = {}
    for s in out["spans"]:
        by_name[s["name"]] = by_name.get(s["name"], 0.0) + out["idle"][s["id"]]
    assert by_name["serve.wait"] == pytest.approx(20e-6)
    assert by_name["serve.render"] == pytest.approx(80e-6)
    assert by_name["serve.copy"] == pytest.approx(20e-6)
    assert by_name["serve.encode"] == pytest.approx(200e-6)
    assert by_name["serve.request"] == pytest.approx(0.0, abs=1e-12)
    assert out["idle_s"] == pytest.approx(520e-6)
    assert out["unattributed_s"] == pytest.approx(200e-6)


@pytest.mark.parametrize("metric, value", [
    ("encode_ms.serve", 0.1), ("enqueue_ms.serve", 0.2),
    ("launch_idle_ms.serve", 0.04), ("mlp_points_per_ray.serve", 196.608)])
def test_serve_readers(drained, metric, value):
    drained(frames())
    read = harness.reader(metric)
    assert read(ctx_of(FakeTraced(BUSY))) == pytest.approx(value)


def test_readers_of_one_run_share_one_drain(drained, capsys):
    calls = drained(frames())
    ctx = ctx_of(FakeTraced(BUSY))
    got = [harness.reader(m)(ctx) for m in ("encode_ms.serve",
                                            "enqueue_ms.serve",
                                            "launch_idle_ms.serve")]
    assert got == pytest.approx([0.1, 0.2, 0.04]) and len(calls) == 1
    assert harness.reader("loop_idle_ms.train")(ctx) is None
    assert capsys.readouterr().out.count("[bench] idle by span") == 1


def test_spans_outside_the_window_are_clipped(drained):
    rec = frames()
    rec["spans"].append(sp(99, None, 99, "serve.request", -300, 100))
    rec["spans"].append(sp(98, None, 98, "serve.request", 1100, 1200))
    drained(rec)
    out = bench_spans.of(ctx_of(FakeTraced(BUSY)))
    early = [s for s in out["spans"] if s["id"] == 99][0]
    assert (early["t0"], early["t1"]) == (0.0, 100.0)
    assert 98 not in {s["id"] for s in out["spans"]}
    assert bench_spans.frames(out) == 3


def test_the_clock_check_finds_each_frames_copy(drained, capsys):
    ops = [("cudaMemcpyAsync", 5.0, 2.0), ("cudaMemcpyAsync", 220.0, 5.0),
           ("cudaMemcpyAsync", 505.0, 2.0), ("cudaMemcpyAsync", 150.0 + 500,
                                             5.0)]
    drained(frames())
    bench_spans.of(ctx_of(FakeTraced(BUSY, ops)))
    # frame 1's last copy lies in its serve.copy span, frame 2's not
    assert "clock check: 1 of 2 serve.copy" in capsys.readouterr().out


def test_loop_idle_a_step(drained):
    rec = {"spans": [
        sp(2, 1, 1, "train.batch", 0, 100),
        sp(3, 1, 1, "train.dispatch", 100, 200),
        sp(1, None, 1, "train.window", 0, 300),
        sp(5, 4, 17, "train.occ_update", 300, 400),
        sp(6, 4, 17, "train.log", 500, 600),
        sp(4, None, 17, "train.window", 300, 700),
        sp(7, None, 7, "train.save", 700, 1000)],
        "counts": {}}
    drained(rec)
    busy = [(50, 150), (350, 450), (550, 560), (800, 900)]
    ctx = ctx_of(FakeTraced(busy), mode="train", steps=32)
    # idle: batch 50, occ_update 50, log 90 us; not dispatch's 50, the
    # windows' own 300-350 / 450-500 / 600-700, nor the final save's 200
    assert harness.reader("loop_idle_ms.train")(ctx) == pytest.approx(
        1e3 * 190e-6 / 32)


METRICS = ["encode_ms.serve", "enqueue_ms.serve", "launch_idle_ms.serve",
           "mlp_points_per_ray.serve", "loop_idle_ms.train"]


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_from_an_overflowed_store(drained, metric):
    """Spans dropped past the program's bound would make every sum fall
    short: no reader reports."""
    rec = frames()
    rec["counts"]["spans.dropped"] = 1
    drained(rec)
    mode = "train" if metric.endswith(".train") else "serve"
    assert harness.reader(metric)(ctx_of(FakeTraced(BUSY), mode, 32)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_from_a_program_without_spans(monkeypatch, metric):
    import builtins

    real = builtins.__import__

    def no_spans(name, *a, **kw):
        if name == "nerfmlp_torch.utils" and "spans" in (a[2] or ()):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    mode = "train" if metric.endswith(".train") else "serve"
    assert harness.reader(metric)(ctx_of(FakeTraced(BUSY), mode, 32)) is None


def test_the_trace_base_is_a_chrome_traces():
    base = bench_spans.base_ns()
    assert base >= 0 and base % 1_000_000_000 == 0
