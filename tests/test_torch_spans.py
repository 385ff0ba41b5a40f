"""The program's spans and counters (nerfmlp_torch/utils/spans.py): off
without a profiler, nested and on the Chrome trace's clock under one, and
where the serving and training paths record them; /health's latency over
the whole request.

Imports neither jax nor the JAX package, so the card's case also runs
where only PyTorch and the CUDA toolkit are installed:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import json
import time

import pytest
import torch

from nerfmlp_torch.config import RenderConfig, TrainConfig
from nerfmlp_torch.data.blender import BlenderDataset
from nerfmlp_torch.data.synthetic import make_synthetic_scene
from nerfmlp_torch.models.mlp import NeRFMLP
from nerfmlp_torch.ops.rays import pose_spherical
from nerfmlp_torch.serve import RenderService
from nerfmlp_torch.train.loop import Trainer
from nerfmlp_torch.utils import spans

CPU = [torch.profiler.ProfilerActivity.CPU]
ARCH = dict(depth=2, width=32, N_samples=8, N_importance=8)
BOX = (-1.5, -1.5, -1.2, 1.5, 1.5, 1.5)


@pytest.fixture(autouse=True)
def _clean_store():
    """One intra-op thread, and an empty store before and after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.drain()
    yield
    spans.drain()
    torch.set_num_threads(n)


def _trace(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0))


def test_off_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = spans.span("a", group=1), spans.span("b")
    assert first is second
    with first:
        spans.count("c", 3)
    assert spans.drain() == {"spans": [], "counts": {}}


def test_nesting_groups_and_the_trace_clock(tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with spans.span("outer", group=7):
            with spans.span("inner"):
                torch.ones(64).sum()
                with spans.span("leaf", label="leaf range"):
                    spans.count("things", 2)
            with spans.span("inner"):
                spans.count("things")
        with spans.span("alone"):
            pass
    got = spans.drain()
    assert got["counts"] == {"things": 3}
    by = {}
    for s in got["spans"]:
        by.setdefault(s.name, []).append(s)
    outer, = by["outer"]
    assert outer.parent is None and outer.group == 7
    assert [s.parent for s in by["inner"]] == [outer.id, outer.id]
    assert by["leaf"][0].parent == by["inner"][0].id
    assert {s.group for s in by["inner"] + by["leaf"]} == {7}
    alone, = by["alone"]
    assert alone.parent is None and alone.group == alone.id
    # The closing order: children before their parent.
    assert [s.name for s in got["spans"]] == ["leaf", "inner", "inner",
                                              "outer", "alone"]

    events, base = _trace(prof, tmp_path / "t.json")
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    names = {"outer": "outer", "inner": "inner", "leaf": "leaf range",
             "alone": "alone"}
    slack = 500_000   # ns
    for name, label in names.items():
        assert len(ranges[label]) == len(by[name]), label
        for s, e in zip(sorted(by[name], key=lambda s: s.start_ns),
                        sorted(ranges[label], key=lambda e: e["ts"])):
            a = e["ts"] * 1000 + base
            b = a + e["dur"] * 1000
            assert s.start_ns - slack <= a and b <= s.end_ns + slack, name
            assert s.end_ns - s.start_ns < (b - a) + 2 * slack, name


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with torch.profiler.profile(activities=CPU):
        for _ in range(5):
            with spans.span("s"):
                pass
    got = spans.drain()
    assert len(got["spans"]) == 3 and got["counts"] == {"spans.dropped": 2}


def _service(**kw):
    cfg = RenderConfig(near=2.0, far=6.0, perturb=False, **dict(ARCH, **kw))
    torch.manual_seed(0)
    net = NeRFMLP(cfg.model_config())
    return RenderService({"coarse": net}, cfg, 12, 10, 15.0, tile=64,
                         device="cpu", log=lambda *a: None)


@pytest.mark.parametrize("occupancy", [False, True])
def test_a_request_records_its_stages(occupancy):
    """Dense 8 + 8 or the grid's 8 probes + 8 refinements: 16 points a
    ray, padding included."""
    kw = dict(use_occupancy=True, aabb=BOX, occ_grid_size=8,
              occ_dense_samples=16) if occupancy else {}
    svc = _service(**kw)
    spans.drain()   # the grid's build
    with torch.profiler.profile(activities=CPU):
        body, ctype = svc.render_request(
            {"theta": 20, "phi": -30, "radius": 4, "format": "png"})
    assert ctype == "image/png"
    got = spans.drain()
    root, = [s for s in got["spans"] if s.name == "serve.request"]
    assert root.parent is None and root.group == 1
    kids = sorted((s for s in got["spans"] if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["serve.wait", "serve.render",
                                      "serve.copy", "serve.encode"]
    assert all(s.group == root.group for s in kids)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert root.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= root.end_ns
    c = got["counts"]
    rays, pad = 12 * 10, 2 * 64 - 12 * 10
    assert c == {"serve.rays": rays, "mlp.points": (rays + pad) * 16}
    # A second request is number 2.
    with torch.profiler.profile(activities=CPU):
        svc.render_request({"theta": 40, "phi": -30, "radius": 4})
    assert [s.group for s in spans.drain()["spans"]] == [2] * 5


def test_health_times_the_whole_request(monkeypatch):
    """The latency runs from the call to the body, the encode included;
    wait_ms comes from the same requests."""
    svc = _service()
    encode = svc._encode

    def slow(*a):
        time.sleep(0.5)
        return encode(*a)

    monkeypatch.setattr(svc, "_encode", slow)
    svc.render_request({"theta": 0, "phi": -30, "radius": 4})
    svc.render_pose(pose_spherical(0.0, -30.0, 4.0))
    h = svc.health()
    lat = h["latency"]
    assert h["renders"] == 2 and lat["n"] == 2
    assert lat["max_ms"] >= 500.0 > lat["p50_ms"]
    assert set(lat["wait_ms"]) == {"p50", "p95"}
    assert 0.0 <= lat["wait_ms"]["p50"] <= lat["wait_ms"]["p95"] < 500.0
    assert spans.drain() == {"spans": [], "counts": {}}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_synthetic_scene(root, n_train=3, n_val=1, n_test=0, img_wh=(16, 16))
    return root


@pytest.mark.parametrize("k, occupancy", [(1, False), (4, True)])
def test_the_training_loop_records_its_stages(scene, tmp_path, k,
                                              occupancy):
    ds = BlenderDataset(scene, "train", img_wh=(16, 16))
    near, far = ds.dynamic_near_far()
    occ = dict(use_occupancy=True, aabb=BOX, occ_grid_size=8,
               occ_dense_samples=16, occ_update_every=4,
               occ_warmup_steps=4) if occupancy else {}
    rc = RenderConfig(near=near, far=far, **ARCH, **occ)
    tc = TrainConfig(batch_size=32, iters=3, precrop_iters=2, seed=1,
                     steps_per_dispatch=k, quick_val_interval=0,
                     full_val_interval=0, log_interval=5, ckpt_interval=0)
    t = Trainer(rc, tc, ds, save_dir=str(tmp_path), device="cpu",
                verbose=False)
    t.train()
    spans.drain()
    with torch.profiler.profile(activities=CPU):
        t.train(iters=13)
    got = spans.drain()
    wins = [s for s in got["spans"] if s.name == "train.window"]
    for w in wins:
        kids = [s for s in got["spans"] if s.parent == w.id]
        assert {s.group for s in kids} <= {w.group}
        kids = [s.name for s in kids]
        assert kids.count("train.dispatch") == 1, kids
        assert "train.batch" in kids or k > 1
    names = [s.name for s in got["spans"]]
    assert names.count("train.log") == 2        # steps 5 and 10
    assert names.count("train.save") == 2
    assert names.count("train.epoch") == len(wins)
    # a refresh at steps 5, 9 and 13 (every 4 from step 1)
    assert names.count("train.occ_update") == (3 if occupancy else 0)
    # Each window is grouped by its first step; the windows tile steps
    # 4-13, the 10 steps taken, and at K = 4 end at the log steps (5, 10)
    # and before the refreshes (multiples of 4).
    firsts = [s.group for s in wins] + [14]
    steps = [b - a for a, b in zip(firsts, firsts[1:])]
    assert firsts[0] == 4 and min(steps) >= 1 and sum(steps) == 10
    assert max(steps) == (3 if k > 1 else 1)


@pytest.mark.cuda
def test_a_span_holds_its_kernel_under_a_cuda_profiler(tmp_path):
    """As the benchmark traces: CUDA activity alone. A span around a
    kernel and a synchronise contains the kernel's device interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda._sleep(1000)   # the first launch's set-up
    torch.cuda.synchronize()
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda) as prof:
        with spans.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    s, = spans.drain()["spans"]
    events, base = _trace(prof, tmp_path / "t.json")
    kern = [e for e in events if e.get("cat") == "kernel"]
    assert len(kern) == 1, [(e.get("cat"), e.get("name")) for e in events]
    a = kern[0]["ts"] * 1000 + base
    b = a + kern[0]["dur"] * 1000
    assert kern[0]["dur"] > 1000                  # us: the sleep ran
    assert s.start_ns <= a and b <= s.end_ns, (s, a, b)
