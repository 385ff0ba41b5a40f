"""``BENCHMARK.json`` as data: every name resolves to its file, names and
units keep to their characters, each per-layer metric moves an end-to-end
metric that its cells report, and a configuration, a traffic mix, a
metric and a cell added as new files are found with no edit to a file
that is there."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

SPEC = harness.bench_spec()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["traffic"] for w in SPEC["workloads"]])
    assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        for entry in SPEC[group]:
            assert 1 <= len(entry["why"]) <= 200


def test_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    w = [x for x in SPEC["workloads"] if x["name"] == cell][0]
    assert c.config["name"] == w["config"] and w["chips"] == 1
    assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                       c.traffic["kind"] + ".py"))
    assert c.limits
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in harness.load_cell(cell).end_to_end}
            assert m["moves"] in e2e, (m["name"], cell)


def test_config_files_name_their_source_and_cuts():
    for entry in SPEC["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
        assert cfg["name"] == entry["name"]
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["source"] and cfg["assumed"]


def test_new_files_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    here = str(root / "benchmark")
    cfg = harness.load_json(os.path.join(
        ROOT, "benchmark/configs/nerf_paper_8x256_bf16.json"))
    cfg["name"] = "nerf_new"
    (root / "benchmark/configs/nerf_new.json").write_text(json.dumps(cfg))
    traffic = harness.load_json(os.path.join(
        harness.HERE, "traffic/frames_closed.json"))
    traffic["H"] = traffic["W"] = 200
    (root / "benchmark/traffic/frames_small.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/limits/new_serve.json").write_text(
        json.dumps({"level_gap_mean": 1.0}))
    (root / "benchmark/metrics/frames_seen.serve.py").write_text(
        "def read(ctx):\n    return float(ctx['work']['frames'])\n")
    spec["configs"].append({"name": "nerf_new", "source": "x",
                            "file": "benchmark/configs/nerf_new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new_serve", "config": "nerf_new",
                              "traffic": "frames_small", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "frames_seen.serve", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "frame assembly",
                              "moves": "frame_ms_mean",
                              "workloads": ["new_serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("new_serve", here=here)
    assert cell.config["name"] == "nerf_new" and cell.traffic["H"] == 200
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.serve"]
    read = harness.reader("frames_seen.serve", here=here)
    assert read({"work": {"frames": 3}}) == 3.0
