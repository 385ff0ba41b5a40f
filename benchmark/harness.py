"""What every cell shares: ``BENCHMARK.json`` and the files it names, the
seeds, the program's configuration objects, the limits, the per-layer
readers and the result line.

A cell is found by name: its configuration in ``configs/<config>.json``,
its traffic in ``traffic/<traffic>.json`` (whose ``kind`` names the
driver in ``drivers/``), its limits in ``limits/<cell>.json``, and each
per-layer metric's reader in ``metrics/<metric>.py``. A new cell is one
``workloads`` entry and, at most, one new file of each kind.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "nerfmlp_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, spec: Optional[Dict] = None,
              here: str = HERE) -> Cell:
    spec = spec or bench_spec(os.path.dirname(here))
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    root = os.path.dirname(here)
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, cfg_entry["file"])),
        traffic=load_json(os.path.join(here, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if name in m["workloads"]])


def reader(metric: str, here: str = HERE):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(here, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def subseed(seed: int, purpose: int) -> int:
    """A 32-bit seed for one purpose (scene, weights, trainer, poses)."""
    return int(np.random.SeedSequence([int(seed), purpose])
               .generate_state(1)[0])


SCENE, WEIGHTS, TRAINER, POSES, CHECK = range(5)


def program_configs(cfg: Dict, seed: int):
    """The program's (RenderConfig, TrainConfig) of a configuration: every
    key of its ``render`` and ``train`` groups, the model's sizes, and
    what the benchmark fixes (no validation, no checkpoints in the run,
    the trainer's seed)."""
    from nerfmlp_torch.config import RenderConfig, TrainConfig

    model = {k: v for k, v in cfg["model"].items() if k != "skips"}
    render = dict(cfg["render"])
    if render.get("aabb") is not None:
        render["aabb"] = tuple(render["aabb"])
    rc = RenderConfig(**model, **render)
    if list(rc.model_config().skips) != list(cfg["model"]["skips"]):
        raise ValueError("the configuration's skips differ from the "
                         "program's rule for its depth")
    tc = TrainConfig(**cfg.get("train", {}), seed=seed, quick_val_interval=0,
                     full_val_interval=0, ckpt_interval=0)
    return rc, tc


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or its package's."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def compare(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): each limited number at most its
    limit; a missing or non-finite number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": None if v is None else float(v),
                     "limit": float(limit)}
    return ok, out
