"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload paper_train --seed 7 --seconds 40 \\
        --trace 0

From the root of a checkout that holds the program (``nerfmlp_torch``),
on a machine with the cards the cell asks for. ``--trace 0`` measures the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled window. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), then ``checks``: each number the
correctness check compared, with its limit, which also end standard
error. Without CUDA, with too few cards, or with JAX loaded once the
window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import counts, harness  # noqa: E402


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["NERFMLP_TORCH_BUILD_DIR"] = os.path.join(build,
                                                         "nerfmlp_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def per_layer(cell: harness.Cell, result: dict) -> dict:
    """Each per-layer metric of the cell whose reader finds something."""
    traced = result["traced"]
    ctx = {"trace": traced, "window_s": traced.window_s,
           "work": result["work"], "model": cell.config["model"],
           "render": cell.config["render"]}
    roles = counts.kernel_roles()
    launches = sum(1 for n, _, _ in traced.kernels()
                   if any(k in n for k in roles["fwd"]))
    print(f"[bench] forward launches traced {launches}, counted "
          f"{len(result['work']['fwd_calls'])}", flush=True)
    out = {}
    for m in cell.per_layer:
        value = harness.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(args, device="cuda", overrides=None) -> dict:
    """One run of the cell: the result object, or SystemExit where the
    contract says no result."""
    cell = harness.load_cell(args.workload)
    if overrides:
        overrides(cell)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("benchmark: no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            sys.exit(f"benchmark: {cell.name} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} found")
        print(f"[bench] card and power limit: {power_limit()}", flush=True)
    drv = harness.driver(cell.traffic["kind"])
    res = drv.run(cell, args.seed, args.seconds, bool(args.trace), device,
                  T0)
    banned = harness.banned_modules()
    if banned:
        sys.exit(f"benchmark: loaded {', '.join(banned)} (JAX or its "
                 "package) in the measured process")
    correct, checks = harness.compare(res["readings"], cell.limits)
    info = {k: v for k, v in res["readings"].items() if k not in checks}
    if args.trace:
        metrics = per_layer(cell, res)
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in res["e2e"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(res["peak"])}
    line = {"correct": bool(correct and res["failed"] == 0),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        t = res["traced"]
        dev.update(busy_s=t.busy_s(), window_s=t.window_s)
        line["breakdown"] = {"device_ops": t.device_ops_top(),
                             "idle_gaps": t.idle_gaps_top()}
    if info:
        print(f"[bench] not compared: {json.dumps(info)}", flush=True)
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return line


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(harness.ROOT)
    line = run(args)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
