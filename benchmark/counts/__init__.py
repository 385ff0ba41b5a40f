"""The yardstick's counts: the work each fused-MLP call has to do, the
least time the card could take for it, the evaluations a ray costs and
the useful operations of a step and of a frame.

Counted from the configuration's shapes, whatever implements them, so a
later design (stored activations, no workspace, another tiling) is read
against the same numbers:

* forward: the net's multiply-adds (one per weight) for every point;
  bytes: the points (3 fp32) and encoded directions (bf16) in, the
  weights (bf16) and biases (fp32), the (T, 4) fp32 output, each once;
* backward: dX and dW, twice the forward's multiply-adds; bytes: its
  inputs (points, directions, the (T, 4) fp32 cotangent, the weights)
  and its outputs (every weight's and bias's fp32 gradient), each once.
  No workspace and no recompute are counted.

The least time of a call is the larger of its operations over the
card's peak rate and its bytes over its peak bandwidth (``peaks.json``).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> Dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def kernel_roles() -> Dict[str, List[str]]:
    """Role (fwd, bwd) -> the names of the program's kernels that play it
    (matched as substrings of the traced kernel names)."""
    with open(os.path.join(HERE, "kernels.json")) as f:
        return json.load(f)


def layer_dims(model: Dict) -> List[Tuple[int, int]]:
    """(inputs, outputs) of every dense layer of the view-dependent net."""
    x = 3 * (1 + 2 * model["pos_enc_L"])
    d = 3 * (1 + 2 * model["dir_enc_L"])
    wd = model["width"]
    dims = []
    for i in range(model["depth"]):
        n_in = x if i == 0 else wd
        dims.append((n_in + (x if i in model["skips"] else 0), wd))
    dims += [(wd, 1), (wd, wd), (wd + d, wd // 2), (wd // 2, 3)]
    return dims


def macs_per_point(model: Dict) -> int:
    """Forward multiply-adds of one point: one per weight."""
    return sum(a * b for a, b in layer_dims(model))


def n_biases(model: Dict) -> int:
    return sum(b for _, b in layer_dims(model))


def dirs_dim(model: Dict) -> int:
    return 3 * (1 + 2 * model["dir_enc_L"])


def evals_per_ray(render: Dict) -> int:
    """Net evaluations a ray costs. Occupancy sampling queries only the
    final net, at N_samples + N_importance depths, with or without a
    separate fine net; the shared hierarchical net is queried at the
    N_samples coarse depths and the N_importance new ones; a separate
    fine net re-queries the coarse depths too."""
    ns, ni = render["N_samples"], render.get("N_importance", 0)
    if render.get("use_occupancy"):
        return ns + ni
    if render.get("separate_fine") and ni > 0:
        return 2 * ns + ni
    return ns + ni


def fwd_work(model: Dict, points: int) -> Tuple[float, float]:
    """(operations, bytes) of one forward call over ``points``."""
    macs = macs_per_point(model)
    bytes_ = (points * (3 * 4 + dirs_dim(model) * 2 + 4 * 4)
              + macs * 2 + n_biases(model) * 4)
    return 2.0 * macs * points, float(bytes_)


def bwd_work(model: Dict, points: int) -> Tuple[float, float]:
    """(operations, bytes) of one backward call over ``points``."""
    macs = macs_per_point(model)
    bytes_ = (points * (3 * 4 + dirs_dim(model) * 2 + 4 * 4)
              + macs * 2 + n_biases(model) * 4
              + (macs + n_biases(model)) * 4)
    return 4.0 * macs * points, float(bytes_)


def least_time(ops: float, bytes_: float) -> Tuple[float, str]:
    """(seconds, "operations" | "bytes"): the bound that holds."""
    p = peaks()
    t_ops, t_bytes = ops / p["bf16_flops_per_s"], bytes_ / p["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_calls(render: Dict, rays: int) -> List[int]:
    """Points of each net call of one training step, each differentiated
    (one forward and one backward call apiece)."""
    ns, ni = render["N_samples"], render.get("N_importance", 0)
    if render.get("use_occupancy") and not render.get("occ_one_shot"):
        return [rays * ns, rays * ni]
    if render.get("use_occupancy"):
        return [rays * (ns + ni)]
    if render.get("separate_fine") and ni > 0:
        return [rays * ns, rays * (ns + ni)]
    return [rays * ns, rays * ni] if ni > 0 else [rays * ns]


def frame_calls(render: Dict, pixels: int, tile: int) -> List[int]:
    """Points of each forward call of one frame: its rays padded to whole
    tiles, each tile a training step's calls without the gradient."""
    tiles = -(-pixels // tile)
    return [p for _ in range(tiles) for p in step_calls(render, tile)]


def refresh_points(render: Dict) -> int:
    """Points of one grid refresh (one forward call)."""
    return render["occ_grid_size"] ** 3


def train_useful_flops(model: Dict, render: Dict, rays: int) -> float:
    """Useful operations of training ``rays`` rays: forward and backward,
    3 x the forward's, at the evaluations a ray needs; grid refreshes and
    the backward's recompute are not counted."""
    return 3.0 * 2.0 * macs_per_point(model) * evals_per_ray(render) * rays


def frame_useful_flops(model: Dict, render: Dict, pixels: int) -> float:
    """Forward operations of one frame's rays (no padding)."""
    return 2.0 * macs_per_point(model) * evals_per_ray(render) * pixels


def mfu_pct(flops: float, seconds: float) -> float:
    """A share of the card's peak: ``flops`` over ``seconds``."""
    return 100.0 * flops / seconds / peaks()["bf16_flops_per_s"]


def role_seconds(kernels, role: str) -> float:
    """Device seconds of the traced kernels that play ``role`` (a key of
    ``kernels.json``); ``kernels``: (name, start us, duration us)."""
    names = kernel_roles()[role]
    return sum(d for n, _, d in kernels if any(k in n for k in names)) * 1e-6


def other_seconds(kernels) -> float:
    """Device seconds of the traced kernels that play no role."""
    names = [k for ks in kernel_roles().values() for k in ks]
    return sum(d for n, _, d in kernels
               if not any(k in n for k in names)) * 1e-6


def roofline_pct(kernels, role: str, calls: List[int], model: Dict):
    """The least time of ``calls`` (points per call) over the device time
    of the kernels of ``role`` (fwd or bwd), in %; None where the trace
    holds none of them."""
    dev = role_seconds(kernels, role)
    if dev <= 0 or not calls:
        return None
    work = fwd_work if role == "fwd" else bwd_work
    least = sum(n * least_time(*work(model, p))[0]
                for p, n in Counter(calls).items())
    return 100.0 * least / dev
