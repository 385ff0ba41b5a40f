"""Where the fused MLP backward's time goes, on one GPU.

    python -m nerfmlp_torch.scripts.bwd_ablate

Builds csrc/fused_mlp_bwd.cu as it is and in variants with one part of a
kernel taken out (results are then wrong: only their time counts), all
builds started together, and times each variant's two phases at the
flagship train step's fine call (1024 rays x 128 samples, 8x256 + view
head, bf16, random weights from seed 0). Then, with the source as it is:
phase 2 and the reduction at 4 to 32 row splits, and the whole backward
at the fine and coarse calls in one chunk per call and in chunks of 8,192
points (80 MB of workspace, against 1.31 GB for the fine call in one
chunk). Device times by CUDA events, median of 10, with a GPU spin ahead
of each timed call so that the host's launch path is not timed. Variant
sources go under build/nerfmlp_torch/ablate/; a variant whose text is no
longer in the source fails with its name. Needs no jax.
"""

import argparse
import concurrent.futures
import os
import statistics
import subprocess
from unittest import mock

import torch

from nerfmlp_torch.config import RenderConfig
from nerfmlp_torch.models.mlp import init_model
from nerfmlp_torch.ops import _build
from nerfmlp_torch.ops import fused_mlp as fm
from nerfmlp_torch.ops.encoding import positional_encoding

_SRC = os.path.join(_build.CSRC, "fused_mlp_bwd.cu")
_P1_END = "// dW and db partials of one job"
CHUNK_TRY = 8192

# name -> [(old text, new text, in phase 1's kernel or not)]
VARIANTS = {
    "as built": [],
    "phase 1 without mma": [(
        "            mma(acc[mt][2 * p], a[mt], b[0], b[1]);\n"
        "            mma(acc[mt][2 * p + 1], a[mt], b[2], b[3]);",
        "            acc[mt][2 * p][0] += __uint_as_float(a[mt][0] ^ b[0]);\n"
        "            acc[mt][2 * p + 1][0] += __uint_as_float(a[mt][1] ^ b[2]);",
        True)],
    "phase 1 without slab wait + barrier": [(
        "        cp_async_wait_n(stages - 2);\n"
        "        __syncthreads();  // the slab is in; the oldest slot is free\n",
        "", True)],
    "phase 1 without weight loads": [(
        "      if (f_dst >= 0) {", "      if (false) {", True)],
    "phase 1 without workspace copy": [(
        "      if (m >= 0) {", "      if (false) {", True)],
    "phase 1 without B-fragment ldmatrix": [(
        "          if (fwd) {\n"
        "            ldsm_x4_t(b, q);\n"
        "            if (kHiLo) ldsm_x4_t(bl, q + half);\n"
        "          } else {\n"
        "            ldsm_x4(b, q);\n"
        "            if (kHiLo) ldsm_x4(bl, q + half);\n"
        "          }",
        "          b[0] = b[1] = b[2] = b[3] = lane ^ j;\n"
        "          bl[0] = bl[1] = bl[2] = bl[3] = lane;\n"
        "          (void)q;", True)],
    "phase 1 without A-fragment ldmatrix": [(
        "          ldsm_x4(a[mt], a_base + mt * 16 * ld);",
        "          a[mt][0] = a[mt][1] = a[mt][2] = a[mt][3] = j + lane;\n"
        "          (void)a_base;", True)],
    "phase 2 without mma": [(
        "          mma(acc[mt][2 * p], a[mt], b[0], b[1]);\n"
        "          mma(acc[mt][2 * p + 1], a[mt], b[2], b[3]);\n"
        "          if (kHiLo) {",
        "          acc[mt][2 * p][0] += __uint_as_float(a[mt][0] ^ b[0]);\n"
        "          acc[mt][2 * p + 1][0] += __uint_as_float(a[mt][1] ^ b[2]);\n"
        "          if (kHiLo) {", False)],
    "phase 2 without loads": [
        ("      if (cc < ca) {", "      if (false) {", False),
        ("      if (cc < cy) {", "      if (false) {", False)],
}


def variant_source(name: str) -> str:
    """The backward's source with the named variant's edits applied; each
    edit's text must occur once in its kernel's part of the source."""
    src = open(_SRC).read()
    for old, new, phase1 in VARIANTS[name]:
        cut = src.index(_P1_END)
        part = src[:cut] if phase1 else src[cut:]
        if part.count(old) != 1:
            raise RuntimeError(f"{name}: its text is not found once in the "
                               f"source: {old!r}")
        part = part.replace(old, new)
        src = part + src[cut:] if phase1 else src[:cut] + part
    return src


def build_variants(names):
    """Each variant's source directory, every one built (in parallel)."""
    dirs = {}
    for name in names:
        d = os.path.join(_build.build_dir(), "ablate", name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "fused_mlp_bwd.cu"), "w") as f:
            f.write(variant_source(name))
        dirs[name] = d
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: _build.build(["fused_mlp_bwd"], d),
                      dirs.values()))
    return dirs


def device_ms(fn, iters: int = 10) -> float:
    fn()
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_inputs(n, cfg):
    """Points in the scene box, encoded unit view directions and a small
    random cotangent for n points, from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    pts = torch.rand((n, 3), device="cuda", generator=gen) * 2.4 - 1.2
    d = torch.randn((n, 3), device="cuda", generator=gen)
    dirs = positional_encoding(d / d.norm(dim=-1, keepdim=True),
                               cfg.dir_enc_L)
    g = torch.randn((n, 4), device="cuda", generator=gen) / n
    return pts, dirs, g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablate: needs a CUDA device")
    cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True)
    net = init_model(cfg.model_config(), seed=0, device="cuda")
    packed = fm.pack_params(net, cfg.pos_enc_L, True)
    total = packed.grad_total
    n = 1024 * 128
    pts, dirs, g = call_inputs(n, cfg)
    ws = torch.empty(n * packed.ws_cols, device="cuda", dtype=torch.bfloat16)
    splits, split_rows = fm.bwd_splits(n)
    part = torch.empty((splits, fm.part_stride(total)), device="cuda")
    print(f"[ablate] {torch.cuda.get_device_name(0)}; fine call, n={n}, "
          f"{splits} splits of {split_rows} rows")
    for name, d in build_variants(VARIANTS).items():
        lib = fm._bwd_kernel(d)
        with mock.patch.object(fm, "_bwd_kernel", lambda: lib):
            t1 = device_ms(lambda: fm.bwd_workspace(packed, pts, dirs, g, ws))
            t2 = device_ms(lambda: fm.weight_grads(packed, ws, n, split_rows,
                                                   part))
        print(f"[ablate] {name}: phase 1 {t1:.3f} ms, phase 2 {t2:.3f} ms",
              flush=True)

    fm.bwd_workspace(packed, pts, dirs, g, ws)
    for s in (4, 8, 16, 32):
        for rows in (n // 2, n):
            per = -(-rows // (s * fm.BWD_STAGE_ROWS)) * fm.BWD_STAGE_ROWS
            part = torch.empty((-(-rows // per), fm.part_stride(total)),
                               device="cuda")
            t2 = device_ms(lambda: fm.weight_grads(packed, ws, rows, per,
                                                   part))
            t3 = device_ms(lambda: fm.reduce_partials(part, total))
            tl = device_ms(lambda: part[:, :total].sum(0))
            print(f"[ablate] {rows} rows in {part.shape[0]} splits: phase 2 "
                  f"{t2:.3f} ms, reduction {t3:.4f} ms (part.sum(0) "
                  f"{tl:.4f} ms)", flush=True)

    for rows, label in ((n, "fine"), (n // 2, "coarse")):
        p, d, gg = call_inputs(rows, cfg)
        one = device_ms(lambda: fm._launch_bwd(packed, p, d, gg))
        with mock.patch.object(fm, "BWD_CHUNK_ROWS", CHUNK_TRY):
            chunked = device_ms(lambda: fm._launch_bwd(packed, p, d, gg))
        print(f"[ablate] {label} call, whole backward: one chunk of "
              f"{fm.BWD_CHUNK_ROWS} points {one:.3f} ms, chunks of "
              f"{CHUNK_TRY} points {chunked:.3f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
