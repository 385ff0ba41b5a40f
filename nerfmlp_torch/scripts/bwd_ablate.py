"""Where the fused MLP kernels' time goes, on one GPU.

    python -m nerfmlp_torch.scripts.bwd_ablate
    python -m nerfmlp_torch.scripts.bwd_ablate --outputs FILE
    python -m nerfmlp_torch.scripts.bwd_ablate --compare FILE FILE

Builds csrc/fused_mlp_bwd.cu and csrc/fused_mlp_fwd.cu as they are and in
variants with one part of a kernel taken out (results are then wrong:
only their time counts), all builds of a source started together, and
times each backward variant's two phases at the flagship train step's
fine call (1024 rays x 128 samples, 8x256 + view head, bf16, random
weights from seed 0), and each forward variant at that call and at the
served fine call (4096 rays x 128 samples), then the forward with its
narrow operations' weight rows per ring stage capped. Then, with the
sources as they are:
phase 2 and the reduction at 4 to 32 row splits, and the whole backward
at the fine and coarse calls in one chunk per call and in chunks of 8,192
points (80 MB of workspace, against 1.31 GB for the fine call in one
chunk). Device times by CUDA events, median of 10, with a GPU spin ahead
of each timed call so that the host's launch path is not timed. Variant
sources go under build/nerfmlp_torch/ablate/; a variant whose text is no
longer in the source fails with its name. Needs no jax.

``--outputs FILE`` instead writes the forward's output and the backward's
flat gradient of the depth-8 nets (OUTPUT_NETS) at the fine call, from
seed 0, and ``--compare A B`` holds two such files to each other bit for
bit (exit 1 on a difference): run with another tree's package first on
PYTHONPATH, they show that a change left those paths' results as they
were.
"""

import argparse
import concurrent.futures
import os
import shutil
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
_FWD_SRC = os.path.join(_build.CSRC, "fused_mlp_fwd.cu")
_P1_END = "// dW and db partials of one job"
CHUNK_TRY = 8192
# (width, view head, hi_lo) of the depth-8 nets --outputs writes: 8x256 and
# phase 16's wide nets (chip_smoke.py), and 8x592 without the view head.
OUTPUT_NETS = ((256, True, False), (256, True, True), (288, True, False),
               (384, True, False), (512, True, False), (640, True, False),
               (384, True, True), (512, True, True), (576, True, True),
               (592, False, False))

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


# The forward's variants: name -> [(old text, new text)].
FWD_VARIANTS = {
    "as built": [],
    "forward without mma": [(
        "            mma(acc[mt][2 * p], a[mt], b[0], b[1]);\n"
        "            mma(acc[mt][2 * p + 1], a[mt], b[2], b[3]);\n"
        "            if (kHiLo) {",
        "            acc[mt][2 * p][0] += __uint_as_float(a[mt][0] ^ b[0]);\n"
        "            acc[mt][2 * p + 1][0] += __uint_as_float(a[mt][1] ^ b[2]);\n"
        "            if (kHiLo) {")],
    "forward without stage wait + barrier": [(
        "        cp_async_wait_n(stages - 2);\n"
        "        __syncthreads();  // the slab is in; the oldest slot is free\n",
        "")],
    "forward without weight loads": [(
        "      if (f_dst >= 0) {", "      if (false) {")],
    "forward without B-fragment ldmatrix": [(
        "          ldsm_x4_t(b, q);\n"
        "          if (kHiLo) ldsm_x4_t(bl, q + half);",
        "          b[0] = b[1] = b[2] = b[3] = lane ^ p;\n"
        "          bl[0] = bl[1] = bl[2] = bl[3] = lane;\n"
        "          (void)q;")],
    "forward without A-fragment ldmatrix": [(
        "          ldsm_x4(a[mt], a_s + mt * 16 * ld);",
        "          a[mt][0] = a[mt][1] = a[mt][2] = a[mt][3] = mt + lane;\n"
        "          (void)a_s;")],
    "forward without encoding": [(
        "(g < n && j < enc_dim) ? encode(pts_s, g, j) : 0.f",
        "(g < n && j < enc_dim) ? 0.5f : 0.f")],
}


def fwd_variant_source(name: str) -> str:
    """The forward's source with the named variant's edits applied; each
    edit's text must occur once in the source."""
    src = open(_FWD_SRC).read()
    for old, new in FWD_VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: its text is not found once in the "
                               f"source: {old!r}")
        src = src.replace(old, new)
    return src


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


def build_variants(names, kernel="fused_mlp_bwd", source=variant_source):
    """Each variant's source directory for ``kernel`` (its source from
    ``source(name)``, beside the headers), every one built (in
    parallel)."""
    dirs = {}
    for name in names:
        d = os.path.join(_build.build_dir(), "ablate", kernel,
                         name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        for path in _build.sources(kernel)[1:]:   # the headers
            shutil.copy(path, d)
        with open(os.path.join(d, _build.KERNELS[kernel]), "w") as f:
            f.write(source(name))
        dirs[name] = d
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: _build.build([kernel], d), dirs.values()))
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


def write_outputs(path: str) -> None:
    """OUTPUT_NETS' forward outputs and flat backward gradients at the
    fine call (random weights and inputs from seed 0), to ``path``."""
    out = {}
    n = 1024 * 128
    for width, vdirs, hi_lo in OUTPUT_NETS:
        cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True,
                           width=width, use_viewdirs=vdirs)
        net = init_model(cfg.model_config(), seed=0, device="cuda")
        packed = fm.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
        pts, dirs, g = call_inputs(n, cfg)
        dirs = dirs if vdirs else None
        g = g[:, :packed.out_w]
        with torch.no_grad():
            key = f"8x{width}{'' if vdirs else ' no view head'}" + (
                " hi_lo" if hi_lo else "")
            out[key + " forward"] = fm._launch(packed, pts, dirs).cpu()
            out[key + " backward"] = fm._launch_bwd(packed, pts, dirs,
                                                    g).cpu()
        print(f"[outputs] {key}: phase-1 tile {packed.bwd_rows}", flush=True)
        del net, packed
        torch.cuda.empty_cache()
    torch.save(out, path)


def compare_outputs(a: str, b: str) -> int:
    """0 when the two --outputs files hold the same bits, else 1."""
    x, y = torch.load(a), torch.load(b)
    same = sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)
    for k in sorted(x):
        print(f"[compare] {k}: "
              f"{'bit-identical' if k in y and torch.equal(x[k], y[k]) else 'DIFFERS'}")
    print(f"[compare] {a} vs {b}: {'bit-identical' if same else 'DIFFER'}")
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outputs", metavar="FILE")
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    args = ap.parse_args(argv)
    if args.compare:
        return compare_outputs(*args.compare)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablate: needs a CUDA device")
    if args.outputs:
        write_outputs(args.outputs)
        return 0
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
    serve = call_inputs(4 * n, cfg)[:2]
    fwd_dirs = build_variants(FWD_VARIANTS, "fused_mlp_fwd",
                              fwd_variant_source)
    with torch.no_grad():
        for name, d in fwd_dirs.items():
            lib = fm._kernel(d)
            with mock.patch.object(fm, "_kernel", lambda: lib):
                tt = device_ms(lambda: fm._launch(packed, pts, dirs))
                ts = device_ms(lambda: fm._launch(packed, *serve))
            print(f"[ablate] {name}: train fine call {tt:.3f} ms, served "
                  f"fine call ({4 * n} points) {ts:.3f} ms", flush=True)
        # The narrow operations (sigma, rgb, view) with at most `cap` weight
        # rows per ring stage (0: a full-width stage's 16 * ksub rows, as
        # wide operations take), packed anew; the as-built program last.
        stage_rows = fm._stage_rows
        for cap in (0, 64, 128, None):
            def capped(lay, nn, k, cap=cap):
                got = stage_rows(lay, nn, k)
                return got if cap is None else min(got, max(16 * lay.ksub, cap))
            with mock.patch.object(fm, "_stage_rows", capped):
                pc = fm.pack_params(net, cfg.pos_enc_L, True)
            tt = device_ms(lambda: fm._launch(pc, pts, dirs))
            ts = device_ms(lambda: fm._launch(pc, *serve))
            print(f"[ablate] forward, narrow operations at "
                  f"{'as built' if cap is None else f'<= max({cap}, 32)'} "
                  f"rows per stage: train fine call {tt:.3f} ms, served fine "
                  f"call {ts:.3f} ms", flush=True)

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
