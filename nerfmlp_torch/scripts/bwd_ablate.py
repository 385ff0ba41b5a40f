"""Where the fused MLP kernels' time goes, on one GPU.

    python -m nerfmlp_torch.scripts.bwd_ablate [--kernels fwd,bwd]
    python -m nerfmlp_torch.scripts.bwd_ablate --outputs FILE
    python -m nerfmlp_torch.scripts.bwd_ablate --compare FILE FILE

Builds csrc/fused_mlp_bwd.cu and csrc/fused_mlp_fwd.cu as they are and in
variants with one part of the design taken out (results are then wrong:
only their time counts), all builds of a source started together: the
wgmma of mlp_tile.cuh's shared core, the producer's weight copies (its
full barriers then arm with no bytes), the epilogue, the encoding; and
phase 2's mma and loads. It times each backward variant's two phases at
the flagship train step's fine call (1024 rays x 128 samples, 8x256 + view
head, bf16, random weights from seed 0), and each forward variant at that
call and at the served fine call (4096 rays x 128 samples). Then the
multicast: the shallow wide nets' forward and phase 1 as built (clusters
of one CTA) and with their tiles in clusters of 64 / T CTAs. Then, with the sources as they are: phase 2 and
the reduction at 4 to 32 row splits, and the whole backward at the fine
and coarse calls in one chunk per call and in chunks of 8,192 points.
Device times by CUDA events, median of 10, with a GPU spin ahead of each
timed call so that the host's launch path is not timed. Variant sources
go under build/nerfmlp_torch/ablate/; a variant whose text is no longer in
the source fails with its name. Needs no jax.

``--outputs FILE`` instead writes the forward's output and the backward's
flat gradient of the depth-8 nets (OUTPUT_NETS) at the fine call, from
seed 0, and ``--compare A B`` holds two such files to each other bit for
bit (exit 1 on a difference): run with another tree's package first on
PYTHONPATH, they show that a change left those paths' results as they
were.
"""

import argparse
import concurrent.futures
import dataclasses
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

_P1_END = "// dW and db partials of one job"
CHUNK_TRY = 8192
# (width, view head, hi_lo) of the depth-8 nets --outputs writes: 8x256 and
# phase 16's wide nets (chip_smoke.py), and 8x592 without the view head.
OUTPUT_NETS = ((256, True, False), (256, True, True), (288, True, False),
               (384, True, False), (512, True, False), (640, True, False),
               (384, True, True), (512, True, True), (576, True, True),
               (592, False, False))
# (depth, width) of the shallow wide nets whose tiles run in clusters.
SHALLOW_NETS = ((2, 1024), (1, 1696))

_CORE = "mlp_tile.cuh"
_NO_MMA = (
    "template <int N>\nstruct Wgmma;\n",
    "template <int N>\nstruct Wgmma;\n"
    "template <int N>\nstruct NoMma {\n"
    "  template <int kTnspA>\n"
    "  static __device__ __forceinline__ void mma(float (&d)[N / 2], "
    "uint64_t a,\n      uint64_t b, int s) {\n"
    "    d[0] += __uint_as_float(static_cast<uint32_t>(a ^ b)) * s;\n"
    "  }\n};\n")
# Parts of mlp_tile.cuh's core (both kernels): (file, old text, new text).
_CORE_VARIANTS = {
    "without wgmma": [
        (_CORE, *_NO_MMA),
        (_CORE, "  using Mma = Wgmma<T>;", "  using Mma = NoMma<T>;")],
    "without the weight copies": [
        (_CORE, "          mbar_expect_tx(&full[pos.slot], kHiLo ? 2 * bytes : "
         "bytes);", "          mbar_expect_tx(&full[pos.slot], 0 * bytes);"),
        (_CORE, "        if (kind == kOpFwd) {\n          if (t < strips) {",
         "        if (false) {\n          if (t < strips) {"),
        (_CORE, "        } else if (t == 0) {", "        } else if (false) {")],
}
# The forward's variants: name -> [(file, old text, new text)]; file the
# kernel's source or mlp_tile.cuh. The results are then wrong: only the
# time counts. Without an epilogue the accumulators still reach a
# (predicated) store, or the compiler would drop the products too.
_NO_EPILOGUE = ("      epilogue(0, acc0);\n      epilogue(1, acc1);",
                "      st_global_if(reinterpret_cast<float*>({}), 0.f,\n"
                "                   acc0[0] == 123.f && acc1[1] == 7.f);")
FWD_VARIANTS = {
    "as built": [],
    **_CORE_VARIANTS,
    "without the epilogue": [(
        "fused_mlp_fwd.cu", _NO_EPILOGUE[0], _NO_EPILOGUE[1].format("out"))],
    "without the encoding": [(
        "fused_mlp_fwd.cu",
        "(p < n && j < enc_dim) ? encode_pair(pts_s, p, j, &v0, &v1) : 1",
        "(p < n && j < enc_dim) ? 1 : 1")],
}
# Phase 1's variants (its part of fused_mlp_bwd.cu, before phase 2).
VARIANTS = {
    "as built": [],
    **_CORE_VARIANTS,
    "without the epilogue": [(
        _NO_EPILOGUE[0], _NO_EPILOGUE[1].format("ws"))],
    "without the encoding": [(
        "(gr < n && j < enc_dim) ? encode_pair(pts_s, gr, j, &v0, &v1) : 1",
        "(gr < n && j < enc_dim) ? 1 : 1")],
}
# Phase 2's, in its part of the source.
P2_VARIANTS = {
    "phase 2 without mma": [(
        "          mma(acc[mt][2 * p], a[mt], b[0], b[1]);\n"
        "          mma(acc[mt][2 * p + 1], a[mt], b[2], b[3]);\n"
        "          if (kHiLo) {",
        "          acc[mt][2 * p][0] += __uint_as_float(a[mt][0] ^ b[0]);\n"
        "          acc[mt][2 * p + 1][0] += __uint_as_float(a[mt][1] ^ b[2]);\n"
        "          if (kHiLo) {")],
    "phase 2 without loads": [
        ("      if (cc < ca) {", "      if (false) {"),
        ("      if (cc < cy) {", "      if (false) {")],
}


def variant_files(kernel: str, name: str, edits) -> dict:
    """{file name: text} of ``kernel``'s source and the headers with the
    variant ``name``'s edits ((file,) old, new) applied; each old text must
    occur once in its file (phase 1's and phase 2's in their own part of
    fused_mlp_bwd.cu), else the variant fails by name."""
    files = {os.path.basename(p): open(p).read()
             for p in _build.sources(kernel)}
    for edit in edits:
        fname, old, new = edit if len(edit) == 3 else (
            _build.KERNELS[kernel], *edit)
        src = files[fname]
        part, rest = src, ""
        if fname == "fused_mlp_bwd.cu":
            cut = src.index(_P1_END)
            p2 = edit in [e for v in P2_VARIANTS.values() for e in v]
            part, rest = (src[cut:], src[:cut]) if p2 else (src[:cut],
                                                             src[cut:])
        if part.count(old) != 1:
            raise RuntimeError(f"{name}: its text is not found once in "
                               f"{fname}: {old!r}")
        part = part.replace(old, new)
        files[fname] = (rest + part if fname == "fused_mlp_bwd.cu" and p2
                        else part + rest)
    return files


def build_variants(variants, kernel):
    """Each variant's source directory for ``kernel`` (``variants``: name
    -> edits), every one built (in parallel)."""
    dirs = {}
    for name, edits in variants.items():
        d = os.path.join(_build.build_dir(), "ablate", kernel,
                         name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        for fname, text in variant_files(kernel, name, edits).items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
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


def multicast(tries):
    """``tries`` with every tile below 64 points in a cluster of 64 / T
    CTAs that share each weight stage by multicast."""
    return {hi_lo: tuple((t[0], max(1, 64 // t[0]), *t[2:]) for t in ts)
            for hi_lo, ts in tries.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outputs", metavar="FILE")
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    ap.add_argument("--kernels", default="fwd,bwd",
                    help="which kernels' variants to time: fwd, bwd or both")
    args = ap.parse_args(argv)
    if args.compare:
        return compare_outputs(*args.compare)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablate: needs a CUDA device")
    if args.outputs:
        write_outputs(args.outputs)
        return 0
    kernels = args.kernels.split(",")
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
    if "bwd" in kernels:
        for name, d in build_variants({**VARIANTS, **P2_VARIANTS},
                                      "fused_mlp_bwd").items():
            lib = fm._bwd_kernel(d)
            with mock.patch.object(fm, "_bwd_kernel", lambda: lib):
                t1 = device_ms(lambda: fm.bwd_workspace(packed, pts, dirs, g,
                                                        ws))
                t2 = device_ms(lambda: fm.weight_grads(packed, ws, n,
                                                       split_rows, part))
            print(f"[ablate] {name}: phase 1 {t1:.3f} ms, phase 2 "
                  f"{t2:.3f} ms", flush=True)
    serve = call_inputs(4 * n, cfg)[:2]
    if "fwd" in kernels:
        with torch.no_grad():
            for name, d in build_variants(FWD_VARIANTS,
                                          "fused_mlp_fwd").items():
                lib = fm._kernel(d)
                with mock.patch.object(fm, "_kernel", lambda: lib):
                    tt = device_ms(lambda: fm._launch(packed, pts, dirs))
                    ts = device_ms(lambda: fm._launch(packed, *serve))
                print(f"[ablate] forward {name}: train fine call {tt:.3f} ms,"
                      f" served fine call ({4 * n} points) {ts:.3f} ms",
                      flush=True)
    # The multicast: the shallow wide nets' layouts as built (clusters of
    # one CTA, each streaming every stage itself) and with their tiles in
    # clusters of 64 / T CTAs that share each stage by multicast.
    for depth, width in SHALLOW_NETS:
        scfg = dataclasses.replace(cfg, depth=depth, width=width)
        snet = init_model(scfg.model_config(), seed=0, device="cuda")
        times = []
        for label, fwd_tries, bwd_tries in (
                ("as built", fm.FWD_TRIES, fm.BWD_TRIES),
                ("multicast", multicast(fm.FWD_TRIES),
                 multicast(fm.BWD_TRIES))):
            with mock.patch.object(fm, "FWD_TRIES", fwd_tries), \
                    mock.patch.object(fm, "BWD_TRIES", bwd_tries):
                fm._fwd_layout.cache_clear()
                fm._bwd_layout.cache_clear()
                sp = fm.pack_params(snet, scfg.pos_enc_L, True)
                sws = torch.empty(fm.ws_rows(n, sp.bwd_rows) * sp.ws_cols,
                                  device="cuda", dtype=torch.bfloat16)
                with torch.no_grad():
                    tf = device_ms(lambda: fm._launch(sp, pts, dirs))
                t1 = (device_ms(lambda: fm.bwd_workspace(sp, pts, dirs, g,
                                                         sws))
                      if "bwd" in kernels else float("nan"))
            times.append(f"{label} (forward {fwd_header_line(sp)}): "
                         f"forward {tf:.3f} ms, phase 1 {t1:.3f} ms")
        fm._fwd_layout.cache_clear()
        fm._bwd_layout.cache_clear()
        print(f"[ablate] {depth}x{width}: " + "; ".join(times), flush=True)
        del snet, sp, sws
        torch.cuda.empty_cache()

    if "bwd" in kernels:
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
                print(f"[ablate] {rows} rows in {part.shape[0]} splits: "
                      f"phase 2 {t2:.3f} ms, reduction {t3:.4f} ms "
                      f"(part.sum(0) {tl:.4f} ms)", flush=True)
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


def fwd_header_line(packed) -> str:
    """A packed net's forward and phase-1 tiles and clusters."""
    h = fm.fwd_header(packed)
    return (f"{h['rows']}-point tiles x {h['cluster']}, phase 1 "
            f"{packed.bwd_rows} x {packed.bwd_cluster}")


if __name__ == "__main__":
    raise SystemExit(main())
