"""Where the fused MLP kernels' time goes, on one GPU.

    python -m nerfmlp_torch.scripts.bwd_ablate [--kernels fwd,bwd]
    python -m nerfmlp_torch.scripts.bwd_ablate --outputs FILE
    python -m nerfmlp_torch.scripts.bwd_ablate --compare FILE FILE

Builds csrc/fused_mlp_bwd.cu and csrc/fused_mlp_fwd.cu as they are and in
variants with one part of the design taken out (results are then wrong:
only their time counts), all builds of a source started together: the
wgmma of mlp_tile.cuh's shared core, the producer's weight copies (its
full barriers then arm with no bytes), the epilogue, the encoding; and
phase 2's wgmma, its copies, its bias products. It times each backward
variant's two phases at the flagship train step's fine call (1024 rays x
128 samples, 8x256 + view head, bf16, random weights from seed 0), and
each forward variant at that call and at the served fine call (4096 rays
x 128 samples). Then, with the sources as they are: phase 2 and the
reduction at 4 to 32 row splits, and the whole backward at the fine and
coarse calls in one chunk per call and in chunks of 8,192 points. Phase
2's variants, and the sources as built, are also timed at 866x16 and
8x576 hi_lo (P2_NETS).
Device times by CUDA events, median of 10, with a GPU spin ahead of each
timed call so that the host's launch path is not timed. Variant sources
go under build/nerfmlp_torch/ablate/; a variant whose text is no longer in
the source fails with its name. Needs no jax.

With the sources as built, the training path's residual handover
(fused_mlp.Handover) is timed too: the forward with and without its
residuals, phase 1 without and with its recomputed forward, at the fine and
coarse calls.

``--outputs FILE`` instead writes, for the nets of OUTPUT_NETS at the fine
call (random weights and inputs from seed 0), the forward's output, a
digest of each of phase 1's workspace matrices (read out of its layout) on
the call's first 16,384 points and the backward's flat gradient, each by
the path a training call takes (the forward with its residuals and phase
1 without the forward where the net hands over), and ``--compare A B``
holds two such files to each other bit for bit (exit 1 on a difference;
beside a differing gradient its largest difference over its largest
value). Run this file by its path with another tree's package first on
PYTHONPATH, they show that a change left those paths' results as they
were.
"""

import argparse
import concurrent.futures
import dataclasses
import hashlib
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

_P1_END = "// Phase 2: the products of one group of a stage"
CHUNK_TRY = 8192
# Points of the call phase 1's workspace digests cover (every tile runs the
# same code).
P1_DIGEST_POINTS = 16_384
# (depth, width, view head, hi_lo) of the nets --outputs writes: every net
# whose layouts tests/test_torch_fused_mlp_bwd.py pins, phase 16's other
# wide nets (chip_smoke.py), and 8x592 without the view head.
OUTPUT_NETS = ((8, 256, True, False), (8, 256, True, True),
               (8, 288, True, False), (8, 512, True, False),
               (8, 640, True, False), (8, 384, True, True),
               (8, 512, True, True), (8, 576, True, True),
               (32, 256, True, False), (866, 16, True, False),
               (1, 1696, True, False), (2, 1312, True, False),
               (5, 864, True, False), (2, 1024, True, False),
               (1, 1472, True, True), (3, 960, True, True),
               (5, 752, True, True), (8, 592, False, False))
# (depth, width, hi_lo) of the nets phase 2 is also timed at: the narrowest
# units and an operation-bound one.
P2_NETS = ((866, 16, False), (8, 576, True))

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
    # The training forward's residuals by phase 1's 16-B copies (right
    # results; the design's choice is measured against it).
    "residuals by 16-B copies": [(
        _CORE, "  const int whole = max(0, min(nn, (cols >> 6 << 6) - col0)) "
        ">> 6;", "  const int whole = 0;")],
    # The training forward without its mask stores (only the time counts).
    "residuals without the masks": [(
        "fused_mlp_fwd.cu", "                                    ok && "
        "mask_out >= 0);", "                                    false);")],
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
    # The recomputed forward's operations skipped by the consumers and by
    # the producer's weight stream (the dX epilogues then read masks that
    # no operation wrote).
    "without its forward operations": [
        ("      if (kind == kOpNone) {",
         "      if (kind == kOpFwd) continue;\n      if (kind == kOpNone) {"),
        (_CORE, "      // The forward's strips: this lane's strip t of the "
         "pass (its cores a\n",
         "      if (kind == kOpFwd) continue;\n"
         "      // The forward's strips: this lane's strip t of the pass (its "
         "cores a\n")],
    # Every operation's columns left in shared memory (the encoded points
    # and dirs, and the cotangent, still reach the workspace).
    "without the workspace copies": [(
        "      const int m = o[fMat];\n      if (m >= 0)\n",
        "      const int m = o[fMat];\n      if (false && m >= 0)\n")],
}
# Phase 2's, in its part of the source.
P2_VARIANTS = {
    "phase 2 without wgmma": [(
        "        p2_products<kHiLo>(nc, db >= 0 && w1 > 0, acc,\n"
        "                           da + kSteps * s * a_step, a_step,\n"
        "                           dy + kSteps * s * b_step, b_step, a_lo, "
        "lo, bias0,\n"
        "                           bias1, ys, y_step, y_lo, ones_desc);",
        "        acc[0] += __uint_as_float(static_cast<uint32_t>(da ^ ys[0])) "
        "* s;")],
    "phase 2 without copies": [
        ("        mbar_expect_tx(&full[pos.slot], rr * (kc + nc) * 2 * "
         "(kHiLo ? 2 : 1));",
         "        mbar_expect_tx(&full[pos.slot], 0 * rr);"),
        ("      if (on) {", "      if (false) {")],
    "phase 2 without the bias products": [
        ("        p2_products<kHiLo>(nc, db >= 0 && w1 > 0, acc,",
         "        p2_products<kHiLo>(nc, false, acc,")],
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
    """OUTPUT_NETS' forward outputs, phase-1 workspace digests and flat
    backward gradients at the fine call (random weights and inputs from
    seed 0), to ``path``."""
    out = {}
    n = 1024 * 128
    for depth, width, vdirs, hi_lo in OUTPUT_NETS:
        cfg = RenderConfig(compute_dtype="bfloat16", use_kernel=True,
                           depth=depth, width=width, use_viewdirs=vdirs)
        net = init_model(cfg.model_config(), seed=0, device="cuda")
        packed = fm.pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
        pts, dirs, g = call_inputs(n, cfg)
        dirs = dirs if vdirs else None
        g = g[:, :packed.out_w]
        key = f"{depth}x{width}{'' if vdirs else ' no view head'}" + (
            " hi_lo" if hi_lo else "")
        # A training call's path: the handover where the net takes it
        # (one chunk: every net here at this call), else the recompute.
        ho = fm.hands_over(packed, n, True)
        with torch.no_grad():
            res = fm.residual_buffers(packed, n, pts.device) if ho else None
            out[key + " forward"] = (
                fm.forward_residuals(packed, pts, dirs, *res) if ho
                else fm._launch(packed, pts, dirs)).cpu()
            m = P1_DIGEST_POINTS
            part = (pts[:m], None if dirs is None else dirs[:m], g[:m])
            if ho:
                ws, masks = fm.residual_buffers(packed, m, pts.device)
                fm.forward_residuals(packed, *part[:2], ws, masks)
            else:
                ws, masks = torch.empty(
                    fm.ws_rows(m, packed.bwd_rows) * packed.ws_cols,
                    device="cuda", dtype=torch.bfloat16), None
            fm.bwd_workspace(packed, *part, ws, masks)
            out[key + " phase 1"] = [
                hashlib.sha256(fm.ws_matrix(packed, ws, i)[:, :m].cpu()
                               .view(torch.int16).numpy().tobytes())
                .hexdigest() for i in range(len(packed.ws_mats))]
            del ws, masks
            out[key + " backward"] = fm._launch_bwd(packed, pts, dirs, g,
                                                    res).cpu()
            del res
        print(f"[outputs] {key}: phase-1 tile {packed.bwd_rows}, "
              f"{'handover at tile ' + str(packed.handover.rows) if ho else 'recompute'}",
              flush=True)
        del net, packed
        torch.cuda.empty_cache()
    torch.save(out, path)


def compare_outputs(a: str, b: str) -> int:
    """0 when the two --outputs files hold the same bits, else 1."""
    x, y = torch.load(a), torch.load(b)

    def same(k):
        if k not in y:
            return False
        if isinstance(x[k], list):
            return x[k] == y[k]
        return torch.equal(x[k], y[k])

    for k in sorted(x):
        note = ""
        if k in y and not isinstance(x[k], list) and not same(k):
            note = (f" (max |diff| / max |value| "
                    f"{float((x[k] - y[k]).abs().max() / y[k].abs().max()):.3e})")
        print(f"[compare] {k}: "
              f"{'bit-identical' if same(k) else 'DIFFERS'}{note}")
    ok = sorted(x) == sorted(y) and all(same(k) for k in x)
    print(f"[compare] {a} vs {b}: {'bit-identical' if ok else 'DIFFER'}")
    return 0 if ok else 1


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
    splits, split_rows = fm.bwd_splits(n, packed.bwd_units)
    part = torch.empty((splits, fm.part_stride(total)), device="cuda")
    print(f"[ablate] {torch.cuda.get_device_name(0)}; fine call, n={n}, "
          f"{splits} splits of {split_rows} rows")
    if "bwd" in kernels:
        # Phase 2's other nets: their workspaces filled once, as built.
        p2_calls = []
        for depth, width, hi_lo in P2_NETS:
            ncfg = dataclasses.replace(cfg, depth=depth, width=width)
            nnet = init_model(ncfg.model_config(), seed=0, device="cuda")
            npk = fm.pack_params(nnet, ncfg.pos_enc_L, True, hi_lo)
            rows = fm.ws_rows(n, npk.bwd_rows)
            nsplits, nper = fm.bwd_splits(rows, npk.bwd_units)
            nws = torch.empty(rows * npk.ws_cols, device="cuda",
                              dtype=torch.bfloat16)
            npart = torch.empty((nsplits, fm.part_stride(npk.grad_total)),
                                device="cuda")
            fm.bwd_workspace(npk, pts, dirs.float() if hi_lo else dirs, g,
                             nws)
            p2_calls.append((f"{depth}x{width}{' hi_lo' if hi_lo else ''} "
                             f"({len(npk.bwd_units)} units x {nsplits} "
                             f"splits)", npk, nws, rows, nper, npart))
            del nnet
        for name, d in build_variants({**VARIANTS, **P2_VARIANTS},
                                      "fused_mlp_bwd").items():
            lib = fm._bwd_kernel(d)
            with mock.patch.object(fm, "_bwd_kernel", lambda: lib):
                t1 = device_ms(lambda: fm.bwd_workspace(packed, pts, dirs, g,
                                                        ws))
                h = n // 2
                t1c = device_ms(lambda: fm.bwd_workspace(
                    packed, pts[:h], dirs[:h], g[:h], ws))
                t2 = device_ms(lambda: fm.weight_grads(packed, ws, n,
                                                       split_rows, part))
                more = ""
                if name == "as built" or name in P2_VARIANTS:
                    more = "".join(
                        f", phase 2 at {label} "
                        f"{device_ms(lambda: fm.weight_grads(*c)):.3f} ms"
                        for label, *c in p2_calls)
            print(f"[ablate] {name}: phase 1 {t1:.3f} ms (coarse call "
                  f"{t1c:.3f} ms), phase 2 {t2:.3f} ms{more}", flush=True)
        del p2_calls
    serve = call_inputs(4 * n, cfg)[:2]
    if "fwd" in kernels:
        res = fm.residual_buffers(packed, n, pts.device)
        h = n // 2
        with torch.no_grad():
            for name, d in build_variants(FWD_VARIANTS,
                                          "fused_mlp_fwd").items():
                lib = fm._kernel(d)
                with mock.patch.object(fm, "_kernel", lambda: lib):
                    tt = device_ms(lambda: fm._launch(packed, pts, dirs))
                    tr = device_ms(lambda: fm._launch(packed, pts, dirs,
                                                      res))
                    trc = device_ms(lambda: fm._launch(packed, pts[:h],
                                                       dirs[:h], res))
                    ts = device_ms(lambda: fm._launch(packed, *serve))
                print(f"[ablate] forward {name}: train fine call {tt:.3f} ms,"
                      f" with its residuals {tr:.3f} ms (coarse call "
                      f"{trc:.3f} ms), served fine call ({4 * n} points) "
                      f"{ts:.3f} ms", flush=True)
        del res
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
            res = fm.residual_buffers(packed, rows, p.device)
            with torch.no_grad():
                tf = device_ms(lambda: fm._launch(packed, p, d))
                tr = device_ms(lambda: fm.forward_residuals(packed, p, d,
                                                            *res))
            t1 = device_ms(lambda: fm.bwd_workspace(packed, p, d, gg, ws))
            th = device_ms(lambda: fm.bwd_workspace(packed, p, d, gg, *res))
            tb = device_ms(lambda: fm._launch_bwd(packed, p, d, gg, res))
            print(f"[ablate] {label} call, handover: forward {tf:.3f} ms, "
                  f"with its residuals {tr:.3f} ms; phase 1 recomputing "
                  f"{t1:.3f} ms, without the forward {th:.3f} ms; whole "
                  f"backward {tb:.3f} ms", flush=True)
            del res
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
