"""Fused encode -> MLP -> raw, forward and backward: the CUDA kernels, their
plain versions, and the wrappers that pick between them by the tensor's
device.

Counterpart of ``nerfmlp_tpu/ops/pallas_mlp.py``: ``_flatten_params``
(:103-141) becomes :func:`pack_params`; ``_encode_tile`` +
``_mlp_tile_math`` (:172-246) are the kernel in ``csrc/fused_mlp_fwd.cu``
and :func:`fused_nerf_mlp_plain`; ``_bwd_kernel`` + ``_trunk_bwd``
(:312-441) are the two phases and the partial-sum reduction in
``csrc/fused_mlp_bwd.cu`` (:func:`bwd_workspace`, :func:`weight_grads`,
:func:`reduce_partials`) and :func:`fused_nerf_mlp_bwd_plain`; the ``_fused_apply``
custom VJP (:530-567) is :class:`FusedMLPFunction`; ``fused_nerf_mlp``
(:611-689) is :func:`fused_nerf_mlp`. Each CUDA source notes what bounds
it and how it is built for Hopper.

* :func:`fused_nerf_mlp` runs the forward kernel for CUDA tensors — or
  raises — and the plain version for CPU tensors, under autograd: the
  backward runs :func:`fused_nerf_mlp_bwd` (the backward's kernels, or
  the plain backward on the CPU) and returns the ``nn.Linear`` weight and
  bias gradients; points and dirs get zeros. Nothing falls back from a
  kernel to a plain version. In training (the parameters need a
  gradient, the call's backward is one chunk, and the net's
  :class:`Handover` exists: :func:`hands_over`, :func:`handover_misfit`)
  the forward kernel also writes the activations phase 2 reads and the
  ReLU masks (:func:`forward_residuals`), and phase 1 runs only the dX
  chain on them: the same bits, without recomputing the forward. Each
  kernel's wrapper counts its launches: ``fused_nerf_mlp.launches``
  (of them ``fused_nerf_mlp.residual_launches`` with residuals),
  ``bwd_workspace.launches`` (``bwd_workspace.handover_launches`` without
  the forward), ``weight_grads.launches`` and
  ``reduce_partials.launches``. Under
  :func:`nerfmlp_torch.check_numerics` each wrapper checks what its kernel
  wrote (or its plain version returned) for NaNs, naming the kernel.
* :func:`pack_params` lays a net's weights out for the kernels once
  (transposed to ``(in, out)``, split at the skip and view layers, padded
  to multiples of 16 with zeros, bf16 — (hi, lo) bf16 pairs in the hi_lo
  mode of ``fp32_precision="high"`` — each block in the strips of 128-byte
  swizzled atoms the kernels' wgmma reads, :func:`strip_image`; the
  kernels' layouts in ``csrc/mlp_tile.cuh``) together with the forward's
  program (one operation per pass of at most ``FWD_MAX_N`` columns over
  each layer) and the backward's program and job list — at service build,
  weight swap and once per train step, never per call.
* :func:`kernel_fits` and :func:`backward_fits` are the Hopper budgets that
  decide, from the architecture alone, whether a net goes to the kernels
  (the role of ``backward_fits_vmem``, :592-608, for the TPU's VMEM).
* A stack of S nets of one architecture (:class:`NetStack`, packed by
  :func:`pack_params_stack`: one scene per net) runs every call above as
  ONE launch of each kernel over a scene axis — the TPU kernels under
  ``jax.vmap``, whose batching rule gives each ``pallas_call`` a leading
  grid axis over scenes (multi-scene training,
  ``parallel/multi_scene.py``). The points come scene-major, the same
  number per scene; scene s's results are bit-equal to a launch of its net
  alone. The plain version of a stacked call is the plain function on
  each scene's slice, concatenated.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from nerfmlp_torch import (
    check_nan, numerics_checked, numerics_scope, numerics_where,
)
from nerfmlp_torch.config import ModelConfig, RenderConfig
from nerfmlp_torch.models.mlp import NeRFMLP
from nerfmlp_torch.ops import _build
from nerfmlp_torch.ops.encoding import positional_encoding

log = logging.getLogger(__name__)

# The kernels' shared core (csrc/mlp_tile.cuh): two consumer warpgroups
# and a producer warpgroup a block. Checked against the built libraries
# at load.
CORE_THREADS = 384
FWD_THREADS = CORE_THREADS
FWD_MAX_N = 256         # output columns of one pass (four 64-row wgmma tiles)
FWD_HEADER_INTS = 16
FWD_MAX_BUFS = 4        # X, D, P0, P1: (byte offset, columns, 0)
FWD_OP_INTS = 16
FWD_OPS_BASE = FWD_HEADER_INTS + 3 * FWD_MAX_BUFS
SMEM_LIMIT = 232_448    # dynamic shared memory one Hopper block may use
STRIP = 64              # columns of a weight strip: one wgmma's M
MAX_STAGES = 8          # slots of a weight ring
# Weight rows a ring stage gives the widest forward operations, each tried
# (a dX stage is one 64-column strip of as many rows, a multiple of 64, as
# the slot then holds; a narrow operation takes as many rows as it holds).
STAGE_ROWS = (64, 32, 16)
BARRIER_BYTES = 16      # a slot's full and empty mbarriers
ZERO_BYTES = 128        # after the barriers: zeros a missing tile multiplies

# The backward kernels' fixed shape (csrc/fused_mlp_bwd.cu). The matrix and
# operation tables follow the buffer table, sized by the net (their bases
# and counts are in the header).
BWD_P1_THREADS = CORE_THREADS
BWD_P2_THREADS = CORE_THREADS
BWD_MAX_N = 256         # output columns of one phase-1 pass
BWD_HEADER_INTS = 32
BWD_MAX_BUFS = 8        # shared-memory buffers (byte offset, columns, 0)
BWD_OP_INTS = 16
BWD_TABLES_BASE = BWD_HEADER_INTS + 3 * BWD_MAX_BUFS
BWD_UNIT_K = 128        # phase 2: input features of a work unit, at most
BWD_UNIT_N = 256        # ... and output features (wgmma's N)
BWD_STAGE_ROWS = 64     # workspace rows and phase 2's splits: multiples
BWD_UNIT_INTS = 12
P2_RING_OFF = 1024      # phase 2's ring, after its barriers, the zero
#                         block and the ones (and zeros) its bias products
#                         multiply
P2_SLACK = 1024         # ... and the bytes a narrow A strip's tile reads past
P2_GROUP_ROWS = {False: 64, True: 32}   # phase 2: a group of rows (its
#                         k-steps issued as one block), bf16 and hi_lo
P2_MAX_SUB = 16         # groups of rows a phase-2 stage, at most
P2_MAX_STAGES = MAX_STAGES   # phase 2's ring slots, at most

# The layouts tried: points a tile for the forward, and (points a tile,
# matrix and operation tables in shared memory) for phase 1, each at every
# stage size of STAGE_ROWS; _fwd_pick / _bwd_pick choose among them. A tile
# of T points is the N of every wgmma, one CTA a tile. Phase 1 keeps its
# tables in device memory only where they crowd shared memory.
FWD_TRIES = {False: (128, 64, 32, 16), True: (64, 32, 16)}
BWD_TRIES = {
    False: ((128, True), (64, True), (32, True), (16, True)),
    True: ((64, True), (32, True), (16, True), (16, False), (8, False)),
}
# Phase 2's layouts tried: (input features a work unit, bytes a ring stage
# aims at); _p2_pick chooses (scripts/layout_sweep.py times them all).
P2_TRIES = ((128, 32768), (128, 16384), (128, 65536), (64, 32768),
            (64, 16384), (64, 65536))
# Every tile a layout may take has its kernels in the CUDA sources.
TILE_ROWS = (128, 64, 32, 16)
TILE_ROWS_HI_LO = (64, 32, 16, 8)
# How a call is cut: at most BWD_CHUNK_ROWS points of a scene per phase-1 /
# phase-2 pair, fewer (a multiple of BWD_CHUNK_ALIGN) where a scene's
# workspace would pass BWD_WS_BUDGET bytes; phase 2's rows split in up to
# BWD_MAX_SPLITS ranges of at least BWD_MIN_SPLIT_ROWS and, where the
# splits allow, at most BWD_MAX_SPLIT_ROWS points (the length of each fp32
# sum), enough to give BWD_FILL_ITEMS work items (units x splits) or more,
# up to twice that, as many as balance the P2_SMS CTAs' bytes best
# (bwd_splits). A
# call's workspace and partial slots may take BWD_MEMORY_SHARE of the
# card's memory (the rest holds the nets, the optimizer and the step's
# activations); a stack of more scenes is refused by name.
BWD_CHUNK_ROWS = 131_072
BWD_CHUNK_ALIGN = 4096
BWD_WS_BUDGET = 8 << 30
BWD_MEMORY_SHARE = 0.5
BWD_MAX_SPLITS = 32
BWD_MIN_SPLIT_ROWS = 512
BWD_MAX_SPLIT_ROWS = 2048   # the split lengths of the mma.sync design
#                             at the train calls (32 x 2,048 / 32 x 4,096
#                             at 65,536 / 131,072 points): on an H100, sums
#                             over 11,968 points a split left phase 2 at
#                             3.0e-5 of the plain products (normalised,
#                             8x256 fine call), over 4,096 at 7.1e-6
#                             (PERF.md)
BWD_FILL_ITEMS = 2 * 132
P2_SMS = 132            # phase 2's persistent CTAs on an H100, one an SM
P2_ITEM_ROWS = 256      # an item's fixed cost (its pipeline's fill and its
#                         epilogue), in rows of its operands

# Shared-memory buffers and epilogues of the forward's program.
_X, _D, _P0, _P1 = 0, 1, 2, 3
_RELU_BF16, _BF16, _OUT_F32 = 0, 1, 2
# Operation kinds of both programs (mlp_tile.cuh's CoreKind): a forward
# product, a dX product, none (phase 1's load of the cotangent).
_FWD, _DX, _LOAD_G = 0, 1, 2


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _pad64(n: int) -> int:
    return -(-n // 64) * 64


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def _hidden_cols(mc: ModelConfig, vdirs: bool) -> int:
    widths = [mc.width] + ([mc.bottleneck_ch, mc.view_width] if vdirs else [])
    return max(_pad16(w) for w in widths)


def _layer_widths(mc: ModelConfig, vdirs: bool) -> List[int]:
    """Padded output widths of the forward's layers, in program order: the
    trunk, then sigma, bottleneck, view and rgb, or the output head."""
    trunk = [_pad16(mc.width)] * mc.depth
    if vdirs:
        return trunk + [16, _pad16(mc.bottleneck_ch), _pad16(mc.view_width),
                        16]
    return trunk + [_pad16(mc.output_ch)]


def forward_ops(mc: ModelConfig, vdirs: bool) -> int:
    """Operations of the forward's program: one per pass of at most
    ``FWD_MAX_N`` columns over each layer."""
    return sum(-(-w // FWD_MAX_N) for w in _layer_widths(mc, vdirs))


# --------------------------------------------------------------------- #
# The weight image: mlp_tile.cuh's strip layout
# --------------------------------------------------------------------- #
def strip_cores(cols: int, s: int) -> int:
    """Core matrices (8 columns each) a row group of strip ``s`` of a block
    ``cols`` wide holds: 8, or fewer in a last, narrower strip."""
    return min(8, (cols - STRIP * s) // 8)


def strip_image(blk: torch.Tensor) -> torch.Tensor:
    """A (k, n) weight block, both multiples of 16, in the kernels' layout
    (mlp_tile.cuh), flat: strips of 64 columns one after another, each its
    row groups of 8 rows one after another (:func:`ws_index`). The
    forward reads a strip as W^T (M-major A of wgmma), dX the same bytes as
    W (K-major A). Only device operations on the block's device (the train
    step packs inside a CUDA-graph capture, where no host tensor may be
    copied in)."""
    k, n = blk.shape
    full = n // STRIP * STRIP
    parts = []
    if full:
        # (strip, row group, row, 16-byte chunk, element); row r's chunk j
        # holds the chunk j ^ r of the row.
        a = (blk[:, :full].reshape(k // 8, 8, full // STRIP, 8, 8)
             .permute(2, 0, 1, 3, 4))
        r = torch.arange(8, device=blk.device)
        swz = (r[:, None] ^ r[None, :])[None, None, :, :, None]
        parts.append(torch.gather(a, 3, swz.expand(a.shape)).reshape(-1))
    if full < n:
        w = n - full
        parts.append(blk[:, full:].reshape(k // 8, 8, w // 8, 8)
                     .permute(0, 2, 1, 3).reshape(-1))
    return torch.cat(parts)


def block_from_image(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The (k, n) block :func:`strip_image` laid out as ``flat`` (k a
    multiple of 8): row r's 16-byte chunk j of a whole strip from its chunk
    j ^ r, a narrower strip's core matrices back to rows."""
    cols = []
    at = 0
    r = torch.arange(8, device=flat.device)
    swz = r[:, None] ^ r[None, :]
    for s in range(0, n, STRIP):
        w = min(STRIP, n - s)
        part = flat[at:at + k * w]
        if w == STRIP:
            t = part.view(k // 8, 8, 8, 8)[:, r[:, None], swz, :]
        else:
            t = part.view(k // 8, w // 8, 8, 8).permute(0, 2, 1, 3)
        cols.append(t.reshape(k, w))
        at += k * w
    return torch.cat(cols, 1)


def act_index(rows: int, cols: int, col0: int = 0) -> torch.Tensor:
    """Element offsets of columns ``col0`` to ``col0 + cols`` of an
    activation buffer of ``rows`` points (mlp_tile.cuh's act_byte / 2):
    (rows, cols), the 128-byte swizzled atom (column / 64, point / 8) at
    ((column / 64) * (rows / 8) + point / 8) * 512, row point % 8, chunk
    (column % 64 / 8) ^ (point % 8). The wgmma's B operand, K-major."""
    p = torch.arange(rows)[:, None]
    c = torch.arange(col0, col0 + cols)[None, :]
    return (((c // 64) * (rows // 8) + p // 8) * 512 + (p % 8) * 64
            + ((c // 8) ^ (p % 8)) % 8 * 8 + c % 8)


def ws_index(rows: int, cols: int, device=None) -> torch.Tensor:
    """Element offsets of a workspace matrix of ``rows`` points (a multiple
    of 8) and ``cols`` columns within one plane (fused_mlp_bwd.cu's
    ws_elem): (rows, cols), the weights' strip layout (:func:`strip_image`)
    with the points as its rows: strip c // 64 at rows * 64 * (c // 64), a
    whole strip in 128-byte swizzled atoms of 8 rows, a narrower last strip
    in 8 x 8 core matrices. Phase 2 reads a stage of a strip with one bulk
    copy, as wgmma's M-major A or N-major B."""
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(cols, device=device)[None, :]
    cc = c % STRIP
    w = torch.clamp(cols - c // STRIP * STRIP, max=STRIP)
    full = (r // 8) * 512 + (r % 8) * 64 + ((cc // 8) ^ (r % 8)) * 8 + c % 8
    narrow = ((r // 8) * (w // 8) + cc // 8) * 64 + (r % 8) * 8 + c % 8
    return rows * (c - cc) + torch.where(w == STRIP, full, narrow)


# --------------------------------------------------------------------- #
# Layouts: the operations' shapes, the ring, shared memory
# --------------------------------------------------------------------- #
# One product of a program, as the ring sees it: kind, the rows (k) of its
# operands' weight blocks (forward) or their columns (dX), the block's
# other dimension (wld: forward its columns, dX its rows), the pass's
# first column and its width.
@dataclasses.dataclass(frozen=True)
class OpShape:
    kind: int
    ka: int
    kb: int
    wld: int
    col: int
    n: int


def _fwd_touch(op: OpShape, rows: int) -> int:
    """Bytes of a slot a forward stage of ``rows`` weight rows reaches (one
    plane): its strips' rows, and the rest of 64 columns a narrow last
    strip's last row group reads."""
    strips = -(-op.n // STRIP)
    sc = strip_cores(op.wld, op.col // STRIP + strips - 1)
    used = (strips - 1) * rows * 128 + rows * sc * 16
    return used + (8 - sc) * 128 if sc < 8 else used


def _dx_touch(op: OpShape, rows: int) -> int:
    """Bytes of a slot a dX stage of ``rows`` block rows of its widest
    strip reaches (one plane): a 64-row tile reads whole 64 rows."""
    sc = strip_cores(max(op.ka, op.kb), 0)
    return _pad64(rows) * sc * 16


def _touch(op: OpShape, rows: int) -> int:
    return _fwd_touch(op, rows) if op.kind == _FWD else _dx_touch(op, rows)


def stage_rows(op: OpShape, slot: int) -> int:
    """Rows a stage of ``op`` takes in a slot of ``slot`` bytes a plane:
    forward, as many weight rows (a multiple of 16, up to its operands'
    rows and 64: four k-steps) as fit; dX, as many block rows of a strip
    (a multiple of 64, up to the pass's columns)."""
    step, top = ((16, min(STAGE_ROWS[0], _pad16(max(op.ka, op.kb))))
                 if op.kind == _FWD else (64, _pad64(op.n)))
    rows = step
    while rows + step <= top and _touch(op, rows + step) <= slot:
        rows += step
    return rows


def _ring_slot(ops: List[OpShape], kr: int, dx_rows: int = 64) -> int:
    """Bytes a plane of a ring slot needs so that every forward operation
    takes stages of ``kr`` rows (its operands' rows, where fewer) and every
    dX operation stages of ``dx_rows`` (its pass's columns, where fewer)."""
    need = [_fwd_touch(o, min(kr, _pad16(max(o.ka, o.kb)))) if o.kind == _FWD
            else _dx_touch(o, min(dx_rows, _pad64(o.n)))
            for o in ops if o.kind != _LOAD_G]
    return _align1k(max(need))


def _layer_shapes(mc: ModelConfig, vdirs: bool):
    """(first operand's rows, second's or 0, output columns) of each
    forward layer, in program order: the skip layer's encoded and hidden
    blocks, the view layer's bottleneck and dirs blocks."""
    enc, w = _pad16(mc.input_ch), _pad16(mc.width)
    out = []
    for i in range(mc.depth):
        prev = enc if i == 0 else w
        out.append((enc, _pad16(mc.input_ch if i == 0 else mc.width), w)
                   if i in mc.skips else (prev, 0, w))
    if vdirs:
        bott, view = _pad16(mc.bottleneck_ch), _pad16(mc.view_width)
        out += [(w, 0, 16), (w, 0, bott),
                (bott, _pad16(mc.input_ch_views), view), (view, 0, 16)]
    else:
        out.append((w, 0, _pad16(mc.output_ch)))
    return out


def _fwd_shapes(mc: ModelConfig, vdirs: bool) -> List[OpShape]:
    """The forward program's products: a pass of at most ``FWD_MAX_N``
    columns over each layer."""
    return [OpShape(_FWD, ka, kb, n, c0, min(FWD_MAX_N, n - c0))
            for ka, kb, n in _layer_shapes(mc, vdirs)
            for c0 in range(0, n, FWD_MAX_N)]


def _bwd_shapes(mc: ModelConfig, vdirs: bool) -> List[OpShape]:
    """Phase 1's operations: the recomputed forward without the output
    heads, the load of the cotangent, and the dX chain (dX's ka / kb: the
    cotangents' widths, wld: the output's), each a pass of at most
    ``BWD_MAX_N`` columns."""
    layers = _layer_shapes(mc, vdirs)
    fwd = layers[:mc.depth] + ([layers[mc.depth + 1], layers[mc.depth + 2]]
                               if vdirs else [])
    w = _pad16(mc.width)
    if vdirs:
        bott, view = _pad16(mc.bottleneck_ch), _pad16(mc.view_width)
        dx = [(16, 0, view), (view, 0, bott), (bott, 16, w)]
    else:
        dx = [(_pad16(mc.output_ch), 0, w)]
    dx += [(w, 0, w)] * (mc.depth - 1)
    ops = [OpShape(_FWD, ka, kb, n, c0, min(BWD_MAX_N, n - c0))
           for ka, kb, n in fwd for c0 in range(0, n, BWD_MAX_N)]
    ops.append(OpShape(_LOAD_G, 0, 0, 0, 0, 0))
    return ops + [OpShape(_DX, ka, kb, n, c0, min(BWD_MAX_N, n - c0))
                  for ka, kb, n in dx for c0 in range(0, n, BWD_MAX_N)]


def _handover_shapes(mc: ModelConfig, vdirs: bool) -> List[OpShape]:
    """Phase 1's operations where the forward handed over its residuals:
    the load of the cotangent and the dX chain, without the recomputed
    forward."""
    return [o for o in _bwd_shapes(mc, vdirs) if o.kind != _FWD]


@dataclasses.dataclass(frozen=True)
class FwdLayout:
    """The forward kernel's shared memory for one architecture and mode:
    ``rows`` points a tile; the program's buffers as ``(name, (byte
    offset, columns, 0))`` pairs in table order;
    the ring's barriers' and slots' byte offsets, a slot's bytes (in
    hi_lo, the lo plane at half), its stages and the weight rows a stage
    gives the widest operations (``kr``); the total bytes."""

    rows: int
    bufs: Tuple[Tuple[str, Tuple[int, int, int]], ...]
    bar_off: int
    ring_off: int
    slot: int
    stages: int
    kr: int
    smem: int


def _ring_at(room: int, ops: List[OpShape], planes: int, kr: int,
             dx_rows: int = 64):
    """(stages, rows a stage, a plane's slot bytes) of a ring in ``room``
    bytes whose widest forward operations take stages of ``kr`` rows (and
    dX operations of ``dx_rows``): as many stages as fit, up to
    ``MAX_STAGES``."""
    slot = _ring_slot(ops, kr, dx_rows)
    return max(0, min(MAX_STAGES, room // (slot * planes))), kr, slot


def _fwd_pick(layouts):
    """The forward's layout among ``layouts`` (every tile of the tries at
    every stage size): the largest tile that holds two stages, at the
    largest stage that leaves two; else the last tried. Measured on an
    H100 (scripts/layout_sweep.py, PERF.md): at every net of chip_smoke.py's
    phases 4 and 16-18 this is the fastest layout; a larger tile (the N of
    every wgmma) and larger stages gain more than a deeper ring."""
    fit = [lay for lay in layouts if lay.stages >= 2]
    return max(fit, key=lambda lay: (lay.rows, lay.kr)) if fit \
        else layouts[-1]


def _bwd_pick(layouts):
    """Phase 1's layout among ``layouts``: the most points x weight rows a
    stage, the larger tile on a tie, among tiles of 16 points or more with
    their tables in shared memory that hold three stages of at least 32
    rows; else two stages; else the same with the tables in device memory;
    else 8-point tiles that hold two; else the last tried. Measured on an H100
    (scripts/layout_sweep.py, PERF.md): phase 1, whose dX stages follow its
    forward ones, loses up to 1.45x with two stages where three fit, and
    gains with the product of its tile and stage."""
    def best(fit):
        return max(fit, key=lambda lay: (lay.rows * lay.kr, lay.rows))

    shared = lambda lay: lay.prog_ints > BWD_TABLES_BASE
    for want, tables, small in ((3, True, False), (2, True, False),
                                (2, False, False), (2, False, True)):
        fit = [lay for lay in layouts
               if lay.stages >= want and (lay.rows < 16) == small
               and (shared(lay) or not tables)
               and (want == 2 or lay.kr >= 32)]
        if fit:
            return best(fit)
    return layouts[-1]


@functools.lru_cache(maxsize=None)
def _fwd_layout_at(mc: ModelConfig, vdirs: bool, hi_lo: bool, rows: int,
                   kr: int) -> FwdLayout:
    """The forward's layout at tiles of ``rows`` points: the program, the
    ring's barriers, the buffers x
    (encoded points; the heads' fp32 rows are staged there after the
    trunk), d (encoded dirs), p0 (and p1 where a layer takes more than one
    pass: every layer of a net at most ``FWD_MAX_N`` wide writes its output
    over its input), each ``rows`` rows of its columns rounded up to 64
    (whole swizzled atoms) in bf16 (two planes in hi_lo), then the ring:
    stages of ``kr`` rows, as many as fit. The program's bytes (64 a layer)
    bound the depth."""
    planes = 2 if hi_lo else 1
    hid = _pad64(_hidden_cols(mc, vdirs))
    prog = _align128(4 * (FWD_OPS_BASE + forward_ops(mc, vdirs) * FWD_OP_INTS))
    out_w = 4 if vdirs else mc.output_ch
    cols = (("x", max(_pad64(mc.input_ch), _pad64(2 * out_w))),
            ("d", _pad64(mc.input_ch_views) if vdirs else 0),
            ("p0", hid), ("p1", hid if hid > FWD_MAX_N else 0))
    ops = _fwd_shapes(mc, vdirs)
    bar = prog
    off = _align1k(bar + MAX_STAGES * BARRIER_BYTES + ZERO_BYTES)
    bufs = []
    for name, c in cols:
        bufs.append((name, (off, c, 0)))
        off += rows * c * 2 * planes
    stages, kr, slot = _ring_at(SMEM_LIMIT - off, ops, planes, kr)
    return FwdLayout(rows, tuple(bufs), bar, off, slot * planes, stages, kr,
                     off + slot * planes * stages)


@functools.lru_cache(maxsize=None)
def _fwd_layout(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> FwdLayout:
    """The forward's layout (:func:`_fwd_layout_at`) at the tiles of
    ``FWD_TRIES`` and the stage sizes of ``STAGE_ROWS``, chosen by
    :func:`_fwd_pick`. Where no layout holds two stages, the last tried is
    returned (:func:`forward_misfit` names it)."""
    return _fwd_pick([_fwd_layout_at(mc, vdirs, hi_lo, rows, kr)
                      for rows in FWD_TRIES[hi_lo] for kr in STAGE_ROWS])


def kernel_layouts(packed: "PackedMLP") -> Dict[str, Dict[str, int]]:
    """The layouts a packed net's kernels run: the forward's and phase 1's
    points a tile, ring stages and weight rows a stage (of the widest
    forward operations); phase 2's input features a unit, the bytes a
    stage aims at, its ring stages and slot bytes."""
    mc = packed.net.cfg
    out = {key: {"points_a_tile": lay.rows, "stages": lay.stages,
                 "rows_a_stage": lay.kr}
           for key, lay in (("fwd", _fwd_layout(mc, packed.vdirs,
                                                packed.hi_lo)),
                            ("phase1", _bwd_layout(mc, packed.vdirs,
                                                   packed.hi_lo)))}
    hdr = bwd_header(packed)
    unit_k, stage_bytes = _p2_pick(mc, packed.vdirs, packed.hi_lo)
    out["phase2"] = {"unit_k": unit_k, "stage_bytes": stage_bytes,
                     "stages": hdr["p2_stages"], "slot": hdr["p2_slot"],
                     "units": hdr["n_units"]}
    return out


def smem_bytes(mc: ModelConfig, vdirs: bool, hi_lo: bool = False) -> int:
    """Shared memory one forward block needs for this architecture and
    mode."""
    return _fwd_layout(mc, vdirs, hi_lo).smem


def _arch_name(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> str:
    return (f"depth {mc.depth} width {mc.width}"
            + (" +view head" if vdirs else "") + (" hi_lo" if hi_lo else ""))


def forward_misfit(mc: ModelConfig, vdirs: bool = True,
                   hi_lo: bool = False) -> Optional[str]:
    """Why the forward kernel does not take this architecture, or None:
    its program, activation buffers and two weight-ring stages must fit
    one block's shared memory (the program's bytes bound the depth)."""
    lay = _fwd_layout(mc, vdirs, hi_lo)
    if lay.stages < 2:
        return (f"the forward's buffers of {lay.rows}-point tiles leave room "
                f"for {lay.stages} weight stage(s) of two in {SMEM_LIMIT} B "
                f"of shared memory")
    return None


@functools.lru_cache(maxsize=None)
def kernel_fits(mc: ModelConfig, vdirs: bool = True,
                hi_lo: bool = False) -> bool:
    """Whether the forward kernel takes this architecture
    (:func:`forward_misfit` says why not). Logged once per architecture
    and mode."""
    lay = _fwd_layout(mc, vdirs, hi_lo)
    why = forward_misfit(mc, vdirs, hi_lo)
    log.info(
        "fused MLP kernel budget: %s: %d-point tiles, %d weight stages of "
        "%d rows (%d B a slot), %d B of shared memory per block (Hopper "
        "limit %d B): %s",
        _arch_name(mc, vdirs, hi_lo), lay.rows, lay.stages, lay.kr,
        lay.slot, lay.smem, SMEM_LIMIT, why or "kernel")
    return why is None


def _bwd_mats(mc: ModelConfig, vdirs: bool) -> List[Tuple[str, int]]:
    """The workspace matrices phase 1 writes and phase 2 reads, in order:
    (name, padded width). Every stored activation (encoded points and
    dirs, each trunk layer, bottleneck, view) and every rounded cotangent
    (the output's, dv, dbott, each trunk layer's dacc)."""
    w = _pad16(mc.width)
    mats = [("x", _pad16(mc.input_ch))]
    if vdirs:
        mats.append(("d", _pad16(mc.input_ch_views)))
    mats += [(f"h{i}", w) for i in range(mc.depth)]
    if vdirs:
        bott, view = _pad16(mc.bottleneck_ch), _pad16(mc.view_width)
        mats += [("bott", bott), ("v", view), ("g_rgb", 16),
                 ("g_sigma", 16), ("dv", view), ("dbott", bott)]
    else:
        mats.append(("g_out", _pad16(mc.output_ch)))
    return mats + [(f"dacc{i}", w) for i in range(mc.depth - 1, -1, -1)]


def backward_counts(mc: ModelConfig, vdirs: bool,
                    hi_lo: bool = False) -> Tuple[int, int]:
    """(phase-1 operations, workspace matrices) for an architecture and
    mode: a pass of at most ``BWD_MAX_N`` columns over each recomputed
    forward layer (the output heads excepted), the load of the cotangent,
    and a pass over each dX output of the chain; the matrices of
    :func:`_bwd_mats`."""
    return len(_bwd_shapes(mc, vdirs)), len(_bwd_mats(mc, vdirs))


def mask_entry_bytes(rows: int) -> int:
    """Bytes of a thread's ReLU bits for one 16-column warp tile of a pass
    at tiles of ``rows`` points: rows / 2 bits (two features' rows of its
    accumulator fragment), at least a byte."""
    return max(1, rows // 16)


def _mask_blocks(mc: ModelConfig, vdirs: bool, rows: int
                 ) -> Tuple[Tuple[int, ...], ...]:
    """Phase 1's ReLU masks at tiles of ``rows`` points: for each ReLU
    layer's slot (trunk layer i, then the view layer), one block per column
    pass, as its byte offset in the mask region. A thread keeps the bits of
    its own accumulator fragment: the block of a pass of n columns holds,
    for each of its n / 16 warp tiles (64-row tile mt, warp w: 4 mt + w),
    32 lanes' entries of :func:`mask_entry_bytes`; blocks 16-byte
    aligned. The last entry is the region's bytes."""
    entry = mask_entry_bytes(rows)
    slots, at = [], 0
    for cols in [mc.width] * mc.depth + ([mc.view_width] if vdirs else []):
        blocks = []
        for c0 in range(0, _pad16(cols), BWD_MAX_N):
            blocks.append(at)
            nn = min(BWD_MAX_N, _pad16(cols) - c0)
            at += -(-nn * 32 * entry // 16 // 16) * 16
        slots.append(tuple(blocks))
    return tuple(slots) + ((at,),)


def bwd_scratch_bytes(mc: ModelConfig, vdirs: bool,
                      hi_lo: bool = False) -> int:
    """Workspace bytes per point: every matrix of :func:`_bwd_mats`, bf16
    (two planes in hi_lo mode). At 8x640 + view head: 24,576 B in bf16
    (3.2 GB for a chunk of ``BWD_CHUNK_ROWS`` points); at 8x576 hi_lo:
    44,288 B (5.8 GB)."""
    cols = sum(c for _, c in _bwd_mats(mc, vdirs))
    return cols * 2 * (2 if hi_lo else 1)


def bwd_chunk_rows(mc: ModelConfig, vdirs: bool, hi_lo: bool = False) -> int:
    """Points of a scene per chunk of a backward call: ``BWD_CHUNK_ROWS``,
    or as many (a multiple of ``BWD_CHUNK_ALIGN``) as keep one scene's
    workspace within ``BWD_WS_BUDGET`` (a deep net: 147x128 hi_lo takes
    152,576 B a point, 20 GB for 131,072 points). An architecture's chunk,
    whatever the call's scenes, so a stack's scene gives a single-scene
    call's bits."""
    fit = BWD_WS_BUDGET // bwd_scratch_bytes(mc, vdirs, hi_lo)
    return min(BWD_CHUNK_ROWS,
               max(BWD_CHUNK_ALIGN, fit // BWD_CHUNK_ALIGN * BWD_CHUNK_ALIGN))


def ws_rows(n: int, tile: int) -> int:
    """Workspace rows of a scene's n points at phase-1 tiles of ``tile``
    points: n rounded up to the tile and to ``BWD_STAGE_ROWS`` (tiles of
    fewer points fill the rows up to 64 with zero points)."""
    step = max(tile, BWD_STAGE_ROWS)
    return -(-n // step) * step


@dataclasses.dataclass(frozen=True)
class BwdLayout:
    """Phase 1's shared memory for one architecture and mode: ``rows``
    points a tile; ``prog_ints`` the program's
    ints copied into shared memory (header, buffer, matrix and operation
    tables, or the header and buffer table alone); the buffers as ``{name:
    (byte offset, columns, 0)}``; the mask region's byte offset and its
    blocks (:func:`_mask_blocks`); the ring's barriers' and slots' byte
    offsets, a slot's bytes, its stages and the weight rows a stage gives
    the widest forward operations (``kr``); the total bytes."""

    rows: int
    prog_ints: int
    bufs: Dict[str, Tuple[int, int, int]]
    mask_off: int
    masks: Tuple[Tuple[int, ...], ...]
    bar_off: int
    ring_off: int
    slot: int
    stages: int
    kr: int
    smem: int

    @property
    def pass_cols(self) -> int:
        return BWD_MAX_N


@functools.lru_cache(maxsize=None)
def _bwd_layout_at(mc: ModelConfig, vdirs: bool, hi_lo: bool, rows: int,
                   shared: bool, kr: int, handover: bool = False
                   ) -> BwdLayout:
    """Phase 1's dynamic shared memory at tiles of ``rows`` points: the
    program (or, where ``shared`` is
    false, its header and buffer table); the ring's barriers; the buffers
    x, d, p0 (and p1 where a layer takes more than one pass: a net at most
    ``BWD_MAX_N`` wide writes every output over its input, down the dX
    chain too), and the cotangent's gr / gs laid over x when they fit there
    (x is dead by then), each ``rows`` rows of its columns in bf16 (two
    planes in hi_lo); the mask blocks (one bit a value of a ReLU layer's
    column pass); the ring: stages of ``kr`` rows, as many as fit.
    ``handover``: the program without the recomputed forward
    (:func:`_handover_shapes`), whose residuals the forward wrote: no x or
    d, the cotangent in a buffer g of its own, dX stages of ``4 kr`` rows
    (the slot the forward's stages of ``kr`` rows would take)."""
    planes = 2 if hi_lo else 1
    n_mats = len(_bwd_mats(mc, vdirs))
    ops = (_handover_shapes if handover else _bwd_shapes)(mc, vdirs)
    hid = _hidden_cols(mc, vdirs)
    prog_ints = (BWD_TABLES_BASE + 2 * n_mats + BWD_OP_INTS * len(ops)
                 if shared else BWD_TABLES_BASE)
    bar = _align128(4 * prog_ints)
    off = _align1k(bar + MAX_STAGES * BARRIER_BYTES + ZERO_BYTES)
    bufs: Dict[str, Tuple[int, int, int]] = {}

    def region(name, cols):
        nonlocal off
        bufs[name] = (off, _pad64(cols), 0)
        off += rows * _pad64(cols) * 2 * planes

    if handover:
        region("g", 32 if vdirs else mc.output_ch)
    else:
        region("x", mc.input_ch)
        if vdirs:
            region("d", mc.input_ch_views)
    region("p0", hid)
    if hid > BWD_MAX_N:
        region("p1", hid)
    # The cotangent in x's atoms (x is dead by then; with the handover, in
    # g's): rgb's columns from 0, sigma's from 16 (or the output head's
    # from 0).
    g_at, g_cols = bufs.pop("g")[:2] if handover else bufs["x"][:2]
    bufs["gr"] = (g_at, g_cols, 0)
    if vdirs:
        bufs["gs"] = (g_at, g_cols, 16)
    mask_off = off
    masks = _mask_blocks(mc, vdirs, rows)
    off += _align128(masks[-1][0])
    off = _align1k(off)
    stages, kr, slot = _ring_at(SMEM_LIMIT - off, ops, planes, kr,
                                4 * kr if handover else 64)
    return BwdLayout(rows, prog_ints, bufs, mask_off, masks[:-1], bar, off,
                     slot * planes, stages, kr, off + slot * planes * stages)


@functools.lru_cache(maxsize=None)
def _bwd_layout(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> BwdLayout:
    """Phase 1's layout (:func:`_bwd_layout_at`) at the entries of
    ``BWD_TRIES`` and the stage sizes of ``STAGE_ROWS``, chosen by
    :func:`_bwd_pick`. Where none holds two stages, the last tried is
    returned (:func:`backward_misfit` names it)."""
    return _bwd_pick([_bwd_layout_at(mc, vdirs, hi_lo, *entry, kr)
                      for entry in BWD_TRIES[hi_lo] for kr in STAGE_ROWS])


@functools.lru_cache(maxsize=None)
def _handover_layout(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> BwdLayout:
    """Phase 1's layout without the recomputed forward
    (:func:`_bwd_layout_at`'s ``handover``), at the forward's tile: the
    forward writes its ReLU bits at its own tile, in the layout this phase
    1 reads them. Among the entries of ``BWD_TRIES`` at that tile and the
    stage sizes of ``STAGE_ROWS``, chosen by :func:`_bwd_pick`."""
    rows = _fwd_layout(mc, vdirs, hi_lo).rows
    return _bwd_pick([_bwd_layout_at(mc, vdirs, hi_lo, *entry, kr, True)
                      for entry in BWD_TRIES[hi_lo] if entry[0] == rows
                      for kr in STAGE_ROWS])


def handover_misfit(mc: ModelConfig, vdirs: bool = True,
                    hi_lo: bool = False) -> Optional[str]:
    """Why a training call on this architecture recomputes the forward in
    phase 1 instead of taking the forward's residuals, or None. Both
    kernels must take the net; phase 1 without the forward must hold two
    weight stages at the forward's tile (:func:`_handover_layout`), and
    three where that tile is not phase 1's own (measured on an H100,
    PERF.md: at a larger tile, two stages left the handover slower than
    the recompute at 2x1312, 8x592, 1x1472 and 8x608 hi_lo); and that tile
    must give the workspace the rows phase 1's own tile gives it
    (:func:`ws_rows`), so that phase 2 sums the same rows in the same
    splits and the gradient keeps its bits."""
    why = forward_misfit(mc, vdirs, hi_lo) or backward_misfit(mc, vdirs,
                                                              hi_lo)
    if why is not None:
        return why
    lay = _handover_layout(mc, vdirs, hi_lo)
    own = _bwd_layout(mc, vdirs, hi_lo).rows
    if lay.stages < (2 if lay.rows == own else 3):
        return (f"phase 1's buffers and masks of the forward's {lay.rows}-"
                f"point tiles leave room for {lay.stages} weight stage(s) "
                f"of {2 if lay.rows == own else 3} in {SMEM_LIMIT} B of "
                f"shared memory")
    if max(lay.rows, BWD_STAGE_ROWS) != max(own, BWD_STAGE_ROWS):
        return (f"the forward's {lay.rows}-point tiles give the workspace "
                f"other rows than phase 1's {own}-point tiles")
    return None


def bwd_smem_bytes(mc: ModelConfig, vdirs: bool, hi_lo: bool = False) -> int:
    """Shared memory one phase-1 block needs for this architecture."""
    return _bwd_layout(mc, vdirs, hi_lo).smem


def backward_misfit(mc: ModelConfig, vdirs: bool = True,
                    hi_lo: bool = False) -> Optional[str]:
    """Why the backward kernels do not take this architecture, or None:
    phase 1's buffers, masks and two weight-ring stages must fit one
    block's shared memory at some tile of points (its program's tables,
    sized by the net, too where they fit, else they stay in device
    memory). The workspace is bounded by cutting the call into chunks
    (:func:`bwd_chunk_rows`)."""
    lay = _bwd_layout(mc, vdirs, hi_lo)
    if lay.stages < 2:
        return (f"phase 1's buffers and masks of {lay.rows}-point tiles "
                f"leave room for {lay.stages} weight stage(s) of two in "
                f"{SMEM_LIMIT} B of shared memory")
    return None


@functools.lru_cache(maxsize=None)
def backward_fits(mc: ModelConfig, vdirs: bool = True,
                  hi_lo: bool = False) -> bool:
    """Whether the backward kernels take this architecture
    (:func:`backward_misfit` says why not). The workspace,
    :func:`bwd_scratch_bytes` per point, is bounded by the call's chunk
    (:func:`bwd_chunk_rows`); the partial gradients by ``BWD_MAX_SPLITS``
    slots a chunk (at 8x640, 32 slots of ~3.6M floats). Logged once per
    architecture and mode."""
    ops, mats = backward_counts(mc, vdirs, hi_lo)
    lay = _bwd_layout(mc, vdirs, hi_lo)
    why = backward_misfit(mc, vdirs, hi_lo)
    log.info(
        "fused MLP backward budget: %s: %d-point tiles, %d B of shared "
        "memory per block (%d weight stages of %d rows, %d B of masks; "
        "Hopper limit %d B), %d operations and %d workspace matrices "
        "(tables in %s memory), %d B of workspace per point, chunks of %d "
        "points: %s",
        _arch_name(mc, vdirs, hi_lo), lay.rows, lay.smem,
        lay.stages, lay.kr, lay.ring_off - lay.mask_off,
        SMEM_LIMIT, ops, mats,
        "shared" if lay.prog_ints > BWD_TABLES_BASE else "device",
        bwd_scratch_bytes(mc, vdirs, hi_lo), bwd_chunk_rows(mc, vdirs, hi_lo),
        why or "kernel")
    return why is None


# --------------------------------------------------------------------- #
# Weights, packed once for the kernels
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """One net's weights in the kernels' layout, plus both programs.

    ``weights``: every weight block, bf16, each a ``(k_pad, n_pad)`` block
    in ``(in, out)`` layout laid out by :func:`strip_image` — in ``hi_lo``
    mode a (hi, lo) pair of such blocks, lo right after hi; ``biases``:
    fp32, each padded to ``n_pad``;
    ``program``: the forward's int32 header, buffer table and one record
    per column pass of each layer (see ``fused_mlp_fwd.cu``), also on the
    device as ``program_dev``; ``bwd_program``: the backward's header, buffer
    and matrix tables, phase-1 operations and phase 2's work units
    ``bwd_units`` (see ``fused_mlp_bwd.cu``), also on the device as
    ``bwd_program_dev``, of which phase 1 copies the first ``bwd_prog_len``
    ints into shared memory. ``ws_mats``: each workspace matrix's (name,
    column offset, cols); a workspace of R rows holds ``R * ws_cols`` bf16,
    matrix m at ``R * offset``, plane after plane, each in the strip layout
    of :func:`ws_index` (:func:`ws_matrix` reads one).
    ``grad_blocks`` / ``grad_biases`` say where each parameter's gradient
    lies in the backward's flat fp32 output: ``(param, in_start, k, n,
    offset, k_pad, n_pad)`` per weight block and ``(param, offset, n)``
    per bias. ``bwd_rows``: phase 1's points per tile. ``net`` is the
    module the blocks came from (the plain path and the architecture
    check read it). ``handover``: what a training call needs to hand the
    forward's residuals to phase 1, or None where the net recomputes
    (:func:`handover_misfit`)."""

    net: NeRFMLP
    vdirs: bool
    hi_lo: bool
    weights: torch.Tensor
    biases: torch.Tensor
    program: np.ndarray
    program_dev: torch.Tensor
    out_w: int
    bwd_program: np.ndarray
    bwd_program_dev: torch.Tensor
    bwd_prog_len: int
    bwd_units: np.ndarray
    bwd_smem: int
    bwd_rows: int
    ws_cols: int
    ws_mats: Tuple[Tuple[str, int, int], ...]
    grad_total: int
    grad_blocks: Tuple[Tuple, ...]
    grad_biases: Tuple[Tuple, ...]
    stack: Tuple[NeRFMLP, ...] = ()
    handover: Optional["Handover"] = None

    @property
    def n_scenes(self) -> int:
        """Nets laid out one after another (:func:`pack_params_stack`): 1
        for a single net."""
        return len(self.stack) or 1

    @property
    def w_stride(self) -> int:
        """bf16 elements of one scene's weights."""
        return self.weights.numel() // self.n_scenes

    @property
    def b_stride(self) -> int:
        """fp32 elements of one scene's biases."""
        return self.biases.numel() // self.n_scenes


@dataclasses.dataclass(frozen=True)
class Handover:
    """A packed net's residual handover (:func:`handover_misfit`): the
    training forward writes the activations phase 2 reads and the ReLU
    masks into the backward's workspace and a mask image per tile, and
    phase 1 runs only the dX chain. ``rows``: points a tile, the forward's
    and phase 1's; ``res``: the forward's residual table (x's and d's
    workspace matrices as (column offset, columns), d's (-1, 0) without
    the view head; then per forward operation its matrix's column offset
    or -1, its columns, its mask block's byte offset or -1, and 0), also on
    the device as ``res_dev``; ``program``: phase 1's program without the
    recomputed forward, also ``program_dev``, of which it copies
    ``prog_len`` ints into its ``smem`` bytes of shared memory;
    ``mask_bytes``: one tile's mask image."""

    rows: int
    res: np.ndarray
    res_dev: torch.Tensor
    program: np.ndarray
    program_dev: torch.Tensor
    prog_len: int
    smem: int
    mask_bytes: int


@dataclasses.dataclass(frozen=True)
class NetStack:
    """S nets of one architecture, one per scene, queried together: every
    call takes S equal, scene-major slices of points, scene s's through
    ``nets[s]``."""

    nets: Tuple[NeRFMLP, ...]


def _check_arch(net: NeRFMLP, mc: ModelConfig, vdirs: bool) -> None:
    """Fail before any launch when the net is not the configured one
    (``pallas_mlp.py:640-655``)."""
    c = net.cfg
    head = "view_linear" if vdirs else "output_linear"
    head_rows = (mc.bottleneck_ch + mc.input_ch_views) if vdirs else mc.width
    if (
        c.depth != mc.depth
        or tuple(c.skips) != tuple(mc.skips)
        or any(not 0 <= s < mc.depth for s in mc.skips)
        or c.width != mc.width
        or c.input_ch != mc.input_ch
        or not hasattr(net, head)
        or getattr(net, head).in_features != head_rows
    ):
        raise NotImplementedError(
            f"params do not match the configured architecture (depth "
            f"{mc.depth}, width {mc.width}, skips {mc.skips}, {head} rows "
            f"{head_rows}); set use_kernel=False or fix "
            "--netdepth/--netwidth/--use_viewdirs"
        )


def pack_params(net: NeRFMLP, n_freqs: int, vdirs: bool,
                hi_lo: bool = False) -> PackedMLP:
    """Lay ``net`` out for the kernels, on the net's device; ``hi_lo``
    splits every weight into a (hi, lo) bf16 pair."""
    mc = net.cfg
    if vdirs and not mc.use_viewdirs:
        raise ValueError("viewdirs given to a net without a view head")
    dev = net.pts_linears[0].weight.device
    enc_dim = 3 + 6 * n_freqs
    if enc_dim != mc.input_ch:
        raise ValueError(f"pos_enc_L={n_freqs} gives {enc_dim} encoded "
                         f"channels; the net takes {mc.input_ch}")
    names = {id(m): name for name, m in net.named_modules()}
    w_parts, b_parts = [], []
    w_off = b_off = g_off = 0
    grad_blocks, grad_biases = [], []
    blocks: Dict[str, list] = {}   # Linear name -> [(w_off, k_pad, n_pad)]
    bias_of: Dict[str, int] = {}

    def weight(lin, in0: int, k: torch.Tensor):
        """One (in, out) block of ``lin`` from input column ``in0``."""
        nonlocal w_off, g_off
        kp, np_ = _pad16(k.shape[0]), _pad16(k.shape[1])
        blk = torch.zeros(kp, np_, device=dev, dtype=torch.float32)
        blk[: k.shape[0], : k.shape[1]] = k
        hi = blk.to(torch.bfloat16)
        w_parts.append(strip_image(hi))
        if hi_lo:
            w_parts.append(strip_image((blk - hi.float()).to(torch.bfloat16)))
        name = names[id(lin)]
        grad_blocks.append((f"{name}.weight", in0, k.shape[0], k.shape[1],
                            g_off, kp, np_))
        blocks.setdefault(name, []).append((w_off, kp, np_, g_off))
        off, w_off = w_off, w_off + kp * np_ * (2 if hi_lo else 1)
        g_off += kp * np_
        return off, kp

    def bias(lin) -> int:
        nonlocal b_off
        b = lin.bias.detach().float()
        bp = torch.zeros(_pad16(b.shape[0]), device=dev, dtype=torch.float32)
        bp[: b.shape[0]] = b
        b_parts.append(bp)
        bias_of[names[id(lin)]] = b_off
        off, b_off = b_off, b_off + bp.shape[0]
        return off

    ops = []
    res_ops = []   # per operation: (workspace matrix or None, ReLU slot, c0)
    lay = _fwd_layout(mc, vdirs, hi_lo)
    slot = lay.slot // (2 if hi_lo else 1)

    def layer(a, b, lin, mode, dst, n_real=0, res=(None, -1)):
        """a/b: (buffer, in_start, (in, out) block) operands; b may be
        None. One operation per pass of at most FWD_MAX_N columns; an
        output head's dst is its first output column. ``res``: the
        workspace matrix the layer's output is stored in for the backward
        and its ReLU mask slot (:func:`_mask_blocks`), or -1."""
        wa, ka = weight(lin, a[1], a[2])
        wb, kb = weight(lin, b[1], b[2]) if b is not None else (0, 0)
        bo, n = bias(lin), _pad16(lin.out_features)
        for c0 in range(0, n, FWD_MAX_N):
            nn = min(FWD_MAX_N, n - c0)
            head = mode == _OUT_F32
            ops.append([_FWD, a[0], wa, ka, b[0] if b is not None else 0,
                        wb if kb else 0, kb, nn, c0, n,
                        stage_rows(OpShape(_FWD, ka, kb, n, c0, nn), slot),
                        dst + c0 if head else dst, bo + c0, mode,
                        max(0, min(nn, n_real - c0)) if head else 0, 0])
            res_ops.append((*res, c0))

    kt = lambda lin: lin.weight.detach().float().t()
    # Where every layer is one pass, each writes its output over its input.
    p = (_P0, _P1) if dict(lay.bufs)["p1"][1] else (_P0, _P0)
    with torch.no_grad():
        cur = _X
        for i, lin in enumerate(net.pts_linears):
            k = kt(lin)
            dst = p[i % 2]
            if i in mc.skips:  # cat([x, h]) @ W == x @ W[:enc] + h @ W[enc:]
                layer((_X, 0, k[:enc_dim]), (cur, enc_dim, k[enc_dim:]), lin,
                      _RELU_BF16, dst, res=(f"h{i}", i))
            else:
                layer((cur, 0, k), None, lin, _RELU_BF16, dst,
                      res=(f"h{i}", i))
            cur = dst
        other = p[1] if cur == p[0] else p[0]
        if vdirs:
            kv = kt(net.view_linear)
            bott = mc.bottleneck_ch
            layer((cur, 0, kt(net.sigma_linear)), None, net.sigma_linear,
                  _OUT_F32, 3, 1)
            layer((cur, 0, kt(net.bottleneck_linear)), None,
                  net.bottleneck_linear, _BF16, other, res=("bott", -1))
            layer((other, 0, kv[:bott]), (_D, bott, kv[bott:]),
                  net.view_linear, _RELU_BF16, cur, res=("v", mc.depth))
            layer((cur, 0, kt(net.rgb_linear)), None, net.rgb_linear,
                  _OUT_F32, 0, 3)
            out_w = 4
        else:
            out_w = mc.output_ch
            layer((cur, 0, kt(net.output_linear)), None, net.output_linear,
                  _OUT_F32, 0, out_w)

    if ([OpShape(o[0], o[3], o[6], o[9], o[8], o[7]) for o in ops]
            != _fwd_shapes(mc, vdirs)):
        raise ValueError(f"forward program of {len(ops)} operations")
    header = dict(
        n_ops=len(ops), prog_len=FWD_OPS_BASE + FWD_OP_INTS * len(ops),
        n_freqs=n_freqs, enc_dim=enc_dim,
        dirs_dim=mc.input_ch_views if vdirs else 0, out_w=out_w,
        hi_lo=int(hi_lo), rows=lay.rows, stages=lay.stages, ring_off=lay.ring_off, slot=lay.slot,
        bar_off=lay.bar_off, smem=lay.smem)
    head = [header[k] for k in _FWD_HEADER]
    head += [0] * (FWD_HEADER_INTS - len(head))
    program = np.asarray(head + [v for _, b in lay.bufs for v in b]
                         + [v for rec in ops for v in rec], dtype=np.int32)
    modules = dict(net.named_modules())
    for name, off in bias_of.items():
        grad_biases.append((f"{name}.bias", g_off + off,
                            modules[name].out_features))
    bwd_program, ws_mats = _bwd_program(net, n_freqs, vdirs, hi_lo, out_w,
                                        blocks, bias_of, g_off)
    handover = None
    if handover_misfit(mc, vdirs, hi_lo) is None:
        handover = _pack_handover(
            _bwd_program(net, n_freqs, vdirs, hi_lo, out_w, blocks, bias_of,
                         g_off, handover=True)[0],
            mc, vdirs, hi_lo, ws_mats, res_ops, str(dev))
    hdr = bwd_program[:BWD_HEADER_INTS]
    units_off, n_units = int(hdr[_H_UNITS_OFF]), int(hdr[_H_N_UNITS])
    return PackedMLP(
        net=net, vdirs=vdirs, hi_lo=hi_lo,
        weights=torch.cat(w_parts).contiguous(),
        biases=torch.cat(b_parts).contiguous(),
        program=program, program_dev=_device_program(program.tobytes(),
                                                     str(dev)),
        out_w=out_w,
        bwd_program=bwd_program,
        bwd_program_dev=_device_program(bwd_program.tobytes(), str(dev)),
        bwd_prog_len=int(hdr[_H_PROG_LEN]),
        bwd_units=bwd_program[units_off:].reshape(n_units, BWD_UNIT_INTS),
        bwd_smem=int(hdr[_H_SMEM]), bwd_rows=int(hdr[_H_ROWS]),
        ws_cols=int(hdr[_H_WS_COLS]),
        ws_mats=ws_mats, grad_total=g_off + b_off,
        grad_blocks=tuple(grad_blocks), grad_biases=tuple(grad_biases),
        handover=handover,
    )


def _pack_handover(program: np.ndarray, mc: ModelConfig, vdirs: bool,
                   hi_lo: bool, ws_mats, res_ops, device: str) -> Handover:
    """A net's :class:`Handover`: phase 1's ``program`` without the
    recomputed forward, and the forward's residual table from its
    operations' ``res_ops`` ((workspace matrix or None, ReLU slot or -1,
    first column) each) and the workspace's matrices ``ws_mats``."""
    lay = _handover_layout(mc, vdirs, hi_lo)
    at = {name: (off, cols) for name, off, cols in ws_mats}
    res = [*at["x"], *at.get("d", (-1, 0))]
    for name, relu, c0 in res_ops:
        res += [*(at[name] if name else (-1, 0)),
                lay.masks[relu][c0 // BWD_MAX_N] if relu >= 0 else -1, 0]
    res = np.asarray(res, np.int32)
    hdr = dict(zip(_BWD_HEADER, program.tolist()))
    return Handover(
        rows=lay.rows, res=res, res_dev=_device_program(res.tobytes(), device),
        program=program, program_dev=_device_program(program.tobytes(),
                                                     device),
        prog_len=hdr["prog_len"], smem=hdr["smem"],
        mask_bytes=-(-_mask_blocks(mc, vdirs, lay.rows)[-1][0] // 16) * 16)


def pack_params_stack(nets, n_freqs: int, vdirs: bool,
                      hi_lo: bool = False) -> PackedMLP:
    """Lay S nets of one architecture out for one launch over a scene
    axis: scene 0's programs, and every net's weights, then biases, one
    scene after another (scene s's at ``s * w_stride`` / ``s * b_stride``).
    ``packed.stack`` holds the nets."""
    nets = tuple(nets.nets if isinstance(nets, NetStack) else nets)
    if not nets:
        raise ValueError("pack_params_stack needs at least one net")
    packs = [pack_params(net, n_freqs, vdirs, hi_lo) for net in nets]
    first = packs[0]
    for net, p in zip(nets[1:], packs[1:]):
        if (net.cfg != first.net.cfg
                or not np.array_equal(p.program, first.program)
                or not np.array_equal(p.bwd_program, first.bwd_program)):
            raise ValueError("the nets of a stack must share one "
                             "architecture")
    return dataclasses.replace(
        first, stack=nets,
        weights=torch.cat([p.weights for p in packs]),
        biases=torch.cat([p.biases for p in packs]))


@functools.lru_cache(maxsize=64)
def _device_program(prog: bytes, device: str) -> torch.Tensor:
    """A kernel's program on its device, copied once per architecture: a
    copy from pageable host memory would wait for the device's queue on
    every pack, i.e. every train step."""
    return torch.frombuffer(bytearray(prog), dtype=torch.int32).to(device)


# The forward program's header fields, in the order of fused_mlp_fwd.cu's
# `Header` enum.
_FWD_HEADER = ("n_ops", "prog_len", "n_freqs", "enc_dim", "dirs_dim",
               "out_w", "hi_lo", "rows", "stages", "ring_off", "slot",
               "bar_off", "smem")


def fwd_header(packed: "PackedMLP") -> Dict[str, int]:
    """The forward program's header fields by name."""
    return dict(zip(_FWD_HEADER, packed.program.tolist()))


# The backward program's header fields, in the order of fused_mlp_bwd.cu's
# `Header` enum.
_BWD_HEADER = ("n_ops", "prog_len", "n_freqs", "enc_dim", "dirs_dim",
               "g_cols", "gr_cols", "x_buf", "d_buf", "gr_buf", "gs_buf",
               "x_mat", "d_mat", "gr_mat", "gs_mat", "stages", "ring_off",
               "slot", "mask_off", "smem", "ws_cols", "units_off",
               "n_units", "rows", "mats_base", "ops_base", "n_mats",
               "bar_off", "p2_stages", "p2_slot", "p2_ring_off", "p2_smem")
_H_PROG_LEN, _H_SMEM, _H_WS_COLS, _H_UNITS_OFF, _H_N_UNITS, _H_ROWS = (
    _BWD_HEADER.index(k)
    for k in ("prog_len", "smem", "ws_cols", "units_off", "n_units", "rows"))


def bwd_header(packed: "PackedMLP") -> Dict[str, int]:
    """The backward program's header fields by name."""
    return dict(zip(_BWD_HEADER, packed.bwd_program.tolist()))


def _p2_pick(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> Tuple[int, int]:
    """Phase 2's layout among ``P2_TRIES``: (input features a unit, bytes a
    ring stage aims at). Measured on an H100 (scripts/layout_sweep.py,
    PERF.md): units of 128 input features everywhere (64 is up to 1.6x
    slower, never faster by more than 3%); stages of about 32 KB, and of
    64 KB on nets at most 64 wide, whose narrow units need more rows in
    flight (866x16 2.537 ms against 2.771; a wide net loses up to 18%)."""
    return (128, 65536) if mc.width <= 64 else (128, 32768)


def p2_units(blocks, unit_k: int):
    """Phase 2's work units of weight blocks ``blocks`` ([(A matrix, A
    columns, Y matrix, Y columns, gradient offset, bias gradient offset or
    -1)], largest first): each block cut into ``unit_k`` (64 or 128) of
    its input features, the A strips (the last maybe narrower), by up to
    ``BWD_UNIT_N`` of its output features: whole 64-column strips of Y, or
    its narrower last strip alone. The units of one block and output range
    are neighbours. Returns [(A, k0, kc, Y, n0, nc, offset, ld, db)]; db
    (the unit sums the bias of its output range) only where k0 is 0."""
    out = []
    for am, kp, ym, np_, goff, db in blocks:
        full = np_ // STRIP * STRIP
        ranges = [(n0, min(BWD_UNIT_N, full - n0))
                  for n0 in range(0, full, BWD_UNIT_N)]
        if full < np_:
            ranges.append((full, np_ - full))
        for n0, nc in ranges:
            for k0 in range(0, kp, unit_k):
                out.append((am, k0, min(unit_k, kp - k0), ym, n0, nc, goff,
                            np_, db if k0 == 0 else -1))
    return out


@dataclasses.dataclass(frozen=True)
class P2Layout:
    """Phase 2's shared memory: each unit's groups of rows a stage
    (``subs``), the ring's slot bytes (both planes in hi_lo) and stages,
    its offset and the total bytes."""

    subs: Tuple[int, ...]
    slot: int
    stages: int
    ring_off: int
    smem: int


def p2_layout(units, hi_lo: bool, stage_bytes: int) -> P2Layout:
    """Each unit's stage: as many groups of rows (``P2_GROUP_ROWS``, up to
    ``P2_MAX_SUB``) as keep its bytes (A's and Y's columns, both planes in
    hi_lo) within ``stage_bytes``, at least one; a slot holds the largest
    stage; as many slots as fit (up to ``P2_MAX_STAGES``) after the
    barriers and zero block and before ``P2_SLACK`` bytes that a narrow A
    strip's 64-row tile reads past its last stage."""
    planes = 2 if hi_lo else 1
    group = [P2_GROUP_ROWS[hi_lo] * (u[2] + u[5]) * 2 * planes
             for u in units]
    subs = tuple(max(1, min(P2_MAX_SUB, stage_bytes // g)) for g in group)
    slot = -(-max(s * g for s, g in zip(subs, group)) // (1024 * planes)) \
        * 1024 * planes
    stages = min(P2_MAX_STAGES,
                 (SMEM_LIMIT - P2_RING_OFF - P2_SLACK) // slot)
    return P2Layout(subs, slot, stages, P2_RING_OFF,
                    P2_RING_OFF + stages * slot + P2_SLACK)


def _bwd_program(net: NeRFMLP, n_freqs: int, vdirs: bool, hi_lo: bool,
                 out_w: int, blocks: Dict[str, list], bias_of: Dict[str, int],
                 db_base: int, handover: bool = False
                 ) -> Tuple[np.ndarray, Tuple]:
    """The backward kernels' program — ``_bwd_kernel``/``_trunk_bwd``
    (``pallas_mlp.py:312-441``) as phase 1's operations over shared-memory
    buffers, each writing a workspace matrix, and phase 2's work units over
    those matrices. ``blocks``: per Linear its (weight offset, k_pad,
    n_pad, gradient offset) blocks in operand order; ``bias_of``: its bias
    offset, which is also its gradient's offset after ``db_base``. Returns
    the program (header, buffer table, matrix table, operations, units)
    and the matrices' (name, column offset, cols). ``handover``: phase 1's
    program where the forward wrote its residuals
    (:func:`_handover_layout`): no recomputed forward, and no x or d
    buffer (-1 in the header)."""
    mc = net.cfg
    depth = mc.depth
    lay = (_handover_layout if handover else _bwd_layout)(mc, vdirs, hi_lo)
    bufs = lay.bufs
    buf = {name: i for i, name in enumerate(bufs)}
    names = _bwd_mats(mc, vdirs)
    mat = {name: i for i, (name, _) in enumerate(names)}
    # Where every layer is one pass, each output is written over its input.
    x, p = buf.get("x", -1), (buf["p0"], buf.get("p1", buf["p0"]))
    slot_bytes = lay.slot // (2 if hi_lo else 1)
    ops: List[List[int]] = []

    def op(kind, a=-1, wa=0, ka=0, b=-1, wb=0, kb=0, n=0, col=0, wld=0,
           dst=-1, bias=0, mask_in=-1, mask_out=-1, m=-1):
        kr = (stage_rows(OpShape(kind, ka, kb, wld, col, n), slot_bytes)
              if kind != _LOAD_G else 0)
        ops.append([kind, a, wa, ka, b, wb, kb, n, col, wld, kr, dst, bias,
                    mask_in, mask_out, m])

    step = BWD_MAX_N

    def block_of(slot, c0):
        """The mask block of a ReLU layer's slot for the pass at c0: its
        byte offset in the mask region, or -1."""
        return -1 if slot < 0 else lay.masks[slot][c0 // step]

    def fwd(name, srcs, dst, m, slot=-1):
        """dst = act(sum of src @ W + bias), one op per column pass; ReLU
        when it records a mask."""
        blk = blocks[name]
        wa, ka, na, _ = blk[0]
        wb, kb = (blk[1][0], blk[1][1]) if len(blk) > 1 else (0, 0)
        for c0 in range(0, na, step):
            op(_FWD, srcs[0], wa, ka, srcs[1] if len(srcs) > 1 else -1,
               wb, kb, min(step, na - c0), c0, na, dst, bias_of[name] + c0,
               mask_out=block_of(slot, c0), m=mat[m])

    def dx(srcs, dst, m, slot=-1):
        """dst = mask(sum of src @ W^T) for (src, name, part) operands, one
        op per pass over the output columns (W's rows), each over all of
        the cotangent's columns."""
        (sa, na, pa) = srcs[0]
        wa, rows, ka, _ = blocks[na][pa]
        sb, wb, kb = -1, 0, 0
        if len(srcs) > 1:
            sb, nb, pb = srcs[1]
            wb, kb = blocks[nb][pb][0], blocks[nb][pb][2]
        for c0 in range(0, rows, step):
            op(_DX, sa, wa, ka, sb, wb, kb, min(step, rows - c0), c0, rows,
               dst, mask_in=block_of(slot, c0), m=mat[m])

    # Recompute the forward (mask slot i: h_i > 0; with the handover the
    # forward kernel wrote it), load the cotangent, walk the dX chain; h_i
    # is in p[i % 2].
    trunk = [f"pts_linears.{i}" for i in range(depth)]
    last, other = p[(depth - 1) % 2], p[depth % 2]
    if not handover:
        for i, name in enumerate(trunk):
            a = x if i == 0 else p[(i - 1) % 2]
            fwd(name, (x, a) if i in mc.skips else (a,), p[i % 2], f"h{i}",
                i)
        if vdirs:
            fwd("bottleneck_linear", (last,), other, "bott")
            fwd("view_linear", (other, buf["d"]), last, "v", depth)
    if vdirs:
        op(_LOAD_G)
        # rgb head, view layer (dv masked by v > 0), bottleneck, then
        # dh = dbott @ Wb^T + g_sigma @ Ws^T and the last layer's mask.
        dx([(buf["gr"], "rgb_linear", 0)], other, "dv", depth)
        dx([(other, "view_linear", 0)], last, "dbott")
        dx([(last, "bottleneck_linear", 0), (buf["gs"], "sigma_linear", 0)],
           other, f"dacc{depth - 1}", depth - 1)
        gr_cols = 3
    else:
        op(_LOAD_G)
        dx([(buf["gr"], "output_linear", 0)], other, f"dacc{depth - 1}",
           depth - 1)
        gr_cols = out_w
    cur = other
    for i in range(depth - 1, 0, -1):  # the skip's d(enc) branch is dropped
        nxt = p[0] if cur == p[1] else p[1]
        dx([(cur, trunk[i], len(blocks[trunk[i]]) - 1)], nxt,
           f"dacc{i - 1}", i - 1)
        cur = nxt

    # Phase 2: dW = A^T dY per weight block, in work units; db with the
    # first input features of each layer's first block. Largest blocks
    # first.
    wblocks = [(f"h{depth - 1}", "g_out", "output_linear", 0)]
    if vdirs:
        wblocks = [("v", "g_rgb", "rgb_linear", 0),
                   ("bott", "dv", "view_linear", 0),
                   ("d", "dv", "view_linear", 1),
                   (f"h{depth - 1}", "dbott", "bottleneck_linear", 0),
                   (f"h{depth - 1}", "g_sigma", "sigma_linear", 0)]
    for i, name in enumerate(trunk):
        a = "x" if i == 0 else f"h{i - 1}"
        parts = [("x", 0), (a, 1)] if i in mc.skips else [(a, 0)]
        wblocks += [(am, f"dacc{i}", name, pt) for am, pt in parts]
    wblocks.sort(key=lambda b: -blocks[b[2]][b[3]][1] * blocks[b[2]][b[3]][2])
    unit_k, stage_bytes = _p2_pick(mc, vdirs, hi_lo)
    units = p2_units([(mat[am], blocks[name][pt][1], mat[ym],
                       blocks[name][pt][2], blocks[name][pt][3],
                       db_base + bias_of[name] if pt == 0 else -1)
                      for am, ym, name, pt in wblocks], unit_k)
    p2 = p2_layout(units, hi_lo, stage_bytes)
    units = [[*u, sub, 0, 0] for u, sub in zip(units, p2.subs)]

    buf_table = [0] * (3 * BWD_MAX_BUFS)
    for i, rec in enumerate(bufs.values()):
        buf_table[3 * i: 3 * i + 3] = rec
    mat_table, ws_mats, col = [], [], 0
    for name, c in names:
        mat_table += [col, c]
        ws_mats.append((name, col, c))
        col += c * (2 if hi_lo else 1)
    ops_base = BWD_TABLES_BASE + len(mat_table)
    units_off = ops_base + BWD_OP_INTS * len(ops)
    header = dict(
        n_ops=len(ops), prog_len=lay.prog_ints, n_freqs=n_freqs,
        enc_dim=3 + 6 * n_freqs,
        dirs_dim=mc.input_ch_views if vdirs else 0, g_cols=out_w,
        gr_cols=gr_cols, x_buf=x, d_buf=buf.get("d", -1), gr_buf=buf["gr"],
        gs_buf=buf.get("gs", -1), x_mat=mat["x"], d_mat=mat.get("d", -1),
        gr_mat=mat["g_rgb" if vdirs else "g_out"],
        gs_mat=mat.get("g_sigma", -1), stages=lay.stages,
        ring_off=lay.ring_off, slot=lay.slot,
        mask_off=lay.mask_off, smem=lay.smem, ws_cols=col,
        units_off=units_off, n_units=len(units), rows=lay.rows,
        mats_base=BWD_TABLES_BASE, ops_base=ops_base, n_mats=len(names),
        bar_off=lay.bar_off, p2_stages=p2.stages, p2_slot=p2.slot,
        p2_ring_off=p2.ring_off, p2_smem=p2.smem)
    head = [header[k] for k in _BWD_HEADER]
    head += [0] * (BWD_HEADER_INTS - len(head))
    prog = np.asarray(head + buf_table + mat_table
                      + [v for rec in ops + units for v in rec], np.int32)
    if ([OpShape(o[0], o[3], o[6], o[9], o[8], o[7]) if o[0] != _LOAD_G
         else OpShape(_LOAD_G, 0, 0, 0, 0, 0) for o in ops]
            != (_handover_shapes if handover else _bwd_shapes)(mc, vdirs)
            or lay.prog_ints not in (units_off, BWD_TABLES_BASE)
            or p2.stages < 2):
        raise ValueError(f"backward program of {len(ops)} operations and "
                         f"{len(units)} phase-2 units ({p2.stages} stages)")
    return prog, tuple(ws_mats)


# --------------------------------------------------------------------- #
# The plain versions: same functions, same rounding points, plain PyTorch
# --------------------------------------------------------------------- #
def _split_bf16(a: torch.Tensor):
    """fp32 -> (hi, lo) bf16-valued fp32 pair with hi + lo ~= a."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _plain_forward(net: NeRFMLP, pts, dirs, n_freqs: int, dt, hi_lo: bool):
    """The forward with its residuals: (out, (x, d, hs, bott, v))."""
    mc = net.cfg
    f32 = torch.float32

    def rnd(t):
        return t.to(dt).float()

    def dot(a, w):  # w: an nn.Linear weight, (out, in)
        if hi_lo:
            a_hi, a_lo = _split_bf16(a)
            w_hi, w_lo = _split_bf16(w.float())
            return a_hi @ w_hi.t() + a_hi @ w_lo.t() + a_lo @ w_hi.t()
        return rnd(a) @ rnd(w.float()).t()

    x = rnd(positional_encoding(pts.to(f32), n_freqs))
    enc = x.shape[-1]
    h = x
    hs = []
    for i, lin in enumerate(net.pts_linears):
        if i in mc.skips:
            acc = dot(x, lin.weight[:, :enc]) + dot(h, lin.weight[:, enc:])
        else:
            acc = dot(h, lin.weight)
        h = rnd(torch.relu(acc + lin.bias.float()))
        hs.append(h)
    if dirs is None:
        out = dot(h, net.output_linear.weight) + net.output_linear.bias
        return out, (x, None, hs, None, None)
    d = rnd(dirs.to(f32))
    bott_ch = mc.bottleneck_ch
    bott = rnd(dot(h, net.bottleneck_linear.weight)
               + net.bottleneck_linear.bias)
    wv = net.view_linear.weight
    v = rnd(torch.relu(dot(bott, wv[:, :bott_ch]) + dot(d, wv[:, bott_ch:])
                       + net.view_linear.bias))
    rgb = dot(v, net.rgb_linear.weight) + net.rgb_linear.bias
    sigma = dot(h, net.sigma_linear.weight) + net.sigma_linear.bias
    return torch.cat([rgb, sigma], dim=-1), (x, d, hs, bott, v)


def fused_nerf_mlp_plain(net: NeRFMLP, pts: torch.Tensor,
                         dirs: Optional[torch.Tensor], n_freqs: int,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         hi_lo: bool = False) -> torch.Tensor:
    """What the forward kernel computes, in plain PyTorch: pts (N, 3) ->
    (N, 4).

    "bf16 operands, fp32 accumulation" is ``a.to(bf16).float() @
    w.to(bf16).float()`` — ``torch.matmul`` on bf16 tensors would round its
    OUTPUT to bf16, which the kernel does not. fp32 matmuls are true fp32
    where the caller keeps TF32 off (the package's entry points do, see
    :func:`nerfmlp_torch.use_true_fp32`). ``hi_lo``: three bf16 products
    per matmul, hi@hi + hi@lo + lo@hi, with fp32 activations
    (``pallas_mlp.py:68-100``)."""
    dt = torch.float32 if hi_lo else compute_dtype
    with torch.no_grad():
        return _plain_forward(net, pts, dirs, n_freqs, dt, hi_lo)[0]


def fused_nerf_mlp_bwd_plain(net: NeRFMLP, pts: torch.Tensor,
                             dirs: Optional[torch.Tensor], g: torch.Tensor,
                             n_freqs: int,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             hi_lo: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """What the backward kernel computes, in plain PyTorch: the gradient of
    ``sum(g * fused_nerf_mlp(pts, dirs))`` for every parameter of ``net``,
    by name, in the ``nn.Linear`` layout.

    The rounding points of ``_bwd_kernel``/``_trunk_bwd``
    (``pallas_mlp.py:383-441``): the cotangent cast to the compute type;
    ``dv`` masked, then rounded; ``dbott`` rounded; ``dh`` rounded after the
    sigma and bottleneck branches are summed; every ``dacc`` and ``dh`` down
    the trunk rounded; dW from rounded operands in fp32; db an fp32 sum of
    the rounded cotangents; the skip's d(enc) branch dropped. ``hi_lo``
    splits both operands of every product (``:347-365``), and sums for db
    each cotangent's (hi, lo) pair, the bf16 planes the kernels' workspace
    stores (the TPU kernel sums the fp32 values: within 2^-17 of each
    value)."""
    mc = net.cfg
    dt = torch.float32 if hi_lo else compute_dtype

    def rnd(t):
        return t.to(dt).float()

    def wgrad(a, gg):  # (out, in) = (a^T @ gg)^T
        if hi_lo:
            a_hi, a_lo = _split_bf16(a)
            g_hi, g_lo = _split_bf16(gg)
            return g_hi.t() @ a_hi + g_lo.t() @ a_hi + g_hi.t() @ a_lo
        return gg.t() @ a

    def colsum(t):  # db: in hi_lo the kernel sums each value's stored pair
        return sum(_split_bf16(t)).sum(0) if hi_lo else t.sum(0)

    def back(gg, w):  # gg @ W for an (out, in) weight: the dX product
        if hi_lo:
            g_hi, g_lo = _split_bf16(gg)
            w_hi, w_lo = _split_bf16(w.float())
            return g_hi @ w_hi + g_hi @ w_lo + g_lo @ w_hi
        return gg @ rnd(w.float())

    grads: Dict[str, torch.Tensor] = {}

    def put(name, dw, dbias):
        grads[f"{name}.weight"] = dw
        grads[f"{name}.bias"] = dbias

    with torch.no_grad():
        _, (x, d, hs, bott, v) = _plain_forward(net, pts, dirs, n_freqs, dt,
                                                hi_lo)
        g = g.float()
        h_last = hs[-1]
        if dirs is None:
            g_out = rnd(g)
            put("output_linear", wgrad(h_last, g_out), colsum(g_out))
            dh = rnd(back(g_out, net.output_linear.weight))
        else:
            g_rgb, g_sigma = rnd(g[:, 0:3]), rnd(g[:, 3:4])
            put("rgb_linear", wgrad(v, g_rgb), colsum(g_rgb))
            dv = back(g_rgb, net.rgb_linear.weight)
            dv = rnd(torch.where(v > 0, dv, torch.zeros_like(dv)))
            put("view_linear", torch.cat([wgrad(bott, dv), wgrad(d, dv)], 1),
                colsum(dv))
            dbott = rnd(back(dv, net.view_linear.weight[:, :mc.bottleneck_ch]))
            put("bottleneck_linear", wgrad(h_last, dbott), colsum(dbott))
            put("sigma_linear", wgrad(h_last, g_sigma), colsum(g_sigma))
            dh = rnd(back(dbott, net.bottleneck_linear.weight)
                     + back(g_sigma, net.sigma_linear.weight))
        enc = x.shape[-1]
        for i in range(mc.depth - 1, -1, -1):
            lin = net.pts_linears[i]
            dacc = rnd(torch.where(hs[i] > 0, dh, torch.zeros_like(dh)))
            a = x if i == 0 else hs[i - 1]
            if i in mc.skips:
                dw = torch.cat([wgrad(x, dacc), wgrad(a, dacc)], 1)
                w_h = lin.weight[:, enc:]   # the d(enc) branch is dropped
            else:
                dw = wgrad(a, dacc)
                w_h = lin.weight
            put(f"pts_linears.{i}", dw, colsum(dacc))
            if i > 0:
                dh = rnd(back(dacc, w_h))
    return grads


def reduce_partials_plain(part: torch.Tensor, total: int) -> torch.Tensor:
    """What the reduction kernel computes: the sum of the (G, stride)
    partial rows' first ``total`` columns, added in row order; of each
    scene's rows for (S, G, stride) partials -> (S, total)."""
    if part.dim() == 3:
        return torch.stack([reduce_partials_plain(p, total) for p in part])
    out = part[0, :total].clone()
    for b in range(1, part.shape[0]):
        out += part[b, :total]
    return out


def _residuals(net: NeRFMLP, pts, dirs, n_freqs: int, dt, hi_lo: bool):
    """The forward's output, the activations the backward stores by
    workspace matrix name (see :func:`_bwd_mats`), and the ReLU masks the
    dX chain reads (trunk layer i's, then the view layer's: act > 0 of the
    stored value)."""
    out, (x, d, hs, bott, v) = _plain_forward(net, pts, dirs, n_freqs, dt,
                                              hi_lo)
    acts = {"x": x, **{f"h{i}": h for i, h in enumerate(hs)}}
    if dirs is not None:
        acts.update(d=d, bott=bott, v=v)
    on = [h > 0 for h in hs] + ([v > 0] if dirs is not None else [])
    return out, acts, on


def _dx_terms(net: NeRFMLP, g, on, vdirs: bool, dt,
              hi_lo: bool) -> Dict[str, torch.Tensor]:
    """The rounded cotangents the backward stores, by workspace matrix
    name (see :func:`_bwd_mats`), at :func:`fused_nerf_mlp_bwd_plain`'s
    rounding points, from the cotangent ``g`` and the ReLU masks ``on``
    (:func:`_residuals`)."""
    mc = net.cfg

    def rnd(t):
        return t.to(dt).float()

    def back(gg, w):  # gg @ W for an (out, in) weight: the dX product
        if hi_lo:
            g_hi, g_lo = _split_bf16(gg)
            w_hi, w_lo = _split_bf16(w.float())
            return g_hi @ w_hi + g_hi @ w_lo + g_lo @ w_hi
        return gg @ rnd(w.float())

    terms = {}
    g = g.float()
    if not vdirs:
        terms["g_out"] = rnd(g)
        dh = rnd(back(terms["g_out"], net.output_linear.weight))
    else:
        g_rgb, g_sigma = rnd(g[:, 0:3]), rnd(g[:, 3:4])
        dv = back(g_rgb, net.rgb_linear.weight)
        dv = rnd(torch.where(on[mc.depth], dv, torch.zeros_like(dv)))
        dbott = rnd(back(dv, net.view_linear.weight[:, :mc.bottleneck_ch]))
        dh = rnd(back(dbott, net.bottleneck_linear.weight)
                 + back(g_sigma, net.sigma_linear.weight))
        terms.update(g_rgb=g_rgb, g_sigma=g_sigma, dv=dv, dbott=dbott)
    enc = mc.input_ch
    for i in range(mc.depth - 1, -1, -1):
        dacc = rnd(torch.where(on[i], dh, torch.zeros_like(dh)))
        terms[f"dacc{i}"] = dacc
        if i > 0:
            w = net.pts_linears[i].weight
            dh = rnd(back(dacc, w[:, enc:] if i in mc.skips else w))
    return terms


def _bwd_terms(net: NeRFMLP, pts, dirs, g, n_freqs: int, dt,
               hi_lo: bool) -> Dict[str, torch.Tensor]:
    """Every value the backward stores, by workspace matrix name (see
    :func:`_bwd_mats`): the forward's residuals and the rounded cotangents
    of :func:`fused_nerf_mlp_bwd_plain`, at its rounding points."""
    with torch.no_grad():
        _, acts, on = _residuals(net, pts, dirs, n_freqs, dt, hi_lo)
        return {**acts, **_dx_terms(net, g, on, dirs is not None, dt, hi_lo)}


def _scenes(t: Optional[torch.Tensor], n_scenes: int):
    """The S equal, scene-major slices of ``t`` (None: S Nones)."""
    if t is None:
        return [None] * n_scenes
    if t.shape[0] % n_scenes:
        raise ValueError(f"{t.shape[0]} rows do not split into {n_scenes} "
                         f"equal scenes")
    return list(t.chunk(n_scenes)) if n_scenes > 1 else [t]


def fused_nerf_mlp_stack_plain(nets, pts: torch.Tensor,
                               dirs: Optional[torch.Tensor], n_freqs: int,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               hi_lo: bool = False) -> torch.Tensor:
    """What the forward kernel computes over a scene axis: scene s's
    slice of the scene-major points through ``nets[s]``
    (:func:`fused_nerf_mlp_plain`), concatenated."""
    nets = nets.nets if isinstance(nets, NetStack) else tuple(nets)
    return torch.cat([
        fused_nerf_mlp_plain(net, p, d, n_freqs, compute_dtype, hi_lo)
        for net, p, d in zip(nets, _scenes(pts, len(nets)),
                             _scenes(dirs, len(nets)))])


def fused_nerf_mlp_bwd_stack_plain(nets, pts: torch.Tensor,
                                   dirs: Optional[torch.Tensor],
                                   g: torch.Tensor, n_freqs: int,
                                   compute_dtype: torch.dtype = torch.bfloat16,
                                   hi_lo: bool = False
                                   ) -> List[Dict[str, torch.Tensor]]:
    """What the backward kernels compute over a scene axis: each scene's
    gradients (:func:`fused_nerf_mlp_bwd_plain` on its slice), by scene."""
    nets = nets.nets if isinstance(nets, NetStack) else tuple(nets)
    s = len(nets)
    return [fused_nerf_mlp_bwd_plain(net, p, d, gg, n_freqs, compute_dtype,
                                     hi_lo)
            for net, p, d, gg in zip(nets, _scenes(pts, s), _scenes(dirs, s),
                                     _scenes(g, s))]


def ws_matrix(packed: PackedMLP, ws: torch.Tensor, m: int) -> torch.Tensor:
    """Workspace matrix ``m`` of a flat workspace, read out of its strip
    layout (:func:`ws_index`): (planes, rows, cols), a copy."""
    rows = ws.numel() // packed.ws_cols
    _, off, cols = packed.ws_mats[m]
    planes = 2 if packed.hi_lo else 1
    return torch.stack([
        block_from_image(ws[rows * (off + p * cols):
                            rows * (off + (p + 1) * cols)], rows, cols)
        for p in range(planes)])


def ws_store(packed: PackedMLP, ws: torch.Tensor, m: int,
             mat: torch.Tensor) -> None:
    """Write workspace matrix ``m`` (planes, rows, cols) into a flat
    workspace of that many rows, in its strip layout (:func:`ws_index`)."""
    rows = ws.numel() // packed.ws_cols
    _, off, cols = packed.ws_mats[m]
    for p, t in enumerate(mat):
        ws[rows * (off + p * cols): rows * (off + (p + 1) * cols)] = \
            strip_image(t)


def bwd_workspace_plain(packed: PackedMLP, pts: torch.Tensor,
                        dirs: Optional[torch.Tensor], g: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """What phase 1 computes, from the function's definition: the flat
    workspace of ``rows`` rows holding every stored activation and rounded
    cotangent of the n points (bf16; in hi_lo mode the (hi, lo) planes of
    the fp32 value), rows n and on zero, each matrix in its strip layout.
    For a stack, scene s's n / S points fill rows ``s * rows_s`` on,
    ``rows_s`` = n / S rounded up to phase 1's tile."""
    dt = torch.float32 if packed.hi_lo else torch.bfloat16
    n_freqs = int(packed.bwd_program[_BWD_HEADER.index("n_freqs")])
    ws = torch.zeros(rows * packed.ws_cols, device=pts.device,
                     dtype=torch.bfloat16)
    s = packed.n_scenes
    scenes = [_bwd_terms(net, p, d, gg, n_freqs, dt, packed.hi_lo)
              for net, p, d, gg in zip(packed.stack or (packed.net,),
                                       _scenes(pts, s), _scenes(dirs, s),
                                       _scenes(g, s))]
    _store_terms(packed, ws, scenes, ws_rows(pts.shape[0] // s,
                                             packed.bwd_rows))
    return ws


def mask_lanes(rows: int, cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the ReLU bits of a mask block lie in its pass of ``cols``
    columns at tiles of ``rows`` points (mlp_tile.cuh's accumulator
    fragments): (feature, point) of bit i of entry e, each (cols / 16 * 32,
    rows / 2). Entry 32 v + l is lane l's of the warp tile of features 16
    v..; its element i = 4 j + 2 h + e' is feature 16 v + l / 4 + 8 h,
    point 8 j + 2 (l % 4) + e'."""
    e = torch.arange(cols // 16 * 32)[:, None]
    i = torch.arange(rows // 2)[None, :]
    lane = e % 32
    return (16 * (e // 32) + lane // 4 + 8 * ((i >> 1) & 1),
            8 * (i >> 2) + 2 * (lane % 4) + (i & 1))


def mask_encode(on: torch.Tensor) -> torch.Tensor:
    """A pass's ReLU bits (tiles, rows, cols) bool -> each tile's mask
    block, (tiles, entries x :func:`mask_entry_bytes`) uint8: an entry's
    bits little-endian, bit i for element i."""
    tiles, rows, cols = on.shape
    feat, pt = mask_lanes(rows, cols)
    width = 8 * mask_entry_bytes(rows)
    bits = torch.nn.functional.pad(on[:, pt, feat].to(torch.int32),
                                   (0, width - rows // 2))
    weights = 1 << torch.arange(8, dtype=torch.int32)
    return ((bits.view(tiles, -1, width // 8, 8) * weights).sum(-1)
            .to(torch.uint8).view(tiles, -1))


def mask_decode(blocks: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """:func:`mask_encode`'s inverse: (tiles, entry bytes) uint8 -> (tiles,
    rows, cols) bool."""
    tiles = blocks.shape[0]
    feat, pt = mask_lanes(rows, cols)
    bits = ((blocks.to(torch.int32)[..., None]
             >> torch.arange(8, dtype=torch.int32)) & 1).view(
        tiles, feat.shape[0], -1)[..., :rows // 2].bool()
    on = torch.zeros((tiles, rows, cols), dtype=torch.bool)
    on[:, pt, feat] = bits
    return on


def _relu_widths(packed: PackedMLP) -> List[int]:
    """The ReLU layers' widths, in mask slot order: each trunk layer's,
    then the view layer's."""
    mc = packed.net.cfg
    return [mc.width] * mc.depth + ([mc.view_width] if packed.vdirs else [])


def _mask_passes(packed: PackedMLP):
    """The handover's mask blocks: (ReLU slot, byte offset in a tile's
    image, first column, columns) of each pass."""
    lay = _handover_layout(packed.net.cfg, packed.vdirs, packed.hi_lo)
    widths = _relu_widths(packed)
    return [(slot, off, b * BWD_MAX_N,
             min(BWD_MAX_N, _pad16(widths[slot]) - b * BWD_MAX_N))
            for slot, blocks in enumerate(lay.masks)
            for b, off in enumerate(blocks)]


def _mask_images(packed: PackedMLP, masks: torch.Tensor, rows_s: int):
    """The handover's mask images of a call whose scenes take ``rows_s``
    workspace rows each: (scenes x tiles, mask_bytes), a view of
    ``masks``."""
    ho = packed.handover
    tiles = packed.n_scenes * rows_s // ho.rows
    return masks[:tiles * ho.mask_bytes].view(tiles, ho.mask_bytes)


def _store_terms(packed: PackedMLP, ws: torch.Tensor, scenes, rows_s: int):
    """Each scene's values by workspace matrix name (``scenes``: one dict
    of (n, cols) fp32 values a scene) into the flat workspace ``ws``:
    scene i's at rows ``i * rows_s`` on, bf16 (the (hi, lo) planes in
    hi_lo mode), every other row of those matrices zero; the other
    matrices are left as they were."""
    planes = 2 if packed.hi_lo else 1
    cap = ws.numel() // packed.ws_cols
    for m, (name, _, cols) in enumerate(packed.ws_mats):
        if name not in scenes[0]:
            continue
        mat = torch.zeros((planes, cap, cols), device=ws.device,
                          dtype=torch.bfloat16)
        for i, terms in enumerate(scenes):
            t = terms[name]
            r0, n = i * rows_s, t.shape[0]
            hi = t.to(torch.bfloat16)
            mat[0, r0:r0 + n, :t.shape[1]] = hi
            if planes == 2:
                mat[1, r0:r0 + n, :t.shape[1]] = (
                    t - hi.float()).to(torch.bfloat16)
        ws_store(packed, ws, m, mat)


def forward_residuals_plain(packed: PackedMLP, pts: torch.Tensor,
                            dirs: Optional[torch.Tensor], ws: torch.Tensor,
                            masks: torch.Tensor) -> torch.Tensor:
    """What the forward kernel computes with its residuals, from the
    function's definition: the output (:func:`fused_nerf_mlp_plain`), and
    into the flat workspace ``ws`` every activation matrix of
    :func:`bwd_workspace_plain` (rows past n zero), and into ``masks`` each
    tile's mask image (:class:`Handover`: the blocks of
    :func:`_handover_layout`, :func:`mask_encode`'s bits of the stored
    activation > 0; points past n off). The cotangent matrices are left
    as they were. A stack's scene s from tile (and row) s * tiles_s on."""
    ho = packed.handover
    dt = torch.float32 if packed.hi_lo else torch.bfloat16
    n_freqs = int(packed.bwd_program[_BWD_HEADER.index("n_freqs")])
    s = packed.n_scenes
    rows_s = ws_rows(pts.shape[0] // s, ho.rows)
    tiles_s = rows_s // ho.rows
    image = _mask_images(packed, masks, rows_s)
    image.zero_()
    outs, scenes = [], []
    with torch.no_grad():
        for i, (net, p, d) in enumerate(zip(packed.stack or (packed.net,),
                                            _scenes(pts, s),
                                            _scenes(dirs, s))):
            out, acts, on = _residuals(net, p, d, n_freqs, dt, packed.hi_lo)
            outs.append(out)
            scenes.append(acts)
            for slot, off, c0, nn in _mask_passes(packed):
                part = torch.zeros((rows_s, nn), dtype=torch.bool)
                part[:p.shape[0], :on[slot].shape[1] - c0] = \
                    on[slot][:, c0:c0 + nn]
                blk = mask_encode(part.view(tiles_s, ho.rows, nn))
                image[i * tiles_s:(i + 1) * tiles_s,
                      off:off + blk.shape[1]] = blk
    _store_terms(packed, ws, scenes, rows_s)
    return torch.cat(outs)


def bwd_handover_plain(packed: PackedMLP, g: torch.Tensor, ws: torch.Tensor,
                       masks: torch.Tensor) -> torch.Tensor:
    """What phase 1 computes without the recomputed forward: the rounded
    cotangents of :func:`bwd_workspace_plain` into the flat workspace
    ``ws`` (rows past n zero), its dX chain masked by the bits of the mask
    images ``masks`` (:func:`mask_decode`) alone; the activation matrices
    are left as the forward wrote them. Returns ``ws``."""
    ho = packed.handover
    dt = torch.float32 if packed.hi_lo else torch.bfloat16
    s = packed.n_scenes
    n = g.shape[0] // s
    rows_s = ws_rows(n, ho.rows)
    tiles_s = rows_s // ho.rows
    image = _mask_images(packed, masks, rows_s)
    widths = _relu_widths(packed)
    scenes = []
    with torch.no_grad():
        for i, (net, gg) in enumerate(zip(packed.stack or (packed.net,),
                                          _scenes(g, s))):
            on = [torch.zeros((rows_s, _pad16(w)), dtype=torch.bool)
                  for w in widths]
            for slot, off, c0, nn in _mask_passes(packed):
                blk = image[i * tiles_s:(i + 1) * tiles_s,
                            off:off + nn * 2 * mask_entry_bytes(ho.rows)]
                on[slot][:, c0:c0 + nn] = mask_decode(
                    blk, ho.rows, nn).view(rows_s, nn)
            scenes.append(_dx_terms(
                net, gg, [m[:n, :w] for m, w in zip(on, widths)],
                packed.vdirs, dt, packed.hi_lo))
    _store_terms(packed, ws, scenes, rows_s)
    return ws


def bwd_splits(rows: int, units) -> Tuple[int, int]:
    """(splits, rows per split) of phase 2 over ``rows`` points (a multiple
    of ``BWD_STAGE_ROWS``) for the work units ``units`` (their records):
    among the splits that give ``BWD_FILL_ITEMS`` items (units x splits) or
    more and ranges of at most ``BWD_MAX_SPLIT_ROWS`` points, up to twice
    as many (and at most ``BWD_MAX_SPLITS`` ranges of at least
    ``BWD_MIN_SPLIT_ROWS`` points), the one whose busiest CTA, in the
    kernel's round-robin walk of the items over ``P2_SMS`` CTAs, moves the
    fewest bytes (an item: its rows, plus ``P2_ITEM_ROWS``, times its A and
    Y columns); each split a whole number of 64-row groups. Asked once per
    (rows, units' columns): the walk is host time of every backward
    call."""
    u = np.asarray(units)
    return _bwd_splits(rows, tuple((u[:, 2] + u[:, 5]).tolist()),
                       (BWD_MAX_SPLITS, BWD_MIN_SPLIT_ROWS,
                        BWD_MAX_SPLIT_ROWS, BWD_FILL_ITEMS, P2_SMS,
                        P2_ITEM_ROWS))


@functools.lru_cache(maxsize=4096)
def _bwd_splits(rows: int, cols: Tuple[int, ...],
                rule: Tuple[int, ...]) -> Tuple[int, int]:
    max_splits, min_rows, max_rows, fill, sms, item_rows = rule
    top = max(1, min(max_splits, rows // min_rows))
    low = min(top, max(-(-fill // len(cols)), -(-rows // max_rows)))
    best = None
    for want in range(low, min(top, 2 * low) + 1):
        per = -(-rows // (want * BWD_STAGE_ROWS)) * BWD_STAGE_ROWS
        splits = -(-rows // per)
        items = len(cols) * splits
        ctas = min(items, sms)
        load = [0] * ctas
        for i in range(items):
            s = i // len(cols)
            r = per if s < splits - 1 else rows - s * per
            load[i % ctas] += (r + item_rows) * cols[i % len(cols)]
        if best is None or max(load) < best[0]:
            best = (max(load), splits, per)
    return best[1], best[2]


def part_stride(total: int) -> int:
    """Floats per partial slot: the gradient, rounded up to 64."""
    return -(-total // 64) * 64


def _p2_blocks(packed: PackedMLP):
    """Phase 2's weight blocks, from its units: [(A matrix, Y matrix,
    gradient offset, row stride, bias gradient offset or -1)]."""
    blocks: Dict[int, list] = {}
    for am, _, _, ym, _, _, off, ld, db, *_ in packed.bwd_units.tolist():
        b = blocks.setdefault(off, [am, ym, off, ld, -1])
        b[4] = max(b[4], db)
    return list(blocks.values())


def weight_grads_plain(packed: PackedMLP, ws: torch.Tensor, rows: int,
                       split_rows: int) -> torch.Tensor:
    """What phase 2 computes: for each split of the workspace's first
    ``rows`` rows into ranges of ``split_rows``, one (splits, stride) fp32
    partial slot with every weight block's dW (A^T dY over the range; in
    hi_lo mode hi*hi + lo*hi + hi*lo) and every bias's db (dY's column
    sums, of each (hi, lo) pair in hi_lo): per scene and weight block one
    batched product over the splits. For a stack, ``rows`` per scene from
    ``s * rows`` on, into (S, splits, stride)."""
    splits = -(-rows // split_rows)
    n_sc = packed.n_scenes
    part = torch.zeros((n_sc, splits, part_stride(packed.grad_total)),
                       device=ws.device)
    mats: Dict[int, torch.Tensor] = {}

    def cut(m, sc):
        """Scene sc's rows of matrix m, fp32, (planes, splits, split_rows,
        cols): the last split's rows past ``rows`` zero."""
        if m not in mats:
            mats[m] = ws_matrix(packed, ws, m)
        t = mats[m][:, sc * rows:(sc + 1) * rows].float()
        t = torch.nn.functional.pad(t, (0, 0, 0, splits * split_rows - rows))
        return t.reshape(t.shape[0], splits, split_rows, t.shape[-1])

    for sc in range(n_sc):
        for am, ym, off, ld, db in _p2_blocks(packed):
            a, y = cut(am, sc), cut(ym, sc)
            prod = a[0].transpose(1, 2) @ y[0]
            if packed.hi_lo:
                prod = (prod + a[1].transpose(1, 2) @ y[0]
                        + a[0].transpose(1, 2) @ y[1])
            part[sc, :, off:off + prod.shape[1] * ld] = prod.reshape(
                splits, -1)
            if db >= 0:
                part[sc, :, db:db + ld] = y.sum(0).sum(1)
    return part if packed.stack else part[0]


# --------------------------------------------------------------------- #
# The kernels and their wrappers
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _kernel(csrc: str = _build.CSRC):
    """The forward's library built from the sources in ``csrc``, with its
    C signature declared and its fixed shape checked against this
    module's."""
    lib = _build.load("fused_mlp_fwd", csrc)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_fwd.argtypes = ([vp] * 5 + [i32, i32, ctypes.c_longlong, i32,
                                   vp] + [i32] * 4 + [vp])
    lib.fused_mlp_fwd.restype = i32
    lib.fused_mlp_fwd_res.argtypes = (lib.fused_mlp_fwd.argtypes[:-1]
                                      + [vp, vp, ctypes.c_longlong, vp, i32,
                                         vp])
    lib.fused_mlp_fwd_res.restype = i32
    lib.fused_mlp_fwd_error_string.argtypes = [i32]
    lib.fused_mlp_fwd_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_fwd_constants.argtypes = [ctypes.POINTER(i32), i32]
    want = [FWD_THREADS, FWD_MAX_N, FWD_HEADER_INTS, FWD_MAX_BUFS,
            FWD_OP_INTS]
    consts = (i32 * len(want))()
    lib.fused_mlp_fwd_constants(consts, len(want))
    if list(consts) != want:
        raise RuntimeError(f"fused_mlp_fwd.cu constants {list(consts)} "
                           f"differ from the wrapper's {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_kernel(csrc: str = _build.CSRC):
    """The backward's library (both phases + reduction) built from the
    sources in ``csrc``, declared and checked."""
    lib = _build.load("fused_mlp_bwd", csrc)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_mlp_bwd_phase1.argtypes = ([vp] * 6 + [i32] * 5 + [i64]
                                         + [i32] * 2 + [vp, i64, vp, i32,
                                                        vp])
    lib.fused_mlp_bwd_phase1.restype = i32
    lib.fused_mlp_bwd_phase2.argtypes = [vp, i64, vp, vp] + [i32] * 6 + [
        vp, i64, i64, i32, vp]
    lib.fused_mlp_bwd_phase2.restype = i32
    lib.fused_mlp_bwd_reduce.argtypes = [vp, i32, i64, vp, i64, i32, vp]
    lib.fused_mlp_bwd_reduce.restype = i32
    lib.fused_mlp_bwd_error_string.argtypes = [i32]
    lib.fused_mlp_bwd_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_bwd_constants.argtypes = [ctypes.POINTER(i32), i32]
    want = [BWD_P2_THREADS, BWD_MAX_N, BWD_HEADER_INTS, BWD_MAX_BUFS,
            BWD_OP_INTS, BWD_UNIT_K, BWD_UNIT_N, BWD_STAGE_ROWS,
            BWD_UNIT_INTS, BWD_P1_THREADS, MAX_STAGES,
            *TILE_ROWS, *TILE_ROWS_HI_LO]
    consts = (i32 * len(want))()
    lib.fused_mlp_bwd_constants(consts, len(want))
    if list(consts) != want:
        raise RuntimeError(f"fused_mlp_bwd.cu constants {list(consts)} "
                           f"differ from the wrapper's {want}")
    return lib


def _bwd_error(lib, what: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.fused_mlp_bwd_error_string(rc).decode())


def _check_operands(packed: PackedMLP, pts, dirs):
    """Device, type, shape and alignment of the kernels' operands; returns
    (pts, dirs) contiguous, dirs in the kernel's type. A stack's points
    split into ``packed.n_scenes`` equal scenes."""
    n = pts.shape[0] if pts.dim() == 2 else -1
    dev = pts.device
    if packed.weights.device != dev:
        raise ValueError(f"packed weights on {packed.weights.device}, "
                         f"points on {dev}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (N, 3) float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    if n % packed.n_scenes:
        raise ValueError(f"{n} points do not split into {packed.n_scenes} "
                         f"equal scenes")
    pts = pts.contiguous()
    if packed.vdirs:
        views = fwd_header(packed)["dirs_dim"]
        if dirs is None or dirs.shape != (n, views) or dirs.device != dev:
            raise ValueError(f"dirs must be ({n}, {views}) on {dev}")
        dirs = dirs.to(torch.float32 if packed.hi_lo
                       else torch.bfloat16).contiguous()
    else:
        dirs = None
    for t in (pts, dirs, packed.weights, packed.biases):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    return pts, dirs


def _launch(packed: PackedMLP, pts: torch.Tensor,
            dirs: Optional[torch.Tensor], res=None) -> torch.Tensor:
    """The forward kernel; with ``res`` = (workspace, mask images), checked
    by the caller, the training forward that also writes its residuals
    there (:func:`forward_residuals`)."""
    pts, dirs = _check_operands(packed, pts, dirs)
    n = pts.shape[0]
    dev = pts.device
    out = torch.empty((n, packed.out_w), device=dev, dtype=torch.float32)
    if n == 0:
        return out
    lib = _kernel()
    hdr = fwd_header(packed)
    scenes = packed.n_scenes
    n_s = n // scenes
    args = (pts.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            out.data_ptr(), n_s, scenes, packed.w_stride, packed.b_stride,
            packed.program_dev.data_ptr(),
            hdr["prog_len"], hdr["hi_lo"], hdr["rows"], hdr["smem"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if res is None:
            rc = lib.fused_mlp_fwd(*args, stream)
        else:
            ws, masks = res
            rc = lib.fused_mlp_fwd_res(
                *args, packed.handover.res_dev.data_ptr(), ws.data_ptr(),
                ws.numel() // packed.ws_cols, masks.data_ptr(),
                packed.handover.mask_bytes, stream)
    if rc != 0:
        raise RuntimeError("fused_mlp_fwd launch failed: "
                           + lib.fused_mlp_fwd_error_string(rc).decode())
    fused_nerf_mlp.launches += 1
    fused_nerf_mlp.residual_launches += res is not None
    check_nan([("the output of the fused_mlp_fwd kernel", out)])
    return out


def _check_handover(packed: PackedMLP, n: int, ws: torch.Tensor,
                    masks: torch.Tensor, dev) -> int:
    """The workspace's rows per matrix, after checking that the net hands
    over and that ``ws`` and ``masks`` hold a call of n points: the
    workspace rows of the handover's tile, and a mask image a tile."""
    ho = packed.handover
    if ho is None:
        mc = packed.net.cfg
        raise ValueError(f"{_arch_name(mc, packed.vdirs, packed.hi_lo)} "
                         f"recomputes its forward in phase 1: "
                         f"{handover_misfit(mc, packed.vdirs, packed.hi_lo)}")
    rows = packed.n_scenes * ws_rows(n // packed.n_scenes, ho.rows)
    cap = _check_ws(packed, ws, rows, dev)
    need = rows // ho.rows * ho.mask_bytes
    if (masks.dtype != torch.uint8 or masks.dim() != 1
            or not masks.is_contiguous() or masks.device != dev
            or masks.numel() < need or masks.data_ptr() % 16):
        raise ValueError(f"the mask images must be a contiguous uint8 vector "
                         f"of >= {need} bytes on {dev}, 16-byte aligned")
    return cap


def residual_buffers(packed: PackedMLP, n: int, dev) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """(workspace, mask images) that a training forward of n points hands
    to the backward (:func:`forward_residuals`): the backward's whole
    workspace, the rows of the handover's tile, and one mask image a tile.
    On a card, the bytes are checked against the card first
    (:func:`check_bwd_memory`)."""
    ho = packed.handover
    scenes = packed.n_scenes
    rows = ws_rows(n // scenes, ho.rows)
    _check_card(packed, n // scenes, dev)
    return (torch.empty(scenes * rows * packed.ws_cols, device=dev,
                        dtype=torch.bfloat16),
            torch.empty(scenes * rows // ho.rows * ho.mask_bytes,
                        device=dev, dtype=torch.uint8))


def forward_residuals(packed: PackedMLP, pts: torch.Tensor,
                      dirs: Optional[torch.Tensor], ws: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """The training forward: the forward's output, and its residuals for
    the backward (:class:`Handover`): the activation matrices of the
    workspace ``ws`` and each tile's ReLU masks into ``masks``
    (:func:`residual_buffers`), which :func:`bwd_workspace` then reads in
    place of recomputing the forward. The forward kernel for CUDA tensors
    (or raise), :func:`forward_residuals_plain` for CPU ones.
    ``fused_nerf_mlp.residual_launches`` counts these kernel launches
    (``fused_nerf_mlp.launches`` counts them too)."""
    _check_handover(packed, pts.shape[0], ws, masks, pts.device)
    if pts.device.type == "cpu":
        out = forward_residuals_plain(packed, pts, dirs, ws, masks)
        check_nan([("the output of the fused MLP's plain forward", out)])
        return out
    return _launch(packed, pts, dirs, (ws, masks))


def reduce_partials(part: torch.Tensor, total: int) -> torch.Tensor:
    """Sum the rows of a (slots, stride) fp32 partial-gradient array in row
    order -> (total,), or each scene's rows of (S, slots, stride) -> (S,
    total), in one launch: the reduction kernel for a CUDA tensor (or
    raise), :func:`reduce_partials_plain` for a CPU one. Bit-identical run
    to run and to the plain sum. ``reduce_partials.launches`` counts kernel
    launches."""
    if part.device.type == "cpu":
        return reduce_partials_plain(part, total)
    scenes = part.shape[0] if part.dim() == 3 else 1
    if (part.dtype != torch.float32 or part.dim() not in (2, 3)
            or not part.is_contiguous() or part.shape[-1] < total
            or part.shape[-1] % 4 or part.data_ptr() % 16
            or (scenes > 1 and total % 4)):
        raise ValueError(f"partials must be a contiguous ([scenes,] slots, "
                         f">= {total}) float32 array, rows a multiple of 4, "
                         f"got {tuple(part.shape)} {part.dtype}")
    lib = _bwd_kernel()
    out = torch.empty((scenes, total) if part.dim() == 3 else total,
                      device=part.device, dtype=torch.float32)
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_reduce launch",
                   lib.fused_mlp_bwd_reduce(part.data_ptr(), part.shape[-2],
                                            part.shape[-1], out.data_ptr(),
                                            total, scenes, stream))
    reduce_partials.launches += 1
    check_nan([("the gradient of the fused_mlp_bwd_reduce kernel", out)])
    return out


def _check_ws(packed: PackedMLP, ws: torch.Tensor, rows: int, dev) -> int:
    """The workspace's rows per matrix, after checking it holds ``rows``
    (its rows a multiple of ``BWD_STAGE_ROWS``: the strips' row groups and
    phase 2's stages)."""
    cap = ws.numel() // packed.ws_cols
    if (ws.dtype != torch.bfloat16 or ws.dim() != 1 or not ws.is_contiguous()
            or ws.device != dev or cap < rows or cap % BWD_STAGE_ROWS
            or ws.numel() != cap * packed.ws_cols or ws.data_ptr() % 16):
        raise ValueError(f"the workspace must be a contiguous bf16 vector of "
                         f">= {rows} x {packed.ws_cols} on {dev}, its rows a "
                         f"multiple of {BWD_STAGE_ROWS}")
    return cap


def bwd_workspace(packed: PackedMLP, pts: torch.Tensor,
                  dirs: Optional[torch.Tensor], g: torch.Tensor,
                  ws: torch.Tensor,
                  masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 1 for n points: recompute the forward, walk the dX chain and
    fill the flat workspace ``ws`` (at least :func:`ws_rows` of n rows per
    matrix; for a stack, S times those of n / S, scene s's rows after
    scene s - 1's). With ``masks``, the handover: the forward wrote its
    activations into ``ws`` and its ReLU masks into ``masks``
    (:func:`forward_residuals`), and phase 1 runs only the dX chain. The
    kernel for CUDA tensors (or raise), :func:`bwd_workspace_plain` (or
    :func:`bwd_handover_plain`) for CPU ones. ``bwd_workspace.launches``
    counts kernel launches, ``bwd_workspace.handover_launches`` those
    without the recomputed forward."""
    pts, dirs = _check_operands(packed, pts, dirs)
    n, dev = pts.shape[0], pts.device
    if g.shape != (n, packed.out_w) or g.device != dev:
        raise ValueError(f"the cotangent must be ({n}, {packed.out_w}) on "
                         f"{dev}, got {tuple(g.shape)} on {g.device}")
    g = g.to(torch.float32).contiguous()
    ho = packed.handover if masks is not None else None
    tile = packed.bwd_rows
    scenes = packed.n_scenes
    n_s = n // scenes
    rows = ws_rows(n_s, tile)
    if masks is None:
        cap = _check_ws(packed, ws, scenes * rows, dev)
    else:
        cap = _check_handover(packed, n, ws, masks, dev)
        tile = ho.rows
    if dev.type == "cpu":
        if ho is not None:
            return bwd_handover_plain(packed, g, ws, masks)
        return ws.copy_(bwd_workspace_plain(packed, pts, dirs, g, cap))
    if n == 0:
        return ws
    lib = _bwd_kernel()
    prog, prog_len, smem = ((ho.program_dev, ho.prog_len, ho.smem)
                            if ho is not None else
                            (packed.bwd_program_dev, packed.bwd_prog_len,
                             packed.bwd_smem))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_phase1 launch", lib.fused_mlp_bwd_phase1(
            pts.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            g.data_ptr(), packed.weights.data_ptr(),
            packed.biases.data_ptr(), prog.data_ptr(), prog_len,
            int(packed.hi_lo), tile, n_s, scenes,
            packed.w_stride, packed.b_stride, smem, ws.data_ptr(),
            cap, masks.data_ptr() if ho is not None else None,
            ho.mask_bytes if ho is not None else 0, stream))
    bwd_workspace.launches += 1
    bwd_workspace.handover_launches += ho is not None
    if numerics_checked():
        check_nan([(f"the workspace of the fused_mlp_bwd_phase1 kernel "
                    f"({name})", ws_matrix(packed, ws, m)[
                        :, s * rows:s * rows + n_s])
                   for m, (name, _, _) in enumerate(packed.ws_mats)
                   for s in range(scenes)])
    return ws


def weight_grads(packed: PackedMLP, ws: torch.Tensor, rows: int,
                 split_rows: int, part: torch.Tensor) -> torch.Tensor:
    """Phase 2: every weight and bias gradient of the workspace's first
    ``rows`` rows (a multiple of ``BWD_STAGE_ROWS``), one fp32 partial slot
    per range of ``split_rows`` rows, into ``part`` (splits, stride). For a
    stack, ``rows`` per scene (scene s's from ``s * rows``) into ``part``
    (S, splits, stride), each scene's slots contiguous (a slice of more
    slots is allowed). The kernel for CUDA tensors (or raise),
    :func:`weight_grads_plain` for CPU ones. ``weight_grads.launches``
    counts kernel launches."""
    splits = -(-rows // split_rows)
    stride = part_stride(packed.grad_total)
    scenes = packed.n_scenes
    shape = (scenes, splits, stride) if packed.stack else (splits, stride)
    if (part.shape != shape or part.dtype != torch.float32
            or part.stride()[-2:] != (stride, 1) or part.device != ws.device
            or rows % BWD_STAGE_ROWS or split_rows % BWD_STAGE_ROWS):
        raise ValueError(f"partials must be a {shape} float32 array beside "
                         f"the workspace, each scene's slots contiguous; rows "
                         f"and split_rows multiples of {BWD_STAGE_ROWS}")
    cap = _check_ws(packed, ws, scenes * rows, ws.device)
    if ws.device.type == "cpu":
        return part.copy_(weight_grads_plain(packed, ws, rows, split_rows))
    lib = _bwd_kernel()
    prog = packed.bwd_program_dev
    hdr = bwd_header(packed)
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_phase2 launch", lib.fused_mlp_bwd_phase2(
            ws.data_ptr(), cap, prog.data_ptr(),
            prog.data_ptr() + 4 * hdr["units_off"], hdr["n_units"],
            int(packed.hi_lo), rows, splits, split_rows, scenes,
            part.data_ptr(), stride, part.stride(0) if packed.stack else 0,
            hdr["p2_smem"], stream))
    weight_grads.launches += 1
    check_nan([("the partial gradients of the fused_mlp_bwd_phase2 kernel",
                part[..., :packed.grad_total])])
    return part


def _bwd_chunks(packed: PackedMLP, n_s: int):
    """A backward call over n_s points a scene, cut into chunks: [(first
    point, points, (phase-2 splits, rows a split))] of at most
    :func:`bwd_chunk_rows` points each."""
    step = bwd_chunk_rows(packed.net.cfg, packed.vdirs, packed.hi_lo)
    return [(c0, r, bwd_splits(ws_rows(r, packed.bwd_rows),
                               packed.bwd_units))
            for c0 in range(0, n_s, step) for r in [min(step, n_s - c0)]]


def bwd_call_bytes(packed: PackedMLP, n_s: int) -> int:
    """Device bytes a backward call over n_s points a scene allocates: the
    workspace of one chunk of every scene, and every chunk's partial
    slots."""
    chunks = _bwd_chunks(packed, n_s)
    rows = max((ws_rows(r, packed.bwd_rows) for _, r, _ in chunks), default=0)
    slots = sum(splits for _, _, (splits, _) in chunks)
    return packed.n_scenes * (rows * packed.ws_cols * 2
                              + slots * part_stride(packed.grad_total) * 4)


def check_bwd_memory(packed: PackedMLP, n_s: int, card_bytes: int) -> int:
    """:func:`bwd_call_bytes`, after checking that they fit
    ``BWD_MEMORY_SHARE`` of a card of ``card_bytes``; else a ValueError
    naming the net, the bytes and the most scenes of n_s points that
    fit."""
    need = bwd_call_bytes(packed, n_s)
    limit = int(card_bytes * BWD_MEMORY_SHARE)
    if need > limit:
        mc = packed.net.cfg
        raise ValueError(
            f"{_arch_name(mc, packed.vdirs, packed.hi_lo)}: a backward call "
            f"over {packed.n_scenes} scene(s) of {n_s} points needs {need} B "
            f"of workspace and partial gradients ("
            f"{bwd_scratch_bytes(mc, packed.vdirs, packed.hi_lo)} B a point "
            f"in chunks of {bwd_chunk_rows(mc, packed.vdirs, packed.hi_lo)} "
            f"points a scene), more than the {limit} B a call may take "
            f"({BWD_MEMORY_SHARE:.0%} of the card's {card_bytes} B): at most "
            f"{limit // (need // packed.n_scenes)} scene(s) of {n_s} points "
            f"fit")
    return need


@functools.lru_cache(maxsize=None)
def _card_bytes(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).total_memory


@functools.lru_cache(maxsize=256)
def _state_bwd_bytes(name: str, scenes: int, n_s: int, need: int,
                     card: int) -> None:
    """Say, once per net, scenes and points, what a backward call takes."""
    log.info("fused MLP backward: %s, %d scene(s) of %d points: %d B of "
             "workspace and partial gradients (card %d B)", name, scenes,
             n_s, need, card)


def _check_card(packed: PackedMLP, n_s: int, dev) -> None:
    """On a card, a backward call's bytes over n_s points a scene against
    the card (:func:`check_bwd_memory`), said once."""
    if dev.type != "cuda":
        return
    card = _card_bytes(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    _state_bwd_bytes(_arch_name(packed.net.cfg, packed.vdirs, packed.hi_lo),
                     packed.n_scenes, n_s,
                     check_bwd_memory(packed, n_s, card), card)


def _launch_bwd(packed: PackedMLP, pts: torch.Tensor,
                dirs: Optional[torch.Tensor], g: torch.Tensor,
                res=None) -> torch.Tensor:
    """The backward: the flat fp32 gradient (``packed.grad_total``) in the
    packed blocks' layout; (S, grad_total) for a stack. The call is walked
    in chunks of at most :func:`bwd_chunk_rows` points (of each scene),
    each phase 1 into one workspace, then phase 2 into the chunk's partial
    slots; the reduction sums every slot in (chunk, split) order. A stack's
    chunk is one launch of each phase over all scenes, so it launches each
    kernel as often as one of its scenes alone. ``res``: the (workspace,
    mask images) the call's forward wrote its residuals into
    (:func:`forward_residuals`), for a call of one chunk; phase 1 then
    takes them (:func:`bwd_workspace`) instead of recomputing the forward.
    On a card, the bytes are checked against the card first
    (:func:`check_bwd_memory`)."""
    n, dev = pts.shape[0], pts.device
    if g.shape != (n, packed.out_w):
        raise ValueError(f"the cotangent must be ({n}, {packed.out_w}), got "
                         f"{tuple(g.shape)}")
    total = packed.grad_total
    tile = packed.bwd_rows
    scenes = packed.n_scenes
    n_s = n // scenes
    _check_card(packed, n_s, dev)
    chunks = _bwd_chunks(packed, n_s)
    if res is not None and len(chunks) != 1:
        raise ValueError(f"the forward's residuals hold a call of one chunk; "
                         f"this one has {len(chunks)}")
    ws = res[0] if res is not None else torch.empty(
        scenes * max((ws_rows(r, tile) for _, r, _ in chunks), default=0)
        * packed.ws_cols, device=dev, dtype=torch.bfloat16)
    slots = sum(splits for _, _, (splits, _) in chunks)
    part = torch.empty((scenes, slots, part_stride(total)), device=dev,
                       dtype=torch.float32)

    def piece(t, c0, r):
        """The chunk's rows of every scene, scene-major."""
        if t is None or len(chunks) == 1:
            return t
        rows = t.reshape(scenes, n_s, -1)[:, c0:c0 + r]
        return rows.reshape(scenes * r, -1)

    slot = 0
    for c0, r, (splits, split_rows) in chunks:
        bwd_workspace(packed, piece(pts, c0, r), piece(dirs, c0, r),
                      piece(g, c0, r), ws, None if res is None else res[1])
        weight_grads(packed, ws, ws_rows(r, tile), split_rows,
                     part[:, slot:slot + splits] if packed.stack
                     else part[0, slot:slot + splits])
        slot += splits
    if n == 0:
        return torch.zeros((scenes, total) if packed.stack else total,
                           device=dev, dtype=torch.float32)
    return reduce_partials(part if packed.stack else part[0], total)


def unpack_grads(packed: PackedMLP, flat: torch.Tensor):
    """The flat gradient of the packed blocks -> each parameter's gradient
    in the ``nn.Linear`` layout: (in, out) blocks transposed to (out, in),
    skip and view blocks side by side, padding dropped. For a stack, (S,
    grad_total) -> one such dict per scene."""
    if flat.dim() == 2:
        return [unpack_grads(dataclasses.replace(packed, stack=()), f)
                for f in flat]
    grads = {name: torch.zeros_like(p)
             for name, p in packed.net.named_parameters()}
    for name, in0, k, n, off, kp, np_ in packed.grad_blocks:
        blk = flat[off: off + kp * np_].view(kp, np_)
        grads[name][:, in0: in0 + k] = blk[:k, :n].t()
    for name, off, n in packed.grad_biases:
        grads[name] = flat[off: off + n].clone()
    return grads


def hands_over(packed: Optional[PackedMLP], n: int, needs_grad: bool) -> bool:
    """Whether a forward of n points writes its residuals for the backward
    (:class:`FusedMLPFunction`): the nets' parameters need a gradient, the
    call runs the kernels on a net that hands over (:func:`handover_misfit`)
    and its backward is one chunk (each scene's points at most
    :func:`bwd_chunk_rows`)."""
    if not needs_grad or packed is None or packed.handover is None:
        return False
    return 0 < n // packed.n_scenes <= bwd_chunk_rows(
        packed.net.cfg, packed.vdirs, packed.hi_lo)


@dataclasses.dataclass(frozen=True)
class _Call:
    """What one fused-MLP call runs on: its nets (one, or a stack's, one per
    scene), their packed layout (None for CPU tensors, which take the plain
    versions), the encoding's frequencies, the compute type and the hi_lo
    mode; ``grad``: gradients were being recorded where it was made."""

    nets: Tuple[NeRFMLP, ...]
    stacked: bool
    packed: Optional[PackedMLP]
    n_freqs: int
    dt: torch.dtype
    hi_lo: bool
    grad: bool = False

    def forward(self, pts, dirs, res=None) -> torch.Tensor:
        """The output; with ``res`` (:func:`residual_buffers`), also the
        residuals for the backward."""
        if res is not None:
            return forward_residuals(self.packed, pts, dirs, *res)
        if self.packed is None:
            out = fused_nerf_mlp_stack_plain(self.nets, pts, dirs,
                                             self.n_freqs, self.dt,
                                             self.hi_lo)
            check_nan([("the output of the fused MLP's plain forward", out)])
            return out
        return _launch(self.packed, pts, dirs)

    def backward(self, pts, dirs, g,
                 res=None) -> List[Dict[str, torch.Tensor]]:
        """Each net's gradients, in the order of ``nets``; ``res``: the
        forward's residuals, if it wrote them."""
        if self.packed is None:
            grads = fused_nerf_mlp_bwd_stack_plain(self.nets, pts, dirs, g,
                                                   self.n_freqs, self.dt,
                                                   self.hi_lo)
            check_nan([(f"the fused MLP's plain backward's gradient of "
                        f"{name}", t) for gr in grads
                       for name, t in gr.items()])
            return grads
        grads = unpack_grads(self.packed,
                             _launch_bwd(self.packed, pts, dirs, g, res))
        return grads if self.stacked else [grads]


def _route(params, pts_flat, dirs_enc_flat, cfg: RenderConfig,
           mc: Optional[ModelConfig], backward: bool):
    """(call, dirs) for one call: checks the architecture, and for CUDA
    tensors the kernels' type and budgets (``backward``: the backward's
    too), and packs a bare net or stack (per call: callers pack once and
    pass the layout)."""
    vdirs = bool(cfg.use_viewdirs) and dirs_enc_flat is not None
    mc = mc or cfg.model_config()
    if isinstance(params, PackedMLP):
        stacked = bool(params.stack)
        nets = params.stack or (params.net,)
    else:
        stacked = isinstance(params, NetStack)
        nets = params.nets if stacked else (params,)
    for net in nets:
        _check_arch(net, mc, vdirs)
    dt = getattr(torch, cfg.compute_dtype)
    hi_lo = dt == torch.float32 and cfg.fp32_precision == "high"
    dirs = dirs_enc_flat if vdirs else None
    if pts_flat.shape[0] % len(nets):
        raise ValueError(f"{pts_flat.shape[0]} points do not split into "
                         f"{len(nets)} equal scenes")
    if pts_flat.device.type == "cpu":
        return _Call(nets, stacked, None, cfg.pos_enc_L, dt, hi_lo,
                     backward), dirs
    if dt != torch.bfloat16 and not hi_lo:
        raise ValueError("the CUDA kernels compute in bfloat16 or fp32 "
                         "'high'; fp32 'highest' takes the plain module path")
    if not kernel_fits(mc, vdirs, hi_lo) or (
            backward and not backward_fits(mc, vdirs, hi_lo)):
        why = forward_misfit(mc, vdirs, hi_lo) or backward_misfit(
            mc, vdirs, hi_lo)
        raise ValueError(f"{_arch_name(mc, vdirs, hi_lo)} does not fit the "
                         f"kernels: {why}")
    if (not isinstance(params, PackedMLP) or params.vdirs != vdirs
            or params.hi_lo != hi_lo):
        params = (pack_params_stack(nets, cfg.pos_enc_L, vdirs, hi_lo)
                  if stacked else pack_params(nets[0], cfg.pos_enc_L, vdirs,
                                              hi_lo))
    return _Call(nets, stacked, params, cfg.pos_enc_L, dt, hi_lo,
                 backward), dirs


class FusedMLPFunction(torch.autograd.Function):
    """The fused MLP under autograd (``_fused_apply``'s custom VJP,
    ``pallas_mlp.py:530-567``). ``apply(call, pts, dirs, *params)``, the
    parameters of every net of the call in order: the forward kernel (or
    plain forward) of ``call``; the backward runs the backward kernels and
    reduction (or the plain backward) and returns each parameter's
    gradient — every net's of a stack, from its own scene's rows; two
    calls on one net (coarse and fine) are summed by autograd — and zeros
    for points and dirs (``:564``). Where the parameters need a gradient
    and :func:`hands_over` allows, the forward writes its residuals
    (:func:`forward_residuals`), kept on ``ctx`` for the backward's phase
    1; the TPU kernel's custom VJP saved only the inputs, its activations
    living in VMEM."""

    @staticmethod
    def forward(ctx, call, pts, dirs, *net_params):
        ctx.call = call
        ctx.where = numerics_where()
        ctx.save_for_backward(pts, dirs)
        needs = call.grad and any(ctx.needs_input_grad[3:])
        ctx.res = (residual_buffers(call.packed, pts.shape[0], pts.device)
                   if hands_over(call.packed, pts.shape[0], needs) else None)
        return call.forward(pts, dirs, ctx.res)

    @staticmethod
    def backward(ctx, g):
        pts, dirs = ctx.saved_tensors
        with numerics_scope("backward of the "
                            + (ctx.where[-1] if ctx.where else "fused MLP")):
            grads = ctx.call.backward(pts, dirs, g, ctx.res)
        d_pts = torch.zeros_like(pts) if ctx.needs_input_grad[1] else None
        d_dirs = (torch.zeros_like(dirs)
                  if dirs is not None and ctx.needs_input_grad[2] else None)
        return (None, d_pts, d_dirs,
                *[gr[name] for gr, net in zip(grads, ctx.call.nets)
                  for name, _ in net.named_parameters()])


def fused_nerf_mlp(
    params: Union[NeRFMLP, NetStack, PackedMLP],
    pts_flat: torch.Tensor,
    dirs_enc_flat: Optional[torch.Tensor],
    cfg: RenderConfig,
    mc: Optional[ModelConfig] = None,
) -> torch.Tensor:
    """Fused encode -> MLP -> raw. pts (N, 3) -> raw (N, 4), or (N,
    output_ch) with ``dirs_enc_flat=None`` / ``use_viewdirs=False``.

    ``params``: the net, a :class:`NetStack` (N points scene-major, N / S
    per scene), or their :func:`pack_params` / :func:`pack_params_stack`
    layout (packed once by the caller; a bare net or stack is packed per
    call). CUDA tensors run the kernels — bf16, or fp32 with
    ``fp32_precision="high"`` (hi_lo); fp32 'highest' raises — and CPU
    tensors the plain versions. Differentiable with respect to the nets'
    parameters through :class:`FusedMLPFunction` (the backward kernels);
    points and dirs get zero gradients. ``mc``: the architecture the nets
    must have (default: the coarse net of ``cfg``)."""
    call, dirs = _route(params, pts_flat, dirs_enc_flat, cfg, mc,
                        backward=torch.is_grad_enabled())
    return FusedMLPFunction.apply(call, pts_flat, dirs,
                                  *[p for net in call.nets
                                    for p in net.parameters()])


def fused_nerf_mlp_bwd(
    params: Union[NeRFMLP, NetStack, PackedMLP],
    pts_flat: torch.Tensor,
    dirs_enc_flat: Optional[torch.Tensor],
    g: torch.Tensor,
    cfg: RenderConfig,
    mc: Optional[ModelConfig] = None,
):
    """The gradient of ``sum(g * fused_nerf_mlp(...))`` for every parameter
    of the net, by name (for a stack, one such dict per scene). CUDA
    tensors run the backward's kernels (or raise); CPU tensors
    :func:`fused_nerf_mlp_bwd_plain`."""
    call, dirs = _route(params, pts_flat, dirs_enc_flat, cfg, mc,
                        backward=True)
    grads = call.backward(pts_flat, dirs, g)
    return grads if call.stacked else grads[0]


fused_nerf_mlp.launches = 0
fused_nerf_mlp.residual_launches = 0
bwd_workspace.launches = 0
bwd_workspace.handover_launches = 0
weight_grads.launches = 0
reduce_partials.launches = 0
