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
  kernel to a plain version. Each kernel's wrapper counts its launches:
  ``fused_nerf_mlp.launches``, ``bwd_workspace.launches``,
  ``weight_grads.launches`` and ``reduce_partials.launches``. Under
  :func:`nerfmlp_torch.check_numerics` each wrapper checks what its kernel
  wrote (or its plain version returned) for NaNs, naming the kernel.
* :func:`pack_params` lays a net's weights out for the kernels once
  (transposed to ``(in, out)``, split at the skip and view layers, padded
  to multiples of 16 with zeros, bf16 — (hi, lo) bf16 pairs in the hi_lo
  mode of ``fp32_precision="high"``) together with the forward's program
  (one operation per pass of at most ``FWD_MAX_N`` columns over each
  layer) and the backward's program and job list — at service build,
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

# The forward kernel's fixed shape (csrc/fused_mlp_fwd.cu); checked against
# the built library at load.
FWD_THREADS = 512       # 16 warps, 4 x 4 over a tile's output pass
PAD = 8                 # bf16 elements of padding per shared-memory row
FWD_MAX_N = 256         # output columns of one pass
FWD_HEADER_INTS = 16
FWD_MAX_BUFS = 4        # X, D, P0, P1: (offset, ld, cols)
FWD_OP_INTS = 16
FWD_OPS_BASE = FWD_HEADER_INTS + 3 * FWD_MAX_BUFS
SMEM_LIMIT = 232_448    # dynamic shared memory one Hopper block may use

# The backward kernels' fixed shape (csrc/fused_mlp_bwd.cu). The matrix and
# operation tables follow the buffer table, sized by the net (their bases
# and counts are in the header).
BWD_THREADS = 256      # phase 2 and the reduction
BWD_P1_THREADS = 512   # phase 1: 16 warps over the tile and a column pass
BWD_MAX_N = 256         # output columns of one phase-1 pass
BWD_SLAB_K = 16         # weight rows per ring stage of phase 1
BWD_HEADER_INTS = 32
BWD_MAX_BUFS = 8        # shared-memory buffers (offset, ld, cols)
BWD_OP_INTS = 16
BWD_TABLES_BASE = BWD_HEADER_INTS + 3 * BWD_MAX_BUFS
BWD_TILE_K = 128        # phase 2: dW rows per block
BWD_TILE_N = 128        # phase 2: dW columns per block
BWD_STAGE_ROWS = 64     # phase 2: points per ring stage
BWD_STAGES2 = 3
BWD_JOB_INTS = 10
# Phase 1's points per tile, in the order tried: the first whose layout
# holds two weight stages is taken (hi_lo: two bf16 planes per value).
BWD_TILE_ROWS = (128, 64, 32)
BWD_TILE_ROWS_HI_LO = (64, 32, 16)
# ... and the largest tile at which the matrix and operation tables may
# stay in device memory (a deep net's program, once its masks have taken
# the tile down).
BWD_DEVICE_TABLES_ROWS = 32
# How a call is cut: at most BWD_CHUNK_ROWS points of a scene per phase-1 /
# phase-2 pair, fewer (a multiple of BWD_CHUNK_ALIGN) where a scene's
# workspace would pass BWD_WS_BUDGET bytes; phase 2's rows split in up to
# BWD_MAX_SPLITS ranges of at least BWD_MIN_SPLIT_ROWS points. A call's
# workspace and partial slots may take BWD_MEMORY_SHARE of the card's
# memory (the rest holds the nets, the optimizer and the step's
# activations); a stack of more scenes is refused by name.
BWD_CHUNK_ROWS = 131_072
BWD_CHUNK_ALIGN = 4096
BWD_WS_BUDGET = 8 << 30
BWD_MEMORY_SHARE = 0.5
BWD_MAX_SPLITS = 32
BWD_MIN_SPLIT_ROWS = 2048

# Shared-memory buffers and epilogues of the forward's program.
_X, _D, _P0, _P1 = 0, 1, 2, 3
_RELU_BF16, _BF16, _OUT_F32 = 0, 1, 2
# Operations of the backward's phase-1 program.
_FWD, _DX, _LOAD_G = 0, 1, 2


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


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


@dataclasses.dataclass(frozen=True)
class FwdLayout:
    """The forward kernel's shared memory for one architecture and mode:
    ``rows`` points per tile (128, or 64), ``ksub`` 16-row k-steps per
    weight-ring stage (2, or 1), the program's buffers as ``(name, (byte
    offset, ld, cols))`` pairs in table order, the ring's byte offset, the
    elements of a stage's hi slab, the ring's stages and the total
    bytes."""

    rows: int
    ksub: int
    bufs: Tuple[Tuple[str, Tuple[int, int, int]], ...]
    ring_off: int
    stage_elems: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=None)
def _fwd_layout(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> FwdLayout:
    """The program, then the buffers x (encoded points), d (encoded dirs),
    p0 / p1 (a layer's input and output, ping-pong), each ``rows`` rows of
    ``cols + PAD`` bf16 (two planes in hi_lo), then the weight ring with as
    many stages (up to 4) as fit. bf16: the first of 128-point tiles with
    32-row stages, 64-point tiles with 32-row stages and 64-point tiles
    with 16-row stages that holds three stages, else the first that holds
    two. hi_lo: 16-row stages, 64-point tiles where they hold two stages
    (up to width 320), else 32-point tiles (widths 336-608). The program's
    bytes (64 a layer) are the only bound on depth: at 866x16, 55 KB
    beside 128-point tiles."""
    planes = 2 if hi_lo else 1
    hid = _hidden_cols(mc, vdirs)
    pass_cols = min(FWD_MAX_N, max(_layer_widths(mc, vdirs)))
    prog = _align128(4 * (FWD_OPS_BASE + forward_ops(mc, vdirs) * FWD_OP_INTS))
    cols = (("x", _pad16(mc.input_ch)),
            ("d", _pad16(mc.input_ch_views) if vdirs else 0),
            ("p0", hid), ("p1", hid))
    layouts = []
    for rows, ksub in (((64, 1), (32, 1)) if hi_lo
                       else ((128, 2), (64, 2), (64, 1))):
        off, bufs = prog, []
        for name, c in cols:
            bufs.append((name, (off, c + PAD, c)))
            off += _align128(rows * (c + PAD) * 2 * planes) if c else 0
        stage = 16 * ksub * (pass_cols + PAD)
        stages = max(0, min(4, (SMEM_LIMIT - off) // (2 * stage * planes)))
        layouts.append(FwdLayout(rows, ksub, tuple(bufs), off, stage, stages,
                                 off + 2 * stage * planes * stages))
    for want in ((2,) if hi_lo else (3, 2)):
        for lay in layouts:
            if lay.stages >= want:
                return lay
    return layouts[-1]


def _stage_rows(lay: FwdLayout, n: int, k: int) -> int:
    """Weight rows per ring stage of an operation of ``n`` columns whose
    largest operand has ``k`` rows: as many (a multiple of 16) as a slot of
    ``lay.stage_elems`` holds at a row stride of ``n + PAD`` — 16 *
    ``lay.ksub`` for the widest operations — and no more than k needs."""
    return min(lay.stage_elems // (n + PAD) // 16 * 16, _pad16(k))


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
        "%d rows, %d B of shared memory per block (Hopper limit %d B): %s",
        _arch_name(mc, vdirs, hi_lo), lay.rows, lay.stages, 16 * lay.ksub,
        lay.smem, SMEM_LIMIT, why or "kernel")
    return why is None


def _passes(cols: int) -> int:
    """Column passes of at most ``BWD_MAX_N`` over a layer of ``cols``."""
    return -(-_pad16(cols) // BWD_MAX_N)


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


def backward_counts(mc: ModelConfig, vdirs: bool) -> Tuple[int, int]:
    """(phase-1 operations, workspace matrices) for an architecture: a
    pass of at most ``BWD_MAX_N`` columns over each recomputed forward
    layer (the output heads excepted), the load of the cotangent, and a
    pass over each dX output of the chain; the matrices of
    :func:`_bwd_mats`."""
    w = _passes(mc.width)
    fwd = mc.depth * w
    dx = (mc.depth - 1) * w
    if vdirs:
        bott, view = _passes(mc.bottleneck_ch), _passes(mc.view_width)
        fwd += bott + view
        dx += view + bott + w
    else:
        dx += w
    return fwd + 1 + dx, len(_bwd_mats(mc, vdirs))


def _warp_grid(rows: int) -> Tuple[int, int, int, int]:
    """``mlp_tile.cuh``'s ``WarpGrid<rows>``: (m16 tiles a warp, columns a
    warp, column groups, row groups) of the 16 warps over a tile and a
    pass of ``BWD_MAX_N`` columns."""
    wn = 64 if rows >= 64 else rows
    groups = BWD_MAX_N // wn
    return (rows // 64 if rows >= 64 else 1), wn, groups, 16 // groups


def _mask_blocks(mc: ModelConfig, vdirs: bool, rows: int
                 ) -> Tuple[Tuple[Tuple[Tuple[int, int], ...], ...], int]:
    """Phase 1's ReLU masks at tiles of ``rows`` points: for each ReLU
    layer's slot (trunk layer i, then the view layer), one block per
    column pass as (its first mask word, the warp column groups it holds);
    and the bytes of all blocks. A thread keeps the bits of its own (row,
    column) positions, one word of ``columns a warp / 2`` bits per m16
    tile, so a block of g column groups is ``32 x row groups x g x m16
    tiles`` words. A pass holds the column groups its columns reach; a net
    256 or more wide keeps one whole grid's block (``rows x 256`` bits)
    per pass."""
    m16, wn, groups, row_groups = _warp_grid(rows)
    whole = mc.width >= BWD_MAX_N
    slots, at = [], 0
    for cols in [mc.width] * mc.depth + ([mc.view_width] if vdirs else []):
        blocks = []
        for c0 in range(0, _pad16(cols), BWD_MAX_N):
            g = groups if whole else -(-min(BWD_MAX_N, _pad16(cols) - c0)
                                       // wn)
            blocks.append((at, g))
            at += 32 * row_groups * g * m16
        slots.append(tuple(blocks))
    return tuple(slots), at * wn // 16


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
    points: n rounded up to the tile and to phase 2's ``BWD_STAGE_ROWS``
    (tiles of 32 and 16 points fill the rows up to the stage with zero
    points)."""
    step = max(tile, BWD_STAGE_ROWS)
    return -(-n // step) * step


@dataclasses.dataclass(frozen=True)
class BwdLayout:
    """Phase 1's shared memory for one architecture and mode: ``rows``
    points per tile; ``prog_ints`` the program's ints copied into shared
    memory (header, buffer, matrix and operation tables, or the header and
    buffer table alone); the buffers as ``{name: (byte offset, ld,
    cols)}``; the mask blocks' byte offset and their words per slot and
    pass (:func:`_mask_blocks`); the weight ring's byte offset, the
    elements of a stage's hi slab and its stages; the total bytes."""

    rows: int
    prog_ints: int
    bufs: Dict[str, Tuple[int, int, int]]
    mask_off: int
    masks: Tuple[Tuple[Tuple[int, int], ...], ...]
    ring_off: int
    stage_elems: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=None)
def _bwd_layout(mc: ModelConfig, vdirs: bool, hi_lo: bool) -> BwdLayout:
    """Phase 1's dynamic shared memory: the program; the buffers x, d, the
    two ping-pong activation buffers p0 / p1, and the cotangent's gr / gs
    laid over x when they fit there (x is dead by then), each ``rows``
    rows of ``cols + PAD`` bf16 (two planes in hi_lo); the mask blocks
    (one bit a value of a ReLU layer's column pass); the weight ring, with
    as many stages (up to 4) of 16 rows of a pass as fit. The first tile
    of ``BWD_TILE_ROWS`` (hi_lo: ``BWD_TILE_ROWS_HI_LO``) whose layout
    holds two stages: 128 points (hi_lo 64) up to width 256 and wherever
    else they fit, then 64, then 32, then (hi_lo) 16, with the whole
    program in shared memory; failing those, the tiles of at most
    ``BWD_DEVICE_TABLES_ROWS`` points with only its header and buffer
    table there (a deep net: the kernel then reads the matrix and
    operation tables from device memory)."""
    planes = 2 if hi_lo else 1
    n_ops, n_mats = backward_counts(mc, vdirs)
    whole = BWD_TABLES_BASE + 2 * n_mats + BWD_OP_INTS * n_ops
    hid = _hidden_cols(mc, vdirs)
    stage = BWD_SLAB_K * (min(hid, BWD_MAX_N) + PAD)
    layout = None
    tiles = BWD_TILE_ROWS_HI_LO if hi_lo else BWD_TILE_ROWS
    for prog_ints, rows in [(whole, r) for r in tiles] + [
            (BWD_TABLES_BASE, r) for r in tiles
            if r <= BWD_DEVICE_TABLES_ROWS]:
        off = _align128(4 * prog_ints)
        bufs: Dict[str, Tuple[int, int, int]] = {}

        def size(cols):
            return _align128(rows * (cols + PAD) * 2 * planes)

        def region(name, cols, at=None):
            nonlocal off
            if at is None:
                at, off = off, off + size(cols)
            bufs[name] = (at, cols + PAD, cols)
            return at + size(cols)

        region("x", _pad16(mc.input_ch))
        if vdirs:
            region("d", _pad16(mc.input_ch_views))
        region("p0", hid)
        region("p1", hid)
        g_cols = (16, 16) if vdirs else (_pad16(mc.output_ch),)
        over_x = sum(size(c) for c in g_cols) <= size(_pad16(mc.input_ch))
        at = bufs["x"][0] if over_x else None
        for name, c in zip(("gr", "gs"), g_cols):
            end = region(name, c, at)
            at = end if over_x else None
        mask_off = off
        masks, mask_bytes = _mask_blocks(mc, vdirs, rows)
        off += _align128(mask_bytes)
        stages = max(0, min(4, (SMEM_LIMIT - off) // (2 * stage * planes)))
        layout = BwdLayout(rows, prog_ints, bufs, mask_off, masks, off, stage,
                           stages, off + 2 * stage * planes * stages)
        if stages >= 2:
            break
    return layout


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
    ops, mats = backward_counts(mc, vdirs)
    lay = _bwd_layout(mc, vdirs, hi_lo)
    why = backward_misfit(mc, vdirs, hi_lo)
    log.info(
        "fused MLP backward budget: %s: %d-point tiles, %d B of shared "
        "memory per block (%d weight stages, %d B of masks; Hopper limit %d "
        "B), %d operations and %d workspace matrices (tables in %s memory), "
        "%d B of workspace per point, chunks of %d points: %s",
        _arch_name(mc, vdirs, hi_lo), lay.rows, lay.smem, lay.stages,
        lay.ring_off - lay.mask_off, SMEM_LIMIT, ops, mats,
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

    ``weights``: every weight block, bf16, each ``(k_pad, n_pad)`` row-major
    in ``(in, out)`` layout — in ``hi_lo`` mode a (hi, lo) pair of such
    blocks, lo right after hi; ``biases``: fp32, each padded to ``n_pad``;
    ``program``: the forward's int32 header, buffer table and one record
    per column pass of each layer (see ``fused_mlp_fwd.cu``), also on the
    device as ``program_dev``; ``bwd_program``: the backward's header, buffer
    and matrix tables, phase-1 operations and phase 2's ``bwd_jobs`` (see
    ``fused_mlp_bwd.cu``), also on the device as ``bwd_program_dev``, of
    which phase 1 copies the first ``bwd_prog_len`` ints into shared
    memory. ``ws_mats``: each workspace
    matrix's (name, column offset, cols); a workspace of R rows holds
    ``R * ws_cols`` bf16, matrix m at ``R * offset`` as (planes, R, cols).
    ``grad_blocks`` / ``grad_biases`` say where each parameter's gradient
    lies in the backward's flat fp32 output: ``(param, in_start, k, n,
    offset, k_pad, n_pad)`` per weight block and ``(param, offset, n)``
    per bias. ``bwd_rows``: phase 1's points per tile. ``net`` is the
    module the blocks came from (the plain path and the architecture
    check read it)."""

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
    bwd_jobs: np.ndarray
    bwd_smem: int
    bwd_rows: int
    ws_cols: int
    ws_mats: Tuple[Tuple[str, int, int], ...]
    grad_total: int
    grad_blocks: Tuple[Tuple, ...]
    grad_biases: Tuple[Tuple, ...]
    stack: Tuple[NeRFMLP, ...] = ()

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
        w_parts.append(hi.reshape(-1))
        if hi_lo:
            w_parts.append((blk - hi.float()).to(torch.bfloat16).reshape(-1))
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
    lay = _fwd_layout(mc, vdirs, hi_lo)

    def layer(a, b, lin, mode, dst, n_real=0):
        """a/b: (buffer, in_start, (in, out) block) operands; b may be
        None. One operation per pass of at most FWD_MAX_N columns; an
        output head's dst is its first output column."""
        wa, ka = weight(lin, a[1], a[2])
        wb, kb = weight(lin, b[1], b[2]) if b is not None else (0, 0)
        bo, n = bias(lin), _pad16(lin.out_features)
        for c0 in range(0, n, FWD_MAX_N):
            nn = min(FWD_MAX_N, n - c0)
            head = mode == _OUT_F32
            ops.append([a[0], wa + c0, ka, b[0] if b is not None else 0,
                        wb + c0 if kb else 0, kb, bo + c0, nn, n, mode,
                        dst + c0 if head else dst, 0 if head else c0,
                        max(0, min(nn, n_real - c0)) if head else 0,
                        _stage_rows(lay, nn, max(ka, kb)), 0, 0])

    kt = lambda lin: lin.weight.detach().float().t()
    with torch.no_grad():
        cur = _X
        for i, lin in enumerate(net.pts_linears):
            k = kt(lin)
            dst = _P0 if i % 2 == 0 else _P1
            if i in mc.skips:  # cat([x, h]) @ W == x @ W[:enc] + h @ W[enc:]
                layer((_X, 0, k[:enc_dim]), (cur, enc_dim, k[enc_dim:]), lin,
                      _RELU_BF16, dst)
            else:
                layer((cur, 0, k), None, lin, _RELU_BF16, dst)
            cur = dst
        other = _P1 if cur == _P0 else _P0
        if vdirs:
            kv = kt(net.view_linear)
            bott = mc.bottleneck_ch
            layer((cur, 0, kt(net.sigma_linear)), None, net.sigma_linear,
                  _OUT_F32, 3, 1)
            layer((cur, 0, kt(net.bottleneck_linear)), None,
                  net.bottleneck_linear, _BF16, other)
            layer((other, 0, kv[:bott]), (_D, bott, kv[bott:]),
                  net.view_linear, _RELU_BF16, cur)
            layer((cur, 0, kt(net.rgb_linear)), None, net.rgb_linear,
                  _OUT_F32, 0, 3)
            out_w = 4
        else:
            out_w = mc.output_ch
            layer((cur, 0, kt(net.output_linear)), None, net.output_linear,
                  _OUT_F32, 0, out_w)

    if len(ops) != forward_ops(mc, vdirs):
        raise ValueError(f"forward program of {len(ops)} operations")
    header = dict(
        n_ops=len(ops), prog_len=FWD_OPS_BASE + FWD_OP_INTS * len(ops),
        n_freqs=n_freqs, enc_dim=enc_dim,
        dirs_dim=mc.input_ch_views if vdirs else 0, out_w=out_w,
        hi_lo=int(hi_lo), rows=lay.rows, ksub=lay.ksub, stages=lay.stages,
        ring_off=lay.ring_off, stage_elems=lay.stage_elems, smem=lay.smem)
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
    hdr = bwd_program[:BWD_HEADER_INTS]
    jobs_off, n_jobs = int(hdr[_H_JOBS_OFF]), int(hdr[_H_N_JOBS])
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
        bwd_jobs=bwd_program[jobs_off:].reshape(n_jobs, BWD_JOB_INTS),
        bwd_smem=int(hdr[_H_SMEM]), bwd_rows=int(hdr[_H_ROWS]),
        ws_cols=int(hdr[_H_WS_COLS]),
        ws_mats=ws_mats, grad_total=g_off + b_off,
        grad_blocks=tuple(grad_blocks), grad_biases=tuple(grad_biases),
    )


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
               "out_w", "hi_lo", "rows", "ksub", "stages", "ring_off",
               "stage_elems", "smem")


def fwd_header(packed: "PackedMLP") -> Dict[str, int]:
    """The forward program's header fields by name."""
    return dict(zip(_FWD_HEADER, packed.program.tolist()))


# The backward program's header fields, in the order of fused_mlp_bwd.cu's
# `Header` enum.
_BWD_HEADER = ("n_ops", "prog_len", "n_freqs", "enc_dim", "dirs_dim",
               "g_cols", "gr_cols", "x_buf", "d_buf", "gr_buf", "gs_buf",
               "x_mat", "d_mat", "gr_mat", "gs_mat", "stages", "ring_off",
               "stage_elems", "mask_off", "smem", "ws_cols", "jobs_off",
               "n_jobs", "rows", "mats_base", "ops_base", "n_mats")
_H_PROG_LEN, _H_SMEM, _H_WS_COLS, _H_JOBS_OFF, _H_N_JOBS, _H_ROWS = (
    _BWD_HEADER.index(k)
    for k in ("prog_len", "smem", "ws_cols", "jobs_off", "n_jobs", "rows"))


def _bwd_program(net: NeRFMLP, n_freqs: int, vdirs: bool, hi_lo: bool,
                 out_w: int, blocks: Dict[str, list], bias_of: Dict[str, int],
                 db_base: int) -> Tuple[np.ndarray, Tuple]:
    """The backward kernels' program — ``_bwd_kernel``/``_trunk_bwd``
    (``pallas_mlp.py:312-441``) as phase 1's operations over shared-memory
    buffers, each writing a workspace matrix, and phase 2's jobs over
    those matrices. ``blocks``: per Linear its (weight offset, k_pad,
    n_pad, gradient offset) blocks in operand order; ``bias_of``: its bias
    offset, which is also its gradient's offset after ``db_base``. Returns
    the program (header, buffer table, matrix table, operations, jobs) and
    the matrices' (name, column offset, cols)."""
    mc = net.cfg
    depth = mc.depth
    lay = _bwd_layout(mc, vdirs, hi_lo)
    bufs = lay.bufs
    buf = {name: i for i, name in enumerate(bufs)}
    names = _bwd_mats(mc, vdirs)
    mat = {name: i for i, (name, _) in enumerate(names)}
    x, p = buf["x"], (buf["p0"], buf["p1"])
    ops: List[List[int]] = []

    def op(kind, a=-1, wa=0, ka=0, b=-1, wb=0, kb=0, bias=0, n=0,
           mask_in=(-1, 0), dst=-1, m=-1, mask_out=(-1, 0), col=0, wld=0):
        ops.append([kind, a, wa, ka, b, wb, kb, bias, n, mask_in[0], dst, m,
                    mask_out[0], col, wld, max(mask_in[1], mask_out[1])])

    def block_of(slot, c0):
        """The mask block of a ReLU layer's slot for the pass at c0: (its
        first word, its column groups), or (-1, 0)."""
        return (-1, 0) if slot < 0 else lay.masks[slot][c0 // BWD_MAX_N]

    def fwd(name, srcs, dst, m, slot=-1):
        """dst = act(sum of src @ W + bias), one op per column pass; ReLU
        when it records a mask."""
        blk = blocks[name]
        wa, ka, na, _ = blk[0]
        wb, kb = (blk[1][0], blk[1][1]) if len(blk) > 1 else (0, 0)
        for c0 in range(0, na, BWD_MAX_N):
            op(_FWD, srcs[0], wa + c0, ka, srcs[1] if len(srcs) > 1 else -1,
               wb + c0 if kb else 0, kb, bias_of[name] + c0,
               min(BWD_MAX_N, na - c0), dst=dst, m=mat[m],
               mask_out=block_of(slot, c0), col=c0, wld=na)

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
        for c0 in range(0, rows, BWD_MAX_N):
            op(_DX, sa, wa + c0 * ka, ka, sb, wb + c0 * kb if kb else 0, kb,
               n=min(BWD_MAX_N, rows - c0), mask_in=block_of(slot, c0),
               dst=dst, m=mat[m], col=c0, wld=rows)

    # Recompute the forward (mask slot i: h_i > 0), load the cotangent,
    # walk the dX chain; h_i is in p[i % 2].
    trunk = [f"pts_linears.{i}" for i in range(depth)]
    for i, name in enumerate(trunk):
        a = x if i == 0 else p[(i - 1) % 2]
        fwd(name, (x, a) if i in mc.skips else (a,), p[i % 2], f"h{i}", i)
    last, other = p[(depth - 1) % 2], p[depth % 2]
    if vdirs:
        fwd("bottleneck_linear", (last,), other, "bott")
        fwd("view_linear", (other, buf["d"]), last, "v", depth)
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

    # Phase 2: dW = A^T dY per weight block, in tiles; db with the first
    # k-tile of each layer's first block. Largest blocks first.
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
    jobs = []
    for am, ym, name, pt in wblocks:
        _, kp, np_, goff = blocks[name][pt]
        for k0 in range(0, kp, BWD_TILE_K):
            for n0 in range(0, np_, BWD_TILE_N):
                db = db_base + bias_of[name] if pt == 0 and k0 == 0 else -1
                jobs.append([mat[am], k0, min(BWD_TILE_K, kp - k0), mat[ym],
                             n0, min(BWD_TILE_N, np_ - n0), goff, np_, db, 0])

    buf_table = [0] * (3 * BWD_MAX_BUFS)
    for i, rec in enumerate(bufs.values()):
        buf_table[3 * i: 3 * i + 3] = rec
    mat_table, ws_mats, col = [], [], 0
    for name, c in names:
        mat_table += [col, c]
        ws_mats.append((name, col, c))
        col += c * (2 if hi_lo else 1)
    ops_base = BWD_TABLES_BASE + len(mat_table)
    jobs_off = ops_base + BWD_OP_INTS * len(ops)
    header = dict(
        n_ops=len(ops), prog_len=lay.prog_ints, n_freqs=n_freqs,
        enc_dim=3 + 6 * n_freqs,
        dirs_dim=mc.input_ch_views if vdirs else 0, g_cols=out_w,
        gr_cols=gr_cols, x_buf=x, d_buf=buf.get("d", -1), gr_buf=buf["gr"],
        gs_buf=buf.get("gs", -1), x_mat=mat["x"], d_mat=mat.get("d", -1),
        gr_mat=mat["g_rgb" if vdirs else "g_out"],
        gs_mat=mat.get("g_sigma", -1), stages=lay.stages,
        ring_off=lay.ring_off, stage_elems=lay.stage_elems,
        mask_off=lay.mask_off, smem=lay.smem, ws_cols=col,
        jobs_off=jobs_off, n_jobs=len(jobs), rows=lay.rows,
        mats_base=BWD_TABLES_BASE, ops_base=ops_base, n_mats=len(names))
    head = [header[k] for k in _BWD_HEADER]
    head += [0] * (BWD_HEADER_INTS - len(head))
    prog = np.asarray(head + buf_table + mat_table
                      + [v for rec in ops + jobs for v in rec], np.int32)
    if (len(ops) != backward_counts(mc, vdirs)[0]
            or lay.prog_ints not in (jobs_off, BWD_TABLES_BASE)):
        raise ValueError(f"backward program of {len(ops)} operations")
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


def _bwd_terms(net: NeRFMLP, pts, dirs, g, n_freqs: int, dt,
               hi_lo: bool) -> Dict[str, torch.Tensor]:
    """Every value the backward stores, by workspace matrix name (see
    :func:`_bwd_mats`): the forward's residuals and the rounded cotangents
    of :func:`fused_nerf_mlp_bwd_plain`, at its rounding points."""
    mc = net.cfg

    def rnd(t):
        return t.to(dt).float()

    def back(gg, w):  # gg @ W for an (out, in) weight: the dX product
        if hi_lo:
            g_hi, g_lo = _split_bf16(gg)
            w_hi, w_lo = _split_bf16(w.float())
            return g_hi @ w_hi + g_hi @ w_lo + g_lo @ w_hi
        return gg @ rnd(w.float())

    with torch.no_grad():
        _, (x, d, hs, bott, v) = _plain_forward(net, pts, dirs, n_freqs, dt,
                                                hi_lo)
        terms = {"x": x, **{f"h{i}": h for i, h in enumerate(hs)}}
        g = g.float()
        if dirs is None:
            terms["g_out"] = rnd(g)
            dh = rnd(back(terms["g_out"], net.output_linear.weight))
        else:
            g_rgb, g_sigma = rnd(g[:, 0:3]), rnd(g[:, 3:4])
            dv = back(g_rgb, net.rgb_linear.weight)
            dv = rnd(torch.where(v > 0, dv, torch.zeros_like(dv)))
            dbott = rnd(back(dv, net.view_linear.weight[:, :mc.bottleneck_ch]))
            dh = rnd(back(dbott, net.bottleneck_linear.weight)
                     + back(g_sigma, net.sigma_linear.weight))
            terms.update(d=d, bott=bott, v=v, g_rgb=g_rgb, g_sigma=g_sigma,
                         dv=dv, dbott=dbott)
        enc = x.shape[-1]
        for i in range(mc.depth - 1, -1, -1):
            dacc = rnd(torch.where(hs[i] > 0, dh, torch.zeros_like(dh)))
            terms[f"dacc{i}"] = dacc
            if i > 0:
                w = net.pts_linears[i].weight
                dh = rnd(back(dacc, w[:, enc:] if i in mc.skips else w))
    return terms


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
    """Workspace matrix ``m`` of a flat workspace: (planes, rows, cols)."""
    rows = ws.numel() // packed.ws_cols
    _, off, cols = packed.ws_mats[m]
    planes = 2 if packed.hi_lo else 1
    return ws[rows * off: rows * (off + planes * cols)].view(planes, rows,
                                                               cols)


def bwd_workspace_plain(packed: PackedMLP, pts: torch.Tensor,
                        dirs: Optional[torch.Tensor], g: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """What phase 1 computes, from the function's definition: the flat
    workspace of ``rows`` rows holding every stored activation and rounded
    cotangent of the n points (bf16; in hi_lo mode the (hi, lo) planes of
    the fp32 value), rows n and on zero. For a stack, scene s's n / S
    points fill rows ``s * rows_s`` on, ``rows_s`` = n / S rounded up to
    phase 1's tile."""
    hi_lo = packed.hi_lo
    dt = torch.float32 if hi_lo else torch.bfloat16
    n_freqs = int(packed.bwd_program[_BWD_HEADER.index("n_freqs")])
    ws = torch.zeros(rows * packed.ws_cols, device=pts.device,
                     dtype=torch.bfloat16)
    s = packed.n_scenes
    nets = packed.stack or (packed.net,)
    for i, (net, p, d, gg) in enumerate(zip(
            nets, _scenes(pts, s), _scenes(dirs, s), _scenes(g, s))):
        n = p.shape[0]
        r0 = i * ws_rows(n, packed.bwd_rows)
        terms = _bwd_terms(net, p, d, gg, n_freqs, dt, hi_lo)
        for m, (name, _, _) in enumerate(packed.ws_mats):
            t = terms[name]
            mat = ws_matrix(packed, ws, m)
            hi = t.to(torch.bfloat16)
            mat[0, r0:r0 + n, :t.shape[1]] = hi
            if hi_lo:
                mat[1, r0:r0 + n, :t.shape[1]] = (
                    t - hi.float()).to(torch.bfloat16)
    return ws


def bwd_splits(rows: int) -> Tuple[int, int]:
    """(splits, rows per split) of phase 2 over ``rows`` points, a multiple
    of ``BWD_STAGE_ROWS``: up to ``BWD_MAX_SPLITS`` ranges of at least
    ``BWD_MIN_SPLIT_ROWS`` points, each a whole number of stages."""
    want = max(1, min(BWD_MAX_SPLITS, rows // BWD_MIN_SPLIT_ROWS))
    per = -(-rows // (want * BWD_STAGE_ROWS)) * BWD_STAGE_ROWS
    return -(-rows // per), per


def part_stride(total: int) -> int:
    """Floats per partial slot: the gradient, rounded up to 64."""
    return -(-total // 64) * 64


def weight_grads_plain(packed: PackedMLP, ws: torch.Tensor, rows: int,
                       split_rows: int) -> torch.Tensor:
    """What phase 2 computes: for each split of the workspace's first
    ``rows`` rows into ranges of ``split_rows``, one (splits, stride) fp32
    partial slot with every job's dW tile (A^T dY over the range; in hi_lo
    mode hi*hi + lo*hi + hi*lo) and its db (dY's column sums). For a stack,
    ``rows`` per scene from ``s * rows`` on, into (S, splits, stride)."""
    splits = -(-rows // split_rows)
    n_sc = packed.n_scenes
    part = torch.zeros((n_sc, splits, part_stride(packed.grad_total)),
                       device=ws.device)
    mats = [ws_matrix(packed, ws, m).float()
            for m in range(len(packed.ws_mats))]
    for am, k0, kc, ym, n0, nc, off, ld, db, _ in packed.bwd_jobs.tolist():
        for sc in range(n_sc):
            for s in range(splits):
                r0 = sc * rows + s * split_rows
                r1 = min((sc + 1) * rows, r0 + split_rows)
                a = mats[am][:, r0:r1, k0:k0 + kc]
                y = mats[ym][:, r0:r1, n0:n0 + nc]
                prod = a[0].t() @ y[0]
                if packed.hi_lo:
                    prod = prod + a[1].t() @ y[0] + a[0].t() @ y[1]
                tile = part[sc, s, off + k0 * ld:
                            off + (k0 + kc) * ld].view(kc, ld)
                tile[:, n0:n0 + nc] = prod
                if db >= 0:
                    part[sc, s, db + n0: db + n0 + nc] = y.sum(0).sum(0)
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
                                   vp] + [i32] * 6 + [vp])
    lib.fused_mlp_fwd.restype = i32
    lib.fused_mlp_fwd_error_string.argtypes = [i32]
    lib.fused_mlp_fwd_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_fwd_constants.argtypes = [ctypes.POINTER(i32), i32]
    want = [FWD_THREADS, PAD, FWD_MAX_N, FWD_HEADER_INTS, FWD_MAX_BUFS,
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
                                         + [i32] * 3 + [vp, i64, vp])
    lib.fused_mlp_bwd_phase1.restype = i32
    lib.fused_mlp_bwd_phase2.argtypes = [vp, i64, vp, vp] + [i32] * 6 + [
        vp, i64, i64, vp]
    lib.fused_mlp_bwd_phase2.restype = i32
    lib.fused_mlp_bwd_reduce.argtypes = [vp, i32, i64, vp, i64, i32, vp]
    lib.fused_mlp_bwd_reduce.restype = i32
    lib.fused_mlp_bwd_error_string.argtypes = [i32]
    lib.fused_mlp_bwd_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_bwd_constants.argtypes = [ctypes.POINTER(i32), i32]
    want = [BWD_THREADS, PAD, BWD_MAX_N, BWD_HEADER_INTS, BWD_MAX_BUFS,
            BWD_OP_INTS, BWD_TILE_K, BWD_TILE_N,
            BWD_STAGE_ROWS, BWD_STAGES2, BWD_JOB_INTS, BWD_P1_THREADS,
            *BWD_TILE_ROWS, *BWD_TILE_ROWS_HI_LO, BWD_DEVICE_TABLES_ROWS]
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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
            dirs: Optional[torch.Tensor]) -> torch.Tensor:
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
    tiles = scenes * -(-n_s // hdr["rows"])
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_mlp_fwd(
            pts.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            out.data_ptr(), n_s, scenes, packed.w_stride, packed.b_stride,
            packed.program_dev.data_ptr(),
            hdr["prog_len"], hdr["hi_lo"], hdr["rows"], hdr["ksub"],
            min(tiles, _sm_count(index)), hdr["smem"], stream,
        )
    if rc != 0:
        raise RuntimeError("fused_mlp_fwd launch failed: "
                           + lib.fused_mlp_fwd_error_string(rc).decode())
    fused_nerf_mlp.launches += 1
    check_nan([("the output of the fused_mlp_fwd kernel", out)])
    return out


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
    """The workspace's rows per matrix, after checking it holds ``rows``."""
    cap = ws.numel() // packed.ws_cols
    if (ws.dtype != torch.bfloat16 or ws.dim() != 1 or not ws.is_contiguous()
            or ws.device != dev or cap < rows
            or ws.numel() != cap * packed.ws_cols or ws.data_ptr() % 16):
        raise ValueError(f"the workspace must be a contiguous bf16 vector of "
                         f">= {rows} x {packed.ws_cols} on {dev}")
    return cap


def bwd_workspace(packed: PackedMLP, pts: torch.Tensor,
                  dirs: Optional[torch.Tensor], g: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """Phase 1 for n points: recompute the forward, walk the dX chain and
    fill the flat workspace ``ws`` (at least :func:`ws_rows` of n rows per
    matrix; for a stack, S times those of n / S, scene s's rows after
    scene s - 1's). The kernel for CUDA
    tensors (or raise), :func:`bwd_workspace_plain` for CPU ones.
    ``bwd_workspace.launches`` counts kernel launches."""
    pts, dirs = _check_operands(packed, pts, dirs)
    n, dev = pts.shape[0], pts.device
    if g.shape != (n, packed.out_w) or g.device != dev:
        raise ValueError(f"the cotangent must be ({n}, {packed.out_w}) on "
                         f"{dev}, got {tuple(g.shape)} on {g.device}")
    g = g.to(torch.float32).contiguous()
    tile = packed.bwd_rows
    scenes = packed.n_scenes
    n_s = n // scenes
    rows = ws_rows(n_s, tile)
    cap = _check_ws(packed, ws, scenes * rows, dev)
    if dev.type == "cpu":
        return ws.copy_(bwd_workspace_plain(packed, pts, dirs, g, cap))
    if n == 0:
        return ws
    lib = _bwd_kernel()
    prog = packed.bwd_program_dev
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_phase1 launch", lib.fused_mlp_bwd_phase1(
            pts.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            g.data_ptr(), packed.weights.data_ptr(),
            packed.biases.data_ptr(), prog.data_ptr(), packed.bwd_prog_len,
            int(packed.hi_lo), tile, n_s, scenes, packed.w_stride,
            packed.b_stride,
            min(scenes * rows // tile, _sm_count(index)),
            packed.bwd_smem, ws.data_ptr(), cap, stream))
    bwd_workspace.launches += 1
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
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_phase2 launch", lib.fused_mlp_bwd_phase2(
            ws.data_ptr(), cap, prog.data_ptr(),
            prog.data_ptr() + 4 * int(packed.bwd_program[_H_JOBS_OFF]),
            len(packed.bwd_jobs),
            int(packed.hi_lo), rows, splits, split_rows, scenes,
            part.data_ptr(), stride, part.stride(0) if packed.stack else 0,
            stream))
    weight_grads.launches += 1
    check_nan([("the partial gradients of the fused_mlp_bwd_phase2 kernel",
                part[..., :packed.grad_total])])
    return part


def _bwd_chunks(packed: PackedMLP, n_s: int):
    """A backward call over n_s points a scene, cut into chunks: [(first
    point, points, (phase-2 splits, rows a split))] of at most
    :func:`bwd_chunk_rows` points each."""
    step = bwd_chunk_rows(packed.net.cfg, packed.vdirs, packed.hi_lo)
    return [(c0, r, bwd_splits(ws_rows(r, packed.bwd_rows)))
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


def _launch_bwd(packed: PackedMLP, pts: torch.Tensor,
                dirs: Optional[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """The backward: the flat fp32 gradient (``packed.grad_total``) in the
    packed blocks' layout; (S, grad_total) for a stack. The call is walked
    in chunks of at most :func:`bwd_chunk_rows` points (of each scene),
    each phase 1 into one workspace, then phase 2 into the chunk's partial
    slots; the reduction sums every slot in (chunk, split) order. A stack's
    chunk is one launch of each phase over all scenes, so it launches each
    kernel as often as one of its scenes alone. On a card, the bytes are
    checked against the card first (:func:`check_bwd_memory`)."""
    n, dev = pts.shape[0], pts.device
    if g.shape != (n, packed.out_w):
        raise ValueError(f"the cotangent must be ({n}, {packed.out_w}), got "
                         f"{tuple(g.shape)}")
    total = packed.grad_total
    tile = packed.bwd_rows
    scenes = packed.n_scenes
    n_s = n // scenes
    if dev.type == "cuda":
        card = _card_bytes(dev.index if dev.index is not None
                           else torch.cuda.current_device())
        _state_bwd_bytes(_arch_name(packed.net.cfg, packed.vdirs,
                                    packed.hi_lo), scenes, n_s,
                         check_bwd_memory(packed, n_s, card), card)
    chunks = _bwd_chunks(packed, n_s)
    ws = torch.empty(scenes * max((ws_rows(r, tile) for _, r, _ in chunks),
                                  default=0)
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
                      piece(g, c0, r), ws)
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


@dataclasses.dataclass(frozen=True)
class _Call:
    """What one fused-MLP call runs on: its nets (one, or a stack's, one per
    scene), their packed layout (None for CPU tensors, which take the plain
    versions), the encoding's frequencies, the compute type and the hi_lo
    mode."""

    nets: Tuple[NeRFMLP, ...]
    stacked: bool
    packed: Optional[PackedMLP]
    n_freqs: int
    dt: torch.dtype
    hi_lo: bool

    def forward(self, pts, dirs) -> torch.Tensor:
        if self.packed is None:
            out = fused_nerf_mlp_stack_plain(self.nets, pts, dirs,
                                             self.n_freqs, self.dt,
                                             self.hi_lo)
            check_nan([("the output of the fused MLP's plain forward", out)])
            return out
        return _launch(self.packed, pts, dirs)

    def backward(self, pts, dirs, g) -> List[Dict[str, torch.Tensor]]:
        """Each net's gradients, in the order of ``nets``."""
        if self.packed is None:
            grads = fused_nerf_mlp_bwd_stack_plain(self.nets, pts, dirs, g,
                                                   self.n_freqs, self.dt,
                                                   self.hi_lo)
            check_nan([(f"the fused MLP's plain backward's gradient of "
                        f"{name}", t) for gr in grads
                       for name, t in gr.items()])
            return grads
        grads = unpack_grads(self.packed,
                             _launch_bwd(self.packed, pts, dirs, g))
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
        return _Call(nets, stacked, None, cfg.pos_enc_L, dt, hi_lo), dirs
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
    return _Call(nets, stacked, params, cfg.pos_enc_L, dt, hi_lo), dirs


class FusedMLPFunction(torch.autograd.Function):
    """The fused MLP under autograd (``_fused_apply``'s custom VJP,
    ``pallas_mlp.py:530-567``). ``apply(call, pts, dirs, *params)``, the
    parameters of every net of the call in order: the forward kernel (or
    plain forward) of ``call``; the backward runs the backward kernels and
    reduction (or the plain backward) and returns each parameter's
    gradient — every net's of a stack, from its own scene's rows; two
    calls on one net (coarse and fine) are summed by autograd — and zeros
    for points and dirs (``:564``)."""

    @staticmethod
    def forward(ctx, call, pts, dirs, *net_params):
        ctx.call = call
        ctx.where = numerics_where()
        ctx.save_for_backward(pts, dirs)
        return call.forward(pts, dirs)

    @staticmethod
    def backward(ctx, g):
        pts, dirs = ctx.saved_tensors
        with numerics_scope("backward of the "
                            + (ctx.where[-1] if ctx.where else "fused MLP")):
            grads = ctx.call.backward(pts, dirs, g)
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
bwd_workspace.launches = 0
weight_grads.launches = 0
reduce_partials.launches = 0
