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
  ``weight_grads.launches`` and ``reduce_partials.launches``.
* :func:`pack_params` lays a net's weights out for the kernels once
  (transposed to ``(in, out)``, split at the skip and view layers, padded
  to multiples of 16 with zeros, bf16 — (hi, lo) bf16 pairs in the hi_lo
  mode of ``fp32_precision="high"``) together with the forward's layer
  program and the backward's program and job list — at service build, weight
  swap and once per train step, never per call.
* :func:`kernel_fits` and :func:`backward_fits` are the Hopper budgets that
  decide, from the architecture alone, whether a net goes to the kernels
  (the role of ``backward_fits_vmem``, :592-608, for the TPU's VMEM).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from nerfmlp_torch.config import ModelConfig, RenderConfig
from nerfmlp_torch.models.mlp import NeRFMLP
from nerfmlp_torch.ops import _build
from nerfmlp_torch.ops.encoding import positional_encoding

log = logging.getLogger(__name__)

# The forward kernel's fixed shape (csrc/fused_mlp_fwd.cu); checked against
# the built library at load.
TILE_ROWS = 64          # points per block
THREADS = 256
SLAB_ROWS = 32          # weight rows per shared-memory slab
CHUNK_COLS = 256        # output columns per register pass
PAD = 8                 # bf16 elements of padding per shared-memory row
MAX_LAYERS = 48
HEADER_INTS = 22
LAYER_INTS = 11
SMEM_LIMIT = 232_448    # dynamic shared memory one Hopper block may use

# The backward kernels' fixed shape (csrc/fused_mlp_bwd.cu).
BWD_THREADS = 256      # phase 2 and the reduction
BWD_P1_THREADS = 512   # phase 1: 16 warps, 4 x 4 over the tile
BWD_MAX_N = 256         # widest layer phase 1's warp grid covers
BWD_SLAB_K = 16         # weight rows per ring stage of phase 1
BWD_HEADER_INTS = 32
BWD_MAX_BUFS = 8        # shared-memory buffers (offset, ld, cols)
BWD_MAX_MATS = 64       # workspace matrices (column offset, cols)
BWD_OP_INTS = 16
BWD_MAX_OPS = 96
BWD_MATS_BASE = BWD_HEADER_INTS + 3 * BWD_MAX_BUFS
BWD_OPS_BASE = BWD_MATS_BASE + 2 * BWD_MAX_MATS
BWD_TILE_K = 128        # phase 2: dW rows per block
BWD_TILE_N = 128        # phase 2: dW columns per block
BWD_STAGE_ROWS = 64     # phase 2: points per ring stage
BWD_STAGES2 = 3
BWD_JOB_INTS = 10
# Phase 1's points per tile: 128, or 64 in hi_lo mode (two bf16 planes).
BWD_TILE_ROWS = 128
BWD_TILE_ROWS_HI_LO = 64
# How a call is cut: at most BWD_CHUNK_ROWS points per phase-1 / phase-2
# pair (bounds the workspace), and phase 2's rows split in up to
# BWD_MAX_SPLITS ranges of at least BWD_MIN_SPLIT_ROWS points.
BWD_CHUNK_ROWS = 131_072
BWD_MAX_SPLITS = 32
BWD_MIN_SPLIT_ROWS = 2048

# Shared-memory buffers and epilogues of the forward's layer program.
_X, _D, _A, _B = 0, 1, 2, 3
_RELU_BF16, _BF16, _OUT_F32 = 0, 1, 2
# Operations of the backward's phase-1 program.
_FWD, _DX, _LOAD_G = 0, 1, 2


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _smem_layout(enc_k: int, dirs_k: int, hid_k: int, hi_lo: bool):
    """Byte offsets in the forward kernel's dynamic shared memory: the
    buffers X, D, A, B, their lo planes and the weight slab's lo twin
    (empty unless hi_lo), the weight slab, the epilogue stage — and the
    total."""
    off = 0

    def region(nbytes):
        nonlocal off
        start, off = off, off + _align128(nbytes)
        return start

    cols = (enc_k, dirs_k, hid_k, hid_k)
    offs = [region(TILE_ROWS * (c + PAD) * 2 if c else 0) for c in cols]
    offs_lo = [region(TILE_ROWS * (c + PAD) * 2 if c and hi_lo else 0)
               for c in cols]
    slab = SLAB_ROWS * (CHUNK_COLS + PAD) * 2
    off_slab = region(slab)
    off_slab_lo = region(slab if hi_lo else 0)
    off_stage = region((THREADS // 32) * 256 * 4)
    return offs, offs_lo, off_slab, off_slab_lo, off_stage, off


def _hidden_cols(mc: ModelConfig, vdirs: bool) -> int:
    widths = [mc.width] + ([mc.bottleneck_ch, mc.view_width] if vdirs else [])
    return max(_pad16(w) for w in widths)


def smem_bytes(mc: ModelConfig, vdirs: bool, hi_lo: bool = False) -> int:
    """Shared memory one forward block needs for this architecture and
    mode."""
    dirs_k = _pad16(mc.input_ch_views) if vdirs else 0
    return _smem_layout(_pad16(mc.input_ch), dirs_k,
                        _hidden_cols(mc, vdirs), hi_lo)[-1]


@functools.lru_cache(maxsize=None)
def kernel_fits(mc: ModelConfig, vdirs: bool = True,
                hi_lo: bool = False) -> bool:
    """Whether the forward kernel takes this architecture: its
    activations, slabs and stage fit one block's shared memory, and its
    layers the kernel's program. Logged once per architecture and mode."""
    need = smem_bytes(mc, vdirs, hi_lo)
    layers = mc.depth + (4 if vdirs else 1)
    fits = need <= SMEM_LIMIT and layers <= MAX_LAYERS
    log.info(
        "fused MLP kernel budget: depth %d width %d%s%s needs %d B of shared "
        "memory per block (Hopper limit %d B) and %d layers (limit %d): %s",
        mc.depth, mc.width, " +view head" if vdirs else "",
        " hi_lo" if hi_lo else "", need, SMEM_LIMIT, layers, MAX_LAYERS,
        "kernel" if fits else "plain module path",
    )
    return fits


def bwd_tile_rows(hi_lo: bool) -> int:
    """Phase 1's points per tile."""
    return BWD_TILE_ROWS_HI_LO if hi_lo else BWD_TILE_ROWS


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
    """(phase-1 operations, workspace matrices) for an architecture: the
    recomputed forward layers (the output heads excepted), the load of the
    cotangent and the dX chain; the matrices of :func:`_bwd_mats`."""
    fwd = mc.depth + (2 if vdirs else 0)
    dx = mc.depth - 1 + (3 if vdirs else 1)
    return fwd + 1 + dx, len(_bwd_mats(mc, vdirs))


def bwd_scratch_bytes(mc: ModelConfig, vdirs: bool,
                      hi_lo: bool = False) -> int:
    """Workspace bytes per point: every matrix of :func:`_bwd_mats`, bf16
    (two planes in hi_lo mode)."""
    cols = sum(c for _, c in _bwd_mats(mc, vdirs))
    return cols * 2 * (2 if hi_lo else 1)


def _bwd_smem_layout(mc: ModelConfig, vdirs: bool, hi_lo: bool):
    """Phase 1's dynamic shared memory, in bytes: the program; the buffers
    x, d, the two ping-pong activation buffers p0 / p1, and the cotangent's
    gr / gs laid over x when they fit there (x is dead by then); a mask
    slot per ReLU layer; the weight ring, with as many 16-row stages (up
    to 4) as fit. Returns (buffers {name: (offset, ld, cols)}, mask
    offset, ring offset, elements of a stage's hi slab, stages, total
    bytes)."""
    rows = bwd_tile_rows(hi_lo)
    planes = 2 if hi_lo else 1
    n_ops, _ = backward_counts(mc, vdirs)
    off = _align128(4 * (BWD_OPS_BASE + n_ops * BWD_OP_INTS))
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
    hid = _hidden_cols(mc, vdirs)
    region("p0", hid)
    region("p1", hid)
    g_cols = (16, 16) if vdirs else (_pad16(mc.output_ch),)
    over_x = sum(size(c) for c in g_cols) <= size(_pad16(mc.input_ch))
    at = bufs["x"][0] if over_x else None
    for name, c in zip(("gr", "gs"), g_cols):
        end = region(name, c, at)
        at = end if over_x else None
    masks = off
    n_masks = mc.depth + (1 if vdirs else 0)
    off += _align128(n_masks * rows * BWD_MAX_N // 8)  # one bit a value
    stage = BWD_SLAB_K * (hid + PAD)
    stages = min(4, (SMEM_LIMIT - off) // (2 * stage * planes))
    return bufs, masks, off, stage, stages, off + 2 * stage * planes * stages


def bwd_smem_bytes(mc: ModelConfig, vdirs: bool, hi_lo: bool = False) -> int:
    """Shared memory one phase-1 block needs for this architecture."""
    return _bwd_smem_layout(mc, vdirs, hi_lo)[-1]


@functools.lru_cache(maxsize=None)
def backward_fits(mc: ModelConfig, vdirs: bool = True,
                  hi_lo: bool = False) -> bool:
    """Whether the backward kernels take this architecture: phase 1's
    buffers, masks and at least two weight-ring stages fit one block's
    shared memory, every layer it writes is at most ``BWD_MAX_N`` wide,
    and its program and workspace fit the kernel's tables. The workspace,
    :func:`bwd_scratch_bytes` per point, is bounded by the call's chunk of
    ``BWD_CHUNK_ROWS`` points. Logged once per architecture and mode."""
    ops, mats = backward_counts(mc, vdirs)
    stages, smem = _bwd_smem_layout(mc, vdirs, hi_lo)[-2:]
    fits = (stages >= 2 and _hidden_cols(mc, vdirs) <= BWD_MAX_N
            and ops <= BWD_MAX_OPS and mats <= BWD_MAX_MATS)
    log.info(
        "fused MLP backward budget: depth %d width %d%s%s needs %d B of "
        "shared memory per block (%d weight stages; Hopper limit %d B), "
        "%d operations (limit %d), %d workspace matrices (limit %d), %d B "
        "of workspace per point: %s",
        mc.depth, mc.width, " +view head" if vdirs else "",
        " hi_lo" if hi_lo else "", smem, stages, SMEM_LIMIT, ops,
        BWD_MAX_OPS, mats, BWD_MAX_MATS, bwd_scratch_bytes(mc, vdirs, hi_lo),
        "kernel" if fits else "plain module path",
    )
    return fits


# --------------------------------------------------------------------- #
# Weights, packed once for the kernels
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """One net's weights in the kernels' layout, plus both programs.

    ``weights``: every weight block, bf16, each ``(k_pad, n_pad)`` row-major
    in ``(in, out)`` layout — in ``hi_lo`` mode a (hi, lo) pair of such
    blocks, lo right after hi; ``biases``: fp32, each padded to ``n_pad``;
    ``program``: the forward's int32 header + one record per layer (see
    ``fused_mlp_fwd.cu``); ``bwd_program``: the backward's header, buffer
    and matrix tables, phase-1 operations (its first ``bwd_prog_len``
    ints) and phase 2's ``bwd_jobs`` (see ``fused_mlp_bwd.cu``), also on
    the device as ``bwd_program_dev``. ``ws_mats``: each workspace
    matrix's (name, column offset, cols); a workspace of R rows holds
    ``R * ws_cols`` bf16, matrix m at ``R * offset`` as (planes, R, cols).
    ``grad_blocks`` / ``grad_biases`` say where each parameter's gradient
    lies in the backward's flat fp32 output: ``(param, in_start, k, n,
    offset, k_pad, n_pad)`` per weight block and ``(param, offset, n)``
    per bias. ``net`` is the module the blocks came from (the plain path
    and the architecture check read it)."""

    net: NeRFMLP
    vdirs: bool
    hi_lo: bool
    weights: torch.Tensor
    biases: torch.Tensor
    program: np.ndarray
    out_w: int
    bwd_program: np.ndarray
    bwd_program_dev: torch.Tensor
    bwd_prog_len: int
    bwd_jobs: np.ndarray
    bwd_smem: int
    ws_cols: int
    ws_mats: Tuple[Tuple[str, int, int], ...]
    grad_total: int
    grad_blocks: Tuple[Tuple, ...]
    grad_biases: Tuple[Tuple, ...]


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

    layers = []

    def layer(a, b, lin, mode, dst, n_real=0):
        """a/b: (buffer, in_start, (in, out) block) operands; b may be
        None."""
        wa, ka = weight(lin, a[1], a[2])
        wb, kb = weight(lin, b[1], b[2]) if b is not None else (0, 0)
        layers.append([a[0], wa, ka, b[0] if b is not None else 0, wb, kb,
                       bias(lin), _pad16(lin.out_features), mode, dst,
                       n_real])

    kt = lambda lin: lin.weight.detach().float().t()
    with torch.no_grad():
        cur = _X
        for i, lin in enumerate(net.pts_linears):
            k = kt(lin)
            dst = _A if i % 2 == 0 else _B
            if i in mc.skips:  # cat([x, h]) @ W == x @ W[:enc] + h @ W[enc:]
                layer((_X, 0, k[:enc_dim]), (cur, enc_dim, k[enc_dim:]), lin,
                      _RELU_BF16, dst)
            else:
                layer((cur, 0, k), None, lin, _RELU_BF16, dst)
            cur = dst
        other = _B if cur == _A else _A
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

    enc_k = _pad16(enc_dim)
    dirs_k = _pad16(mc.input_ch_views) if vdirs else 0
    hid_k = _hidden_cols(mc, vdirs)
    offs, offs_lo, off_slab, off_slab_lo, off_stage, total = _smem_layout(
        enc_k, dirs_k, hid_k, hi_lo)
    header = [len(layers), n_freqs, enc_dim,
              mc.input_ch_views if vdirs else 0, out_w, int(hi_lo),
              enc_k, dirs_k, hid_k, hid_k, *offs, *offs_lo,
              off_slab, off_slab_lo, off_stage, total]
    program = np.asarray(header + [v for rec in layers for v in rec],
                         dtype=np.int32)
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
        program=program, out_w=out_w,
        bwd_program=bwd_program,
        bwd_program_dev=_device_program(bwd_program.tobytes(), str(dev)),
        bwd_prog_len=jobs_off,
        bwd_jobs=bwd_program[jobs_off:].reshape(n_jobs, BWD_JOB_INTS),
        bwd_smem=int(hdr[_H_SMEM]), ws_cols=int(hdr[_H_WS_COLS]),
        ws_mats=ws_mats, grad_total=g_off + b_off,
        grad_blocks=tuple(grad_blocks), grad_biases=tuple(grad_biases),
    )


@functools.lru_cache(maxsize=64)
def _device_program(prog: bytes, device: str) -> torch.Tensor:
    """A backward program on its device, copied once per architecture: a
    copy from pageable host memory would wait for the device's queue on
    every pack, i.e. every train step."""
    return torch.frombuffer(bytearray(prog), dtype=torch.int32).to(device)


# The backward program's header fields, in the order of fused_mlp_bwd.cu's
# `Header` enum.
_BWD_HEADER = ("n_ops", "prog_len", "n_freqs", "enc_dim", "dirs_dim",
               "g_cols", "gr_cols", "x_buf", "d_buf", "gr_buf", "gs_buf",
               "x_mat", "d_mat", "gr_mat", "gs_mat", "stages", "ring_off",
               "stage_elems", "mask_off", "smem", "ws_cols", "jobs_off",
               "n_jobs")
_H_SMEM, _H_WS_COLS, _H_JOBS_OFF, _H_N_JOBS = (
    _BWD_HEADER.index(k) for k in ("smem", "ws_cols", "jobs_off", "n_jobs"))


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
    bufs, mask_off, ring_off, stage, stages, smem = _bwd_smem_layout(
        mc, vdirs, hi_lo)
    buf = {name: i for i, name in enumerate(bufs)}
    names = _bwd_mats(mc, vdirs)
    mat = {name: i for i, (name, _) in enumerate(names)}
    x, p = buf["x"], (buf["p0"], buf["p1"])
    ops: List[List[int]] = []

    def op(kind, a=-1, wa=0, ka=0, b=-1, wb=0, kb=0, bias=0, n=0,
           mask_in=-1, dst=-1, m=-1, mask_out=-1):
        ops.append([kind, a, wa, ka, b, wb, kb, bias, n, mask_in, dst, m,
                    mask_out, 0, 0, 0])

    def fwd(name, srcs, dst, m, mask_out=-1):
        """dst = act(sum of src @ W + bias); ReLU when it records a mask."""
        blk = blocks[name]
        wa, ka, na, _ = blk[0]
        wb, kb = (blk[1][0], blk[1][1]) if len(blk) > 1 else (0, 0)
        op(_FWD, srcs[0], wa, ka, srcs[1] if len(srcs) > 1 else -1, wb, kb,
           bias_of[name], na, dst=dst, m=mat[m], mask_out=mask_out)

    def dx(srcs, dst, m, mask_in=-1):
        """dst = mask(sum of src @ W^T) for (src, name, part) operands."""
        (sa, na, pa) = srcs[0]
        wa, ka_rows, ka_cols, _ = blocks[na][pa]
        rec = dict(a=sa, wa=wa, ka=ka_cols, n=ka_rows, mask_in=mask_in,
                   dst=dst, m=mat[m])
        if len(srcs) > 1:
            sb, nb, pb = srcs[1]
            rec.update(b=sb, wb=blocks[nb][pb][0], kb=blocks[nb][pb][2])
        op(_DX, **rec)

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
    mat_table, ws_mats, col = [0] * (2 * BWD_MAX_MATS), [], 0
    for i, (name, c) in enumerate(names):
        mat_table[2 * i: 2 * i + 2] = [col, c]
        ws_mats.append((name, col, c))
        col += c * (2 if hi_lo else 1)
    prog_len = BWD_OPS_BASE + BWD_OP_INTS * len(ops)
    header = dict(
        n_ops=len(ops), prog_len=prog_len, n_freqs=n_freqs,
        enc_dim=3 + 6 * n_freqs,
        dirs_dim=mc.input_ch_views if vdirs else 0, g_cols=out_w,
        gr_cols=gr_cols, x_buf=x, d_buf=buf.get("d", -1), gr_buf=buf["gr"],
        gs_buf=buf.get("gs", -1), x_mat=mat["x"], d_mat=mat.get("d", -1),
        gr_mat=mat["g_rgb" if vdirs else "g_out"],
        gs_mat=mat.get("g_sigma", -1), stages=stages, ring_off=ring_off,
        stage_elems=stage, mask_off=mask_off, smem=smem, ws_cols=col,
        jobs_off=prog_len, n_jobs=len(jobs))
    head = [header[k] for k in _BWD_HEADER]
    head += [0] * (BWD_HEADER_INTS - len(head))
    prog = np.asarray(head + buf_table + mat_table
                      + [v for rec in ops + jobs for v in rec], np.int32)
    if len(ops) != backward_counts(mc, vdirs)[0] or len(ops) > BWD_MAX_OPS:
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
    splits both operands of every product (``:347-365``)."""
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
            put("output_linear", wgrad(h_last, g_out), g_out.sum(0))
            dh = rnd(back(g_out, net.output_linear.weight))
        else:
            g_rgb, g_sigma = rnd(g[:, 0:3]), rnd(g[:, 3:4])
            put("rgb_linear", wgrad(v, g_rgb), g_rgb.sum(0))
            dv = back(g_rgb, net.rgb_linear.weight)
            dv = rnd(torch.where(v > 0, dv, torch.zeros_like(dv)))
            put("view_linear", torch.cat([wgrad(bott, dv), wgrad(d, dv)], 1),
                dv.sum(0))
            dbott = rnd(back(dv, net.view_linear.weight[:, :mc.bottleneck_ch]))
            put("bottleneck_linear", wgrad(h_last, dbott), dbott.sum(0))
            put("sigma_linear", wgrad(h_last, g_sigma), g_sigma.sum(0))
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
            put(f"pts_linears.{i}", dw, dacc.sum(0))
            if i > 0:
                dh = rnd(back(dacc, w_h))
    return grads


def reduce_partials_plain(part: torch.Tensor, total: int) -> torch.Tensor:
    """What the reduction kernel computes: the sum of the (G, stride)
    partial rows' first ``total`` columns, added in row order."""
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
    the fp32 value), rows n and on zero."""
    hi_lo = packed.hi_lo
    dt = torch.float32 if hi_lo else torch.bfloat16
    n_freqs = int(packed.bwd_program[_BWD_HEADER.index("n_freqs")])
    terms = _bwd_terms(packed.net, pts, dirs, g, n_freqs, dt, hi_lo)
    ws = torch.zeros(rows * packed.ws_cols, device=pts.device,
                     dtype=torch.bfloat16)
    n = pts.shape[0]
    for m, (name, _, _) in enumerate(packed.ws_mats):
        t = terms[name]
        mat = ws_matrix(packed, ws, m)
        hi = t.to(torch.bfloat16)
        mat[0, :n, :t.shape[1]] = hi
        if hi_lo:
            mat[1, :n, :t.shape[1]] = (t - hi.float()).to(torch.bfloat16)
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
    mode hi*hi + lo*hi + hi*lo) and its db (dY's column sums)."""
    splits = -(-rows // split_rows)
    part = torch.zeros((splits, part_stride(packed.grad_total)),
                       device=ws.device)
    mats = [ws_matrix(packed, ws, m).float()
            for m in range(len(packed.ws_mats))]
    for am, k0, kc, ym, n0, nc, off, ld, db, _ in packed.bwd_jobs.tolist():
        for s in range(splits):
            r0, r1 = s * split_rows, min(rows, (s + 1) * split_rows)
            a = mats[am][:, r0:r1, k0:k0 + kc]
            y = mats[ym][:, r0:r1, n0:n0 + nc]
            prod = a[0].t() @ y[0]
            if packed.hi_lo:
                prod = prod + a[1].t() @ y[0] + a[0].t() @ y[1]
            tile = part[s, off + k0 * ld: off + (k0 + kc) * ld].view(kc, ld)
            tile[:, n0:n0 + nc] = prod
            if db >= 0:
                part[s, db + n0: db + n0 + nc] = y.sum(0).sum(0)
    return part


# --------------------------------------------------------------------- #
# The kernels and their wrappers
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _kernel():
    """The forward's library, with its C signatures declared and its fixed
    shape checked against this module's."""
    lib = _build.load("fused_mlp_fwd")
    fn = lib.fused_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.fused_mlp_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_fwd_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_fwd_constants.argtypes = [ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_int]
    consts = (ctypes.c_int * 8)()
    lib.fused_mlp_fwd_constants(consts, 8)
    want = [TILE_ROWS, THREADS, SLAB_ROWS, CHUNK_COLS, PAD, MAX_LAYERS,
            HEADER_INTS, LAYER_INTS]
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
    lib.fused_mlp_bwd_phase1.argtypes = [vp] * 6 + [i32] * 5 + [vp, i64, vp]
    lib.fused_mlp_bwd_phase1.restype = i32
    lib.fused_mlp_bwd_phase2.argtypes = [vp, i64, vp, vp] + [i32] * 5 + [
        vp, i64, vp]
    lib.fused_mlp_bwd_phase2.restype = i32
    lib.fused_mlp_bwd_reduce.argtypes = [vp, i32, i64, vp, i64, vp]
    lib.fused_mlp_bwd_reduce.restype = i32
    lib.fused_mlp_bwd_error_string.argtypes = [i32]
    lib.fused_mlp_bwd_error_string.restype = ctypes.c_char_p
    lib.fused_mlp_bwd_constants.argtypes = [ctypes.POINTER(i32), i32]
    want = [BWD_THREADS, PAD, BWD_MAX_N, BWD_HEADER_INTS, BWD_MAX_BUFS,
            BWD_MAX_MATS, BWD_OP_INTS, BWD_MAX_OPS, BWD_TILE_K, BWD_TILE_N,
            BWD_STAGE_ROWS, BWD_STAGES2, BWD_JOB_INTS, BWD_TILE_ROWS,
            BWD_TILE_ROWS_HI_LO, BWD_P1_THREADS]
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
    (pts, dirs) contiguous, dirs in the kernel's type."""
    n = pts.shape[0] if pts.dim() == 2 else -1
    dev = pts.device
    if packed.weights.device != dev:
        raise ValueError(f"packed weights on {packed.weights.device}, "
                         f"points on {dev}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (N, 3) float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    pts = pts.contiguous()
    if packed.vdirs:
        views = int(packed.program[3])
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
    prog = packed.program
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_mlp_fwd(
            pts.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            out.data_ptr(), n,
            prog.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), prog.size,
            stream,
        )
    if rc != 0:
        raise RuntimeError("fused_mlp_fwd launch failed: "
                           + lib.fused_mlp_fwd_error_string(rc).decode())
    fused_nerf_mlp.launches += 1
    return out


def reduce_partials(part: torch.Tensor, total: int) -> torch.Tensor:
    """Sum the rows of a (slots, stride) fp32 partial-gradient array in row
    order -> (total,): the reduction kernel for a CUDA tensor (or raise),
    :func:`reduce_partials_plain` for a CPU one. Bit-identical run to run
    and to the plain sum. ``reduce_partials.launches`` counts kernel
    launches."""
    if part.device.type == "cpu":
        return reduce_partials_plain(part, total)
    if (part.dtype != torch.float32 or part.dim() != 2
            or not part.is_contiguous() or part.shape[1] < total
            or part.shape[1] % 4 or part.data_ptr() % 16):
        raise ValueError(f"partials must be a contiguous (slots, >= {total}) "
                         f"float32 array, rows a multiple of 4, got "
                         f"{tuple(part.shape)} {part.dtype}")
    lib = _bwd_kernel()
    out = torch.empty(total, device=part.device, dtype=torch.float32)
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_reduce launch",
                   lib.fused_mlp_bwd_reduce(part.data_ptr(), part.shape[0],
                                            part.shape[1], out.data_ptr(),
                                            total, stream))
    reduce_partials.launches += 1
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
    fill the flat workspace ``ws`` (at least n, rounded up to
    :func:`bwd_tile_rows`, rows per matrix). The kernel for CUDA tensors
    (or raise), :func:`bwd_workspace_plain` for CPU ones.
    ``bwd_workspace.launches`` counts kernel launches."""
    pts, dirs = _check_operands(packed, pts, dirs)
    n, dev = pts.shape[0], pts.device
    if g.shape != (n, packed.out_w) or g.device != dev:
        raise ValueError(f"the cotangent must be ({n}, {packed.out_w}) on "
                         f"{dev}, got {tuple(g.shape)} on {g.device}")
    g = g.to(torch.float32).contiguous()
    tile = bwd_tile_rows(packed.hi_lo)
    cap = _check_ws(packed, ws, -(-n // tile) * tile, dev)
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
            int(packed.hi_lo), n, min(-(-n // tile), _sm_count(index)),
            packed.bwd_smem, ws.data_ptr(), cap, stream))
    bwd_workspace.launches += 1
    return ws


def weight_grads(packed: PackedMLP, ws: torch.Tensor, rows: int,
                 split_rows: int, part: torch.Tensor) -> torch.Tensor:
    """Phase 2: every weight and bias gradient of the workspace's first
    ``rows`` rows (a multiple of ``BWD_STAGE_ROWS``), one fp32 partial slot
    per range of ``split_rows`` rows, into ``part`` (splits, stride). The
    kernel for CUDA tensors (or raise), :func:`weight_grads_plain` for CPU
    ones. ``weight_grads.launches`` counts kernel launches."""
    splits = -(-rows // split_rows)
    stride = part_stride(packed.grad_total)
    if (part.shape != (splits, stride) or part.dtype != torch.float32
            or not part.is_contiguous() or part.device != ws.device
            or rows % BWD_STAGE_ROWS or split_rows % BWD_STAGE_ROWS):
        raise ValueError(f"partials must be a contiguous ({splits}, {stride}) "
                         f"float32 array beside the workspace; rows and "
                         f"split_rows multiples of {BWD_STAGE_ROWS}")
    cap = _check_ws(packed, ws, rows, ws.device)
    if ws.device.type == "cpu":
        return part.copy_(weight_grads_plain(packed, ws, rows, split_rows))
    lib = _bwd_kernel()
    prog = packed.bwd_program_dev
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        _bwd_error(lib, "fused_mlp_bwd_phase2 launch", lib.fused_mlp_bwd_phase2(
            ws.data_ptr(), cap, prog.data_ptr(),
            prog.data_ptr() + 4 * packed.bwd_prog_len, len(packed.bwd_jobs),
            int(packed.hi_lo), rows, splits, split_rows, part.data_ptr(),
            stride, stream))
    weight_grads.launches += 1
    return part


def _launch_bwd(packed: PackedMLP, pts: torch.Tensor,
                dirs: Optional[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """The backward: the flat fp32 gradient (``packed.grad_total``) in the
    packed blocks' layout. The call is walked in chunks of at most
    ``BWD_CHUNK_ROWS`` points, each phase 1 into one workspace, then phase
    2 into the chunk's partial slots; the reduction sums every slot in
    (chunk, split) order."""
    n, dev = pts.shape[0], pts.device
    chunk_rows = BWD_CHUNK_ROWS
    if g.shape != (n, packed.out_w):
        raise ValueError(f"the cotangent must be ({n}, {packed.out_w}), got "
                         f"{tuple(g.shape)}")
    total = packed.grad_total
    tile = bwd_tile_rows(packed.hi_lo)
    ws = torch.empty(-(-min(n, chunk_rows) // tile) * tile * packed.ws_cols,
                     device=dev, dtype=torch.bfloat16)
    chunks = [(c0, min(chunk_rows, n - c0)) for c0 in range(0, n, chunk_rows)]
    plans = [bwd_splits(-(-r // tile) * tile) for _, r in chunks]
    part = torch.empty((sum(s for s, _ in plans), part_stride(total)),
                       device=dev, dtype=torch.float32)
    slot = 0
    for (c0, r), (splits, split_rows) in zip(chunks, plans):
        bwd_workspace(packed, pts[c0:c0 + r],
                      None if dirs is None else dirs[c0:c0 + r],
                      g[c0:c0 + r], ws)
        weight_grads(packed, ws, -(-r // tile) * tile, split_rows,
                     part[slot:slot + splits])
        slot += splits
    if n == 0:
        return torch.zeros(total, device=dev, dtype=torch.float32)
    return reduce_partials(part, total)


def unpack_grads(packed: PackedMLP,
                 flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The flat gradient of the packed blocks -> each parameter's gradient
    in the ``nn.Linear`` layout: (in, out) blocks transposed to (out, in),
    skip and view blocks side by side, padding dropped."""
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
    """What one fused-MLP call runs on: the net, its packed layout (None
    for CPU tensors, which take the plain versions), the encoding's
    frequencies, the compute type and the hi_lo mode."""

    net: NeRFMLP
    packed: Optional[PackedMLP]
    n_freqs: int
    dt: torch.dtype
    hi_lo: bool

    def forward(self, pts, dirs) -> torch.Tensor:
        if self.packed is None:
            return fused_nerf_mlp_plain(self.net, pts, dirs, self.n_freqs,
                                        self.dt, self.hi_lo)
        return _launch(self.packed, pts, dirs)

    def backward(self, pts, dirs, g) -> Dict[str, torch.Tensor]:
        if self.packed is None:
            return fused_nerf_mlp_bwd_plain(self.net, pts, dirs, g,
                                            self.n_freqs, self.dt,
                                            self.hi_lo)
        return unpack_grads(self.packed,
                            _launch_bwd(self.packed, pts, dirs, g))


def _route(params, pts_flat, dirs_enc_flat, cfg: RenderConfig,
           mc: Optional[ModelConfig], backward: bool):
    """(call, dirs) for one call: checks the architecture, and for CUDA
    tensors the kernels' type and budgets (``backward``: the backward's
    too), and packs a bare net (per call: callers pack once and pass the
    layout)."""
    vdirs = bool(cfg.use_viewdirs) and dirs_enc_flat is not None
    mc = mc or cfg.model_config()
    net = params.net if isinstance(params, PackedMLP) else params
    _check_arch(net, mc, vdirs)
    dt = getattr(torch, cfg.compute_dtype)
    hi_lo = dt == torch.float32 and cfg.fp32_precision == "high"
    dirs = dirs_enc_flat if vdirs else None
    if pts_flat.device.type == "cpu":
        return _Call(net, None, cfg.pos_enc_L, dt, hi_lo), dirs
    if dt != torch.bfloat16 and not hi_lo:
        raise ValueError("the CUDA kernels compute in bfloat16 or fp32 "
                         "'high'; fp32 'highest' takes the plain module path")
    if not kernel_fits(mc, vdirs, hi_lo) or (
            backward and not backward_fits(mc, vdirs, hi_lo)):
        raise ValueError(f"depth {mc.depth} width {mc.width} does not fit "
                         "the kernels (see kernel_fits, backward_fits)")
    if (not isinstance(params, PackedMLP) or params.vdirs != vdirs
            or params.hi_lo != hi_lo):
        params = pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    return _Call(net, params, cfg.pos_enc_L, dt, hi_lo), dirs


class FusedMLPFunction(torch.autograd.Function):
    """The fused MLP under autograd (``_fused_apply``'s custom VJP,
    ``pallas_mlp.py:530-567``). ``apply(call, pts, dirs, *net_params)``:
    the forward kernel (or plain forward) of ``call``; the backward runs
    the backward kernel and reduction (or the plain backward) and returns
    each parameter's gradient — two calls on one net (coarse and fine)
    are summed by autograd — and zeros for points and dirs (``:564``)."""

    @staticmethod
    def forward(ctx, call, pts, dirs, *net_params):
        ctx.call = call
        ctx.save_for_backward(pts, dirs)
        return call.forward(pts, dirs)

    @staticmethod
    def backward(ctx, g):
        pts, dirs = ctx.saved_tensors
        grads = ctx.call.backward(pts, dirs, g)
        d_pts = torch.zeros_like(pts) if ctx.needs_input_grad[1] else None
        d_dirs = (torch.zeros_like(dirs)
                  if dirs is not None and ctx.needs_input_grad[2] else None)
        return (None, d_pts, d_dirs,
                *[grads[name] for name, _ in ctx.call.net.named_parameters()])


def fused_nerf_mlp(
    params: Union[NeRFMLP, PackedMLP],
    pts_flat: torch.Tensor,
    dirs_enc_flat: Optional[torch.Tensor],
    cfg: RenderConfig,
    mc: Optional[ModelConfig] = None,
) -> torch.Tensor:
    """Fused encode -> MLP -> raw. pts (N, 3) -> raw (N, 4), or (N,
    output_ch) with ``dirs_enc_flat=None`` / ``use_viewdirs=False``.

    ``params``: the net, or its :func:`pack_params` layout (packed once by
    the caller; a bare net is packed per call). CUDA tensors run the
    kernels — bf16, or fp32 with ``fp32_precision="high"`` (hi_lo); fp32
    'highest' raises — and CPU tensors the plain versions. Differentiable
    with respect to the net's parameters through :class:`FusedMLPFunction`
    (the backward kernel); points and dirs get zero gradients. ``mc``: the
    architecture the net must have (default: the coarse net of ``cfg``)."""
    call, dirs = _route(params, pts_flat, dirs_enc_flat, cfg, mc,
                        backward=torch.is_grad_enabled())
    return FusedMLPFunction.apply(call, pts_flat, dirs,
                                  *call.net.parameters())


def fused_nerf_mlp_bwd(
    params: Union[NeRFMLP, PackedMLP],
    pts_flat: torch.Tensor,
    dirs_enc_flat: Optional[torch.Tensor],
    g: torch.Tensor,
    cfg: RenderConfig,
    mc: Optional[ModelConfig] = None,
) -> Dict[str, torch.Tensor]:
    """The gradient of ``sum(g * fused_nerf_mlp(...))`` for every parameter
    of the net, by name. CUDA tensors run the backward's kernels (or
    raise); CPU tensors :func:`fused_nerf_mlp_bwd_plain`."""
    call, dirs = _route(params, pts_flat, dirs_enc_flat, cfg, mc,
                        backward=True)
    return call.backward(pts_flat, dirs, g)


fused_nerf_mlp.launches = 0
bwd_workspace.launches = 0
weight_grads.launches = 0
reduce_partials.launches = 0
