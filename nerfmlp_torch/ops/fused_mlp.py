"""Fused encode -> MLP -> raw forward: the CUDA kernel, its plain version,
and the wrapper that picks between them by the tensor's device.

Counterpart of ``nerfmlp_tpu/ops/pallas_mlp.py`` (forward only):
``_flatten_params`` (:103-141) becomes :func:`pack_params`, ``_encode_tile``
+ ``_mlp_tile_math`` (:172-246) are the kernel in
``csrc/fused_mlp_fwd.cu`` (which notes what bounds it and how it is built
for Hopper) and :func:`fused_nerf_mlp_plain`, and ``fused_nerf_mlp``
(:611-689) is :func:`fused_nerf_mlp`.

* :func:`fused_nerf_mlp` runs the kernel for CUDA tensors — or raises —
  and the plain version for CPU tensors. Nothing falls back from one to
  the other. ``fused_nerf_mlp.launches`` counts kernel launches.
* :func:`pack_params` lays a net's weights out for the kernel once
  (transposed to ``(in, out)``, split at the skip and view layers, padded
  to multiples of 16 with zeros, bf16 — (hi, lo) bf16 pairs in the hi_lo
  mode of ``fp32_precision="high"``) — at service build and on every
  weight swap, never per tile.
* :func:`kernel_fits` is the Hopper budget that decides, from the
  architecture alone, whether a net goes to the kernel (the role of
  ``backward_fits_vmem``, :592-608, for the TPU's VMEM).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
from typing import Optional, Union

import numpy as np
import torch

from nerfmlp_torch.config import ModelConfig, RenderConfig
from nerfmlp_torch.models.mlp import NeRFMLP
from nerfmlp_torch.ops import _build
from nerfmlp_torch.ops.encoding import positional_encoding

log = logging.getLogger(__name__)

# The kernel's fixed shape (csrc/fused_mlp_fwd.cu); checked against the
# built library at load.
TILE_ROWS = 64          # points per block
THREADS = 256
SLAB_ROWS = 32          # weight rows per shared-memory slab
CHUNK_COLS = 256        # output columns per register pass
PAD = 8                 # bf16 elements of padding per shared-memory row
MAX_LAYERS = 48
HEADER_INTS = 22
LAYER_INTS = 11
SMEM_LIMIT = 232_448    # dynamic shared memory one Hopper block may use

# Shared-memory buffers and epilogues of the kernel's layer program.
_X, _D, _A, _B = 0, 1, 2, 3
_RELU_BF16, _BF16, _OUT_F32 = 0, 1, 2


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _smem_layout(enc_k: int, dirs_k: int, hid_k: int, hi_lo: bool):
    """Byte offsets in the kernel's dynamic shared memory: the buffers X,
    D, A, B, their lo planes and the weight slab's lo twin (empty unless
    hi_lo), the weight slab, the epilogue stage — and the total."""
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
    """Shared memory one block needs for this architecture and mode."""
    dirs_k = _pad16(mc.input_ch_views) if vdirs else 0
    return _smem_layout(_pad16(mc.input_ch), dirs_k,
                        _hidden_cols(mc, vdirs), hi_lo)[-1]


@functools.lru_cache(maxsize=None)
def kernel_fits(mc: ModelConfig, vdirs: bool = True,
                hi_lo: bool = False) -> bool:
    """Whether the kernel takes this architecture: its activations, slabs
    and stage fit one block's shared memory, and its layers the kernel's
    program. Wider nets go to the plain module path. Logged once per
    architecture and mode."""
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


# --------------------------------------------------------------------- #
# Weights, packed once for the kernel
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """One net's weights in the kernel's layout, plus the layer program.

    ``weights``: every weight block, bf16, each ``(k_pad, n_pad)`` row-major
    in ``(in, out)`` layout — in ``hi_lo`` mode a (hi, lo) pair of such
    blocks, lo right after hi; ``biases``: fp32, each padded to ``n_pad``;
    ``program``: int32 header + one record per layer (see the CUDA
    source). ``net`` is the module the blocks came from (the plain path
    and the architecture check read it)."""

    net: NeRFMLP
    vdirs: bool
    hi_lo: bool
    weights: torch.Tensor
    biases: torch.Tensor
    program: np.ndarray
    out_w: int


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
    """Lay ``net`` out for the kernel, on the net's device; ``hi_lo``
    splits every weight into a (hi, lo) bf16 pair."""
    mc = net.cfg
    if vdirs and not mc.use_viewdirs:
        raise ValueError("viewdirs given to a net without a view head")
    dev = net.pts_linears[0].weight.device
    enc_dim = 3 + 6 * n_freqs
    if enc_dim != mc.input_ch:
        raise ValueError(f"pos_enc_L={n_freqs} gives {enc_dim} encoded "
                         f"channels; the net takes {mc.input_ch}")
    w_parts, b_parts = [], []
    w_off = b_off = 0

    def weight(k: torch.Tensor):  # (in, out) fp32 -> (offset, padded rows)
        nonlocal w_off
        kp, np_ = _pad16(k.shape[0]), _pad16(k.shape[1])
        blk = torch.zeros(kp, np_, device=dev, dtype=torch.float32)
        blk[: k.shape[0], : k.shape[1]] = k
        hi = blk.to(torch.bfloat16)
        w_parts.append(hi.reshape(-1))
        if hi_lo:
            w_parts.append((blk - hi.float()).to(torch.bfloat16).reshape(-1))
        off, w_off = w_off, w_off + kp * np_ * (2 if hi_lo else 1)
        return off, kp

    def bias(b: torch.Tensor) -> int:
        nonlocal b_off
        bp = torch.zeros(_pad16(b.shape[0]), device=dev, dtype=torch.float32)
        bp[: b.shape[0]] = b
        b_parts.append(bp)
        off, b_off = b_off, b_off + bp.shape[0]
        return off

    layers = []

    def layer(a, b, lin, mode, dst, n_real=0):
        """a/b: (buffer, (in, out) kernel block) operands; b may be None."""
        wa, ka = weight(a[1])
        wb, kb = weight(b[1]) if b is not None else (0, 0)
        layers.append([a[0], wa, ka, b[0] if b is not None else 0, wb, kb,
                       bias(lin.bias.detach().float()),
                       _pad16(lin.out_features), mode, dst, n_real])

    with torch.no_grad():
        cur = _X
        for i, lin in enumerate(net.pts_linears):
            k = lin.weight.detach().float().t()
            dst = _A if i % 2 == 0 else _B
            if i in mc.skips:  # cat([x, h]) @ W == x @ W[:enc] + h @ W[enc:]
                layer((_X, k[:enc_dim]), (cur, k[enc_dim:]), lin,
                      _RELU_BF16, dst)
            else:
                layer((cur, k), None, lin, _RELU_BF16, dst)
            cur = dst
        other = _B if cur == _A else _A
        if vdirs:
            kt = lambda lin: lin.weight.detach().float().t()
            kv = kt(net.view_linear)
            bott = mc.bottleneck_ch
            layer((cur, kt(net.sigma_linear)), None, net.sigma_linear,
                  _OUT_F32, 3, 1)
            layer((cur, kt(net.bottleneck_linear)), None,
                  net.bottleneck_linear, _BF16, other)
            layer((other, kv[:bott]), (_D, kv[bott:]), net.view_linear,
                  _RELU_BF16, cur)
            layer((cur, kt(net.rgb_linear)), None, net.rgb_linear,
                  _OUT_F32, 0, 3)
            out_w = 4
        else:
            out_w = mc.output_ch
            layer((cur, net.output_linear.weight.detach().float().t()), None,
                  net.output_linear, _OUT_F32, 0, out_w)

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
    return PackedMLP(
        net=net, vdirs=vdirs, hi_lo=hi_lo,
        weights=torch.cat(w_parts).contiguous(),
        biases=torch.cat(b_parts).contiguous(),
        program=program, out_w=out_w,
    )


# --------------------------------------------------------------------- #
# The plain version: same function, same rounding points, plain PyTorch
# --------------------------------------------------------------------- #
def _split_bf16(a: torch.Tensor):
    """fp32 -> (hi, lo) bf16-valued fp32 pair with hi + lo ~= a."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def fused_nerf_mlp_plain(net: NeRFMLP, pts: torch.Tensor,
                         dirs: Optional[torch.Tensor], n_freqs: int,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         hi_lo: bool = False) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: pts (N, 3) -> (N, 4).

    "bf16 operands, fp32 accumulation" is ``a.to(bf16).float() @
    w.to(bf16).float()`` — ``torch.matmul`` on bf16 tensors would round its
    OUTPUT to bf16, which the kernel does not. Matmuls run in true fp32
    (TF32 off). ``hi_lo``: three bf16 products per matmul, hi@hi + hi@lo +
    lo@hi, with fp32 activations (``pallas_mlp.py:68-100``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = net.cfg
    f32 = torch.float32
    dt = f32 if hi_lo else compute_dtype

    def rnd(x):
        return x.to(dt).float()

    def dot(a, w):  # w: an nn.Linear weight, (out, in)
        if hi_lo:
            a_hi, a_lo = _split_bf16(a)
            w_hi, w_lo = _split_bf16(w.float())
            return a_hi @ w_hi.t() + a_hi @ w_lo.t() + a_lo @ w_hi.t()
        return rnd(a) @ rnd(w.float()).t()

    x = rnd(positional_encoding(pts.to(f32), n_freqs))
    enc = x.shape[-1]
    h = x
    with torch.no_grad():
        for i, lin in enumerate(net.pts_linears):
            if i in mc.skips:
                acc = dot(x, lin.weight[:, :enc]) + dot(h, lin.weight[:, enc:])
            else:
                acc = dot(h, lin.weight)
            h = rnd(torch.relu(acc + lin.bias.float()))
        if dirs is None:
            return dot(h, net.output_linear.weight) + net.output_linear.bias
        d = rnd(dirs.to(f32))
        bott_ch = mc.bottleneck_ch
        bott = rnd(dot(h, net.bottleneck_linear.weight)
                   + net.bottleneck_linear.bias)
        wv = net.view_linear.weight
        v = rnd(torch.relu(dot(bott, wv[:, :bott_ch]) + dot(d, wv[:, bott_ch:])
                           + net.view_linear.bias))
        rgb = dot(v, net.rgb_linear.weight) + net.rgb_linear.bias
        sigma = dot(h, net.sigma_linear.weight) + net.sigma_linear.bias
        return torch.cat([rgb, sigma], dim=-1)


# --------------------------------------------------------------------- #
# The kernel and the wrapper
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library, with its C signatures declared and its fixed
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


def _launch(packed: PackedMLP, pts: torch.Tensor,
            dirs: Optional[torch.Tensor]) -> torch.Tensor:
    n = pts.shape[0]
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
    for t in (pts, dirs, packed.weights, packed.biases):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
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
    kernel — bf16, or fp32 with ``fp32_precision="high"`` (hi_lo); fp32
    'highest' raises — and CPU tensors the plain version. ``mc``: the
    architecture the net must have (default: the coarse net of ``cfg``)."""
    vdirs = bool(cfg.use_viewdirs) and dirs_enc_flat is not None
    mc = mc or cfg.model_config()
    net = params.net if isinstance(params, PackedMLP) else params
    _check_arch(net, mc, vdirs)
    dt = getattr(torch, cfg.compute_dtype)
    hi_lo = dt == torch.float32 and cfg.fp32_precision == "high"
    dirs = dirs_enc_flat if vdirs else None
    if pts_flat.device.type == "cpu":
        return fused_nerf_mlp_plain(net, pts_flat, dirs, cfg.pos_enc_L, dt,
                                    hi_lo)
    if dt != torch.bfloat16 and not hi_lo:
        raise ValueError("the CUDA kernel computes in bfloat16 or fp32 "
                         "'high'; fp32 'highest' takes the plain module path")
    if not kernel_fits(mc, vdirs, hi_lo):
        raise ValueError(f"depth {mc.depth} width {mc.width} does not fit "
                         "the kernel (see kernel_fits)")
    if (not isinstance(params, PackedMLP) or params.vdirs != vdirs
            or params.hi_lo != hi_lo):
        params = pack_params(net, cfg.pos_enc_L, vdirs, hi_lo)
    return _launch(params, pts_flat, dirs)


fused_nerf_mlp.launches = 0
