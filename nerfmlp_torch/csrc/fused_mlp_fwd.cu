// Fused NeRF-MLP forward for Hopper (sm_90a): positional encoding, the whole
// trunk and both heads for tiles of points in one launch.
//
// Replaces the TPU kernel `_fwd_kernel` (nerfmlp_tpu/ops/pallas_mlp.py:264,
// launched by `_pallas_forward`, :275-309). It computes the same function
// with the same rounding points: bf16 operands with fp32 accumulation; bias
// added in fp32, then ReLU, then rounding to bf16 for every trunk layer; the
// bottleneck rounded to bf16 without ReLU; the view layer ReLU then bf16;
// rgb and sigma left in fp32; the encoding in full precision
// (mlp_tile.cuh's encode), rounded to bf16. A template flag adds the TPU
// kernel's hi_lo mode (fp32_precision="high", pallas_mlp.py:68-100):
// activations stay fp32-grade as (hi, lo) bf16 planes, each weight is a
// (hi, lo) pair of bf16 blocks, and every matmul is hi@hi + lo@hi + hi@lo
// into the same fp32 accumulators.
//
// What bounds it. One point costs 2 * 593,408 FLOP at 8x256 with the view
// head; device memory sees only 12 B of points, 54 B of dirs and 16 B of
// output per point. So the work is compute-bound by about 50x against the
// card's memory rate: the bf16 tensor cores set the floor (0.629 ms for the
// 524,288-point fine serving call at 989 TFLOP/s).
//
// Design: the core of the backward's phase 1 (fused_mlp_bwd.cu), which
// recomputes this same forward.
//   * A persistent grid (one block of 16 warps per SM) walks tiles of 128
//     points (64 in hi_lo, and where two 128-row activation buffers of the
//     net's width do not fit shared memory, e.g. widths 320-768; 32 in
//     hi_lo past width 320, where two planes of 64-row buffers do not).
//     The shallow wide nets take smaller tiles still: bf16 32 points from
//     width 784 and 16 at depth 1 from 1616, hi_lo 16 from 720 (up to the
//     JAX gate's 1696 / 1472), where a larger tile's two activation
//     buffers leave no room for two weight stages.
//     Every block streams the ~1.19 MB of weights from L2 once per tile:
//     9.3 KB per point, half of what the first 64-point, one-tile-per-block
//     design read.
//   * The tile's activations stay in shared memory: the encoded points
//     (kept for the skip layer), the encoded view directions and two
//     ping-pong buffers for a layer's input and output. Only the output
//     heads' real columns leave the block, straight from registers.
//   * Each warp owns 32 x 64 of a 128 x 256 output pass (16 x 64 of a
//     64 x 256 pass, 16 x 32 of a 32 x 256 one, 16 x 16 of a 16 x 256 one:
//     mlp_tile.cuh's WarpGrid): mma.sync m16n8k16 bf16 into fp32
//     accumulators, A fragments from the activation buffers and B
//     fragments from the weight ring, both by ldmatrix. A layer wider
//     than 256 columns is cut into column passes by the Python wrapper,
//     each a record of the program.
//   * Weights stream through a cp.async ring of k-slabs: 32 rows per stage
//     (16 in hi_lo, where the (hi, lo) planes take twice the room), up to
//     4 stages as they fit. A narrow operation takes as many rows per
//     stage as its slot holds: every stage costs a barrier and a wait
//     whatever its width, so the sigma and rgb heads take one stage per
//     operand instead of 8 and 4. The slab sequence runs across the
//     program's operations and across the block's tiles, so the ring never
//     drains; each thread's 16-byte chunk of an operand's slabs is set up
//     once per operand; one block barrier per stage both publishes the
//     stage and frees the oldest slot.
//   * The epilogue works in registers: fp32 bias, ReLU, bf16 (pairs), into
//     the destination buffer; the heads write their real columns to the
//     (n, out_w) fp32 output, rows at or past n masked. The barrier of the
//     next operation's first stage orders an epilogue's writes before any
//     read of them, so operations need no barrier of their own.
//   * The skip layer's cat([x, h]) @ W is two operands accumulated into the
//     same registers, x @ W[:enc] + h @ W[enc:], as is the view layer's
//     cat([bottleneck, dirs]) @ Wv.
//
// Measured (chip_smoke.py, one H100 80GB HBM3 at 700 W): about 4.0 ms for
// the 524,288-point served fine call and 1.0 ms for the 131,072-point
// train fine call, ~150 TFLOP/s: 2.6x faster than the first design (wmma,
// one 64-point tile per block, synchronous slab loads), 6.4x the bound.
// No part dominates (scripts/bwd_ablate.py): without the mma ~20% less,
// without the stage wait and barrier ~17%, without the weight loads ~17%,
// without the B-fragment ldmatrix ~11%, without the encoding (sinf/cosf
// and the point loads) ~8%. The next step is wgmma with a producer warp
// and TMA multicast of the weight slabs (PERF.md).
//
// The network arrives as a program built by the Python wrapper
// (nerfmlp_torch/ops/fused_mlp.py, pack_params) and copied into shared
// memory: a header, a table of the four buffers and one record per column
// pass of each layer naming its operand buffers, weight blocks, bias,
// width, epilogue and destination; its bytes are the only bound on depth
// (866 layers: 55 KB, which a 128-point tile's buffers leave room for at
// width 16). Every dimension is padded to a multiple of 16 with zero
// weights, zero biases and zero activations, so padding adds exactly
// zero. Rows past n are zero on the way in and never written on the
// way out.
//
// A scene axis (the TPU kernel under jax.vmap, whose batching rule gives the
// pallas_call a leading grid axis over scenes): one launch runs S nets of
// one architecture, scene s with its own weights and biases (at s times a
// stride in each buffer), its n points, dirs and output rows (scene-major,
// at s * n). The tile loop runs over S * ceil(n / T) tiles; a tile never
// straddles two scenes, and each tile decodes (scene, local tile). The
// weight ring's fetch stream, which runs ahead into the block's next tile,
// keeps the scene of the tile it fetches for. Every output row is computed
// as in a launch of its scene alone, so scene s's rows equal a single-scene
// launch's bit for bit. S = 1 is the single net.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

using namespace mlp_tile;

constexpr int kThreads = 512;     // 16 warps, 4 x 4 over an output pass
constexpr int kMaxN = 256;        // output columns of one pass
constexpr int kHeaderInts = 16;
constexpr int kMaxBufs = 4;       // X, D, P0, P1: offset, ld, cols
constexpr int kOpInts = 16;
constexpr int kBufsBase = kHeaderInts;
constexpr int kOpsBase = kBufsBase + 3 * kMaxBufs;

// Header fields.
enum Header {
  hNOps = 0, hProgLen, hNFreqs, hEncDim, hDirsDim, hOutW, hHiLo, hRows,
  hKSub, hStages, hRingOff, hStageElems, hSmem
};
// Buffers of the encoded points and dirs (the activations: 2 and 3).
enum Buffer { kX = 0, kD = 1 };
// Epilogues.
enum Mode { kReluBf16 = 0, kBf16 = 1, kOutF32 = 2 };
// Operation record fields: columns [c, c + n) of a layer,
//   dst[:, col:col + n] = act(A @ WA + B @ WB + bias)
// with WA the (k_a, n) block at weight offset w_a, row stride w_ld (the
// layer's padded width; in hi_lo its lo plane k_a * w_ld further on), B and
// WB likewise (k_b == 0: none). kOutF32: out[:, dst + j] for j < n_real.
// kr: weight rows per ring stage, a multiple of 16 — KS, or more for a
// narrow operation whose slab of kr x (n + kPad) still fits a ring slot
// (the sigma and rgb heads take one stage per operand).
enum Field {
  fSrcA = 0, fWA, fKA, fSrcB, fWB, fKB, fBias, fN, fWLd, fMode, fDst, fCol,
  fNReal, fKR
};

// One slab thread per 16-byte chunk of 16 rows: 16 x 32 chunks.
static_assert(16 * (kMaxN / 8) == kThreads, "a slab row set per thread");

// A value into an activation buffer: bf16, or in hi_lo mode the pair
// (hi, lo) = (bf16(v), bf16(v - hi)) — the split the TPU kernel takes of
// its fp32 activations before each product (pallas_mlp.py:68-100).
template <bool kHiLo>
__device__ __forceinline__ void put(bf16* p, int plane, float v) {
  const bf16 h = __float2bfloat16(v);
  p[0] = h;
  if (kHiLo) p[plane] = __float2bfloat16(v - __bfloat162float(h));
}

// kHiLo: (hi, lo) planes and three products. T: points per tile (128, 64,
// 32 or 16; mlp_tile.cuh's WarpGrid<T> lays the 16 warps over it: at 16, 1
// x 16 warps of 16 columns, one m16 tile each). Nothing else depends on T:
// the slab loader's threads cover 16 rows of a stage whatever the tile,
// and the epilogue masks the output rows at or past n per row. KSUB:
// 16-row k-steps per ring stage of a full width operation.
template <bool kHiLo, int T, int KSUB>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fwd_kernel(const float* __restrict__ pts,
                     const void* __restrict__ dirs,
                     const bf16* __restrict__ weights,
                     const float* __restrict__ biases,
                     float* __restrict__ out,
                     const int* __restrict__ prog_in, int prog_len, int n,
                     int n_tiles, long long w_stride, int b_stride) {
  using G = WarpGrid<T>;
  constexpr int MT = G::kMT;      // m16 tiles per warp
  constexpr int NT = G::kNT;      // n8 tiles per warp
  constexpr int KS = 16 * KSUB;   // weight rows per ring stage
  extern __shared__ __align__(128) unsigned char smem[];
  int* prog = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < prog_len; i += kThreads) prog[i] = prog_in[i];
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = (warp / G::kCG) * MT * 16;  // the warp's first row
  const int cb = (warp % G::kCG) * G::kWN;   // ... and first column of a pass
  const int* bufs = prog + kBufsBase;
  const int* ops = prog + kOpsBase;
  const int n_ops = prog[hNOps];
  const int stages = prog[hStages];
  const int half = prog[hStageElems];  // a stage's lo plane follows its hi
  const int stage_elems = half * (kHiLo ? 2 : 1);
  bf16* ring = reinterpret_cast<bf16*>(smem + prog[hRingOff]);
  auto bufp = [&](int b) { return reinterpret_cast<bf16*>(smem + bufs[3 * b]); };
  auto bld = [&](int b) { return bufs[3 * b + 1]; };
  auto stages_of = [](int k, int kr) { return (k + kr - 1) / kr; };
  auto steps = [&](int oi) {
    const int* o = ops + oi * kOpInts;
    return stages_of(o[fKA], o[fKR]) + stages_of(o[fKB], o[fKR]);
  };
  const int tiles_per_scene = (n + T - 1) / T;

  // The slab stream: every operation's kr-row k-slabs, operand A's then
  // B's, in program order, tile after tile. A slab holds rows k0..k0+kr-1
  // of the operation's columns of W, stored [kr][n + kPad]; rows past the
  // operand's k are not loaded (and not read). A thread's chunk (row
  // tid / 32, 16-byte column chunk tid % 32, and the same chunk every 16
  // rows further on) is set up once per operand (f_operand); fetch() then
  // issues it, one slab further each call, or an empty group at the end.
  // f_w: the weights of the scene of the tile being fetched for.
  const bf16* f_w = weights;
  int f_tile = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
  const bf16* f_src = weights;
  long long f_lo = 0, f_rows16 = 0;
  int f_dst = -1, f_ld = 0, f_row = 0, f_k = 0, f_kr = KS;
  int f_op = -1, f_j = 0, f_steps = 0, f_steps_a = 0;
  auto f_operand = [&](const int* o, bool second) {
    const int k = second ? o[fKB] : o[fKA], nn = o[fN], wld = o[fWLd];
    const int r = tid >> 5, cc = tid & 31;
    f_lo = static_cast<long long>(k) * wld;
    f_ld = nn + kPad;
    f_dst = cc < nn / 8 ? r * f_ld + cc * 8 : -1;
    f_src = f_w + (second ? o[fWB] : o[fWA]) +
            static_cast<long long>(r) * wld + cc * 8;
    f_rows16 = 16LL * wld;
    f_row = r;
    f_k = k;
    f_kr = o[fKR];
  };
  int per_tile = 0;
  for (int oi = 0; oi < n_ops; ++oi) per_tile += steps(oi);
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
      ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
      : 0;
  long long f_left = static_cast<long long>(my_tiles) * per_tile;
  auto fetch = [&](int slot) {
    if (f_left > 0) {
      while (f_j >= f_steps) {
        if (f_op + 1 == n_ops || f_op < 0) {  // the block's next tile
          f_op = 0;
          f_tile += gridDim.x;
          f_w = weights + (f_tile / tiles_per_scene) * w_stride;
        } else {
          ++f_op;
        }
        f_j = 0;
        f_steps = steps(f_op);
        f_steps_a = stages_of(ops[f_op * kOpInts + fKA], ops[f_op * kOpInts + fKR]);
        if (f_steps) f_operand(ops + f_op * kOpInts, false);
      }
      if (f_j == f_steps_a) f_operand(ops + f_op * kOpInts, true);
      if (f_dst >= 0) {
        bf16* d = ring + slot * stage_elems + f_dst;
        const bf16* src = f_src;
#pragma unroll 2
        for (int s = 0; s < f_kr && f_row + s < f_k; s += 16) {
          cp_async16(d + s * f_ld, src);
          if (kHiLo) cp_async16(d + s * f_ld + half, src + f_lo);
          src += f_rows16;
        }
      }
      f_src += (f_kr / 16) * f_rows16;
      f_row += f_kr;
      ++f_j;
      --f_left;
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);
  int consumed = 0;

  float acc[MT][NT][4];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // The tile's scene and its first point within the scene; the scene's
    // points, dirs, output rows and biases.
    const int scene = tile / tiles_per_scene;
    const int row0 = (tile - scene * tiles_per_scene) * T;
    const long long base = static_cast<long long>(scene) * n;
    const float* pts_s = pts + 3 * base;
    const float* bias_s = biases + static_cast<long long>(scene) * b_stride;
    __syncthreads();  // the previous tile's reads of X and D are done

    // Encoded points, then the encoded view directions (bf16, or fp32 in
    // hi_lo mode); zeros past n and in the padding columns.
    {
      const int ldx = bld(kX), xc = bufs[3 * kX + 2], enc_dim = prog[hEncDim];
      bf16* xs = bufp(kX);
      for (int idx = tid; idx < T * xc; idx += kThreads) {
        const int r = idx / xc, j = idx - r * xc, g = row0 + r;
        const float v = (g < n && j < enc_dim) ? encode(pts_s, g, j) : 0.f;
        put<kHiLo>(xs + r * ldx + j, T * ldx, v);
      }
    }
    if (prog[hDirsDim] > 0) {
      const int ldd = bld(kD), dc = bufs[3 * kD + 2], dirs_dim = prog[hDirsDim];
      bf16* ds = bufp(kD);
      for (int idx = tid; idx < T * dc; idx += kThreads) {
        const int r = idx / dc, j = idx - r * dc, g = row0 + r;
        float v = 0.f;
        if (g < n && j < dirs_dim) {
          const long long at = (base + g) * dirs_dim + j;
          v = kHiLo ? static_cast<const float*>(dirs)[at]
                    : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
        }
        put<kHiLo>(ds + r * ldd + j, T * ldd, v);
      }
    }

    for (int oi = 0; oi < n_ops; ++oi) {
      const int* o = ops + oi * kOpInts;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      // Per operation: each operand's A rows for this lane, and where the
      // lane's B fragments sit in a slab (column pair p at + 16 p).
      const int nn = o[fN], ka = o[fKA], kb = o[fKB], kr = o[fKR];
      const int steps_a = stages_of(ka, kr), n_steps = steps_a + stages_of(kb, kr);
      const int lda = bld(o[fSrcA]), ldb = kb ? bld(o[fSrcB]) : 0;
      const bf16* a_op =
          bufp(o[fSrcA]) + (rb + (lane & 15)) * lda + (lane >> 4) * 8;
      const bf16* b_op =
          kb ? bufp(o[fSrcB]) + (rb + (lane & 15)) * ldb + (lane >> 4) * 8
             : a_op;
      const int sld = nn + kPad;
      const int b_frag = (lane & 15) * sld + cb + (lane >> 4) * 8;
      // One 16-row k-step: A fragments at a_s (row stride ld), B from the
      // slab's rows at b_s.
      auto k_step = [&](const bf16* a_s, const bf16* b_s, int ld) {
        uint32_t a[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldsm_x4(a[mt], a_s + mt * 16 * ld);
          if (kHiLo) ldsm_x4(al[mt], a_s + mt * 16 * ld + T * ld);
        }
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          if (cb + 16 * p >= nn) continue;  // warp-uniform
          uint32_t b[4], bl[4];
          const bf16* q = b_s + p * 16;
          ldsm_x4_t(b, q);
          if (kHiLo) ldsm_x4_t(bl, q + half);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][2 * p], a[mt], b[0], b[1]);
            mma(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
            if (kHiLo) {
              mma(acc[mt][2 * p], al[mt], b[0], b[1]);
              mma(acc[mt][2 * p + 1], al[mt], b[2], b[3]);
              mma(acc[mt][2 * p], a[mt], bl[0], bl[1]);
              mma(acc[mt][2 * p + 1], a[mt], bl[2], bl[3]);
            }
          }
        }
      };
      for (int j = 0; j < n_steps; ++j) {
        cp_async_wait_n(stages - 2);
        __syncthreads();  // the slab is in; the oldest slot is free
        fetch((consumed + stages - 1) % stages);
        const bf16* slab = ring + (consumed % stages) * stage_elems + b_frag;
        ++consumed;
        const bool second = j >= steps_a;
        const int ld = second ? ldb : lda, k = second ? kb : ka;
        const int k0 = kr * (second ? j - steps_a : j);
        const bf16* a_base = (second ? b_op : a_op) + k0;
        if (kr == KS) {  // a full-width operation: unrolled k-steps
#pragma unroll
          for (int s = 0; s < KSUB; ++s) {
            if (s > 0 && k0 + 16 * s >= k) break;  // warp-uniform
            k_step(a_base + 16 * s, slab + s * 16 * sld, ld);
          }
        } else {
          for (int s = 0; s < kr && k0 + s < k; s += 16)
            k_step(a_base + s, slab + s * sld, ld);
        }
      }

      // Epilogue, in registers: fp32 bias, then ReLU and the activation
      // type into the destination buffer, or the real columns in fp32 to
      // the output. Accumulator acc[mt][nt][2 hh + e] is row rb + 16 mt +
      // lane / 4 + 8 hh, column cb + 8 nt + 2 (lane % 4) + e of the pass.
      const int mode = o[fMode], dst = o[fDst];
      const float* bias = bias_s + o[fBias];
      const int n_real = o[fNReal], out_w = prog[hOutW];
      bf16* d = mode == kOutF32 ? nullptr : bufp(dst) + o[fCol];
      const int ldd = mode == kOutF32 ? 0 : bld(dst);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (cb + nt * 8 >= nn) continue;  // warp-uniform
        const int col = cb + nt * 8 + 2 * (lane & 3);
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = rb + mt * 16 + (lane >> 2) + 8 * hh;
            float v0 = acc[mt][nt][2 * hh] + b0;
            float v1 = acc[mt][nt][2 * hh + 1] + b1;
            if (mode == kOutF32) {
              const int g = row0 + row;
              if (g < n) {
                float* at = out + (base + g) * out_w + dst + col;
                if (col < n_real) at[0] = v0;
                if (col + 1 < n_real) at[1] = v1;
              }
              continue;
            }
            if (mode == kReluBf16) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
            bf16* at = d + row * ldd + col;
            *reinterpret_cast<__nv_bfloat162*>(at) = __halves2bfloat162(h0, h1);
            if (kHiLo)
              store2(at + T * ldd, v0 - __bfloat162float(h0),
                     v1 - __bfloat162float(h1));
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kHiLo, int T, int KSUB>
cudaError_t launch(const float* pts, const void* dirs, const bf16* weights,
                   const float* biases, float* out, const int* prog,
                   int prog_len, int n, int n_scenes, long long w_stride,
                   int b_stride, int grid, int smem, cudaStream_t stream) {
  const int n_tiles = n_scenes * ((n + T - 1) / T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<kHiLo, T, KSUB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_fwd_kernel<kHiLo, T, KSUB><<<grid, kThreads, smem, stream>>>(
      pts, dirs, weights, biases, out, prog, prog_len, n, n_tiles, w_stride,
      b_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's fixed shape, for the wrapper to check against its own.
int fused_mlp_fwd_constants(int* out, int len) {
  const int c[] = {kThreads, kPad, kMaxN, kHeaderInts, kMaxBufs, kOpInts};
  const int count = static_cast<int>(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < len && i < count; ++i) out[i] = c[i];
  return count;
}

const char* fused_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n_scenes scenes of n points each, scene-major: pts (n_scenes * n, 3)
// fp32; dirs (n_scenes * n, dirs_dim), bf16 (fp32 in hi_lo mode) or null;
// weights bf16 and biases fp32, scene s's at s * w_stride and s * b_stride
// elements; out (n_scenes * n, out_w) fp32; prog (int32): the program,
// whose first prog_len ints go to shared memory — all on the current
// device. rows (points per tile: 128, 64, 32 or 16; hi_lo 64, 32 or 16)
// and ksub (16-row k-steps per ring stage: 2 or 1; 1 below 64 points and
// in hi_lo) pick the kernel; smem: the program's shared-memory bytes. Launches `grid` persistent blocks on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError().
int fused_mlp_fwd(const void* pts, const void* dirs, const void* weights,
                  const void* biases, void* out, int n, int n_scenes,
                  long long w_stride, int b_stride, const void* prog,
                  int prog_len, int hi_lo, int rows, int ksub, int grid,
                  int smem, void* stream) {
  if (prog_len < kOpsBase || grid <= 0 || n_scenes <= 0 || w_stride % 8 ||
      b_stride < 0 ||
      static_cast<long long>(n_scenes) * ((n + rows - 1) / rows) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const float*>(pts);
  const auto* w = static_cast<const bf16*>(weights);
  const auto* b = static_cast<const float*>(biases);
  const auto* pr = static_cast<const int*>(prog);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
#define FWD(HI_LO, T, KSUB)                                                  \
  if (!!hi_lo == HI_LO && rows == T && ksub == KSUB)                         \
    return static_cast<int>(launch<HI_LO, T, KSUB>(                         \
        p, dirs, w, b, o, pr, prog_len, n, n_scenes, w_stride, b_stride,     \
        grid, smem, s));
  FWD(true, 64, 1)
  FWD(true, 32, 1)
  FWD(true, 16, 1)
  FWD(false, 128, 2)
  FWD(false, 64, 2)
  FWD(false, 64, 1)
  FWD(false, 32, 1)
  FWD(false, 16, 1)
#undef FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
