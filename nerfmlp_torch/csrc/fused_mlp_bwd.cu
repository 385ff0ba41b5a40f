// Fused NeRF-MLP backward for Hopper (sm_90a): recompute the forward for a
// tile of points, backpropagate the (T, 4) cotangent through the heads and
// the trunk, and accumulate fp32 weight and bias gradients — plus the
// reduction that sums the per-block partial gradients in a fixed order.
//
// Replaces the TPU kernel `_bwd_kernel` + `_trunk_bwd`
// (nerfmlp_tpu/ops/pallas_mlp.py:312-441, launched by `_pallas_backward`,
// :444-496). It computes the same function with the same rounding points:
// the cotangent cast to the compute type; dv masked by v > 0 and rounded;
// dbott rounded; dh rounded after the sigma and bottleneck branches are
// summed; every dacc and every dh down the trunk rounded (mask and rounding
// commute, so one epilogue does both); dW accumulated in fp32 from bf16
// operands; db an fp32 sum over the rounded cotangents; the skip's d(enc)
// branch dropped. A template flag adds the hi_lo mode
// (fp32_precision="high", pallas_mlp.py:347-365): every value is a (hi, lo)
// pair of bf16 planes and every product is hi*hi + hi*lo + lo*hi.
//
// What bounds it. Per point at 8x256 with the view head: 593,408 MACs of
// recomputed forward, 557,696 of dX (none for layer 0, the skip's encoded
// block or the dirs block) and 593,408 of dW: 3.49 MFLOP, bf16 tensor-core
// work. Device memory sees 12 B of points, 54 B of dirs and 16 B of
// cotangent per point, so the floor is the 989 TFLOP/s bf16 peak (0.231 ms
// for 65,536 points, 0.462 ms for 131,072).
//
// Design.
//   * The TPU accumulates dW over a sequential grid. Hopper's blocks run in
//     parallel and in no order, so the grid is persistent: G blocks (those
//     that fit at once, at most two per SM), each walking a fixed,
//     contiguous range of tiles and
//     accumulating into its own fp32 partial slot in device memory (every
//     logical weight and bias). fused_mlp_bwd_reduce then sums the G slots
//     in a fixed order. No atomics: the gradients repeat bit for bit.
//   * The stored activations of a tile (every post-ReLU trunk layer, the
//     bottleneck and the view layer: 8 x 128 x 256 x 2 B = 512 KB at 128
//     rows) do not fit a block's 227 KB of shared memory. They go to a
//     per-block scratch in device memory (786,432 B per block at 8x256 and
//     128 rows; hi_lo doubles it) that the block writes and reads back,
//     mostly from the 50 MB L2. Shared memory holds only the program and
//     each warp's 16x16 epilogue stage (16,448 B).
//   * Every product is wmma 16x16x16 bf16 with fp32 accumulators, operands
//     loaded straight from device memory (scratch, weights: both L2-hot):
//       forward  out[T, n]  = act(A[T, k] @ W[k, n] + b)       W row-major
//       dX       out[T, n]  = mask(dY[T, k] @ W[n, k]^T)        W as col-major B
//       dW       P[k, n]   += A[T, k]^T @ dY[T, n]              A as col-major A
//     Each warp owns a 16 x 128 output strip (eight accumulators).
//   * A tile is 128 rows: each dW update reads and writes the block's whole
//     2.4 MB partial slot once per tile, so more rows per update amortise
//     that traffic; it likely sets the pace of this simple design.
//
// The network arrives as a program built by the Python wrapper
// (nerfmlp_torch/ops/fused_mlp.py, pack_params): a header, a buffer table
// (offset and row stride of each activation or cotangent buffer in the
// block's scratch) and one record per operation (forward layer, dX, dW,
// db). Every width is padded to a multiple of 16 with zeros, so padding
// adds exactly zero. Rows at or past n load a zero cotangent, so they
// contribute nothing to any gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;        // points per tile (rows per dW update)
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kFrags = 8;         // accumulators per warp task: 16 x 128
constexpr int kStrip = 16 * kFrags;
constexpr int kMaxBufs = 64;
constexpr int kHeaderInts = 16;
constexpr int kOpInts = 12;
constexpr int kMaxOps = 160;
constexpr int kOpsBase = kHeaderInts + 2 * kMaxBufs;
constexpr int kMaxProg = kOpsBase + kMaxOps * kOpInts;

// Operations of the program.
enum Op { kFwd = 0, kDx = 1, kDw = 2, kDb = 3 };

// Header fields.
enum Header {
  hNOps = 0, hNBufs, hNFreqs, hEncDim, hDirsDim, hHiLo, hXBuf, hDBuf,
  hGCols, hGrBuf, hGrCols, hGsBuf, hPlane
};

// Operation record fields:
//   kFwd: dst = act(a @ Wa + b @ Wb + bias)   (flag: 1 = ReLU)
//   kDx:  dst = mask(a @ Wa^T + b @ Wb^T)     (flag: mask buffer or -1)
//   kDw:  P[part:] += a^T @ b                 (k_a rows, n columns)
//   kDb:  P[part:] += column sums of a        (n columns)
enum Field {
  fOp = 0, fSrcA, fWA, fKA, fSrcB, fWB, fKB, fOff, fN, fFlag, fDst
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// A value into a buffer: bf16, or in hi_lo mode the pair
// (hi, lo) = (bf16(v), bf16(v - hi)).
template <bool kHiLo>
__device__ __forceinline__ void put(bf16* hi, int plane, size_t i, float v) {
  const bf16 h = __float2bfloat16(v);
  hi[i] = h;
  if (kHiLo) hi[plane + i] = __float2bfloat16(v - __bfloat162float(h));
}

// acc[j] += A[strip rows, :k] @ B[:, cbase + 16 j] for the warp's strip.
// B is W (k x n, row-major) or, with kTransW, W^T where W is n x k
// row-major (a col-major B). In hi_lo mode the lo planes of A and W follow
// their hi planes at `plane` and k * n elements.
template <bool kHiLo, bool kTransW>
__device__ __forceinline__ void strip_mma(AccFrag (&acc)[kFrags],
                                          const bf16* a, int lda, int plane,
                                          const bf16* __restrict__ w, int k,
                                          int n, int cbase) {
  using BLayout =
      typename std::conditional<kTransW, wmma::col_major, wmma::row_major>::type;
  const bf16* w_lo = w + static_cast<size_t>(k) * n;
  const int ldb = kTransW ? k : n;
  for (int k0 = 0; k0 < k; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa, fa_lo;
    wmma::load_matrix_sync(fa, a + k0, lda);
    if (kHiLo) wmma::load_matrix_sync(fa_lo, a + plane + k0, lda);
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      const int col = cbase + 16 * j;
      if (col < n) {  // warp-uniform
        const size_t at = kTransW ? static_cast<size_t>(col) * k + k0
                                  : static_cast<size_t>(k0) * n + col;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
        wmma::load_matrix_sync(fb, w + at, ldb);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
        if (kHiLo) {
          wmma::mma_sync(acc[j], fa_lo, fb, acc[j]);
          wmma::load_matrix_sync(fb, w_lo + at, ldb);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
}

// kHiLo = false: bf16 operands, fp32 accumulation, bf16 values.
// kHiLo = true (fp32_precision="high"): (hi, lo) bf16 planes, three
// products per matmul.
template <bool kHiLo>
__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_kernel(const float* __restrict__ pts,
                     const void* __restrict__ dirs,
                     const float* __restrict__ g,
                     const bf16* __restrict__ weights,
                     const float* __restrict__ biases,
                     const int* __restrict__ prog_in, int prog_len, int n,
                     int n_tiles, bf16* scratch_all, long long scratch_stride,
                     float* part_all, long long part_stride) {
  // The scratch and the partials are written and read back by this block:
  // no __restrict__ / read-only loads on them.
  __shared__ int prog[kMaxProg];
  __shared__ __align__(32) float stage_all[kWarps * 256];
  for (int i = threadIdx.x; i < prog_len; i += kThreads) prog[i] = prog_in[i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* stage = stage_all + warp * 256;
  bf16* scratch = scratch_all + blockIdx.x * scratch_stride;
  float* part = part_all + blockIdx.x * part_stride;
  const int plane = prog[hPlane];
  const int* bufs = prog + kHeaderInts;
  auto buf = [&](int b) { return scratch + bufs[2 * b]; };
  auto ld = [&](int b) { return bufs[2 * b + 1]; };

  const int t_begin = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_tiles / gridDim.x);
  const int t_end = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_tiles / gridDim.x);
  for (int t = t_begin; t < t_end; ++t) {
    const bool first = t == t_begin;
    const int row0 = t * kRows;

    // Encoded points: [x, sin(x * 2^0), cos(x * 2^0), sin(x * 2^1), ...],
    // x * 2^l exact in fp32, full-precision sinf/cosf (as the forward).
    {
      const int xb = prog[hXBuf], ldx = ld(xb), enc_dim = prog[hEncDim];
      bf16* x = buf(xb);
      for (int idx = threadIdx.x; idx < kRows * ldx; idx += kThreads) {
        const int r = idx / ldx, j = idx - r * ldx, gr = row0 + r;
        float v = 0.f;
        if (gr < n && j < enc_dim) {
          if (j < 3) {
            v = pts[3 * static_cast<size_t>(gr) + j];
          } else {
            const int l = (j - 3) / 6, m = (j - 3) - 6 * l;
            const float a =
                pts[3 * static_cast<size_t>(gr) + m % 3] * ldexpf(1.f, l);
            v = m < 3 ? sinf(a) : cosf(a);
          }
        }
        put<kHiLo>(x, plane, idx, v);
      }
    }
    // Encoded view directions: bf16, or fp32 in hi_lo mode.
    if (prog[hDBuf] >= 0) {
      const int db = prog[hDBuf], ldd = ld(db), dirs_dim = prog[hDirsDim];
      bf16* d = buf(db);
      for (int idx = threadIdx.x; idx < kRows * ldd; idx += kThreads) {
        const int r = idx / ldd, j = idx - r * ldd, gr = row0 + r;
        float v = 0.f;
        if (gr < n && j < dirs_dim) {
          const size_t at = static_cast<size_t>(gr) * dirs_dim + j;
          v = kHiLo ? static_cast<const float*>(dirs)[at]
                    : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
        }
        put<kHiLo>(d, plane, idx, v);
      }
    }
    // The cotangent, cast to the compute type: its first gr_cols columns
    // into buffer GR (rgb, or the whole output head), the next into GS
    // (sigma). Rows at or past n are zero.
    {
      const int g_cols = prog[hGCols], gr_cols = prog[hGrCols];
      for (int which = 0; which < 2; ++which) {
        const int b = which ? prog[hGsBuf] : prog[hGrBuf];
        if (b < 0) continue;
        const int ldg = ld(b), c0 = which ? gr_cols : 0;
        const int cn = which ? g_cols - gr_cols : gr_cols;
        bf16* dst = buf(b);
        for (int idx = threadIdx.x; idx < kRows * ldg; idx += kThreads) {
          const int r = idx / ldg, j = idx - r * ldg, gr = row0 + r;
          const float v = (gr < n && j < cn)
                              ? g[static_cast<size_t>(gr) * g_cols + c0 + j]
                              : 0.f;
          put<kHiLo>(dst, plane, idx, v);
        }
      }
    }
    __syncthreads();

    const int n_ops = prog[hNOps];
    for (int oi = 0; oi < n_ops; ++oi) {
      const int* o = prog + kOpsBase + oi * kOpInts;
      const int op = o[fOp], nn = o[fN];
      if (op == kFwd || op == kDx) {
        const int groups = (nn + kStrip - 1) / kStrip;
        const int tasks = (kRows / 16) * groups;
        for (int task = warp; task < tasks; task += kWarps) {
          const int r0 = (task / groups) * 16;
          const int cbase = (task % groups) * kStrip;
          AccFrag acc[kFrags];
#pragma unroll
          for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[j], 0.f);
          for (int opnd = 0; opnd < 2; ++opnd) {
            const int k = opnd ? o[fKB] : o[fKA];
            if (k == 0) continue;
            const int src = opnd ? o[fSrcB] : o[fSrcA];
            const bf16* a = buf(src) + static_cast<size_t>(r0) * ld(src);
            const bf16* w = weights + (opnd ? o[fWB] : o[fWA]);
            if (op == kFwd)
              strip_mma<kHiLo, false>(acc, a, ld(src), plane, w, k, nn, cbase);
            else
              strip_mma<kHiLo, true>(acc, a, ld(src), plane, w, k, nn, cbase);
          }
          // Epilogue: forward: fp32 bias, then ReLU; dX: the ReLU mask of
          // the stored activation. Then the compute type, into dst.
          const int dst = o[fDst], ldo = ld(dst), flag = o[fFlag];
#pragma unroll
          for (int j = 0; j < kFrags; ++j) {
            const int col = cbase + 16 * j;
            if (col >= nn) continue;
            wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
              const int r = r0 + (e >> 4), c = col + (e & 15);
              float v = stage[e];
              if (op == kFwd) {
                v += biases[o[fOff] + c];
                if (flag) v = fmaxf(v, 0.f);
              } else if (flag >= 0) {
                const float m = __bfloat162float(
                    buf(flag)[static_cast<size_t>(r) * ld(flag) + c]);
                if (!(m > 0.f)) v = 0.f;
              }
              put<kHiLo>(buf(dst), plane, static_cast<size_t>(r) * ldo + c,
                         v);
            }
            __syncwarp();
          }
        }
      } else if (op == kDw) {
        // P[k, n] += A^T @ dY over the tile's rows; each warp task owns a
        // 16 x 128 strip of P, loaded once and stored once per tile.
        const int k = o[fKA], src = o[fSrcA], dy = o[fSrcB];
        const int lda = ld(src), ldy = ld(dy);
        const bf16* a = buf(src);
        const bf16* y = buf(dy);
        float* p = part + o[fOff];
        const int groups = (nn + kStrip - 1) / kStrip;
        const int tasks = (k / 16) * groups;
        for (int task = warp; task < tasks; task += kWarps) {
          const int k0 = (task / groups) * 16;
          const int cbase = (task % groups) * kStrip;
          AccFrag acc[kFrags];
#pragma unroll
          for (int j = 0; j < kFrags; ++j) {
            const int col = cbase + 16 * j;
            if (first || col >= nn)
              wmma::fill_fragment(acc[j], 0.f);
            else
              wmma::load_matrix_sync(acc[j], p + static_cast<size_t>(k0) * nn + col,
                                     nn, wmma::mem_row_major);
          }
          for (int t0 = 0; t0 < kRows; t0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa, fa_lo;
            const bf16* at = a + static_cast<size_t>(t0) * lda + k0;
            wmma::load_matrix_sync(fa, at, lda);
            if (kHiLo) wmma::load_matrix_sync(fa_lo, at + plane, lda);
#pragma unroll
            for (int j = 0; j < kFrags; ++j) {
              const int col = cbase + 16 * j;
              if (col < nn) {
                const bf16* yt = y + static_cast<size_t>(t0) * ldy + col;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fb, yt, ldy);
                wmma::mma_sync(acc[j], fa, fb, acc[j]);
                if (kHiLo) {
                  wmma::mma_sync(acc[j], fa_lo, fb, acc[j]);
                  wmma::load_matrix_sync(fb, yt + plane, ldy);
                  wmma::mma_sync(acc[j], fa, fb, acc[j]);
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kFrags; ++j) {
            const int col = cbase + 16 * j;
            if (col < nn)
              wmma::store_matrix_sync(p + static_cast<size_t>(k0) * nn + col,
                                      acc[j], nn, wmma::mem_row_major);
          }
        }
      } else {  // kDb: column sums of the rounded cotangent, fp32, in order
        const int src = o[fSrcA], lds = ld(src);
        const bf16* y = buf(src);
        float* p = part + o[fOff];
        for (int c = threadIdx.x; c < nn; c += kThreads) {
          float s = 0.f;
          for (int r = 0; r < kRows; ++r) {
            const size_t at = static_cast<size_t>(r) * lds + c;
            float v = __bfloat162float(y[at]);
            if (kHiLo) v += __bfloat162float(y[plane + at]);
            s += v;
          }
          p[c] = first ? s : p[c] + s;
        }
      }
      __syncthreads();
    }
  }
}

// out[j] = sum over the G partial slots of part[g * stride + j], in slot
// order: the same bits on every run.
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ part, int slots,
                       long long stride, float* __restrict__ out,
                       long long total) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       j < total; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < slots; ++b) s += part[b * stride + j];
    out[j] = s;
  }
}

template <bool kHiLo>
cudaError_t launch(const float* pts, const void* dirs, const float* g,
                   const bf16* weights, const float* biases, const int* prog,
                   int prog_len, int n, int grid, bf16* scratch,
                   long long scratch_stride, float* part, long long part_stride,
                   cudaStream_t stream) {
  const int n_tiles = (n + kRows - 1) / kRows;
  fused_mlp_bwd_kernel<kHiLo><<<grid, kThreads, 0, stream>>>(
      pts, dirs, g, weights, biases, prog, prog_len, n, n_tiles, scratch,
      scratch_stride, part, part_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's fixed shape, for the wrapper to check against its own.
int fused_mlp_bwd_constants(int* out, int len) {
  const int c[] = {kRows, kThreads, kMaxBufs, kHeaderInts, kOpInts, kMaxOps};
  const int count = static_cast<int>(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < len && i < count; ++i) out[i] = c[i];
  return count;
}

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of the backward kernel that fit on one SM of the current device
// (at most 2) times its SMs: the persistent grid's size G.
int fused_mlp_bwd_grid(int hi_lo, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        hi_lo ? fused_mlp_bwd_kernel<true> : fused_mlp_bwd_kernel<false>,
        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  per_sm = per_sm < 1 ? 1 : (per_sm > 2 ? 2 : per_sm);
  *out = per_sm * sms;
  return static_cast<int>(cudaSuccess);
}

// pts (n, 3) fp32; dirs (n, dirs_dim) bf16 (fp32 in hi_lo mode) or null;
// g (n, g_cols) fp32; weights bf16 and biases fp32 as packed for the
// forward; prog (device, int32): the backward program. scratch: grid *
// scratch_stride bf16; part: grid * part_stride fp32 (no initialisation
// needed). Launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError().
int fused_mlp_bwd(const void* pts, const void* dirs, const void* g,
                  const void* weights, const void* biases, const void* prog,
                  int prog_len, int hi_lo, int n, int grid, void* scratch,
                  long long scratch_stride, void* part, long long part_stride,
                  void* stream) {
  if (prog_len < kOpsBase || prog_len > kMaxProg ||
      (prog_len - kOpsBase) % kOpInts != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  // Every block needs a tile: its partial slot is written by its first.
  if (grid > (n + kRows - 1) / kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(pts);
  const auto* gg = static_cast<const float*>(g);
  const auto* w = static_cast<const bf16*>(weights);
  const auto* b = static_cast<const float*>(biases);
  const auto* pr = static_cast<const int*>(prog);
  auto* sc = static_cast<bf16*>(scratch);
  auto* pa = static_cast<float*>(part);
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hi_lo ? launch<true>(p, dirs, gg, w, b, pr, prog_len, n, grid, sc,
                           scratch_stride, pa, part_stride, s)
            : launch<false>(p, dirs, gg, w, b, pr, prog_len, n, grid, sc,
                            scratch_stride, pa, part_stride, s));
}

// out (total,) = the sum of `slots` partial rows of `stride` floats each.
int fused_mlp_bwd_reduce(const void* part, int slots, long long stride,
                         void* out, long long total, void* stream) {
  if (slots <= 0 || total < 0 || stride < total)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_partials_kernel<<<static_cast<int>(blocks), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), slots, stride,
      static_cast<float*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
