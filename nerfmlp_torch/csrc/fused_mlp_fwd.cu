// Fused NeRF-MLP forward for Hopper (sm_90a): positional encoding, the whole
// trunk and both heads for a tile of points in one launch.
//
// Replaces the TPU kernel `_fwd_kernel` (nerfmlp_tpu/ops/pallas_mlp.py:264,
// launched by `_pallas_forward`, :275-309). It computes the same function
// with the same rounding points: bf16 operands with fp32 accumulation; bias
// added in fp32, then ReLU, then rounding to bf16 for every trunk layer; the
// bottleneck rounded to bf16 without ReLU; the view layer ReLU then bf16;
// rgb and sigma left in fp32. The encoding computes x * 2^l exactly in fp32
// and takes full-precision sinf/cosf (never the fast intrinsics: arguments
// reach |x| * 2^9, thousands, where __sinf is wrong), then rounds to bf16.
// A template flag adds the TPU kernel's hi_lo mode (fp32_precision="high",
// pallas_mlp.py:68-100): activations stay fp32-grade as (hi, lo) bf16
// planes, each weight is a (hi, lo) pair of bf16 blocks, and every matmul
// is hi@hi + lo@hi + hi@lo into the same fp32 accumulators.
//
// What bounds it. One point costs 2 * 593,408 FLOP at 8x256 with the view
// head; device memory sees only 12 B of points, 54 B of dirs and 16 B of
// output per point. So the work is compute-bound by about 50x against the
// card's memory rate: the bf16 tensor cores set the floor (0.315 ms for the
// 262,144-point coarse call at 989 TFLOP/s).
//
// Design. The TPU kernel keeps all ~1.19 MB of bf16 weights resident in
// VMEM. A Hopper block has 227 KB of shared memory, so here:
//   * one block of 8 warps takes a tile of 64 points;
//   * the tile's activations stay in shared memory as bf16, in two
//     ping-pong buffers, beside the encoded input (kept for the skip layer)
//     and the encoded view directions; only the last layer's real columns
//     leave the block;
//   * each layer's weights stream through shared memory in 32-row slabs and
//     stay hot in the 50 MB L2 across blocks;
//   * each warp holds a 16 x 128 slice of the layer's output in registers
//     (eight 16x16x16 bf16 wmma accumulators, fp32), so a 256-wide layer
//     is one pass; wider layers loop over 256-column chunks;
//   * the skip layer's cat([x, h]) @ W is two operands accumulated into the
//     same registers, x @ W[:enc] + h @ W[enc:], as is the view layer's
//     cat([bottleneck, dirs]) @ Wv.
// At 107 KB of shared memory two blocks share an SM (hi_lo: 206 KB, one
// block). Every block re-reads
// all weights from L2 (about 4.9 GB per coarse call), which likely sets the
// pace of this simple design; larger tiles, persistent blocks, wgmma and
// TMA multicast of weight tiles are later work.
//
// The network arrives as a small program built by the Python wrapper
// (nerfmlp_torch/ops/fused_mlp.py): a header and one record per layer
// naming its operand buffers, weight blocks, bias, width, epilogue and
// destination. Every dimension is padded to a multiple of 16 with zero
// weights, zero biases and zero activations, so padding adds exactly zero.
// Rows past n are zero on the way in and never written on the way out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstring>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;         // points per block
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlabRows = 32;     // weight rows per shared-memory slab
constexpr int kChunkCols = 256;   // output columns per register pass
constexpr int kPad = 8;           // bf16 elements of padding per smem row
constexpr int kSlabLd = kChunkCols + kPad;
constexpr int kFrags = 8;         // accumulators per warp: 16 x 128
constexpr int kMaxLayers = 48;
constexpr int kHeaderInts = 22;
constexpr int kLayerInts = 11;
static_assert((kRows / 16) * (kChunkCols / 16) == kWarps * kFrags,
              "the warps' accumulators tile one chunk exactly");

// Shared-memory buffers a layer reads or writes.
enum Buffer { kX = 0, kD = 1, kA = 2, kB = 3 };
// Epilogues.
enum Mode { kReluBf16 = 0, kBf16 = 1, kOutF32 = 2 };

struct Layer {
  int src_a, w_a, k_a;  // first operand: buffer, weight offset, padded rows
  int src_b, w_b, k_b;  // second operand (k_b == 0: none)
  int bias;             // offset of the layer's fp32 bias
  int n;                // padded output columns (row stride of its weights)
  int mode;             // Mode
  int dst;              // destination buffer, or output column for kOutF32
  int n_real;           // real output columns (kOutF32 writes only these)
};
static_assert(sizeof(Layer) == kLayerInts * sizeof(int), "Layer layout");

struct Net {
  int n_layers, n_freqs, enc_dim, dirs_dim, out_w;
  int hi_lo;       // 1: three bf16 products per matmul on (hi, lo) pairs
  int cols[4];     // padded columns of X, D, A, B (row stride = cols + kPad)
  int off[4];      // byte offsets of X, D, A, B in dynamic shared memory
  int off_lo[4];   // ... of their lo planes (hi_lo only)
  int off_slab, off_slab_lo, off_stage, smem_bytes;
  Layer layers[kMaxLayers];
};

// A value into an activation buffer: bf16, or in hi_lo mode the pair
// (hi, lo) = (bf16(v), bf16(v - hi)) — the split the TPU kernel takes of
// its fp32 activations before each product (pallas_mlp.py:68-100).
template <bool kHiLo>
__device__ __forceinline__ void put(bf16* hi, bf16* lo, int i, float v) {
  const bf16 h = __float2bfloat16(v);
  hi[i] = h;
  if (kHiLo) lo[i] = __float2bfloat16(v - __bfloat162float(h));
}

// kHiLo = false: bf16 operands, fp32 accumulation, bf16 activations.
// kHiLo = true (fp32_precision="high"): fp32 activations held as (hi, lo)
// bf16 planes, weights as (hi, lo) blocks, hi@hi + hi@lo + lo@hi per matmul.
template <bool kHiLo>
__global__ void __launch_bounds__(kThreads, kHiLo ? 1 : 2)
fused_mlp_fwd_kernel(const float* __restrict__ pts,
                     const void* __restrict__ dirs,
                     const bf16* __restrict__ weights,
                     const float* __restrict__ biases,
                     float* __restrict__ out, int n, const Net net) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf[4];
  bf16* lo[4];
  int ld[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    buf[i] = reinterpret_cast<bf16*>(smem + net.off[i]);
    lo[i] = reinterpret_cast<bf16*>(smem + net.off_lo[i]);
    ld[i] = net.cols[i] + kPad;
  }
  bf16* slab = reinterpret_cast<bf16*>(smem + net.off_slab);
  bf16* slab_lo = reinterpret_cast<bf16*>(smem + net.off_slab_lo);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + net.off_stage) + warp * 256;
  const int row0 = blockIdx.x * kRows;

  // Encoded points: [x, sin(x * 2^0), cos(x * 2^0), sin(x * 2^1), ...].
  const int enc_k = net.cols[kX];
  for (int idx = threadIdx.x; idx < kRows * enc_k; idx += kThreads) {
    const int r = idx / enc_k, j = idx - r * enc_k, g = row0 + r;
    float v = 0.f;
    if (g < n && j < net.enc_dim) {
      if (j < 3) {
        v = pts[3 * static_cast<size_t>(g) + j];
      } else {
        const int l = (j - 3) / 6, m = (j - 3) - 6 * l;
        const float a = pts[3 * static_cast<size_t>(g) + m % 3] * ldexpf(1.f, l);
        v = m < 3 ? sinf(a) : cosf(a);
      }
    }
    put<kHiLo>(buf[kX], lo[kX], r * ld[kX] + j, v);
  }
  // Encoded view directions: bf16, or fp32 in hi_lo mode.
  const int dirs_k = net.cols[kD];
  for (int idx = threadIdx.x; idx < kRows * dirs_k; idx += kThreads) {
    const int r = idx / dirs_k, j = idx - r * dirs_k, g = row0 + r;
    float v = 0.f;
    if (g < n && j < net.dirs_dim) {
      const size_t at = static_cast<size_t>(g) * net.dirs_dim + j;
      v = kHiLo ? static_cast<const float*>(dirs)[at]
                : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
    }
    put<kHiLo>(buf[kD], lo[kD], r * ld[kD] + j, v);
  }

  const int rt = warp & 3;              // this warp's 16-row tile
  const int cbase = (warp >> 2) * 128;  // its first column in a chunk
  for (int li = 0; li < net.n_layers; ++li) {
    const Layer& L = net.layers[li];
    for (int c0 = 0; c0 < L.n; c0 += kChunkCols) {
      const int cn = min(kChunkCols, L.n - c0);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
      for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[j], 0.f);

      for (int op = 0; op < 2; ++op) {
        const int k = op ? L.k_b : L.k_a;
        if (k == 0) continue;
        const int src = op ? L.src_b : L.src_a;
        // In hi_lo mode a weight block's lo half follows its hi half.
        const bf16* w = weights + (op ? L.w_b : L.w_a);
        const bf16* w_lo = w + static_cast<size_t>(k) * L.n;
        const bf16* a = buf[src] + rt * 16 * ld[src];
        const bf16* a_lo = lo[src] + rt * 16 * ld[src];
        for (int k0 = 0; k0 < k; k0 += kSlabRows) {
          const int ks = min(kSlabRows, k - k0);
          const int vecs = cn / 8;  // 16-byte vectors per slab row
          __syncthreads();  // previous slab consumed, previous layer written
          for (int idx = threadIdx.x; idx < ks * vecs; idx += kThreads) {
            const int r = idx / vecs, v = idx - r * vecs;
            const size_t at = static_cast<size_t>(k0 + r) * L.n + c0 + 8 * v;
            *reinterpret_cast<uint4*>(slab + r * kSlabLd + 8 * v) =
                *reinterpret_cast<const uint4*>(w + at);
            if (kHiLo)
              *reinterpret_cast<uint4*>(slab_lo + r * kSlabLd + 8 * v) =
                  *reinterpret_cast<const uint4*>(w_lo + at);
          }
          __syncthreads();
          for (int kk = 0; kk < ks; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa, fa_lo;
            wmma::load_matrix_sync(fa, a + k0 + kk, ld[src]);
            if (kHiLo) wmma::load_matrix_sync(fa_lo, a_lo + k0 + kk, ld[src]);
#pragma unroll
            for (int j = 0; j < kFrags; ++j) {
              const int col = cbase + 16 * j;
              if (col < cn) {  // warp-uniform
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fb, slab + kk * kSlabLd + col, kSlabLd);
                wmma::mma_sync(acc[j], fa, fb, acc[j]);
                if (kHiLo) {
                  wmma::mma_sync(acc[j], fa_lo, fb, acc[j]);
                  wmma::load_matrix_sync(fb, slab_lo + kk * kSlabLd + col,
                                         kSlabLd);
                  wmma::mma_sync(acc[j], fa, fb, acc[j]);
                }
              }
            }
          }
        }
      }

      // Epilogue: fp32 bias, then ReLU and the activation type into shared
      // memory, or the real columns in fp32 to the output.
#pragma unroll
      for (int j = 0; j < kFrags; ++j) {
        const int col = cbase + 16 * j;
        if (col >= cn) continue;
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = rt * 16 + (e >> 4);
          const int c = c0 + col + (e & 15);
          float v = stage[e] + biases[L.bias + c];
          if (L.mode == kOutF32) {
            if (c < L.n_real && row0 + r < n)
              out[static_cast<size_t>(row0 + r) * net.out_w + L.dst + c] = v;
          } else {
            if (L.mode == kReluBf16) v = fmaxf(v, 0.f);
            put<kHiLo>(buf[L.dst], lo[L.dst], r * ld[L.dst] + c, v);
          }
        }
        __syncwarp();
      }
    }
  }
}

template <bool kHiLo>
cudaError_t launch(const Net& net, const float* pts, const void* dirs,
                   const bf16* weights, const float* biases, float* out,
                   int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<kHiLo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      net.smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  fused_mlp_fwd_kernel<kHiLo><<<blocks, kThreads, net.smem_bytes, stream>>>(
      pts, dirs, weights, biases, out, n, net);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's fixed shape, for the wrapper to check against its own.
int fused_mlp_fwd_constants(int* out, int len) {
  const int c[] = {kRows, kThreads, kSlabRows, kChunkCols, kPad,
                   kMaxLayers, kHeaderInts, kLayerInts};
  const int count = static_cast<int>(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < len && i < count; ++i) out[i] = c[i];
  return count;
}

const char* fused_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pts (n, 3) fp32; dirs (n, dirs_dim), bf16 (fp32 in hi_lo mode) or null;
// weights bf16; biases fp32; out (n, out_w) fp32 — all on the current
// device. prog is the host program (header + layers). Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
int fused_mlp_fwd(const void* pts, const void* dirs, const void* weights,
                  const void* biases, void* out, int n, const int* prog,
                  int prog_len, void* stream) {
  if (prog_len < kHeaderInts || (prog_len - kHeaderInts) % kLayerInts != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  std::memset(&net, 0, sizeof(net));
  std::memcpy(&net, prog, kHeaderInts * sizeof(int));
  if (net.n_layers != (prog_len - kHeaderInts) / kLayerInts ||
      net.n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(net.layers, prog + kHeaderInts,
              net.n_layers * sizeof(Layer));
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const float*>(pts);
  const auto* w = static_cast<const bf16*>(weights);
  const auto* b = static_cast<const float*>(biases);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      net.hi_lo ? launch<true>(net, p, dirs, w, b, o, n, s)
                : launch<false>(net, p, dirs, w, b, o, n, s));
}

}  // extern "C"
