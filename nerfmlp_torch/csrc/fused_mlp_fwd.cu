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
// output per point. So the function is compute-bound by about 50x against
// the card's memory rate: the bf16 tensor cores set the floor (0.629 ms for
// the 524,288-point fine serving call at 989 TFLOP/s). What bounded the
// design before this one (mma.sync m16n8k16 from ldmatrix fragments, a
// block barrier per 16- or 32-row ring stage, weights loaded by all 512
// threads) was latency, ~150 TFLOP/s, with no part dominant; and on the
// shallow wide nets, whose activations only fit 16- and 32-point tiles,
// the weights every tile restreams from L2 (74 GB for one 131,072-point
// call at 1x1696).
//
// Design: mlp_tile.cuh's core, shared with the backward's phase 1.
//   * wgmma.mma_async with the products transposed: M the layer's output
//     features (64 a wgmma; a pass of up to 256 columns over the two
//     consumer warpgroups), N the tile's points (16 to 128), K the input
//     features. A is the weight stage in shared memory, B the tile's
//     activations, both through descriptors; a hi_lo product is three
//     wgmma into the same accumulators.
//   * A producer warpgroup (its registers given to the consumers by
//     setmaxnreg) streams every operation's weight stages through a ring
//     of slots with bulk copies, the packer having written each weight
//     block in the layout wgmma reads; a full and an empty mbarrier per
//     slot and no block-wide barrier per stage. Stages of up to 64 rows
//     (a narrow operation takes as many as the slot holds), at least three
//     deep where the layout fits.
//   * A persistent grid of as many CTAs as the card holds at once walks
//     the tiles, one CTA a tile. (Clusters of 2 and 4 CTAs that shared
//     each 32- or 16-point tile's weight stages by multicast were slower
//     on an H100 at nearly every layout measured, by up to 26%, never
//     faster by more than 1.3%: the small-N wgmma, not L2 reads, take the
//     time. They were taken out.)
//   * The tile's activations stay in shared memory (encoded points, kept
//     for the skip layer; encoded view directions; one activation buffer
//     written in place where every layer is one pass, else two ping-pong
//     buffers). The epilogue works from the accumulators: fp32 bias, ReLU,
//     bf16 (or the hi / lo split) into the next operation's buffer; the
//     heads' real columns, in fp32, into staging columns in the encoded
//     points' buffer (dead after the trunk), copied to the (n, out_w)
//     output after the tile's last operation, coalesced, rows at or past n
//     masked. The epilogue takes no branch and stores nothing to device
//     memory: while the heads took a branch of their own that stored
//     there, ptxas serialized every wgmma of the loop (note C7520, one
//     WARPGROUP.DEPBAR an HGMMA). Two named barriers of the consumers an
//     operation (one before an in-place epilogue, one after every
//     epilogue), none per stage.
//   * The skip layer's cat([x, h]) @ W is two operands accumulated into the
//     same registers, x @ W[:enc] + h @ W[enc:], as is the view layer's
//     cat([bottleneck, dirs]) @ Wv.
//
// The network arrives as a program built by the Python wrapper
// (nerfmlp_torch/ops/fused_mlp.py, pack_params) and copied into shared
// memory: a header, a table of the four buffers and one record per column
// pass of each layer (mlp_tile.cuh's CoreField, then its epilogue); its
// bytes bound the depth (866 layers: 55 KB). Every dimension is padded to
// a multiple of 16 with zero weights, zero biases and zero activations, so
// padding adds exactly zero.
//
// Training (a template flag, kRes): the kernel also writes the residuals
// the backward's phase 1 would otherwise recompute (fused_mlp_bwd.cu's
// handover): the encoded points and dirs and every stored activation into
// the backward's workspace, 5,056 B a point at 8x256, each pass's whole
// 64-column strips by one bulk copy each after its epilogue (the consumers
// go on to the next operation meanwhile); and
// each ReLU layer's mask bits from the epilogue's registers (shared memory
// is full: 231,424 B of 232,448 at 8x256), one image a tile. A table in
// device memory says where each goes. The serving instantiation is the
// kernel without it.
//
// A scene axis (the TPU kernel under jax.vmap, whose batching rule gives the
// pallas_call a leading grid axis over scenes): one launch runs S nets of
// one architecture, scene s with its own weights and biases (at s times a
// stride in each buffer), its n points, dirs and output rows (scene-major,
// at s * n). A tile never straddles two scenes; the producer keeps the
// scene of the tile it streams for. Every output row is computed as
// in a launch of its scene alone, so scene s's rows equal a single-scene
// launch's bit for bit. S = 1 is the single net.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

using namespace mlp_tile;

constexpr int kHeaderInts = 16;
constexpr int kMaxBufs = 4;       // X, D, P0, P1: byte offset, columns, 0
                                  // (mlp_tile.cuh's activation buffers)
constexpr int kOpInts = 16;
constexpr int kBufsBase = kHeaderInts;
constexpr int kOpsBase = kBufsBase + 3 * kMaxBufs;

// Header fields.
enum Header {
  hNOps = 0, hProgLen, hNFreqs, hEncDim, hDirsDim, hOutW, hHiLo, hRows,
  hStages, hRingOff, hSlotBytes, hBarOff, hSmem
};
// Buffers of the encoded points and dirs.
enum Buffer { kX = 0, kD = 1 };
// Epilogues.
enum Mode { kReluBf16 = 0, kBf16 = 1, kOutF32 = 2 };
// Operation record fields after mlp_tile.cuh's CoreField (kind kOpFwd):
//   dst[:, col:col + n] = act(A @ WA + B @ WB + bias), bias at fBias (the
//   pass's first column); kOutF32: out[:, dst + j] for j < n_real.
enum Field { fMode = cBias + 1, fNReal };
// The residual table (kRes): x's workspace matrix (column offset, columns)
// and d's (or -1, 0), then per operation its workspace matrix (column
// offset, or -1: a head), its columns and its ReLU mask block (a byte
// offset in a tile's mask image, or -1).
constexpr int kResHeader = 4;
constexpr int kResInts = 4;
enum ResField { rMat = 0, rCols, rMask };

// A value into an activation buffer: bf16, or in hi_lo mode the pair
// (hi, lo) = (bf16(v), bf16(v - hi)) — the split the TPU kernel takes of
// its fp32 activations before each product (pallas_mlp.py:68-100); the
// epilogue makes the same split (mlp_tile.cuh's store_acc).
template <bool kHiLo>
__device__ __forceinline__ void put(unsigned char* p, int plane, float v) {
  const bf16 h = __float2bfloat16(v);
  *reinterpret_cast<bf16*>(p) = h;
  if (kHiLo)
    *reinterpret_cast<bf16*>(p + plane) =
        __float2bfloat16(v - __bfloat162float(h));
}

// kHiLo: (hi, lo) planes and three products. T: points per tile (128, 64,
// 32 or 16), the N of every wgmma. kRes: the training forward, which also
// writes its residuals for the backward's phase 1 (fused_mlp_bwd.cu): the
// encoded points and dirs and every stored activation into the
// workspace `ws` (rows_cap rows a matrix), each at the rows and in the
// strip layout phase 1 writes them (tile g at rows g * T; a scene's tiles
// cover scene_rows(n, T) rows), and each ReLU layer's mask bits, in
// phase 1's mask layout, into tile g's image of mask_bytes in `masks`,
// from the epilogue's registers (shared memory is full). The residual
// table `res` says where each goes.
template <bool kHiLo, int T, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fwd_kernel(const float* __restrict__ pts,
                     const void* __restrict__ dirs,
                     const bf16* __restrict__ weights,
                     const float* __restrict__ biases,
                     float* __restrict__ out,
                     const int* __restrict__ prog_in, int prog_len, int n,
                     int n_scenes, long long w_stride, int b_stride,
                     const int* __restrict__ res, bf16* __restrict__ ws,
                     long long rows_cap, unsigned char* __restrict__ masks,
                     int mask_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* prog = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < prog_len; i += kThreads) prog[i] = prog_in[i];
  const int stages = prog_in[hStages];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + prog_in[hBarOff]);
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) init_ring(full, empty, stages);
  __syncthreads();

  const int* bufs = prog + kBufsBase;
  const int* ops = prog + kOpsBase;
  const int n_ops = prog[hNOps];
  unsigned char* ring = smem + prog[hRingOff];
  const int slot_bytes = prog[hSlotBytes];
  const int half = kHiLo ? slot_bytes / 2 : 0;
  const int tiles = kRes ? scene_rows(n, T) / T : (n + T - 1) / T;
  const int n_tiles = n_scenes * tiles;
  const int wg = threadIdx.x / 128;

  // The roles never meet again: ptxas treats the code of a branch that
  // reconverges as divergent and serializes every wgmma in it.
  if (wg == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32)
      produce<kHiLo>(ops, kOpInts, n_ops, weights, w_stride, tiles, n_tiles,
                     stages, ring, slot_bytes, half, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  using Core = Consumer<kHiLo, T>;
  using Mask = typename MaskWord<T>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const uint32_t base = smem_u32(smem);
  float acc0[Core::kAcc], acc1[Core::kAcc];
  Ring pos;
  for (int g = blockIdx.x; g < n_tiles; g += gridDim.x) {
    const int scene = g / tiles;
    const int row0 = (g - scene * tiles) * T;
    const long long sbase = static_cast<long long>(scene) * n;
    const float* pts_s = pts + 3 * sbase;
    const float* bias_s = biases + static_cast<long long>(scene) * b_stride;
    const long long ws_row0 = static_cast<long long>(g) * T;  // kRes

    // Encoded points, then the encoded view directions (bf16, or fp32 in
    // hi_lo mode); zeros past n and in the padding columns.
    const int xc = bufs[3 * kX + 1], enc_dim = prog[hEncDim];
    unsigned char* xs = smem + bufs[3 * kX];
    for (int idx = tid; idx < T * xc; idx += kConsumers) {
      const int r = idx / xc, j = idx - r * xc, p = row0 + r;
      float v0 = 0.f, v1 = 0.f;
      const int got =
          (p < n && j < enc_dim) ? encode_pair(pts_s, p, j, &v0, &v1) : 1;
      if (got) put<kHiLo>(xs + act_byte<T>(r, j), 2 * T * xc, v0);
      if (got == 2) put<kHiLo>(xs + act_byte<T>(r, j + 3), 2 * T * xc, v1);
    }
    if (prog[hDirsDim] > 0) {
      const int dc = bufs[3 * kD + 1], dirs_dim = prog[hDirsDim];
      unsigned char* ds = smem + bufs[3 * kD];
      for (int idx = tid; idx < T * dc; idx += kConsumers) {
        const int r = idx / dc, j = idx - r * dc, p = row0 + r;
        float v = 0.f;
        if (p < n && j < dirs_dim) {
          const long long at = (sbase + p) * dirs_dim + j;
          v = kHiLo ? static_cast<const float*>(dirs)[at]
                    : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
        }
        put<kHiLo>(ds + act_byte<T>(r, j), 2 * T * dc, v);
      }
    }
    fence_proxy_async();
    named_sync(kConsumerBar, kConsumers);
    // kRes: the encoded points and dirs into their workspace matrices, as
    // the operations' passes go below.
    if constexpr (kRes) {
      copy_pass_bulk<kHiLo, T>(ws + res[0] * rows_cap, rows_cap, res[1],
                               ws_row0, 0, xs, 2 * T * xc, 0, res[1], tid);
      if (res[2] >= 0)
        copy_pass_bulk<kHiLo, T>(ws + res[2] * rows_cap, rows_cap, res[3],
                                 ws_row0, 0, smem + bufs[3 * kD],
                                 2 * T * bufs[3 * kD + 1], 0, res[3], tid);
    }

    for (int oi = 0; oi < n_ops; ++oi) {
      const int* o = ops + oi * kOpInts;
      Core::op(o, pos, stages, ring, slot_bytes, half, full, empty, bufs,
               base, smem_u32(full + 2 * kMaxStages), wg, tid & 127, acc0,
               acc1);
      // kRes: the previous operation's bulk copies have read their buffer
      // before any barrier after which this operation's epilogue (or the
      // next's) writes it.
      if constexpr (kRes) bulk_wait_read();
      const int mode = o[fMode], dst = o[cDst], nn = o[cN];
      const bool head = mode == kOutF32;
      if (!head && (dst == o[cSrcA] || (o[cKB] && dst == o[cSrcB])))
        named_sync(kConsumerBar, kConsumers);  // in place: all reads done
      // Epilogue: accumulator u, element i = 4 j + 2 h + e is feature
      // 64 (wg + 2 u) + 16 warp + lane / 4 + 8 h of the pass, point
      // 8 j + 2 (lane % 4) + e of the tile.
      const float* bias = bias_s + o[cBias];
      const int col0 = o[cCol], n_real = o[fNReal];  // n_real: 0 but heads
      const int buf = head ? static_cast<int>(kX) : dst;
      const int dc = bufs[3 * buf + 1], out_w = prog[hOutW];
      const bool relu = mode == kReluBf16;
      float* stage = reinterpret_cast<float*>(smem + bufs[3 * kX]);
      // kRes: this operation's workspace matrix and mask block.
      int mat = -1, mat_cols = 0, mask_out = -1;
      if constexpr (kRes) {
        const int* ro = res + kResHeader + kResInts * oi;
        mat = ro[rMat];
        mat_cols = ro[rCols];
        mask_out = ro[rMask];
      }
      // One tile's epilogue, given its accumulator (each array its own
      // call: no accumulator is ever picked at run time). It takes no
      // branch: ptxas serializes every wgmma of the loop where a branch it
      // cannot prove warpgroup-uniform reads the accumulators (note C7520,
      // "WG.AR in divergent path"). A layer's values go to its buffer; a
      // head's real columns, in fp32, to the staging columns in the encoded
      // points' buffer (dead once the trunk is done; T floats a column),
      // copied out after the tile's last operation. Each store is
      // predicated. kRes: a ReLU layer's bits, as phase 1 records them, to
      // its mask block, a byte (8 elements) at a time as store_acc packs
      // them: in bf16 mode the rounded value > 0, read off the stored pair
      // (a bf16 > 0 is a positive int16), in hi_lo the value > 0.
      auto epilogue = [&](int u, float(&acc)[Core::kAcc]) {
        const int f0 = 64 * (wg + 2 * u) + 16 * warp;
        const bool ok = f0 < nn;  // the warp's features lie in the pass
        const int fb = min(f0 + (lane >> 2), nn - 1);
        const float b0 = bias[fb], b1 = bias[min(fb + 8, nn - 1)];
        unsigned char* mk = masks + static_cast<long long>(g) * mask_bytes +
                            max(mask_out, 0) +
                            ((ok ? f0 >> 4 : 0) * 32 + lane) * sizeof(Mask);
        uint32_t byte = 0;
        store_acc<kHiLo, T>(
            smem + bufs[3 * buf], 2 * T * dc,
            bufs[3 * buf + 2] + col0 + (ok ? f0 : 0), lane, ok && !head,
            [&](int i) {
              const float v = acc[i] + ((i & 2) ? b1 : b0);
              if constexpr (kRes && kHiLo) {
                const float a = relu ? fmaxf(v, 0.f) : v;
                byte |= static_cast<uint32_t>(a > 0.f) << (i & 7);
                return a;
              }
              return relu ? fmaxf(v, 0.f) : v;
            },
            [&](int i, uint32_t x) {
              if constexpr (kRes) {
                if constexpr (!kHiLo)
                  byte |= ((static_cast<int16_t>(x & 0xFFFFu) > 0) |
                           (static_cast<int32_t>(x) >= 0x10000) << 1)
                          << (i & 7);
                if ((i & 7) == 6 || i + 2 == Core::kAcc) {
                  st_global_bits_if(mk + (i >> 3),
                                    static_cast<uint8_t>(byte),
                                    ok && mask_out >= 0);
                  byte = 0;
                }
              }
            });
#pragma unroll
        for (int i = 0; i < Core::kAcc; i += 2) {
          const int f = f0 + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int p = 8 * (i >> 2) + 2 * (lane & 3);
          const float b = (i & 2) ? b1 : b0;
          st_shared_v2_if(stage + min(dst + f, out_w - 1) * T + p,
                          acc[i] + b, acc[i + 1] + b, f < n_real);
        }
      };
      epilogue(0, acc0);
      epilogue(1, acc1);
      fence_proxy_async();
      named_sync(kConsumerBar, kConsumers);
      // kRes: the pass's columns into its workspace matrix, one bulk copy
      // a whole strip (the epilogue's fence and barrier made them visible
      // to the copy engine).
      if constexpr (kRes) {
        if (mat >= 0)
          copy_pass_bulk<kHiLo, T>(ws + mat * rows_cap, rows_cap, mat_cols,
                                   ws_row0, col0, smem + bufs[3 * dst],
                                   2 * T * dc, bufs[3 * dst + 2] + col0, nn,
                                   tid);
      }
    }
    // The heads' staged columns to the (n, out_w) output, row-major and
    // coalesced; rows at or past n masked.
    const int out_w = prog[hOutW], all = T * out_w;
    const float* stage = reinterpret_cast<const float*>(smem + bufs[3 * kX]);
    float* out_t = out + (sbase + row0) * out_w;
    const int rest = (n - row0) * out_w;  // values of rows below n
    for (int i0 = 0; i0 < all; i0 += kConsumers) {
      const int i = min(i0 + tid, all - 1), p = i / out_w;
      st_global_if(out_t + min(i, rest - 1), stage[(i - p * out_w) * T + p],
                   i0 + tid < all && i0 + tid < rest);
    }
    named_sync(kConsumerBar, kConsumers);  // read before the next tile
  }
  if constexpr (kRes) bulk_wait_read();
}

template <bool kHiLo, int T, bool kRes>
cudaError_t launch(const float* pts, const void* dirs, const bf16* weights,
                   const float* biases, float* out, const int* prog,
                   int prog_len, int n, int n_scenes, long long w_stride,
                   int b_stride, int smem, const int* res, bf16* ws,
                   long long rows_cap, unsigned char* masks, int mask_bytes,
                   cudaStream_t stream) {
  const long long tiles = kRes ? scene_rows(n, T) / T : (n + T - 1) / T;
  return launch_persistent(fused_mlp_fwd_kernel<kHiLo, T, kRes>,
                           static_cast<long long>(n_scenes) * tiles, smem,
                           stream, pts, dirs, weights, biases, out, prog,
                           prog_len, n, n_scenes, w_stride, b_stride, res, ws,
                           rows_cap, masks, mask_bytes);
}

// Both entry points: res null, the serving forward; else the training
// forward with its residuals.
int forward(const void* pts, const void* dirs, const void* weights,
            const void* biases, void* out, int n, int n_scenes,
            long long w_stride, int b_stride, const void* prog, int prog_len,
            int hi_lo, int rows, int smem, const void* res, void* ws,
            long long rows_cap, void* masks, int mask_bytes, void* stream) {
  if (prog_len < kOpsBase || n_scenes <= 0 || w_stride % 8 ||
      b_stride < 0 || rows <= 0 ||
      static_cast<long long>(n_scenes) * ((n + rows - 1) / rows) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (res != nullptr &&
      (ws == nullptr || masks == nullptr || rows_cap % kStageRows ||
       mask_bytes <= 0 ||
       rows_cap < static_cast<long long>(n_scenes) * scene_rows(n, rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const float*>(pts);
  const auto* w = static_cast<const bf16*>(weights);
  const auto* b = static_cast<const float*>(biases);
  const auto* pr = static_cast<const int*>(prog);
  auto* o = static_cast<float*>(out);
  const auto* rs = static_cast<const int*>(res);
  auto* wsp = static_cast<bf16*>(ws);
  auto* mk = static_cast<unsigned char*>(masks);
  auto* s = static_cast<cudaStream_t>(stream);
#define FWD(HI_LO, T)                                                        \
  if (!!hi_lo == HI_LO && rows == T)                                         \
    return static_cast<int>(                                                \
        rs ? launch<HI_LO, T, true>(p, dirs, w, b, o, pr, prog_len, n,       \
                                    n_scenes, w_stride, b_stride, smem, rs,  \
                                    wsp, rows_cap, mk, mask_bytes, s)        \
           : launch<HI_LO, T, false>(p, dirs, w, b, o, pr, prog_len, n,      \
                                     n_scenes, w_stride, b_stride, smem,     \
                                     nullptr, nullptr, 0, nullptr, 0, s));
  FWD(true, 64)
  FWD(true, 32)
  FWD(true, 16)
  FWD(false, 128)
  FWD(false, 64)
  FWD(false, 32)
  FWD(false, 16)
#undef FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The kernel's fixed shape, for the wrapper to check against its own.
int fused_mlp_fwd_constants(int* out, int len) {
  const int c[] = {kThreads, kMaxN, kHeaderInts, kMaxBufs, kOpInts};
  const int count = static_cast<int>(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < len && i < count; ++i) out[i] = c[i];
  return count;
}

const char* fused_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n_scenes scenes of n points each, scene-major: pts (n_scenes * n, 3)
// fp32; dirs (n_scenes * n, dirs_dim), bf16 (fp32 in hi_lo mode) or null;
// weights bf16 (each block in mlp_tile.cuh's strip layout) and biases
// fp32, scene s's at s * w_stride and s * b_stride elements; out
// (n_scenes * n, out_w) fp32; prog (int32): the program, whose first
// prog_len ints go to shared memory — all on the current device. rows
// (points per tile: 128, 64, 32 or 16; hi_lo 64, 32 or 16) picks the
// kernel; smem: the program's shared-memory bytes. Launches a persistent
// grid of as many CTAs as the card holds at once (and the tiles need) on
// `stream`, does not synchronise, allocates nothing; returns the launch's
// error.
int fused_mlp_fwd(const void* pts, const void* dirs, const void* weights,
                  const void* biases, void* out, int n, int n_scenes,
                  long long w_stride, int b_stride, const void* prog,
                  int prog_len, int hi_lo, int rows, int smem, void* stream) {
  return forward(pts, dirs, weights, biases, out, n, n_scenes, w_stride,
                 b_stride, prog, prog_len, hi_lo, rows, smem, nullptr,
                 nullptr, 0, nullptr, 0, stream);
}

// The training forward: as fused_mlp_fwd, and also its residuals for the
// backward's phase 1 (fused_mlp_fwd_kernel's kRes): res (int32, device)
// the residual table; ws the backward's workspace, rows_cap rows a matrix
// (a multiple of 64, >= n_scenes * scene_rows(n, rows)); masks
// (n_scenes * scene_rows(n, rows) / rows) tiles' mask images of
// mask_bytes each.
int fused_mlp_fwd_res(const void* pts, const void* dirs, const void* weights,
                      const void* biases, void* out, int n, int n_scenes,
                      long long w_stride, int b_stride, const void* prog,
                      int prog_len, int hi_lo, int rows, int smem,
                      const void* res, void* ws, long long rows_cap,
                      void* masks, int mask_bytes, void* stream) {
  if (res == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(pts, dirs, weights, biases, out, n, n_scenes, w_stride,
                 b_stride, prog, prog_len, hi_lo, rows, smem, res, ws,
                 rows_cap, masks, mask_bytes, stream);
}

}  // extern "C"
