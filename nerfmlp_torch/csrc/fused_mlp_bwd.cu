// Fused NeRF-MLP backward for Hopper (sm_90a), split by what bounds each
// part: phase 1 recomputes the forward and walks the dX chain per tile of
// points; phase 2 forms every weight gradient as one long product over the
// points; a reduction sums phase 2's few partial slots in a fixed order.
//
// Replaces the TPU kernel `_bwd_kernel` + `_trunk_bwd`
// (nerfmlp_tpu/ops/pallas_mlp.py:312-441, launched by `_pallas_backward`,
// :444-496) with the same function and the same rounding points: the
// cotangent cast to the compute type; dv masked by v > 0 and rounded; dbott
// rounded; dh rounded after the sigma and bottleneck branches are summed;
// every dacc and every dh down the trunk rounded (mask and rounding commute,
// so one epilogue does both); dW accumulated in fp32 from bf16 operands; db
// an fp32 sum over the rounded cotangents; the skip's d(enc) branch dropped.
// A template flag adds the hi_lo mode (fp32_precision="high",
// pallas_mlp.py:347-365): every value is a (hi, lo) pair of bf16 planes and
// every product is hi*hi + lo*hi + hi*lo.
//
// Work at 8x256 with the view head, per point: 1,150,464 MACs in phase 1
// (the recomputed forward without the two output heads, and dX) and
// 593,408 in phase 2 (dW); the function's floor is the 989 TFLOP/s bf16
// peak over 3.49 MFLOP per point, 0.462 ms for 131,072 points. This design
// adds a workspace that phase 1 writes and phase 2 reads, 9,984 B per point
// (1.31 GB at 131,072 points), so its own floor is about 0.78 ms: phase 1
// by the bytes it writes, phase 2 by the bytes it reads.
//
// Phase 1 (bwd_phase1_kernel). The TPU kernel keeps a tile's activations
// in VMEM; here they stay in shared memory, so phase 1 runs on the
// forward's core (mlp_tile.cuh): wgmma with the products transposed (the
// layer's output features as M, the tile's points as N), weight stages
// streamed by a producer warp through a ring of bulk copies behind full and
// empty mbarriers (multicast over a cluster where the layout asks; the
// layouts take one CTA, which measured as fast or faster). What bounded
// the design before it (mma.sync from ldmatrix fragments, a block barrier
// per 16-row stage, every weight restreamed per 16- or 32-point tile on
// the wide nets) was latency and L2 traffic, at 6-57x the bound.
//   * dX reads the forward's weight image as it lies: the same bytes are
//     W^T for the forward (M-major A) and W for dX (K-major A); a dX stage
//     is one 64-column strip of the block and up to 256 of its rows (the
//     pass's output features), so both walk the same image.
//   * A persistent grid of clusters walks tile groups. The tile's input
//     and output activations live in shared memory (the encoded points and
//     dirs, one buffer written in place where every layer is one pass,
//     else two ping-pong buffers), the cotangent laid over the encoded
//     points once they are dead. A layer wider than 256 is cut by the
//     wrapper into column passes of at most 256, each an operation over
//     the whole K of its operands: a dX pass reads the whole cotangent and
//     writes its columns, so each value is rounded once, after its whole
//     sum, as the TPU kernel rounds it.
//   * The ReLU masks the dX chain needs are kept as bits in shared memory,
//     one block per column pass of each ReLU layer: the warpgroup that owns
//     a pass's features in the forward owns them in dX, so each thread
//     writes its accumulator fragment's bits in the forward epilogue and
//     reads them back in the dX epilogue (one entry of T / 2 bits per 16
//     features), with no other thread involved.
//   * A deep net's program (866x16: 1,737 operations, 125 KB) can crowd the
//     masks and buffers out of shared memory. Where it does, only the
//     header and buffer table are copied there, and the matrix and
//     operation tables are read from device memory (one broadcast load
//     through L1 per record). A template flag picks where they are.
//   * The epilogue stores its accumulators with stmatrix into the
//     destination buffer; each pass's columns are then copied, 16 B a
//     thread, into a row-major (rows, width) workspace matrix.
// Phase 2 (bwd_phase2_kernel). The TPU adds each tile's dW into one
// accumulator over its sequential grid; on 132 parallel blocks that would
// be a read-modify-write of a 2.4 MB partial slot per tile, ~4.6 GB per
// call of 131,072 points.
//   * dW_b = A_b^T dY_b is a product with the points as its long K: one
//     block per 128 x 128 tile of one weight block and one split of the
//     rows, accumulating in registers over its whole range of rows through
//     a 3-stage cp.async ring of 64-row (rows x k) and (rows x n) tiles;
//     A^T comes from ldmatrix.trans. The block writes one fp32 partial.
//   * db is the column sum of the same dY tiles, in fp32, in the blocks
//     that hold the first k-tile of a layer's first weight block.
//   * Jobs are ordered largest weight block first, and the tiles of one
//     weight block and split are neighbours, so blocks that share an
//     operand run together and the second read comes from L2.
// Reduction (reduce_partials_kernel), bound by bytes: float4 loads, sixteen
// slots in flight at a time, added in slot order, so the sum repeats bit
// for bit and equals the plain sum. Nothing here uses atomics.
//
// The network arrives as a program built by the Python wrapper
// (nerfmlp_torch/ops/fused_mlp.py, pack_params): a header, a shared-memory
// buffer table, a workspace matrix table, one record per phase-1 operation
// (forward layer, dX, load of the cotangent) and phase 2's job list, each
// table sized by the net (any depth), at the bases the header gives. Every
// width is padded to a multiple of 16 with zeros, so padding adds exactly
// zero. Rows at or past n load a zero cotangent, so they contribute nothing.
//
// A scene axis (the TPU kernels under jax.vmap: one pallas_call with a
// leading grid axis over scenes): each launch runs S nets of one
// architecture, scene s with its own weights and biases (at s times a
// stride), its own n points, dirs and cotangent rows (scene-major, at s *
// n), its own workspace rows and its own partial slots.
//   * Phase 1 walks S * rows_s / T tiles in groups of a cluster's tiles,
//     none straddling two scenes, rows_s = n rounded up to the tile and to
//     phase 2's 64-row stage (scene_rows); tile t of scene s is workspace
//     rows (s * rows_s / T + t) * T on. The producer keeps the scene of
//     the group it streams for.
//   * Phase 2's blocks are (job, split, scene): scene s's splits cover its
//     rows_s rows only, and write slot block s of the partials.
//   * The reduction sums each scene's slots (grid y: the scene) in the order
//     it sums one scene's.
// So every per-scene result is bit-equal to a launch of that scene alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

using namespace mlp_tile;

constexpr int kThreads = 256;     // phase 2: 8 warps
constexpr int kP2Threads = kThreads;
constexpr int kP1Threads = mlp_tile::kThreads;
constexpr int kHeaderInts = 32;
constexpr int kMaxBufs = 8;       // shared-memory buffers: byte offset,
                                  // columns, first column (mlp_tile.cuh)
constexpr int kOpInts = 16;
constexpr int kBufsBase = kHeaderInts;
// The matrix table (column offset, cols per workspace matrix) and the
// operation table follow the buffer table, sized by the net: the header
// holds their bases and counts.
constexpr int kTablesBase = kBufsBase + 3 * kMaxBufs;
constexpr int kTileK = 128;       // phase 2: dW rows per block
constexpr int kTileN = 128;       // phase 2: dW columns per block
constexpr int kStageRows = 64;    // phase 2: points per ring stage
constexpr int kStages2 = 3;
constexpr int kLd2 = kTileK + kPad;
constexpr int kJobInts = 10;

// Header fields.
enum Header {
  hNOps = 0, hProgLen, hNFreqs, hEncDim, hDirsDim, hGCols, hGrCols,
  hXBuf, hDBuf, hGrBuf, hGsBuf, hXMat, hDMat, hGrMat, hGsMat,
  hStages, hRingOff, hSlotBytes, hMaskOff, hSmem, hWsCols, hJobsOff,
  hNJobs, hRows, hMatsBase, hOpsBase, hNMats, hCluster, hBarOff
};

// Operation record fields after mlp_tile.cuh's CoreField:
//   kOpFwd:  dst[:, col:col + n] = act(A @ WA + B @ WB + bias), bias at
//            cBias (the pass's first column); act = ReLU when maskOut >=
//            0, which also records dst > 0 into that mask block
//   kOpDx:   dst[:, col:col + n] = mask(A @ WA^T + B @ WB^T); maskIn: a
//            mask block, or -1
//   kOpNone: the cotangent into buffers GR / GS and their matrices
// dst's pass is then copied into workspace matrix `mat` (if >= 0). A mask
// block (maskIn / maskOut: its byte offset in the mask region, or -1) holds
// the bits of one column pass of a ReLU layer: for the warp tile of its
// features 16 v.., lane l's entry (its accumulator fragment's T / 2 bits,
// bit i for element i) at (32 v + l) entries.
enum Field { fMaskIn = cBias + 1, fMaskOut, fMat };

// Job record fields (phase 2): the tile [k0, k0 + kc) x [n0, n0 + nc) of
// the weight block whose gradient starts at `off` (row stride `ld`), from
// workspace matrices A (activations) and Y (cotangent); `db`: the bias
// gradient's offset when this job also sums Y's columns, else -1.
enum JobField { jA = 0, jK0, jKc, jY, jN0, jNc, jOff, jLd, jDb };

// A value into a shared-memory buffer (byte address) and its workspace
// matrix: bf16, or in hi_lo mode the pair (hi, lo) = (bf16(v), bf16(v -
// hi)) into two planes.
template <bool kHiLo>
__device__ __forceinline__ void put2(unsigned char* s, int s_plane, bf16* w,
                                     long long w_plane, float v) {
  const bf16 h = __float2bfloat16(v);
  *reinterpret_cast<bf16*>(s) = h;
  w[0] = h;
  if (kHiLo) {
    const bf16 l = __float2bfloat16(v - __bfloat162float(h));
    *reinterpret_cast<bf16*>(s + s_plane) = l;
    w[w_plane] = l;
  }
}

// A scene's workspace rows: its n points rounded up to the tile of T
// points and to phase 2's stage of kStageRows rows (smaller tiles fill the
// rows up to a stage with points past n, which are zero).
__host__ __device__ inline int scene_rows(int n, int t) {
  const int step = t > kStageRows ? t : kStageRows;
  return (n + step - 1) / step * step;
}

// A thread's ReLU bits of one 16-feature warp tile: T / 2 of them.
template <int T> struct MaskWord { using type = uint64_t; };
template <> struct MaskWord<64> { using type = uint32_t; };
template <> struct MaskWord<32> { using type = uint16_t; };
template <> struct MaskWord<16> { using type = uint8_t; };
template <> struct MaskWord<8> { using type = uint8_t; };

// Phase 1 over tiles of T points, its matrix and operation tables in
// shared memory (kSharedTables) or device memory.
template <bool kHiLo, int T, bool kSharedTables>
__global__ void __launch_bounds__(mlp_tile::kThreads, 1)
bwd_phase1_kernel(const float* __restrict__ pts, const void* __restrict__ dirs,
                  const float* __restrict__ g, const bf16* __restrict__ weights,
                  const float* __restrict__ biases,
                  const int* __restrict__ prog_in, int prog_len, int n,
                  int n_scenes, bf16* __restrict__ ws, long long rows_cap,
                  long long w_stride, int b_stride) {
  using Mask = typename MaskWord<T>::type;
  using Core = Consumer<kHiLo, T>;
  extern __shared__ __align__(128) unsigned char smem[];
  // The program's first prog_len ints: the header and buffer table, and
  // with kSharedTables the matrix and operation tables (else those are read
  // from device memory, where every thread reads the same record: one
  // broadcast load through L1).
  int* prog = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < prog_len; i += mlp_tile::kThreads)
    prog[i] = prog_in[i];
  const int stages = prog_in[hStages];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + prog_in[hBarOff]);
  uint64_t* empty = full + stages;
  const int csize = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  if (threadIdx.x == 0) init_ring(full, empty, stages, csize);
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or arrive

  const int* tables = kSharedTables ? prog : prog_in;
  const int* bufs = prog + kBufsBase;
  const int* mats = tables + prog[hMatsBase];
  const int* ops = tables + prog[hOpsBase];
  const int n_ops = prog[hNOps];
  unsigned char* ring = smem + prog[hRingOff];
  unsigned char* masks = smem + prog[hMaskOff];
  const int slot_bytes = prog[hSlotBytes];
  const int half = kHiLo ? slot_bytes / 2 : 0;
  const int tiles = scene_rows(n, T) / T;
  const int groups = scene_groups(tiles, csize);
  const int n_groups = n_scenes * groups;
  const int cluster_id = static_cast<int>(blockIdx.x) / csize;
  const int n_clusters = static_cast<int>(gridDim.x) / csize;
  const int wg = threadIdx.x / 128;
  auto matp = [&](int m) {
    return ws + static_cast<long long>(mats[2 * m]) * rows_cap;
  };
  auto mcols = [&](int m) { return mats[2 * m + 1]; };

  // The roles never meet again: ptxas treats the code of a branch that
  // reconverges as divergent and serializes every wgmma in it.
  if (wg == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32)
      produce<kHiLo>(ops, kOpInts, n_ops, weights, w_stride, groups, n_groups,
                     cluster_id, n_clusters, stages, ring, slot_bytes, half,
                     full, empty, rank, csize == 8 ? 3 : csize == 4 ? 2
                                                                    : csize - 1);
    cluster_sync();  // no CTA leaves while the cluster may still reach it
    return;
  }
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const uint32_t base = smem_u32(smem);
  float acc0[Core::kAcc], acc1[Core::kAcc];
  Ring pos;
  for (int g_i = cluster_id; g_i < n_groups; g_i += n_clusters) {
    // The tile's scene, its first point within the scene (p0), its
    // workspace rows (row0 on) and the scene's points, dirs, cotangent
    // rows and biases.
    const int scene = g_i / groups;
    const int tile = (g_i - scene * groups) * csize + rank;
    const bool live = tile < tiles;
    const int p0 = tile * T;
    const int row0 = (scene * tiles + tile) * T;
    const long long sbase = static_cast<long long>(scene) * n;
    const float* pts_s = pts + 3 * sbase;
    const float* bias_s = biases + static_cast<long long>(scene) * b_stride;

    if (live) {
      // Encoded points (mlp_tile.cuh's encode_pair, as the forward).
      const int xb = prog[hXBuf], xm = prog[hXMat];
      const int xc = mcols(xm), enc_dim = prog[hEncDim];
      const int x_plane = 2 * T * bufs[3 * xb + 1];
      unsigned char* xs = smem + bufs[3 * xb];
      bf16* xw = matp(xm) + static_cast<long long>(row0) * xc;
      for (int idx = tid; idx < T * xc; idx += kConsumers) {
        const int r = idx / xc, j = idx - r * xc, gr = p0 + r;
        float v0 = 0.f, v1 = 0.f;
        const int got =
            (gr < n && j < enc_dim) ? encode_pair(pts_s, gr, j, &v0, &v1) : 1;
        if (got)
          put2<kHiLo>(xs + act_byte<T>(r, j), x_plane, xw + idx,
                      rows_cap * xc, v0);
        if (got == 2)
          put2<kHiLo>(xs + act_byte<T>(r, j + 3), x_plane, xw + idx + 3,
                      rows_cap * xc, v1);
      }
      // Encoded view directions: bf16, or fp32 in hi_lo mode.
      if (prog[hDBuf] >= 0) {
        const int db = prog[hDBuf], dm = prog[hDMat];
        const int dc = mcols(dm), dirs_dim = prog[hDirsDim];
        unsigned char* ds = smem + bufs[3 * db];
        bf16* dw = matp(dm) + static_cast<long long>(row0) * dc;
        for (int idx = tid; idx < T * dc; idx += kConsumers) {
          const int r = idx / dc, j = idx - r * dc, gr = p0 + r;
          float v = 0.f;
          if (gr < n && j < dirs_dim) {
            const long long at = (sbase + gr) * dirs_dim + j;
            v = kHiLo ? static_cast<const float*>(dirs)[at]
                      : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
          }
          put2<kHiLo>(ds + act_byte<T>(r, j), 2 * T * bufs[3 * db + 1],
                      dw + idx, rows_cap * dc, v);
        }
      }
      fence_proxy_async();
    }
    named_sync(kConsumerBar, kConsumers);

    for (int oi = 0; oi < n_ops; ++oi) {
      const int* o = ops + oi * kOpInts;
      const int kind = o[cKind];
      if (kind == kOpNone) {
        // The cotangent, cast to the compute type: its first gr_cols
        // columns into GR (rgb, or the whole output head), the rest into
        // GS (sigma). Rows at or past n are zero. The buffers lie in the
        // encoded points' atoms, which no later operation of the tile
        // reads.
        if (live) {
          const int g_cols = prog[hGCols], gr_cols = prog[hGrCols];
          for (int which = 0; which < 2; ++which) {
            const int b = which ? prog[hGsBuf] : prog[hGrBuf];
            if (b < 0) continue;
            const int m = which ? prog[hGsMat] : prog[hGrMat];
            const int mc = mcols(m), cb = bufs[3 * b + 2];
            const int c0 = which ? gr_cols : 0;
            const int cn = which ? g_cols - gr_cols : gr_cols;
            unsigned char* gs = smem + bufs[3 * b];
            bf16* gw = matp(m) + static_cast<long long>(row0) * mc;
            // The same trips on every thread, the tail predicated: this
            // loop lies in the operation loop.
            for (int i0 = 0; i0 < T * mc; i0 += kConsumers) {
              const int idx = min(i0 + tid, T * mc - 1);
              const bool in = i0 + tid < T * mc;
              const int r = idx / mc, j = idx - r * mc, gr = p0 + r;
              const float v =
                  g[(sbase + min(gr, n - 1)) * g_cols + c0 + min(j, cn - 1)];
              const float x = gr < n && j < cn ? v : 0.f;
              const bf16 h = __float2bfloat16(x);
              unsigned char* at = gs + act_byte<T>(r, cb + j);
              st_shared_if(at, h, in);
              st_global_if(gw + idx, h, in);
              if (kHiLo) {
                const bf16 l = __float2bfloat16(x - __bfloat162float(h));
                st_shared_if(at + 2 * T * bufs[3 * b + 1], l, in);
                st_global_if(gw + idx + rows_cap * mc, l, in);
              }
            }
          }
          fence_proxy_async();
        }
        named_sync(kConsumerBar, kConsumers);
        continue;
      }
      Core::op(o, pos, stages, ring, slot_bytes, half, full, empty, bufs,
               base, smem_u32(full + 2 * kMaxStages), wg, tid & 127, csize,
               live, acc0, acc1);
      if (!live) continue;
      const int dst = o[cDst], nn = o[cN], col0 = o[cCol];
      if (dst == o[cSrcA] || (o[cKB] && dst == o[cSrcB]))
        named_sync(kConsumerBar, kConsumers);  // in place: all reads done

      // Epilogue. Forward: fp32 bias, then ReLU, recording dst > 0 (of
      // the rounded value in bf16 mode) into the mask block. dX: the mask
      // block of the stored activation. Then the compute type, into dst's
      // columns of the pass (mlp_tile.cuh's store_acc). Each value is a
      // whole K sum, rounded once.
      const int mask_in = o[fMaskIn], mask_out = o[fMaskOut];
      const float* bias = bias_s + o[cBias];
      unsigned char* d = smem + bufs[3 * dst];
      const int d_plane = 2 * T * bufs[3 * dst + 1];
      const int dcol = bufs[3 * dst + 2] + col0;
      // One tile's epilogue, given its accumulator (each array its own
      // call: no accumulator is ever picked at run time).
      auto epilogue = [&](int u, float(&acc)[Core::kAcc]) {
        const int f0 = 64 * (wg + 2 * u) + 16 * warp;
        const bool ok = f0 < nn;  // the warp's features lie in the pass
        const int entry = (ok ? f0 >> 4 : 0) * 32 + lane;
        if (kind == kOpFwd) {
          const int fb = min(f0 + (lane >> 2), nn - 1);
          const float b0 = bias[fb], b1 = bias[min(fb + 8, nn - 1)];
          const bool relu = mask_out >= 0;
          Mask bits = 0;
          store_acc<kHiLo, T>(d, d_plane, dcol + (ok ? f0 : 0), lane, ok,
                              [&](int i) {
            float v = acc[i] + ((i & 2) ? b1 : b0);
            if (relu) {
              v = fmaxf(v, 0.f);
              const bool on =
                  kHiLo ? v > 0.f : __bfloat162float(__float2bfloat16(v)) > 0.f;
              bits |= static_cast<Mask>(on) << i;
            }
            return v;
          });
          if (relu)
            st_shared_if(masks + mask_out + entry * sizeof(Mask), bits, ok);
        } else {
          const Mask bits = mask_in >= 0
              ? reinterpret_cast<const Mask*>(masks + mask_in)[entry]
              : static_cast<Mask>(~static_cast<Mask>(0));
          store_acc<kHiLo, T>(d, d_plane, dcol + (ok ? f0 : 0), lane, ok,
                              [&](int i) {
            return ((bits >> i) & 1) ? acc[i] : 0.f;
          });
        }
      };
      epilogue(0, acc0);
      epilogue(1, acc1);
      fence_proxy_async();
      named_sync(kConsumerBar, kConsumers);

      // The pass's columns, 16 B a thread, into its workspace matrix (a
      // loop of the same trips on every thread, its tail predicated).
      const int m = o[fMat];
      if (m >= 0) {
        const int cols = mcols(m), chunks = nn >> 3, all = T * chunks;
        bf16* w = matp(m) + static_cast<long long>(row0) * cols + col0;
        for (int c0 = 0; c0 < all; c0 += kConsumers) {
          const int c = min(c0 + tid, all - 1);
          const int r = c / chunks, cc = c - r * chunks;
          const unsigned char* s = d + act_byte<T>(r, dcol + 8 * cc);
          const long long at = static_cast<long long>(r) * cols + cc * 8;
          copy16_if(w + at, s, c0 + tid < all);
          if (kHiLo) copy16_if(w + rows_cap * cols + at, s + d_plane,
                               c0 + tid < all);
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while the cluster may still reach it
}

// dW and db partials of one job, one split of the rows and one scene.
template <bool kHiLo>
__global__ void __launch_bounds__(kThreads)
bwd_phase2_kernel(const bf16* __restrict__ ws, long long rows_cap,
                  const int* __restrict__ prog, const int* __restrict__ jobs,
                  int n_jobs, int rows, int splits, int split_rows,
                  float* __restrict__ part, long long part_stride,
                  long long part_scene_stride) {
  constexpr int kPlane = kStageRows * kLd2;  // one [64][136] tile
  constexpr int kStage = 2 * kPlane * (kHiLo ? 2 : 1);
  constexpr int kLo = 2 * kPlane;             // lo planes follow both his
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int job = blockIdx.x % n_jobs, split = (blockIdx.x / n_jobs) % splits;
  const int scene = blockIdx.x / n_jobs / splits;
  const int* jb = jobs + job * kJobInts;
  const int* mats = prog + prog[hMatsBase];
  const int am = jb[jA], ym = jb[jY];
  const int k0 = jb[jK0], kc = jb[jKc], n0 = jb[jN0], nc = jb[jNc];
  const int ac = mats[2 * am + 1], yc = mats[2 * ym + 1];
  const bf16* A = ws + static_cast<long long>(mats[2 * am]) * rows_cap + k0;
  const bf16* Y = ws + static_cast<long long>(mats[2 * ym]) * rows_cap + n0;
  const long long a_lo = rows_cap * ac, y_lo = rows_cap * yc;
  // The scene's rows are rows [scene * rows, (scene + 1) * rows).
  const long long r_end = static_cast<long long>(scene + 1) * rows;
  const long long r0 = r_end - rows + static_cast<long long>(split) * split_rows;
  const long long r1 = min(r_end, r0 + split_rows);
  const int n_st = r1 > r0 ? static_cast<int>((r1 - r0) / kStageRows) : 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = (warp >> 2) * 64;  // the warp's k rows of the tile
  const int nb = (warp & 3) * 32;   // ... and its n columns

  // This thread's chunks of a stage: slot c = tid + kThreads i holds row
  // c / 16 and 16-byte chunk c % 16 of the A and Y tiles.
  constexpr int kChunks = kStageRows * 16 / kThreads;
  const int ca = kc / 8, cy = nc / 8;
  auto load = [&](int st, int slot) {
    const long long r = r0 + st * kStageRows;
    bf16* sa = ring + slot * kStage;
    bf16* sy = sa + kPlane;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads, rr = c >> 4, cc = c & 15;
      const int at = rr * kLd2 + cc * 8;
      if (cc < ca) {
        const long long src = (r + rr) * ac + cc * 8;
        cp_async16(sa + at, A + src);
        if (kHiLo) cp_async16(sa + kLo + at, A + a_lo + src);
      }
      if (cc < cy) {
        const long long src = (r + rr) * yc + cc * 8;
        cp_async16(sy + at, Y + src);
        if (kHiLo) cp_async16(sy + kLo + at, Y + y_lo + src);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const bool do_db = jb[jDb] >= 0;
  const int db_col = tid & 127, db_half = tid >> 7;
  float db_sum = 0.f;

  for (int s = 0; s < kStages2 - 1; ++s) {
    if (s < n_st) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kStages2 - 2>();
    __syncthreads();
    if (i + kStages2 - 1 < n_st)
      load(i + kStages2 - 1, (i + kStages2 - 1) % kStages2);
    cp_async_commit();
    const bf16* sa = ring + (i % kStages2) * kStage;
    const bf16* sy = sa + kPlane;
#pragma unroll
    for (int kk = 0; kk < kStageRows; kk += 16) {
      // A^T: the m16 tile is 16 k-columns of A, its K the 16 rows.
      uint32_t a[4][4], al[4][4];
      const bf16* pa = sa + (kk + (lane & 7) + ((lane >> 4) << 3)) * kLd2 +
                       kb + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (kb + 16 * mt < kc) {
          ldsm_x4_t(a[mt], pa + 16 * mt);
          if (kHiLo) ldsm_x4_t(al[mt], pa + 16 * mt + kLo);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = nb + 16 * p;
        if (c >= nc) continue;
        uint32_t b[4], bl[4];
        const bf16* q = sy + (kk + (lane & 15)) * kLd2 + c + (lane >> 4) * 8;
        ldsm_x4_t(b, q);
        if (kHiLo) ldsm_x4_t(bl, q + kLo);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (kb + 16 * mt >= kc) continue;
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
    }
    if (do_db && db_col < nc) {
#pragma unroll 4
      for (int rr = 0; rr < kStageRows / 2; ++rr) {
        const int at = (kStageRows / 2 * db_half + rr) * kLd2 + db_col;
        float v = __bfloat162float(sy[at]);
        if (kHiLo) v += __bfloat162float(sy[kLo + at]);
        db_sum += v;
      }
    }
  }
  cp_async_wait<0>();

  float* P = part + scene * part_scene_stride +
             static_cast<long long>(split) * part_stride;
  const int off = jb[jOff], ld = jb[jLd];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (kb + 16 * mt >= kc) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nb + 8 * nt >= nc) continue;
      const int k = k0 + kb + 16 * mt + (lane >> 2);
      const int c = n0 + nb + 8 * nt + 2 * (lane & 3);
      float* at = P + off + static_cast<long long>(k) * ld + c;
      *reinterpret_cast<float2*>(at) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(at + 8LL * ld) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  if (do_db) {
    __syncthreads();  // the ring is idle: reuse it for the two halves
    float* halves = reinterpret_cast<float*>(smem);
    if (db_half) halves[db_col] = db_sum;
    __syncthreads();
    if (!db_half && db_col < nc) P[jb[jDb] + n0 + db_col] = db_sum + halves[db_col];
  }
}

// out[j] = the sum over `slots` partial rows of part[s * stride + j], added
// in slot order: the same bits on every run, and those of the plain sum.
// Blocks of 64 threads, one float4 column each, so that the blocks spread
// evenly over the SMs. Grid y is the scene: its slots at blockIdx.y *
// slots * stride, its sum at blockIdx.y * total.
constexpr int kReduceThreads = 64;
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ part, int slots,
                       long long stride, float* __restrict__ out,
                       long long total) {
  const long long n4 = (total + 3) / 4, s4 = stride / 4;
  part += static_cast<long long>(blockIdx.y) * slots * stride;
  out += static_cast<long long>(blockIdx.y) * total;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (long long q = blockIdx.x * static_cast<long long>(kReduceThreads) +
                     threadIdx.x;
       q < n4; q += static_cast<long long>(gridDim.x) * kReduceThreads) {
    float4 s = __ldg(p4 + q);
    for (int b = 1; b < slots; b += 16) {
      float4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (b + u < slots) v[u] = __ldg(p4 + (b + u) * s4 + q);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (b + u < slots) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
      }
    }
    const long long j = 4 * q;
    if (j + 3 < total) {
      *reinterpret_cast<float4*>(out + j) = s;
    } else {
      const float e[4] = {s.x, s.y, s.z, s.w};
      for (int u = 0; j + u < total; ++u) out[j + u] = e[u];
    }
  }
}

template <bool kHiLo, int T, bool kSharedTables>
cudaError_t launch_phase1(const float* pts, const void* dirs, const float* g,
                          const bf16* weights, const float* biases,
                          const int* prog, int prog_len, int n,
                          int n_scenes, long long w_stride, int b_stride,
                          int csize, int smem, bf16* ws, long long rows_cap,
                          cudaStream_t stream) {
  auto kernel = bwd_phase1_kernel<kHiLo, T, kSharedTables>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long groups = static_cast<long long>(n_scenes) *
                           scene_groups(scene_rows(n, T) / T, csize);
  int clusters = 0;
  err = max_clusters(kernel, csize, smem, &clusters);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(groups < clusters ? groups : clusters);
  return launch_clusters(kernel, grid, csize, smem, stream, pts, dirs, g,
                         weights, biases, prog, prog_len, n, n_scenes, ws,
                         rows_cap, w_stride, b_stride);
}

template <bool kHiLo>
cudaError_t launch_phase2(const bf16* ws, long long rows_cap, const int* prog,
                          const int* jobs, int n_jobs, int rows, int splits,
                          int split_rows, int n_scenes, float* part,
                          long long part_stride, long long part_scene_stride,
                          cudaStream_t stream) {
  const int smem = kStages2 * 2 * kStageRows * kLd2 * 2 * (kHiLo ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_phase2_kernel<kHiLo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  bwd_phase2_kernel<kHiLo><<<n_jobs * splits * n_scenes, kThreads, smem,
                              stream>>>(
      ws, rows_cap, prog, jobs, n_jobs, rows, splits, split_rows, part,
      part_stride, part_scene_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernels' fixed shape, for the wrapper to check against its own.
int fused_mlp_bwd_constants(int* out, int len) {
  // ... then phase 1's tile sizes: bf16, then hi_lo.
  const int c[] = {kP2Threads, kPad,        kMaxN,      kHeaderInts,
                   kMaxBufs,   kOpInts,     kTileK,     kTileN,
                   kStageRows, kStages2,    kJobInts,   kP1Threads,
                   128, 64, 32, 16, 64, 32, 16, 8};
  const int count = static_cast<int>(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < len && i < count; ++i) out[i] = c[i];
  return count;
}

const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Phase 1 for n_scenes scenes of n points each, scene-major. pts
// (n_scenes * n, 3) fp32; dirs (n_scenes * n, dirs_dim) bf16 (fp32 in
// hi_lo mode) or null; g (n_scenes * n, g_cols) fp32; weights bf16 and
// biases fp32 as packed for the forward, scene s's at s * w_stride and
// s * b_stride elements; prog (device, int32): the program, whose first
// prog_len ints go to shared memory: through the operation table, or the
// header and buffer table alone; rows: the program's points per tile (128,
// 64, 32 or 16; hi_lo 64, 32, 16 or 8), which with prog_len picks the
// kernel, cluster its CTAs a cluster (1, 2, 4 or 8); smem: the program's
// shared-memory bytes; ws: the workspace, rows_cap rows per matrix (>=
// n_scenes times scene_rows(n, rows); scene s's from s times that).
// Launches a persistent grid of as many clusters as the card holds at once
// (and the tile groups need) on `stream`, does not synchronise, allocates
// nothing; returns the launch's error.
int fused_mlp_bwd_phase1(const void* pts, const void* dirs, const void* g,
                         const void* weights, const void* biases,
                         const void* prog, int prog_len, int hi_lo, int rows,
                         int cluster, int n, int n_scenes, long long w_stride,
                         int b_stride, int smem, void* ws, long long rows_cap,
                         void* stream) {
  if (prog_len < kTablesBase || n_scenes <= 0 || w_stride % 8 ||
      b_stride < 0 || rows <= 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      rows_cap < static_cast<long long>(n_scenes) * scene_rows(n, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const float*>(pts);
  const auto* gg = static_cast<const float*>(g);
  const auto* w = static_cast<const bf16*>(weights);
  const auto* b = static_cast<const float*>(biases);
  const auto* pr = static_cast<const int*>(prog);
  auto* wsp = static_cast<bf16*>(ws);
  auto* s = static_cast<cudaStream_t>(stream);
  // The tables stay in device memory only where the program ends at the
  // buffer table (a deep or wide hi_lo net whose masks and buffers crowd
  // shared memory).
  const bool shared_tables = prog_len > kTablesBase;
#define PHASE1(HI_LO, T, SHARED)                                             \
  if (!!hi_lo == HI_LO && rows == T && shared_tables == SHARED)              \
    return static_cast<int>(launch_phase1<HI_LO, T, SHARED>(                \
        p, dirs, gg, w, b, pr, prog_len, n, n_scenes, w_stride, b_stride,    \
        cluster, smem, wsp, rows_cap, s));
  PHASE1(false, 128, true)
  PHASE1(false, 64, true)
  PHASE1(false, 32, true)
  PHASE1(false, 16, true)
  PHASE1(true, 64, true)
  PHASE1(true, 32, true)
  PHASE1(true, 16, true)
  PHASE1(true, 16, false)
  PHASE1(true, 8, false)
#undef PHASE1
  return static_cast<int>(cudaErrorInvalidValue);
}

// Phase 2 over n_scenes scenes of `rows` workspace rows each (a multiple
// of 64; scene s's from s * rows): n_jobs jobs (device, int32) x `splits`
// ranges of split_rows rows (a multiple of 64) x the scenes, each writing
// its tile into part[scene * part_scene_stride + split * part_stride +
// ...] (fp32). Every element of each scene's packed gradient is written
// once per split.
int fused_mlp_bwd_phase2(const void* ws, long long rows_cap, const void* prog,
                         const void* jobs, int n_jobs, int hi_lo, int rows,
                         int splits, int split_rows, int n_scenes, void* part,
                         long long part_stride, long long part_scene_stride,
                         void* stream) {
  if (n_jobs <= 0 || splits <= 0 || n_scenes <= 0 || rows % kStageRows ||
      split_rows % kStageRows ||
      static_cast<long long>(n_scenes) * rows > rows_cap ||
      static_cast<long long>(splits) * split_rows < rows ||
      static_cast<long long>(n_jobs) * splits * n_scenes > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const bf16*>(ws);
  const auto* pr = static_cast<const int*>(prog);
  const auto* jb = static_cast<const int*>(jobs);
  auto* pa = static_cast<float*>(part);
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hi_lo ? launch_phase2<true>(w, rows_cap, pr, jb, n_jobs, rows, splits,
                                  split_rows, n_scenes, pa, part_stride,
                                  part_scene_stride, s)
            : launch_phase2<false>(w, rows_cap, pr, jb, n_jobs, rows, splits,
                                   split_rows, n_scenes, pa, part_stride,
                                   part_scene_stride, s));
}

// For each of n_scenes scenes: out (total,) at scene * total = the sum of
// `slots` partial rows of `stride` floats each, at scene * slots * stride
// (stride and total multiples of 4 when n_scenes > 1, part and out 16-byte
// aligned).
int fused_mlp_bwd_reduce(const void* part, int slots, long long stride,
                         void* out, long long total, int n_scenes,
                         void* stream) {
  if (slots <= 0 || total < 0 || stride < total || stride % 4 ||
      n_scenes <= 0 || n_scenes > 65535 || (n_scenes > 1 && total % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = ((total + 3) / 4 + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 65535) blocks = 65535;
  reduce_partials_kernel<<<dim3(static_cast<unsigned>(blocks),
                                static_cast<unsigned>(n_scenes)),
                           kReduceThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), slots, stride,
      static_cast<float*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
