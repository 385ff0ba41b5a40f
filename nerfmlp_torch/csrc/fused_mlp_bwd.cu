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
// in VMEM. A per-block device-memory scratch in their place would hold
// 786 KB per block, 104 MB over 132 blocks: twice the 50 MB L2, so every
// product would wait on HBM.
//   * A persistent grid (one block per SM) walks tiles of 128 points (64 in
//     hi_lo). The tile's current input and output activations live in
//     shared memory (two ping-pong buffers, the encoded points and dirs), so
//     the A operand of every product comes from shared memory by ldmatrix.
//     Where a net's buffers and masks leave no room for two weight stages
//     (wider than 256), the wrapper picks 64-, then 32-point tiles (hi_lo:
//     32, then 16): at 8x512 bf16 64 points, at 8x640 32, at 8x384 hi_lo
//     32, at 8x608 hi_lo 16; bf16 takes 16-point tiles at depth 1 from
//     width 1552. The weights then stream once per smaller tile: the price
//     of fitting the activations in 227 KB. At hi_lo 1x1456 and 1x1472
//     even 16-point tiles leave no room for two 256-column stages of two
//     planes; the wrapper cuts those nets' layers into passes of 128
//     columns, whose stages and mask blocks are half as wide. The kernel
//     takes a pass's width from its operation record and a stage's size
//     from the header, so it needs nothing else for them.
//   * Weights stream through a ring of 16-row k-slabs (3 stages at 8x256,
//     2 in hi_lo) filled by cp.async two slabs (one in hi_lo) ahead of the
//     product; one barrier per slab. The slab sequence runs across
//     operations and tiles, so the ring never drains, and each thread's
//     chunk of an operand's slabs is set up once per operand: issuing a
//     slab costs a few instructions. A ring of bulk copies instead (warp 0
//     copying each slab's 16 rows with cp.async.bulk, a full and an empty
//     mbarrier per stage, no block barrier per slab, dX from a transposed
//     copy of the weights) measured 29% slower on an H100 (PERF.md). The
//     likely causes, not measured apart: a ring two slabs deep does not
//     hide a bulk copy's latency, and warp 0, a consumer too, waits for
//     the slowest warp before each refill.
//   * mma.sync m16n8k16 bf16 with fp32 accumulators (not wgmma); 16 warps
//     over the tile and one pass of up to 256 output columns
//     (mlp_tile.cuh's WarpGrid: each warp 32 x 64 of a 128-point tile, 16 x
//     64 of a 64-point one, 16 x 32 of a 32-point one, 16 x 16 of a
//     16-point one), so a layer up to 256 wide is one pass over its k-slabs
//     and two warps per scheduler hide each other's latency.
//   * A layer wider than 256 (the forward's layers and the dX chain's
//     outputs) is cut by the wrapper into column passes of at most 256,
//     each an operation of the program over the whole K of its operands:
//     a dX pass reads the whole cotangent and writes its columns, so each
//     value is rounded once, after its whole sum, as the TPU kernel rounds
//     it. A pass reads its own columns (forward) or rows (dX) of the
//     weight block, whose row stride the operation carries.
//   * The ReLU masks the dX chain needs are kept as bits in shared memory,
//     one block per column pass of each ReLU layer: a thread holds the
//     same (row, column) positions in every pass, so it writes its bits in
//     the forward epilogue and reads them back in the dX epilogue, with no
//     other thread involved. A block holds the words of the warps whose
//     columns its pass reaches, so a 16-wide layer of a deep narrow net
//     (866x16 at 32-point tiles: 128 B a layer) does not take a 256-wide
//     pass's room; a net 256 or more wide keeps every warp's words.
//   * A deep net's program (866x16: 1,737 operations, 1,740 workspace
//     matrices, 125 KB) can crowd the masks and buffers out of shared
//     memory. Where it does, only the header and buffer table are copied
//     there, and the matrix and operation tables are read from device
//     memory: every thread reads the same record, once an operation, so
//     one broadcast load through L1 serves the block. A template flag
//     picks where the tables are, so a program that fits shared memory
//     keeps its loads from there.
//   * Every stored activation and every rounded cotangent is copied once,
//     16 B per thread, into a row-major (rows, width) workspace matrix,
//     each pass its own columns.
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
//   * Phase 1 walks S * rows_s / T tiles, none straddling two scenes, rows_s
//     = n rounded up to the tile and to phase 2's 64-row stage
//     (scene_rows); tile t is workspace rows t * T on, so scene s's rows
//     start at s * rows_s. The fetch stream keeps the scene of the tile it
//     fetches for.
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
constexpr int kP1Threads = 512;   // phase 1: 16 warps (mlp_tile.cuh's WarpGrid)
constexpr int kMaxN = 256;        // output columns of one phase-1 pass
constexpr int kHeaderInts = 32;
constexpr int kMaxBufs = 8;       // shared-memory buffers: offset, ld, cols
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

// Phase-1 operations.
enum Op { kFwd = 0, kDx = 1, kLoadG = 2 };

// Header fields.
enum Header {
  hNOps = 0, hProgLen, hNFreqs, hEncDim, hDirsDim, hGCols, hGrCols,
  hXBuf, hDBuf, hGrBuf, hGsBuf, hXMat, hDMat, hGrMat, hGsMat,
  hStages, hRingOff, hStageElems, hMaskOff, hSmem, hWsCols, hJobsOff,
  hNJobs, hRows, hMatsBase, hOpsBase, hNMats
};

// Operation record fields. An operation is one pass of n <= kMaxN output
// columns, from column `col` on, over the whole K of its operands:
//   kFwd:  dst[:, col:col + n] = act(A @ WA + B @ WB + bias), WA the
//          columns col.. of a (k_a, wld) weight block (wA points at column
//          col; in hi_lo its lo plane k_a * wld further on), bias at
//          column col; act = ReLU when maskOut >= 0, which also records
//          dst > 0 into that mask block
//   kDx:   dst[:, col:col + n] = mask(A @ WA^T + B @ WB^T), WA the rows
//          col.. of a (wld, k_a) weight block (wA points at row col; lo
//          plane k_a * wld further on); maskIn: a mask block, or -1
//   kLoadG: the cotangent into buffers GR / GS and their matrices
// dst's pass is then copied into workspace matrix `mat` (if >= 0). A mask
// block (maskIn / maskOut: its first mask word, or -1) holds the bits of
// one column pass of a ReLU layer for the warps of its first maskCg column
// groups (mlp_tile.cuh's WarpGrid), whose columns the pass reaches: warp
// (row group rg, column group cg < maskCg) keeps word
// ((mt * kRG + rg) * maskCg + cg) * 32 + lane of the block. The wrapper
// lays the blocks out, each sized by its pass's columns (a net 256 or
// more wide takes every column group in every pass).
enum Field {
  fOp = 0, fSrcA, fWA, fKA, fSrcB, fWB, fKB, fBias, fN, fMaskIn, fDst,
  fMat, fMaskOut, fCol, fWLd, fMaskCg
};

// Job record fields (phase 2): the tile [k0, k0 + kc) x [n0, n0 + nc) of
// the weight block whose gradient starts at `off` (row stride `ld`), from
// workspace matrices A (activations) and Y (cotangent); `db`: the bias
// gradient's offset when this job also sums Y's columns, else -1.
enum JobField { jA = 0, jK0, jKc, jY, jN0, jNc, jOff, jLd, jDb };

// A value into a shared-memory buffer and its workspace matrix: bf16, or in
// hi_lo mode the pair (hi, lo) = (bf16(v), bf16(v - hi)) into two planes.
template <bool kHiLo>
__device__ __forceinline__ void put2(bf16* s, int s_plane, bf16* w,
                                     long long w_plane, float v) {
  const bf16 h = __float2bfloat16(v);
  s[0] = h;
  w[0] = h;
  if (kHiLo) {
    const bf16 l = __float2bfloat16(v - __bfloat162float(h));
    s[s_plane] = l;
    w[w_plane] = l;
  }
}

// A scene's workspace rows: its n points rounded up to the tile of T
// points and to phase 2's stage of kStageRows rows (tiles of 32 and 16
// points fill the rows up to a stage with points past n, which are zero).
__host__ __device__ inline int scene_rows(int n, int t) {
  const int step = t > kStageRows ? t : kStageRows;
  return (n + step - 1) / step * step;
}

// One thread per 16-byte chunk of a weight slab: 16 rows of up to 32
// chunks (forward), or up to 256 rows of 2 chunks (dX).
static_assert(16 * (kMaxN / 8) <= kP1Threads && 2 * kMaxN <= kP1Threads,
              "a slab must take at most one chunk per thread");

// Phase 1 over tiles of T points (mlp_tile.cuh's WarpGrid<T>), its matrix
// and operation tables in shared memory (kSharedTables) or device memory.
template <bool kHiLo, int T, bool kSharedTables>
__global__ void __launch_bounds__(kP1Threads, 1)
bwd_phase1_kernel(const float* __restrict__ pts, const void* __restrict__ dirs,
                  const float* __restrict__ g, const bf16* __restrict__ weights,
                  const float* __restrict__ biases,
                  const int* __restrict__ prog_in, int prog_len, int n,
                  int n_tiles, bf16* __restrict__ ws, long long rows_cap,
                  long long w_stride, int b_stride) {
  using G = WarpGrid<T>;
  using Mask = typename MaskWord<G::kNT>::type;
  constexpr int MT = G::kMT;
  constexpr int NT = G::kNT;
  constexpr int kThreads = kP1Threads;
  extern __shared__ __align__(128) unsigned char smem[];
  // The program's first prog_len ints: the header and buffer table, and
  // with kSharedTables the matrix and operation tables (else those are read
  // from device memory, where every thread reads the same record: one
  // broadcast load through L1).
  int* prog = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < prog_len; i += kThreads) prog[i] = prog_in[i];
  __syncthreads();
  const int* tables = kSharedTables ? prog : prog_in;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / G::kCG, cg = warp % G::kCG;  // the warp's place
  const int rb = rg * MT * 16;  // the warp's first row
  const int cb = cg * G::kWN;   // ... and first column of a pass
  const int* bufs = prog + kBufsBase;
  const int* mats = tables + prog[hMatsBase];
  const int* ops = tables + prog[hOpsBase];
  const int n_ops = prog[hNOps];
  const int stages = prog[hStages];
  const int half = prog[hStageElems];  // a slab's lo plane follows its hi
  const int stage_elems = half * (kHiLo ? 2 : 1);
  bf16* ring = reinterpret_cast<bf16*>(smem + prog[hRingOff]);
  Mask* masks = reinterpret_cast<Mask*>(smem + prog[hMaskOff]);
  auto bufp = [&](int b) { return reinterpret_cast<bf16*>(smem + bufs[3 * b]); };
  auto bld = [&](int b) { return bufs[3 * b + 1]; };
  auto matp = [&](int m) { return ws + static_cast<long long>(mats[2 * m]) * rows_cap; };
  auto mcols = [&](int m) { return mats[2 * m + 1]; };
  auto steps = [&](int oi) {
    const int* o = ops + oi * kOpInts;
    return o[fOp] == kLoadG ? 0 : (o[fKA] + o[fKB]) / 16;
  };
  const int tiles_per_scene = scene_rows(n, T) / T;

  // The slab stream: every operation's 16-row k-slabs in program order,
  // tile after tile. Forward: rows k0..k0+15 of the pass's columns of W
  // (k x wld), stored [16][n + kPad]. dX: the same rows of W^T, i.e.
  // columns k0..k0+15 of the pass's rows of W (wld x k), stored [n][16]
  // with the two 16-byte halves of a row swapped every 4 rows, so that
  // ldmatrix meets no bank conflict. A thread's chunk of an operand's
  // slabs is set up once per operand (f_operand); fetch() then issues it,
  // one slab further each call, or an empty group at the end. f_w: the
  // weights of the scene of the tile being fetched for.
  const bf16* f_w = weights;
  int f_tile = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
  const bf16* f_src = weights;
  long long f_lo = 0;
  int f_dst = -1, f_step = 0, f_op = -1, f_j = 0, f_steps = 0, f_steps_a = 0;
  auto f_operand = [&](const int* o, bool second) {
    const int k = second ? o[fKB] : o[fKA], nn = o[fN], wld = o[fWLd];
    const bf16* w = f_w + (second ? o[fWB] : o[fWA]);
    f_lo = static_cast<long long>(k) * wld;
    if (o[fOp] == kFwd) {
      const int r = tid >> 5, cc = tid & 31;
      f_dst = cc < nn / 8 ? r * (nn + kPad) + cc * 8 : -1;
      f_src = w + static_cast<long long>(r) * wld + cc * 8;
      f_step = 16 * wld;
    } else {
      const int r = tid >> 1, h = tid & 1;
      f_dst = r < nn ? r * 16 + 8 * (h ^ ((r >> 2) & 1)) : -1;
      f_src = w + static_cast<long long>(r) * k + 8 * h;
      f_step = 16;
    }
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
        f_steps_a = ops[f_op * kOpInts + fKA] / 16;
        if (f_steps) f_operand(ops + f_op * kOpInts, false);
      }
      if (f_j == f_steps_a) f_operand(ops + f_op * kOpInts, true);
      if (f_dst >= 0) {
        bf16* d = ring + slot * stage_elems + f_dst;
        cp_async16(d, f_src);
        if (kHiLo) cp_async16(d + half, f_src + f_lo);
      }
      f_src += f_step;
      ++f_j;
      --f_left;
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);
  int consumed = 0;

  float acc[MT][NT][4];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // Workspace rows row0 on; the tile's scene, its first point within the
    // scene (p0) and the scene's points, dirs, cotangent rows and biases.
    const int row0 = tile * T;
    const int scene = tile / tiles_per_scene;
    const int p0 = (tile - scene * tiles_per_scene) * T;
    const long long base = static_cast<long long>(scene) * n;
    const float* pts_s = pts + 3 * base;
    const float* bias_s = biases + static_cast<long long>(scene) * b_stride;

    // Encoded points (mlp_tile.cuh's encode, as the forward).
    {
      const int xb = prog[hXBuf], ldx = bld(xb), xm = prog[hXMat];
      const int xc = mcols(xm), enc_dim = prog[hEncDim];
      bf16* xs = bufp(xb);
      bf16* xw = matp(xm) + static_cast<long long>(row0) * xc;
      for (int idx = tid; idx < T * xc; idx += kThreads) {
        const int r = idx / xc, j = idx - r * xc, gr = p0 + r;
        const float v = (gr < n && j < enc_dim) ? encode(pts_s, gr, j) : 0.f;
        put2<kHiLo>(xs + r * ldx + j, T * ldx, xw + idx, rows_cap * xc, v);
      }
    }
    // Encoded view directions: bf16, or fp32 in hi_lo mode.
    if (prog[hDBuf] >= 0) {
      const int db = prog[hDBuf], ldd = bld(db), dm = prog[hDMat];
      const int dc = mcols(dm), dirs_dim = prog[hDirsDim];
      bf16* ds = bufp(db);
      bf16* dw = matp(dm) + static_cast<long long>(row0) * dc;
      for (int idx = tid; idx < T * dc; idx += kThreads) {
        const int r = idx / dc, j = idx - r * dc, gr = p0 + r;
        float v = 0.f;
        if (gr < n && j < dirs_dim) {
          const long long at = (base + gr) * dirs_dim + j;
          v = kHiLo ? static_cast<const float*>(dirs)[at]
                    : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
        }
        put2<kHiLo>(ds + r * ldd + j, T * ldd, dw + idx, rows_cap * dc, v);
      }
    }

    for (int oi = 0; oi < n_ops; ++oi) {
      const int* o = ops + oi * kOpInts;
      const int op = o[fOp];
      if (op == kLoadG) {
        // The cotangent, cast to the compute type: its first gr_cols
        // columns into GR (rgb, or the whole output head), the rest into
        // GS (sigma). Rows at or past n are zero. The buffers may overlay
        // the encoded points, which no later operation of the tile reads.
        const int g_cols = prog[hGCols], gr_cols = prog[hGrCols];
        for (int which = 0; which < 2; ++which) {
          const int b = which ? prog[hGsBuf] : prog[hGrBuf];
          if (b < 0) continue;
          const int m = which ? prog[hGsMat] : prog[hGrMat];
          const int ldg = bld(b), mc = mcols(m);
          const int c0 = which ? gr_cols : 0;
          const int cn = which ? g_cols - gr_cols : gr_cols;
          bf16* gs = bufp(b);
          bf16* gw = matp(m) + static_cast<long long>(row0) * mc;
          for (int idx = tid; idx < T * mc; idx += kThreads) {
            const int r = idx / mc, j = idx - r * mc, gr = p0 + r;
            const float v =
                (gr < n && j < cn) ? g[(base + gr) * g_cols + c0 + j] : 0.f;
            put2<kHiLo>(gs + r * ldg + j, T * ldg, gw + idx, rows_cap * mc, v);
          }
        }
        continue;
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      // Per operation: each operand's A rows for this lane, and where the
      // lane's B fragments sit in a slab (column pair p at + p * b_pair).
      const int nn = o[fN];
      const int steps_a = o[fKA] / 16, n_steps = steps(oi);
      const int lda = bld(o[fSrcA]), ldb = o[fKB] ? bld(o[fSrcB]) : 0;
      const int a_lane = (rb + (lane & 15)) * lda + (lane >> 4) * 8;
      const int b_lane = (rb + (lane & 15)) * ldb + (lane >> 4) * 8;
      const bf16* a_op = bufp(o[fSrcA]) + a_lane;
      const bf16* b_op = o[fKB] ? bufp(o[fSrcB]) + b_lane : a_op;
      const bool fwd = op == kFwd;
      const int b_frag =
          fwd ? (lane & 15) * (nn + kPad) + cb + (lane >> 4) * 8
              : (cb + (lane & 7) + ((lane >> 4) << 3)) * 16 +
                    8 * (((lane >> 3) & 1) ^ ((lane >> 2) & 1));
      const int b_pair = fwd ? 16 : 256;
      for (int j = 0; j < n_steps; ++j) {
        cp_async_wait_n(stages - 2);
        __syncthreads();  // the slab is in; the oldest slot is free
        fetch((consumed + stages - 1) % stages);
        const bf16* slab = ring + (consumed % stages) * stage_elems + b_frag;
        ++consumed;
        const bool second = j >= steps_a;
        const int ld = second ? ldb : lda;
        const bf16* a_base = second ? b_op + 16 * (j - steps_a) : a_op + 16 * j;
        uint32_t a[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldsm_x4(a[mt], a_base + mt * 16 * ld);
          if (kHiLo) ldsm_x4(al[mt], a_base + mt * 16 * ld + T * ld);
        }
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          if (cb + 16 * p >= nn) continue;  // warp-uniform
          uint32_t b[4], bl[4];
          const bf16* q = slab + p * b_pair;
          if (fwd) {
            ldsm_x4_t(b, q);
            if (kHiLo) ldsm_x4_t(bl, q + half);
          } else {
            ldsm_x4(b, q);
            if (kHiLo) ldsm_x4(bl, q + half);
          }
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
      }

      // Epilogue. Forward: fp32 bias, then ReLU, recording dst > 0 (of the
      // rounded value in bf16 mode) into the mask block. dX: the mask
      // block of the stored activation. Then the compute type, into dst's
      // columns of the pass. Each value is a whole K sum, rounded once.
      // Bit 4 nt + e of word mt is the thread's accumulator acc[mt][nt][e].
      {
        const int dst = o[fDst], ldd = bld(dst), col0 = o[fCol];
        bf16* d = bufp(dst) + col0;
        const int mask_in = o[fMaskIn], mask_out = o[fMaskOut];
        // The mask block's column groups: a warp past them has no columns
        // in the pass, and no words in the block.
        const int mask_cg = o[fMaskCg];
        const bool mask_mine = cg < mask_cg;
        const float* bias = bias_s + o[fBias];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int word = ((mt * G::kRG + rg) * mask_cg + cg) * 32 + lane;
          const uint32_t bits_in =
              (op == kDx && mask_in >= 0 && mask_mine)
                  ? masks[mask_in + word]
                  : 0xffffffffu;
          uint32_t bits_out = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (cb + nt * 8 >= nn) continue;
            const int col = cb + nt * 8 + 2 * (lane & 3);
            float b0 = 0.f, b1 = 0.f;
            if (op == kFwd) {
              b0 = bias[col];
              b1 = bias[col + 1];
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = rb + mt * 16 + (lane >> 2) + 8 * hh;
              const int bit = 4 * nt + 2 * hh;
              float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
              if (op == kFwd) {
                v0 += b0;
                v1 += b1;
                if (mask_out >= 0) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
              } else {
                if (!((bits_in >> bit) & 1u)) v0 = 0.f;
                if (!((bits_in >> (bit + 1)) & 1u)) v1 = 0.f;
              }
              const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
              bf16* at = d + row * ldd + col;
              *reinterpret_cast<__nv_bfloat162*>(at) = __halves2bfloat162(h0, h1);
              if (kHiLo)
                store2(at + T * ldd, v0 - __bfloat162float(h0),
                       v1 - __bfloat162float(h1));
              if (mask_out >= 0) {
                const bool p0 = kHiLo ? v0 > 0.f : __bfloat162float(h0) > 0.f;
                const bool p1 = kHiLo ? v1 > 0.f : __bfloat162float(h1) > 0.f;
                bits_out |= (static_cast<uint32_t>(p0) << bit) |
                            (static_cast<uint32_t>(p1) << (bit + 1));
              }
            }
          }
          if (mask_out >= 0 && mask_mine)
            masks[mask_out + word] = static_cast<Mask>(bits_out);
        }
      }
      __syncthreads();

      // The pass's columns, 16 B a thread, into its workspace matrix: row
      // r, chunk cc of thread slot c = 32 r + cc.
      const int m = o[fMat];
      if (m >= 0) {
        const int b = o[fDst], cols = mcols(m), ld = bld(b), col0 = o[fCol];
        const bf16* s = bufp(b) + col0;
        bf16* w = matp(m) + static_cast<long long>(row0) * cols + col0;
        for (int c = tid; c < 32 * T; c += kThreads) {
          const int r = c >> 5, cc = c & 31;
          if (8 * cc >= nn) continue;
          const long long at = static_cast<long long>(r) * cols + cc * 8;
          *reinterpret_cast<uint4*>(w + at) =
              *reinterpret_cast<const uint4*>(s + r * ld + cc * 8);
          if (kHiLo)
            *reinterpret_cast<uint4*>(w + rows_cap * cols + at) =
                *reinterpret_cast<const uint4*>(s + (T + r) * ld + cc * 8);
        }
      }
    }
  }
  cp_async_wait<0>();
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
                          int grid, int smem, bf16* ws, long long rows_cap,
                          cudaStream_t stream) {
  const int n_tiles = n_scenes * (scene_rows(n, T) / T);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_phase1_kernel<kHiLo, T, kSharedTables>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bwd_phase1_kernel<kHiLo, T, kSharedTables><<<grid, kP1Threads, smem,
                                              stream>>>(
      pts, dirs, g, weights, biases, prog, prog_len, n, n_tiles, ws, rows_cap,
      w_stride, b_stride);
  return cudaGetLastError();
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
  // ... then phase 1's tile sizes: bf16, then hi_lo, in the order tried;
  // then the largest tile built with its tables in device memory.
  const int c[] = {kThreads,   kPad,        kMaxN,      kHeaderInts,
                   kMaxBufs,   kOpInts,     kTileK,     kTileN,
                   kStageRows, kStages2,    kJobInts,   kP1Threads,
                   128, 64, 32, 16, 64, 32, 16, 32};
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
// 64, 32 or 16; hi_lo 64, 32 or 16), which with prog_len picks the kernel
// (tables in device memory: 32, hi_lo 32 or 16); smem: the program's
// shared-memory bytes; ws: the
// workspace, rows_cap rows per matrix (>= n_scenes times scene_rows(n,
// rows); scene s's from s times that). Launches `grid` persistent blocks
// on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
int fused_mlp_bwd_phase1(const void* pts, const void* dirs, const void* g,
                         const void* weights, const void* biases,
                         const void* prog, int prog_len, int hi_lo, int rows,
                         int n, int n_scenes, long long w_stride,
                         int b_stride, int grid, int smem, void* ws,
                         long long rows_cap, void* stream) {
  if (prog_len < kTablesBase || grid <= 0 || n_scenes <= 0 ||
      w_stride % 8 || b_stride < 0 || rows <= 0 ||
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
  // buffer table, and only at tiles of 32 and 16 points: a program that
  // crowds shared memory belongs to a net whose masks took the tile there.
  const bool shared_tables = prog_len > kTablesBase;
#define PHASE1(HI_LO, T, SHARED)                                             \
  if (!!hi_lo == HI_LO && rows == T && shared_tables == SHARED)              \
    return static_cast<int>(launch_phase1<HI_LO, T, SHARED>(                \
        p, dirs, gg, w, b, pr, prog_len, n, n_scenes, w_stride, b_stride,    \
        grid, smem, wsp, rows_cap, s));
  PHASE1(false, 128, true)
  PHASE1(false, 64, true)
  PHASE1(false, 32, true)
  PHASE1(false, 16, true)
  PHASE1(true, 64, true)
  PHASE1(true, 32, true)
  PHASE1(true, 16, true)
  PHASE1(false, 32, false)
  PHASE1(true, 32, false)
  PHASE1(true, 16, false)
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
