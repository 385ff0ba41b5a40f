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
// The handover. The TPU kernel recomputes the forward because its custom
// VJP saves only the inputs (the activations lived in VMEM); here phase 1
// writes those activations to device memory anyway, so in training the
// forward kernel writes them the first time (fused_mlp_fwd.cu's kRes, at
// the same rows and in the same strips), with each ReLU layer's mask bits
// in this kernel's mask layout, one image a tile. Phase 1 then runs a
// program without the forward operations (557,696 MACs a point at 8x256;
// on an H100 scripts/bwd_ablate.py timed the recomputed forward at 48% of
// phase 1): at each
// tile it copies the tile's mask image into its mask region and runs the
// cotangent's load and the dX chain, writing only the cotangent matrices.
// The wrapper engages it where the net's phase-1 layout without the
// forward fits the forward's tile (the mask bits' layout depends on it)
// and the call's backward is one chunk; the same values in the same order,
// so the workspace and gradients keep their bits.
//
// Phase 1 (bwd_phase1_kernel). The TPU kernel keeps a tile's activations
// in VMEM; here they stay in shared memory, so phase 1 runs on the
// forward's core (mlp_tile.cuh): wgmma with the products transposed (the
// layer's output features as M, the tile's points as N), weight stages
// streamed by a producer warp through a ring of bulk copies behind full and
// empty mbarriers. What bounded the design before it (mma.sync from
// ldmatrix fragments, a block barrier per 16-row stage, every weight
// restreamed per 16- or 32-point tile on the wide nets) was latency and L2
// traffic, at 6-57x the bound.
//   * dX reads the forward's weight image as it lies: the same bytes are
//     W^T for the forward (M-major A) and W for dX (K-major A); a dX stage
//     is one 64-column strip of the block and up to 256 of its rows (the
//     pass's output features), so both walk the same image.
//   * A persistent grid walks the tiles, one CTA a tile. The tile's input
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
//     thread, into its workspace matrix, which lies in the strips phase 2
//     reads (below).
// Phase 2 (bwd_phase2_kernel). The TPU adds each tile's dW into one
// accumulator over its sequential grid; on 132 parallel blocks that would
// be a read-modify-write of a 2.4 MB partial slot per tile, ~4.6 GB per
// call of 131,072 points. Here dW_b = A_b^T Y_b is one long product with
// the points as K, cut into splits of the rows, each writing one fp32
// partial slot; the reduction sums the slots.
//   * What bounds it: the workspace it reads (8x256: 1.31 GB at 131,072
//     points, 0.39 ms at the card's memory rate, against 0.16 ms of bf16
//     products; hi_lo reads twice the bytes for three times the
//     products, and becomes operation-bound). The design before this one
//     (mma.sync from ldmatrix.trans fragments, a block barrier per 64-row
//     cp.async stage, one fixed 128 x 128 tile a block) ran at 12-50% of
//     that bound: a 16-wide block left one warp of eight busy and moved 4
//     KB a barrier, and a 256 x 256 block read A and Y twice each.
//   * The workspace lies in the weights' strip layout (mlp_tile.cuh): each
//     matrix of R rows (points) and C columns is strips of 64 columns,
//     each R rows in 128-byte swizzled atoms of 8 rows, a last, narrower
//     strip in 8 x 8 core matrices. So a stage of a strip is one
//     contiguous bulk copy, and wgmma reads it as it lies: A (the
//     activations) M-major, Y (the cotangent) N-major. No tensor map, no
//     gather; only the addresses phase 1 writes to differ from a row-major
//     matrix, not its values. Narrow matrices are not padded (866x16's
//     bytes stay its own).
//   * A work unit is 64 or 128 input features of a weight block (one or
//     two A strips: M, one consumer warpgroup each) by up to 256 of its
//     output features (N: whole strips of Y, or its narrow last strip), so
//     a 256-wide Y strip is read once per 128 input features. Each
//     consumer warpgroup holds its 64 x N fp32 tile in registers over the
//     whole split: wgmma m64nNk16 with both operands transposed (the
//     points as K), three into the same accumulators in hi_lo. A
//     warpgroup without an A strip multiplies the zero block (the products
//     a stage issues depend on the unit alone: note C7520).
//   * A producer warp streams the unit's stages through a ring of bulk
//     copies behind full and empty mbarriers; the consumers take no
//     block-wide barrier. A stage is whole groups of rows (64 in bf16, 32
//     in hi_lo: kGroupRows), as many as its bytes allow (the wrapper's
//     rule, measured): a narrow unit takes hundreds of rows a stage, so
//     that enough bytes are in flight; a wide one as few as leave the ring
//     three or four stages deep. The consumers issue a group's k-steps as
//     one straight-line block, one commit group a group.
//   * A persistent grid walks the items (unit, split, scene) in order,
//     units largest first; the units of one block and split are
//     neighbours, so the CTAs that read the same Y rows run together and
//     the second read comes from L2. The wrapper picks the splits so that
//     each fp32 sum runs over at most 2,048 points (where 32 splits
//     allow; 4,096 at 131,072 points), the items fill the
//     card two to four times over and the CTAs' bytes balance.
//   * db, an fp32 column sum of Y (in hi_lo of each stored (hi, lo) pair),
//     is taken by the tensor cores, by the units that hold a layer's first
//     input features: a unit of one A strip multiplies the ones block on
//     its idle warpgroup instead of the zero block; a unit of two adds a
//     product of its Y strips (as A) against ones (m64n8k16) a k-step. A
//     loop over the stage in shared memory, on the consumers or on the
//     producer warpgroup's spare warps, cost 40-60% at 8x256.
//   * Every store of the epilogue is predicated in asm; no branch reads
//     the accumulators.
// Reduction (reduce_partials_kernel), bound by bytes: float4 loads, sixteen
// slots in flight at a time, added in slot order, so the sum repeats bit
// for bit and equals the plain sum. Nothing here uses atomics.
//
// The network arrives as a program built by the Python wrapper
// (nerfmlp_torch/ops/fused_mlp.py, pack_params): a header, a shared-memory
// buffer table, a workspace matrix table, one record per phase-1 operation
// (forward layer, dX, load of the cotangent) and phase 2's unit list, each
// table sized by the net (any depth), at the bases the header gives; the
// handover's phase 1 takes a second program of the same form, without the
// forward layers or the x and d buffers. Every
// width is padded to a multiple of 16 with zeros, so padding adds exactly
// zero. Rows at or past n load a zero cotangent, so they contribute nothing.
//
// A scene axis (the TPU kernels under jax.vmap: one pallas_call with a
// leading grid axis over scenes): each launch runs S nets of one
// architecture, scene s with its own weights and biases (at s times a
// stride), its own n points, dirs and cotangent rows (scene-major, at s *
// n), its own workspace rows and its own partial slots.
//   * Phase 1 walks S * rows_s / T tiles, none straddling two scenes,
//     rows_s = n rounded up to the tile and to 64 rows (scene_rows); tile
//     t of scene s is workspace rows (s * rows_s / T + t) * T on. The
//     producer keeps the scene of the tile it streams for.
//   * Phase 2's items are (unit, split, scene): scene s's splits cover its
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

constexpr int kP1Threads = mlp_tile::kThreads;
constexpr int kP2Threads = mlp_tile::kThreads;
constexpr int kHeaderInts = 32;
constexpr int kMaxBufs = 8;       // shared-memory buffers: byte offset,
                                  // columns, first column (mlp_tile.cuh)
constexpr int kOpInts = 16;
constexpr int kBufsBase = kHeaderInts;
// The matrix table (column offset, cols per workspace matrix) and the
// operation table follow the buffer table, sized by the net: the header
// holds their bases and counts.
constexpr int kTablesBase = kBufsBase + 3 * kMaxBufs;
constexpr int kUnitK = 128;       // phase 2: input features of a unit, at most
constexpr int kUnitN = 256;       // ... and output features
// Phase 2's stages are groups of rows (a group's products issued as one
// straight-line block): 64 rows (four k-steps) in bf16, 32 (two) in hi_lo,
// whose 128 x 256-feature units take 48 KB for 32 rows of two planes, so
// that four stages fit.
template <bool kHiLo>
constexpr int kGroupRows = kHiLo ? 32 : 64;
constexpr int kUnitInts = 12;
// Phase 2: 64 bf16 ones, then 128 zero bytes (their lo plane), after the
// ring's barriers and the zero block (mlp_tile.cuh's init_ring).
constexpr int kOnesOff = 2 * kMaxStages * 8 + kZeroBytes;

// Header fields.
enum Header {
  hNOps = 0, hProgLen, hNFreqs, hEncDim, hDirsDim, hGCols, hGrCols,
  hXBuf, hDBuf, hGrBuf, hGsBuf, hXMat, hDMat, hGrMat, hGsMat,
  hStages, hRingOff, hSlotBytes, hMaskOff, hSmem, hWsCols, hUnitsOff,
  hNUnits, hRows, hMatsBase, hOpsBase, hNMats, hBarOff, hP2Stages, hP2Slot,
  hP2RingOff, hP2Smem
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

// Unit record fields (phase 2): the part [k0, k0 + kc) x [n0, n0 + nc) of
// the weight block whose gradient starts at `off` (row stride `ld`), from
// workspace matrices A (activations, columns k0..) and Y (cotangent,
// columns n0..): kc <= 128 (one or two A strips, the last maybe narrow),
// nc <= 256 (whole Y strips, or one narrow last strip); `db`: the bias
// gradient's offset when this unit also sums Y's columns, else -1; `sub`:
// groups of rows (kGroupRows) a ring stage.
enum UnitField { uA = 0, uK0, uKc, uY, uN0, uNc, uOff, uLd, uDb, uSub };

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

// Phase 1 over tiles of T points, its matrix and operation tables in
// shared memory (kSharedTables) or device memory.
template <bool kHiLo, int T, bool kSharedTables>
__global__ void __launch_bounds__(mlp_tile::kThreads, 1)
bwd_phase1_kernel(const float* __restrict__ pts, const void* __restrict__ dirs,
                  const float* __restrict__ g, const bf16* __restrict__ weights,
                  const float* __restrict__ biases,
                  const int* __restrict__ prog_in, int prog_len, int n,
                  int n_scenes, bf16* __restrict__ ws, long long rows_cap,
                  long long w_stride, int b_stride,
                  const unsigned char* __restrict__ gmask, int mask_bytes) {
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
  if (threadIdx.x == 0) init_ring(full, empty, stages);
  __syncthreads();

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
  const int n_tiles = n_scenes * tiles;
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
      produce<kHiLo>(ops, kOpInts, n_ops, weights, w_stride, tiles, n_tiles,
                     stages, ring, slot_bytes, half, full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const uint32_t base = smem_u32(smem);
  float acc0[Core::kAcc], acc1[Core::kAcc];
  Ring pos;
  for (int g_i = blockIdx.x; g_i < n_tiles; g_i += gridDim.x) {
    // The tile's scene, its first point within the scene (p0), its
    // workspace rows (row0 on) and the scene's points, dirs, cotangent
    // rows and biases.
    const int scene = g_i / tiles;
    const int p0 = (g_i - scene * tiles) * T;
    const int row0 = g_i * T;
    const long long sbase = static_cast<long long>(scene) * n;
    const float* pts_s = pts + 3 * sbase;
    const float* bias_s = biases + static_cast<long long>(scene) * b_stride;

    // The handover: the forward wrote this tile's activations into the
    // workspace, and its ReLU masks, in the mask region's layout, as tile
    // g_i of `gmask` (the program then has no forward operation, and no x
    // or d buffer).
    if (gmask != nullptr) {
      const uint4* src = reinterpret_cast<const uint4*>(
          gmask + static_cast<long long>(g_i) * mask_bytes);
      for (int i = tid; i < mask_bytes / 16; i += kConsumers)
        reinterpret_cast<uint4*>(masks)[i] = __ldg(src + i);
    }
    // Encoded points (mlp_tile.cuh's encode_pair, as the forward).
    if (prog[hXBuf] >= 0) {
      const int xb = prog[hXBuf], xm = prog[hXMat];
      const int xc = mcols(xm), enc_dim = prog[hEncDim];
      const int x_plane = 2 * T * bufs[3 * xb + 1];
      unsigned char* xs = smem + bufs[3 * xb];
      bf16* xw = matp(xm);
      for (int idx = tid; idx < T * xc; idx += kConsumers) {
        const int r = idx / xc, j = idx - r * xc, gr = p0 + r;
        float v0 = 0.f, v1 = 0.f;
        const int got =
            (gr < n && j < enc_dim) ? encode_pair(pts_s, gr, j, &v0, &v1) : 1;
        if (got)
          put2<kHiLo>(xs + act_byte<T>(r, j), x_plane,
                      xw + ws_elem(row0 + r, j, rows_cap, xc), rows_cap * xc,
                      v0);
        if (got == 2)
          put2<kHiLo>(xs + act_byte<T>(r, j + 3), x_plane,
                      xw + ws_elem(row0 + r, j + 3, rows_cap, xc),
                      rows_cap * xc, v1);
      }
    }
    // Encoded view directions: bf16, or fp32 in hi_lo mode.
    if (prog[hDBuf] >= 0) {
      const int db = prog[hDBuf], dm = prog[hDMat];
      const int dc = mcols(dm), dirs_dim = prog[hDirsDim];
      unsigned char* ds = smem + bufs[3 * db];
      bf16* dw = matp(dm);
      for (int idx = tid; idx < T * dc; idx += kConsumers) {
        const int r = idx / dc, j = idx - r * dc, gr = p0 + r;
        float v = 0.f;
        if (gr < n && j < dirs_dim) {
          const long long at = (sbase + gr) * dirs_dim + j;
          v = kHiLo ? static_cast<const float*>(dirs)[at]
                    : __bfloat162float(static_cast<const bf16*>(dirs)[at]);
        }
        put2<kHiLo>(ds + act_byte<T>(r, j), 2 * T * bufs[3 * db + 1],
                    dw + ws_elem(row0 + r, j, rows_cap, dc), rows_cap * dc,
                    v);
      }
    }
    fence_proxy_async();
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
        const int g_cols = prog[hGCols], gr_cols = prog[hGrCols];
        for (int which = 0; which < 2; ++which) {
          const int b = which ? prog[hGsBuf] : prog[hGrBuf];
          if (b < 0) continue;
          const int m = which ? prog[hGsMat] : prog[hGrMat];
          const int mc = mcols(m), cb = bufs[3 * b + 2];
          const int c0 = which ? gr_cols : 0;
          const int cn = which ? g_cols - gr_cols : gr_cols;
          unsigned char* gs = smem + bufs[3 * b];
          bf16* gw = matp(m);
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
            bf16* wat = gw + ws_elem(row0 + r, j, rows_cap, mc);
            st_shared_if(at, h, in);
            st_global_if(wat, h, in);
            if (kHiLo) {
              const bf16 l = __float2bfloat16(x - __bfloat162float(h));
              st_shared_if(at + 2 * T * bufs[3 * b + 1], l, in);
              st_global_if(wat + rows_cap * mc, l, in);
            }
          }
        }
        fence_proxy_async();
        named_sync(kConsumerBar, kConsumers);
        continue;
      }
      Core::op(o, pos, stages, ring, slot_bytes, half, full, empty, bufs,
               base, smem_u32(full + 2 * kMaxStages), wg, tid & 127, acc0,
               acc1);
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

      // The pass's columns into its workspace matrix.
      const int m = o[fMat];
      if (m >= 0)
        copy_pass<kHiLo, T>(matp(m), rows_cap, mcols(m), row0, col0, d,
                            d_plane, dcol, nn, tid);
    }
  }
}

// Phase 2: the products of one group of a stage (kGroupRows: four
// straight-line k-steps in bf16, two in hi_lo), for a unit N output
// features wide: acc (its first N / 2) += A^T Y, three products in hi_lo
// (hi*hi + lo*hi + hi*lo). a, b: the group's
// first k-step's descriptors; a_step, b_step: a k-step's advance; a_lo,
// b_lo: the lo planes' offsets (all in 16-byte units). With kBias, also
// the bias: bias[u] (64 x 8) += Y_u^T ones for this warpgroup's Y strips
// u (their descriptors y[u], advancing y_step[u], lo planes y_lo[u]; a
// strip the unit lacks reads the zero block; the second only where N
// passes 128), every column of bias[u] the column sums of the strip's 64
// features (hi + lo in hi_lo).
template <bool kHiLo, int N, bool kBias>
__device__ __forceinline__ void p2_group(
    float (&acc)[2 * kUnitN / 4], uint64_t a, uint32_t a_step, uint64_t b,
    uint32_t b_step, uint32_t a_lo, uint32_t b_lo, float (&bias0)[4],
    float (&bias1)[4], const uint64_t (&y)[2], const uint32_t (&y_step)[2],
    const uint32_t (&y_lo)[2], uint64_t ones) {
  float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&acc[0]);
#pragma unroll
  for (int q = 0; q < kGroupRows<kHiLo> / 16; ++q) {
    const uint64_t aq = a + q * a_step, bq = b + q * b_step;
    Wgmma<N>::template mma<1, 1>(d, aq, bq, 1);
    if (kHiLo) {
      Wgmma<N>::template mma<1, 1>(d, aq + a_lo, bq, 1);
      Wgmma<N>::template mma<1, 1>(d, aq, bq + b_lo, 1);
    }
    if (kBias) {
      const uint64_t y0 = y[0] + q * y_step[0], y1 = y[1] + q * y_step[1];
      Wgmma<8>::template mma<1, 0>(bias0, y0, ones, 1);
      if (N > 128) Wgmma<8>::template mma<1, 0>(bias1, y1, ones, 1);
      if (kHiLo) {
        Wgmma<8>::template mma<1, 0>(bias0, y0 + y_lo[0], ones, 1);
        if (N > 128)
          Wgmma<8>::template mma<1, 0>(bias1, y1 + y_lo[1], ones, 1);
      }
    }
  }
}

// The group's products for a unit nc columns wide: whole Y strips (64,
// 128, 192, 256) or one narrow strip (16, 32, 48), with or without the
// bias. A switch on the unit, each case straight-line (ptxas serializes
// the wgmma of a path it cannot prove warpgroup-uniform; the unit is the
// same for the whole block).
template <bool kHiLo>
__device__ __forceinline__ void p2_products(
    int nc, bool bias, float (&acc)[2 * kUnitN / 4], uint64_t a,
    uint32_t a_step, uint64_t b, uint32_t b_step, uint32_t a_lo,
    uint32_t b_lo, float (&bias0)[4], float (&bias1)[4],
    const uint64_t (&y)[2], const uint32_t (&y_step)[2],
    const uint32_t (&y_lo)[2], uint64_t ones) {
#define P2_GROUP(N)                                                          \
  case N:                                                                    \
    if (bias)                                                                \
      p2_group<kHiLo, N, true>(acc, a, a_step, b, b_step, a_lo, b_lo, bias0, \
                               bias1, y, y_step, y_lo, ones);                \
    else                                                                     \
      p2_group<kHiLo, N, false>(acc, a, a_step, b, b_step, a_lo, b_lo,       \
                                bias0, bias1, y, y_step, y_lo, ones);        \
    break;
  switch (nc) {
    P2_GROUP(16) P2_GROUP(32) P2_GROUP(48) P2_GROUP(64) P2_GROUP(128)
    P2_GROUP(192) P2_GROUP(256)
    default:
      break;
  }
#undef P2_GROUP
}

// Work item i of phase 2: unit i % n_units, then the split, then the
// scene. Returns the unit's record; its rows [r0, r1) of the workspace.
__device__ __forceinline__ const int* p2_item(const int* units, int n_units,
                                              long long i, int rows,
                                              int splits, int split_rows,
                                              int* split, int* scene,
                                              long long* r0, long long* r1) {
  const long long rest = i / n_units;
  *split = static_cast<int>(rest % splits);
  *scene = static_cast<int>(rest / splits);
  const long long r_end = static_cast<long long>(*scene + 1) * rows;
  *r0 = r_end - rows + static_cast<long long>(*split) * split_rows;
  *r1 = min(r_end, *r0 + split_rows);
  return units + (i - rest * n_units) * kUnitInts;
}

// Phase 2's producer warp: every item's stages, item after item of this
// CTA. Lane 0 waits for the slot and arms its full barrier with the
// stage's bytes; lane c + 8 plane copies piece c of that plane: A strip c
// (c < the unit's A strips), else Y strip c - A strips. A stage's plane:
// A strip 0, A strip 1, then Y's strips, each rr rows of its columns.
template <bool kHiLo>
__device__ __forceinline__ void p2_produce(
    const bf16* ws, long long cap, const int* mats, const int* units,
    int n_units, int rows, int splits, int split_rows, long long items,
    int stages, unsigned char* ring, int slot_bytes, int half,
    uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const int c = lane & 7, plane = lane >> 3;
  Ring pos;
#pragma unroll 1
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    int split, scene;
    long long r0, r1;
    const int* u = p2_item(units, n_units, i, rows, splits, split_rows,
                           &split, &scene, &r0, &r1);
    const int kc = u[uKc], nc = u[uNc];
    const int rows_a = kGroupRows<kHiLo> * u[uSub];
    const int w0 = min(64, kc), w1 = kc - w0, a_strips = w1 > 0 ? 2 : 1;
    const bool is_a = c < a_strips;
    const bool on = plane < (kHiLo ? 2 : 1) &&
                    c < a_strips + ((nc + 63) >> 6);
    const int m = is_a ? u[uA] : u[uY];
    const int cols = mats[2 * m + 1];
    const int w = is_a ? (c ? w1 : w0) : min(64, nc);
    const int strip = is_a ? (u[uK0] >> 6) + c : (u[uN0] >> 6) + c - a_strips;
    const bf16* src = ws + cap * (mats[2 * m] + plane * cols) + cap * 64 * strip;
#pragma unroll 1
    for (long long r = r0; r < r1; r += rows_a) {
      const int rr = static_cast<int>(min(static_cast<long long>(rows_a),
                                          r1 - r));
      if (lane == 0) {
        mbar_wait(&empty[pos.slot], pos.phase ^ 1);
        mbar_expect_tx(&full[pos.slot], rr * (kc + nc) * 2 * (kHiLo ? 2 : 1));
      }
      __syncwarp();
      if (on) {
        const int at = is_a ? (c ? rr * w0 * 2 : 0)
                            : rr * kc * 2 + (c - a_strips) * rr * 128;
        bulk_load(ring + pos.slot * slot_bytes + plane * half + at,
                  src + r * w, rr * w * 2, &full[pos.slot]);
      }
      pos.next(stages);
    }
  }
}

__device__ __forceinline__ void st_global_v2_if(float* p, float a, float b,
                                                bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n"
      "@q st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(p),
      "f"(a), "f"(b), "r"(static_cast<int>(pred))
      : "memory");
}

// Phase 2 over n_scenes scenes: each item (unit, split, scene) writes the
// unit's part of the split's partial slot, and its bias columns where the
// unit sums them. The program's header gives the ring.
template <bool kHiLo>
__global__ void __launch_bounds__(mlp_tile::kThreads, 1)
bwd_phase2_kernel(const bf16* __restrict__ ws, long long rows_cap,
                  const int* __restrict__ prog, const int* __restrict__ units,
                  int n_units, int rows, int splits, int split_rows,
                  int n_scenes, float* __restrict__ part,
                  long long part_stride, long long part_scene_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stages = prog[hP2Stages], slot_bytes = prog[hP2Slot];
  const int half = kHiLo ? slot_bytes / 2 : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + prog[hP2RingOff];
  if (threadIdx.x == 0) {
    // The ones the bias products multiply, then the ring (whose fence
    // makes both visible to wgmma).
    uint32_t* ones = reinterpret_cast<uint32_t*>(smem + kOnesOff);
    for (int i = 0; i < kZeroBytes / 4; ++i) {
      ones[i] = 0x3F803F80u;
      ones[kZeroBytes / 4 + i] = 0;
    }
    init_ring(full, empty, stages);
  }
  __syncthreads();
  const int* mats = prog + prog[hMatsBase];
  const long long items = static_cast<long long>(n_units) * splits * n_scenes;
  const int wg = threadIdx.x / 128;

  // The roles never meet again (see bwd_phase1_kernel).
  if (wg == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32)
      p2_produce<kHiLo>(ws, rows_cap, mats, units, n_units, rows, splits,
                        split_rows, items, stages, ring, slot_bytes, half,
                        full, empty);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const uint32_t ring_at = smem_u32(ring);
  const uint64_t zero_desc =
      gmma_desc(smem_u32(full + 2 * kMaxStages), 0, 0, false);
  const uint64_t ones_desc = gmma_desc(smem_u32(smem + kOnesOff), 0, 0, false);
  const uint32_t lo = static_cast<uint32_t>(half) >> 4;
  float acc[2 * kUnitN / 4];  // this warpgroup's 64 x N tile, N <= 256
  float bias0[4], bias1[4];    // ... and its Y strips' column sums
  Ring pos;
#pragma unroll 1
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    int split, scene;
    long long r0, r1;
    const int* u = p2_item(units, n_units, i, rows, splits, split_rows,
                           &split, &scene, &r0, &r1);
    const int k0 = u[uK0], kc = u[uKc], n0 = u[uN0], nc = u[uNc];
    const int db = u[uDb], rows_a = kGroupRows<kHiLo> * u[uSub];
    const int w0 = min(64, kc), w1 = kc - w0;
    // This warpgroup's A strip (none: the zero block) and Y's strips. A
    // unit of one A strip that sums its bias does so on warpgroup 1, A the
    // ones (their lo plane zeros): every row of its tile is the bias; a
    // unit of two, by products of Y against ones (p2_group).
    const bool ones_unit = db >= 0 && w1 == 0;
    const int wa = wg ? w1 : w0;
    const bool mine = wa > 0;
    const int yw = min(64, nc);
    const uint32_t a_step = !mine ? 0 : wa == 64 ? 128 : 2 * wa;
    const uint32_t a_lo = mine ? lo : ones_unit ? kZeroBytes >> 4 : 0;
    const uint32_t b_step = yw == 64 ? 128 : 2 * yw;
    // The bias (units that sum it): this warpgroup's Y strips wg and wg + 2
    // as the M-major A of a product with ones.
    const int ny = (nc + 63) >> 6;
    const bool has[2] = {wg < ny, wg + 2 < ny};
    const uint32_t y_step[2] = {has[0] ? b_step : 0, has[1] ? b_step : 0};
    const uint32_t y_lo[2] = {has[0] ? lo : 0, has[1] ? lo : 0};
#pragma unroll
    for (int e = 0; e < 2 * kUnitN / 4; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) bias0[e] = bias1[e] = 0.f;
    int prev = -1;
#pragma unroll 1
    for (long long r = r0; r < r1; r += rows_a) {
      const int rr = static_cast<int>(min(static_cast<long long>(rows_a),
                                          r1 - r));
      mbar_wait(&full[pos.slot], pos.phase);
      const uint32_t sb = ring_at + pos.slot * slot_bytes;
      const uint32_t a_at = sb + (wg ? rr * w0 * 2 : 0);
      const uint32_t y_at = sb + rr * kc * 2;
      // A M-major: sbo the next 8 rows (an atom, or a row group of cores),
      // lbo unused / the next core. Y N-major: lbo the next 64-column
      // strip, sbo the next 8 rows.
      const uint64_t da =
          !mine ? (ones_unit ? ones_desc : zero_desc)
          : wa == 64 ? gmma_desc(a_at, 1024, 1024, true)
                     : gmma_desc(a_at, (wa >> 3) * 128, 128, false);
      const uint64_t dy =
          yw == 64 ? gmma_desc(y_at, rr * 128, 1024, true)
                   : gmma_desc(y_at, (yw >> 3) * 128, 128, false);
      uint64_t yd[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t at = y_at + (wg + 2 * t) * rr * 128;
        yd[t] = !has[t] ? zero_desc
                : yw == 64 ? gmma_desc(at, 1024, 1024, true)
                           : gmma_desc(at, (yw >> 3) * 128, 128, false);
      }
      constexpr int kSteps = kGroupRows<kHiLo> / 16;
#pragma unroll 1
      for (int s = 0; s < rr / kGroupRows<kHiLo>; ++s) {
        const uint64_t ys[2] = {yd[0] + kSteps * s * y_step[0],
                                yd[1] + kSteps * s * y_step[1]};
        wgmma_fence();
        p2_products<kHiLo>(nc, db >= 0 && w1 > 0, acc,
                           da + kSteps * s * a_step, a_step,
                           dy + kSteps * s * b_step, b_step, a_lo, lo, bias0,
                           bias1, ys, y_step, y_lo, ones_desc);
        wgmma_commit();
        wgmma_wait<1>();
      }
      // The previous stage's products have retired (wait<1> above).
      if (prev >= 0) mbar_arrive_if(&empty[prev], (tid & 127) == 0);
      prev = pos.slot;
      pos.next(stages);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(bias0);
    fence_acc(bias1);
    if (prev >= 0) mbar_arrive_if(&empty[prev], (tid & 127) == 0);

    // The tile into the slot: element (k, n) of the block at off + k * ld
    // + n; rows past this warpgroup's strip and columns past the unit are
    // never written. Every store predicated.
    float* P = part + scene * part_scene_stride + split * part_stride;
    const int ld = u[uLd];
    float* blk = P + u[uOff] + static_cast<long long>(k0) * ld + n0;
#pragma unroll
    for (int j = 0; j < kUnitN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
        const int n = 8 * j + 2 * (lane & 3);
        st_global_v2_if(blk + static_cast<long long>(min(k, kc - 1)) * ld +
                            min(n, nc - 2),
                        acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                        k < kc && n < nc);
      }
    }
    // The bias. Of a unit of two A strips: feature 64 (wg + 2 t) + 16
    // warp + lane / 4 + 8 h of Y is row 16 warp + lane / 4 + 8 h of
    // bias_t, in every column: the lanes of column 0 store it. Of a unit of
    // one: row 0 of warpgroup 1's tile (warp 0, lanes 0-3).
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 64 * (wg + 2 * t) + 16 * warp + (lane >> 2) + 8 * h;
        st_global_if(P + max(db, 0) + n0 + min(n, nc - 1),
                     t ? bias1[2 * h] : bias0[2 * h],
                     db >= 0 && w1 > 0 && (lane & 3) == 0 && n < nc);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnitN / 8; ++j) {
      const int n = 8 * j + 2 * (lane & 3);
      st_global_v2_if(P + max(db, 0) + n0 + min(n, nc - 2), acc[4 * j],
                      acc[4 * j + 1],
                      ones_unit && wg == 1 && (tid & 127) < 4 && n < nc);
    }
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
                          int smem, bf16* ws, long long rows_cap,
                          const unsigned char* masks, int mask_bytes,
                          cudaStream_t stream) {
  return launch_persistent(
      bwd_phase1_kernel<kHiLo, T, kSharedTables>,
      static_cast<long long>(n_scenes) * (scene_rows(n, T) / T), smem,
      stream, pts, dirs, g, weights, biases, prog, prog_len, n, n_scenes, ws,
      rows_cap, w_stride, b_stride, masks, mask_bytes);
}

template <bool kHiLo>
cudaError_t launch_phase2(const bf16* ws, long long rows_cap, const int* prog,
                          const int* units, int n_units, int rows, int splits,
                          int split_rows, int n_scenes, float* part,
                          long long part_stride, long long part_scene_stride,
                          int smem, cudaStream_t stream) {
  return launch_persistent(
      bwd_phase2_kernel<kHiLo>,
      static_cast<long long>(n_units) * splits * n_scenes, smem, stream, ws,
      rows_cap, prog, units, n_units, rows, splits, split_rows, n_scenes,
      part, part_stride, part_scene_stride);
}

}  // namespace

extern "C" {

// The kernels' fixed shape, for the wrapper to check against its own.
int fused_mlp_bwd_constants(int* out, int len) {
  // ... then phase 1's tile sizes: bf16, then hi_lo.
  const int c[] = {kP2Threads, kMaxN,     kHeaderInts, kMaxBufs,
                   kOpInts,    kUnitK,    kUnitN,      kStageRows,
                   kUnitInts,  kP1Threads, kMaxStages,
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
// kernel; smem: the program's shared-memory bytes; ws: the workspace,
// rows_cap rows per matrix (a multiple of 64, >= n_scenes times
// scene_rows(n, rows); scene s's from s times that), each matrix in the
// strip layout (ws_elem). masks: null, or (the handover, with a program
// without forward operations) every tile's ReLU masks as the forward wrote
// them, mask_bytes (a multiple of 16) a tile, the activations already in
// ws. Launches a persistent grid of as many CTAs as the card holds at once
// (and the tiles need) on `stream`, does not synchronise, allocates
// nothing; returns the launch's error.
int fused_mlp_bwd_phase1(const void* pts, const void* dirs, const void* g,
                         const void* weights, const void* biases,
                         const void* prog, int prog_len, int hi_lo, int rows,
                         int n, int n_scenes, long long w_stride,
                         int b_stride, int smem, void* ws, long long rows_cap,
                         const void* masks, int mask_bytes, void* stream) {
  if (prog_len < kTablesBase || n_scenes <= 0 || w_stride % 8 ||
      b_stride < 0 || rows <= 0 || rows_cap % kStageRows ||
      rows_cap < static_cast<long long>(n_scenes) * scene_rows(n, rows) ||
      (masks != nullptr && (mask_bytes <= 0 || mask_bytes % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const float*>(pts);
  const auto* gg = static_cast<const float*>(g);
  const auto* w = static_cast<const bf16*>(weights);
  const auto* b = static_cast<const float*>(biases);
  const auto* pr = static_cast<const int*>(prog);
  auto* wsp = static_cast<bf16*>(ws);
  const auto* mk = static_cast<const unsigned char*>(masks);
  auto* s = static_cast<cudaStream_t>(stream);
  // The tables stay in device memory only where the program ends at the
  // buffer table (a deep or wide hi_lo net whose masks and buffers crowd
  // shared memory).
  const bool shared_tables = prog_len > kTablesBase;
#define PHASE1(HI_LO, T, SHARED)                                             \
  if (!!hi_lo == HI_LO && rows == T && shared_tables == SHARED)              \
    return static_cast<int>(launch_phase1<HI_LO, T, SHARED>(                \
        p, dirs, gg, w, b, pr, prog_len, n, n_scenes, w_stride, b_stride,    \
        smem, wsp, rows_cap, mk, mask_bytes, s));
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
// of 64; scene s's from s * rows): n_units units (device, int32) x `splits`
// ranges of split_rows rows (a multiple of 64) x the scenes, each writing
// its part into part[scene * part_scene_stride + split * part_stride +
// ...] (fp32); prog: the program (its header gives the ring); smem: its
// shared-memory bytes. Every element of each scene's packed gradient is
// written once per split. Launches a persistent grid of as many CTAs as the
// card holds at once (and the items need) on `stream`.
int fused_mlp_bwd_phase2(const void* ws, long long rows_cap, const void* prog,
                         const void* units, int n_units, int hi_lo, int rows,
                         int splits, int split_rows, int n_scenes, void* part,
                         long long part_stride, long long part_scene_stride,
                         int smem, void* stream) {
  if (n_units <= 0 || splits <= 0 || n_scenes <= 0 || rows % kStageRows ||
      split_rows % kStageRows || rows_cap % kStageRows ||
      static_cast<long long>(n_scenes) * rows > rows_cap ||
      static_cast<long long>(splits) * split_rows < rows || smem <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const bf16*>(ws);
  const auto* pr = static_cast<const int*>(prog);
  const auto* un = static_cast<const int*>(units);
  auto* pa = static_cast<float*>(part);
  auto* s = static_cast<cudaStream_t>(stream);
#define PHASE2(HI_LO)                                                        \
  if (!!hi_lo == HI_LO)                                                      \
    return static_cast<int>(launch_phase2<HI_LO>(                           \
        w, rows_cap, pr, un, n_units, rows, splits, split_rows, n_scenes,    \
        pa, part_stride, part_scene_stride, smem, s));
  PHASE2(false)
  PHASE2(true)
#undef PHASE2
  return static_cast<int>(cudaErrorInvalidValue);
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
