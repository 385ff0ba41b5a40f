// Device routines shared by the fused NeRF-MLP kernels for Hopper (sm_90a):
// the forward (fused_mlp_fwd.cu) and the backward's phase 1, which
// recomputes the same forward and walks the dX chain (fused_mlp_bwd.cu),
// run on one core here; phase 2 keeps the mma.sync and cp.async helpers
// at the top.
//
// What bounds the two kernels. Their work is compute (the forward ~50x
// over the card's memory rate at 8x256) but it comes in small pieces: a
// tile of points is the N of every product, 8 to 128 of them where the
// activations must fit shared memory, and every tile streams every weight
// of the net. The design before this core issued mma.sync from ldmatrix
// fragments with a block barrier per 16- or 32-row weight stage, the
// weights loaded by every thread; it was latency-bound (~150 TFLOP/s at
// 8x256, no part dominant) and, at 16- and 32-point tiles, restreamed the
// weights from L2 once per tile.
//
// What the core does about it:
//   * wgmma.mma_async from shared-memory descriptors, the products
//     transposed (M the layer's output features, N the tile's points): one
//     instruction serves tiles of 8 to 128 points, and dX reads the
//     forward's weight image as it lies (K-major instead of M-major A).
//   * A producer warp streams every operation's weight stages through a
//     ring with bulk copies behind a full and an empty mbarrier per slot;
//     consumers wait only on their slot's full barrier, and no block-wide
//     barrier is taken per stage (two named barriers of the consumers an
//     operation). The packer writes the weights in the swizzled layout
//     wgmma reads, so a copy needs no tensor map.
//   * Tiles below 64 points can run in clusters that share each weight
//     stage by multicast, so 64 points or more share each byte read from
//     L2. The layouts take clusters of one CTA: on an H100 the multicast
//     was slower at 123 of 134 layouts measured, never faster by more
//     than 1.3% (scripts/layout_sweep.py).
//   * The epilogue stores the accumulators with stmatrix.
//   * ptxas fences and waits for every wgmma of a loop it cannot prove
//     uniform over the warpgroup (note C7520): the stage's products issue
//     as one straight-line block whose shape depends on the operation
//     alone, a warpgroup without a tile multiplies a zero block instead,
//     and the epilogues take no branch that reads the accumulators: every
//     store is predicated in asm.
// Measured (PERF.md, chip_smoke.py, bwd_ablate.py, layout_sweep.py):
// faster than the design before at 8x256 and on most wide, deep and
// shallow nets; at 16- and 32-point tiles the small-N products, not L2
// traffic, take the time, so the layouts take the largest tile that fits
// and the multicast saves reads that were not the limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace mlp_tile {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // phase 2: bf16 of padding per shared-memory row:
                         // with a row stride of 16 B times an odd number,
                         // the 8 rows an ldmatrix reads fall in 8 banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a @ b for one m16n8k16 tile: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Point g's positional encoding, pts (n, 3) row-major: [x, sin(x * 2^0),
// cos(x * 2^0), sin(x * 2^1), ...], x * 2^l exact in fp32 and
// full-precision sincosf (never the fast intrinsics: arguments reach |x| *
// 2^9, thousands, where __sinf is wrong). Column j into v0 and, where j is
// a sine (j = 3 + 6 l + m, m < 3), its cosine, column j + 3, into v1, from
// one sincosf; returns how many it wrote: 1, 2, or 0 at a cosine (its
// sine's call writes it).
__device__ __forceinline__ int encode_pair(const float* __restrict__ pts,
                                           long long g, int j, float* v0,
                                           float* v1) {
  if (j < 3) {
    *v0 = pts[3 * g + j];
    return 1;
  }
  const int l = (j - 3) / 6, m = (j - 3) - 6 * l;
  if (m >= 3) return 0;
  sincosf(pts[3 * g + m] * ldexpf(1.f, l), v0, v1);
  return 2;
}

// ---------------------------------------------------------------------
// Hopper's asynchronous pieces: mbarriers, bulk copies (multicast over a
// thread-block cluster), wgmma from shared-memory descriptors.
// ---------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Until the phase of parity `parity` of the barrier has completed. The
// loop lies inside one asm statement: to the compiler the wait is one
// instruction, not a loop each thread leaves on its own (a path it could
// not prove convergent would serialize the wgmma after it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Where `pred`, arrive on the barrier at the same offset in CTA `cta` of
// the cluster (predicated in the asm: no branch around it).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 a;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mapa.shared::cluster.u32 a, %0, %1;\n"
      "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [a];\n}\n"
      ::"r"(smem_u32(bar)),
      "r"(cta), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma and bulk
// copies (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Barrier `id` (1..15) among `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this CTA's shared memory, completing on `bar`; the
// multicast form into every CTA of the cluster in `mask`, at the same
// offset, each completing on its own barrier at `bar`'s offset.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor. Without swizzle (sw128 = false) the
// operand is made of core matrices of 8 rows x 16 bytes (128 contiguous
// bytes); `lbo` is the byte distance between core matrices next to each
// other along K, `sbo` along M (A) or N (B). With the 128-byte swizzle,
// of 1024-byte atoms of 8 rows x 128 bytes whose 16-byte chunk j of row r
// sits at chunk j ^ r: `sbo` is the distance between atoms along the
// 8-row direction (K for an M-major A, M or N for a K-major operand),
// `lbo` between atoms along the other (unused within one atom).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, bool sw128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(sw128 ? 1 : 0) << 62);
}

// d (64 x N fp32, the warpgroup's fragments) += A (64 x 16) @ B (16 x N),
// bf16 operands from shared memory; scale_d == 0 starts d at zero. B is
// K-major; A is K-major (kTnspA = 0) or M-major (kTnspA = 1). Thread t of
// the warpgroup holds d[4 j + 2 h + e] = row 16 (t / 32) + (t % 32) / 4 +
// 8 h, column 8 j + 2 (t % 4) + e.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int kTnspA>
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a,
                                          uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTnspA)
        : "memory");
  }
};


template <>
struct Wgmma<16> {
  template <int kTnspA>
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                          uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTnspA)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  template <int kTnspA>
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTnspA)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  template <int kTnspA>
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTnspA)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  template <int kTnspA>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTnspA)
        : "memory");
  }
};



// ---------------------------------------------------------------------
// The k-step core of the forward and of the backward's phase 1.
//
// A block is 3 warpgroups: two consumers and a producer (kThreads). The
// consumers hold a tile's activations in shared memory as the B operand of
// wgmma (points as N, features as K) and take the weights as A (the layer's
// output features as M, 64 a wgmma): a pass of up to 256 output columns is
// up to four 64-row tiles, tiles 0 and 2 to consumer 0, 1 and 3 to
// consumer 1. One thread of the producer streams every operation's weight
// stages, in program order and tile group after tile group, into a ring of
// slots: one bulk copy per 64-column strip (and plane) of a stage, each
// split over the CTAs of the cluster and multicast into all of them. Every
// slot has a full barrier (the producer's arrive and the copies' bytes)
// and an empty barrier (one arrive per consumer warpgroup of every CTA of
// the cluster). The consumers wait only on their stage's full barrier.
//
// Shared-memory layouts (gmma_desc's 128-byte swizzle, 1024-byte atoms of
// 8 rows x 64 bf16 columns, chunk j of row r at j ^ r):
//  * an activation buffer of T points x C columns (C a multiple of 64):
//    atom (column / 64, point / 8) at ((column / 64) * (T / 8) + point / 8)
//    * 1024 bytes, row point % 8 (act_byte); the lo plane T * C elements
//    on. A buffer of the program names its atoms' columns and its first
//    column in them (the cotangent's sigma column shares rgb's atoms);
//  * a weight block W[k][n] (k rows of input features, n columns of output
//    features), in device memory and in a stage alike: strips of 64
//    columns, each its row groups of 8 rows one after another: a whole
//    strip in atoms of 8 rows x 64 columns, a last, narrower strip of sc
//    = (n - 64 s) / 8 < 8 cores a row group in unswizzled core matrices
//    (8 rows x 8 columns, 128 bytes, core (k / 8, n % 64 / 8) at ((k / 8)
//    * sc + n % 64 / 8) * 128). The forward reads a strip as W^T (M-major
//    A: sbo = 1024, the next 8 rows, swizzled; lbo = sc * 128, sbo = 128
//    unswizzled); dX reads the same bytes as W (K-major A: sbo = 1024
//    swizzled; lbo = 128, sbo = sc * 128 unswizzled).
// A 64-row tile may read past the last real row of its operand (a strip
// narrower than 64 columns, a pass ending inside a tile): those rows of
// the product are never written, and the layout leaves room after the
// ring for the bytes read.
// ---------------------------------------------------------------------

constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = 384;     // ... and the producer's
constexpr int kMaxN = 256;        // output columns of one pass
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kConsumerBar = 1;   // named barrier of the two consumers
constexpr int kMaxStages = 8;     // ring slots: their barriers, then
constexpr int kZeroBytes = 128;   // ... a zero block (Consumer::op)

// The fields both programs' operation records share.
enum CoreField {
  cKind = 0, cSrcA, cWA, cKA, cSrcB, cWB, cKB, cN, cCol, cWLd, cKR, cDst,
  cBias
};
// kOpFwd: dst[:, col:col + n] = A @ WA[:, col:col + n] (+ B @ WB[...]),
//   WA a (k_a, wld) block at wA, kr weight rows a stage;
// kOpDx: dst[:, col:col + n] = A @ WA[col:col + n, :]^T (+ B ...), WA a
//   (wld, k_a) block, a stage one 64-column strip of it and kr of its rows;
// kOpNone: no product (phase 1's load of the cotangent).
enum CoreKind { kOpFwd = 0, kOpDx = 1, kOpNone = 2 };

__host__ __device__ inline int strip_cores(int cols, int s) {
  const int c = (cols - 64 * s) / 8;
  return c < 8 ? c : 8;
}

// Byte offset of (point p, column c) in an activation buffer of T points.
template <int T>
__device__ __forceinline__ int act_byte(int p, int c) {
  return ((((c >> 6) * (T >> 3) + (p >> 3)) << 10) | ((p & 7) << 7) |
          ((((c >> 3) ^ p) & 7) << 4)) + ((c & 7) << 1);
}

// Stores predicated inside the asm: a branch of the operation loop that
// the compiler cannot prove uniform over the warpgroup (a warp without
// features in a pass, a lane past n) would serialize every wgmma of the
// loop, so the epilogues branch on no thread-dependent value.
//
// Four (x4) or two (x2) 8 x 8 bf16 blocks of a warp's accumulator
// fragments, transposed into 16-byte rows of shared memory: lane i gives
// the address of row i % 8 of block i / 8; register k holds (bf16x2) the
// lane's two neighbouring columns of block k's row lane / 4. `pred` must
// be the same on every lane of the warp.
__device__ __forceinline__ void stsm_x4_t(void* p, const uint32_t (&r)[4],
                                          bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n}\n" ::"r"(smem_u32(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void stsm_x2_t(void* p, const uint32_t (&r)[4],
                                          bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n"
      "@q stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
      "}\n" ::"r"(smem_u32(p)),
      "r"(r[0]), "r"(r[1]), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void st_global_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void st_global_if(bf16* p, bf16 v, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q st.global.b16 [%0], %1;\n}\n" ::"l"(p),
      "h"(*reinterpret_cast<const unsigned short*>(&v)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Two floats to an 8-byte aligned address.
__device__ __forceinline__ void st_shared_v2_if(float* p, float a, float b,
                                                bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n"
      "@q st.shared.v2.f32 [%0], {%1, %2};\n}\n" ::"r"(smem_u32(p)),
      "f"(a), "f"(b), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void st_shared_if(void* p, bf16 v, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q st.shared.b16 [%0], %1;\n}\n" ::"r"(smem_u32(p)),
      "h"(*reinterpret_cast<const unsigned short*>(&v)),
      "r"(static_cast<int>(pred))
      : "memory");
}

template <typename M>
__device__ __forceinline__ void st_shared_if(void* p, M v, bool pred) {
  const unsigned long long x = v;
  if constexpr (sizeof(M) == 8)
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
        "@q st.shared.b64 [%0], %1;\n}\n" ::"r"(smem_u32(p)),
        "l"(x), "r"(static_cast<int>(pred))
        : "memory");
  else if constexpr (sizeof(M) == 4)
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
        "@q st.shared.b32 [%0], %1;\n}\n" ::"r"(smem_u32(p)),
        "r"(static_cast<uint32_t>(x)), "r"(static_cast<int>(pred))
        : "memory");
  else if constexpr (sizeof(M) == 2)
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
        "@q st.shared.b16 [%0], %1;\n}\n" ::"r"(smem_u32(p)),
        "h"(static_cast<unsigned short>(x)), "r"(static_cast<int>(pred))
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
        "@q st.shared.b8 [%0], %1;\n}\n" ::"r"(smem_u32(p)),
        "h"(static_cast<unsigned short>(x)), "r"(static_cast<int>(pred))
        : "memory");
}

// 16 bytes from shared to device memory where `pred`.
__device__ __forceinline__ void copy16_if(void* g, const void* s, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\n.reg .b32 a, b, c, d;\nsetp.ne.b32 q, %2, 0;\n"
      "@q ld.shared.v4.b32 {a, b, c, d}, [%1];\n"
      "@q st.global.v4.b32 [%0], {a, b, c, d};\n}\n" ::"l"(g),
      "r"(smem_u32(s)), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's 16 features x T points of one 64-row tile (its accumulator
// fragment, element i = 4 j + 2 h + e: feature lane / 4 + 8 h from column
// c of the buffer, point 8 j + 2 (lane % 4) + e) into an activation
// buffer: val(i) the element's final value, stored in bf16 — in hi_lo as
// the pair (hi, lo) = (bf16(v), bf16(v - hi)), the lo plane `plane` bytes
// on; only where `pred` (the same on the warp's lanes). One stmatrix per
// 16 points (per 8 at T = 8).
template <bool kHiLo, int T, typename F>
__device__ __forceinline__ void store_acc(unsigned char* buf, int plane, int c,
                                          int lane, bool pred, F&& val) {
  const int blk = lane >> 3;
  if constexpr (T >= 16) {
#pragma unroll
    for (int jp = 0; jp < T / 16; ++jp) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 4 * (2 * jp + (m >> 1)) + 2 * (m & 1);
        const float v0 = val(i), v1 = val(i + 1);
        hi[m] = pack_bf16(v0, v1);
        if (kHiLo) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[m]);
          lo[m] = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
        }
      }
      unsigned char* at =
          buf + act_byte<T>(16 * jp + 8 * (blk >> 1) + (lane & 7),
                            c + 8 * (blk & 1));
      stsm_x4_t(at, hi, pred);
      if (kHiLo) stsm_x4_t(at + plane, lo, pred);
    }
  } else {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float v0 = val(2 * m), v1 = val(2 * m + 1);
      hi[m] = pack_bf16(v0, v1);
      if (kHiLo) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[m]);
        lo[m] = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
      }
    }
    unsigned char* at = buf + act_byte<T>(lane & 7, c + 8 * (blk & 1));
    stsm_x2_t(at, hi, pred);
    if (kHiLo) stsm_x2_t(at + plane, lo, pred);
  }
}

// Its B-operand descriptor from column c (a multiple of 16): K-major,
// swizzled, the next 8 points 1024 bytes on.
template <int T>
__device__ __forceinline__ uint64_t act_desc(uint32_t buf, int c) {
  return gmma_desc(buf + (c >> 6) * T * 128 + (c & 63) * 2, 16, 1024, true);
}

// Every ring stage of an operation, in the order the producer fills them
// and the consumers take them: f(operand, a, r0, rows) — operand 0 (A) or
// 1 (B); the forward: a = the first weight row, rows weight rows; dX: a =
// the 64-column strip of the block, rows of the pass's columns from r0.
template <typename F>
__device__ __forceinline__ void each_stage(const int* o, F&& f) {
  const int kind = o[cKind], kr = o[cKR], nn = o[cN];
  if (kind == kOpNone) return;
#pragma unroll 1
  for (int x = 0; x < 2; ++x) {
    const int k = x ? o[cKB] : o[cKA];
    if (kind == kOpFwd) {
#pragma unroll 1
      for (int k0 = 0; k0 < k; k0 += kr) f(x, k0, 0, min(kr, k - k0));
    } else {
#pragma unroll 1
      for (int s = 0; s < (k + 63) >> 6; ++s)
#pragma unroll 1
        for (int r0 = 0; r0 < nn; r0 += kr) f(x, s, r0, min(kr, nn - r0));
    }
  }
}

// A ring position: slot and the parity of its round.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// `bytes` of a copy, cut into 128-byte units shared out over the cluster's
// CTAs (rank of 1 << lg), this CTA's part multicast into all of them.
__device__ __forceinline__ void copy_part(unsigned char* dst, const bf16* src,
                                          int bytes, uint64_t* full, int rank,
                                          int lg) {
  if (lg == 0) {
    bulk_load(dst, src, bytes, full);
    return;
  }
  const int units = bytes >> 7;
  const int u0 = (units * rank) >> lg, u1 = (units * (rank + 1)) >> lg;
  if (u1 > u0)
    bulk_load_multicast(dst + (u0 << 7), src + (u0 << 6), (u1 - u0) << 7,
                        full, static_cast<uint16_t>((1u << (1 << lg)) - 1));
}

// The producer warp's stream: every operation's stages in program order,
// group after group of this cluster. Lane 0 waits for the slot and arms
// its full barrier with the stage's bytes; then lane 2 t + plane copies
// the forward stage's strip t of that plane (a dX stage is one strip:
// lanes 0 and 1). `ops`, `n_ops`: the operation table; lg: log2 of the
// cluster's CTAs.
template <bool kHiLo>
__device__ __forceinline__ void produce(
    const int* ops, int op_ints, int n_ops, const bf16* weights,
    long long w_stride, int groups_per_scene, int n_groups, int cluster_id,
    int n_clusters, int stages, unsigned char* ring, int slot_bytes,
    int half, uint64_t* full, uint64_t* empty, int rank, int lg) {
  const int lane = threadIdx.x & 31;
  const int t = kHiLo ? lane >> 1 : lane, plane = kHiLo ? lane & 1 : 0;
  Ring pos;
#pragma unroll 1
  for (int g = cluster_id; g < n_groups; g += n_clusters) {
    const bf16* w = weights + (g / groups_per_scene) * w_stride;
#pragma unroll 1
    for (int oi = 0; oi < n_ops; ++oi) {
      const int* o = ops + oi * op_ints;
      const int kind = o[cKind], nn = o[cN], c0 = o[cCol], wld = o[cWLd];
      // The forward's strips: this lane's strip t of the pass (its cores a
      // row group) and a row's bytes over all strips of one plane.
      const int strips = (nn + 63) >> 6;
      const int gs = (c0 >> 6) + t;
      const int sc = min(8, (wld >> 3) - 8 * gs);
      const int row_bytes =
          16 * (8 * (strips - 1) + min(8, (wld >> 3) - 8 * ((c0 >> 6) + strips - 1)));
      each_stage(o, [&](int x, int a, int r0, int rows) {
        const int k = x ? o[cKB] : o[cKA];
        const bf16* blk = w + (x ? o[cWB] : o[cWA]);
        if (lane == 0) {
          mbar_wait(&empty[pos.slot], pos.phase ^ 1);
          const int bytes = kind == kOpFwd
              ? rows * row_bytes
              : rows * 16 * min(8, (k >> 3) - 8 * a);
          mbar_expect_tx(&full[pos.slot], kHiLo ? 2 * bytes : bytes);
        }
        __syncwarp();
        unsigned char* slot = ring + pos.slot * slot_bytes + plane * half;
        if (kind == kOpFwd) {
          if (t < strips) {
            const long long lo = static_cast<long long>(k) * wld;
            copy_part(slot + t * rows * 128,
                      blk + plane * lo + static_cast<long long>(k) * 64 * gs +
                          a * sc * 8,
                      rows * sc * 16, &full[pos.slot], rank, lg);
          }
        } else if (t == 0) {
          const long long lo = static_cast<long long>(wld) * k;
          const int scs = min(8, (k >> 3) - 8 * a);
          copy_part(slot,
                    blk + plane * lo + static_cast<long long>(wld) * 64 * a +
                        (c0 + r0) * scs * 8,
                    rows * scs * 16, &full[pos.slot], rank, lg);
        }
        pos.next(stages);
      });
    }
  }
}

// The consumers' side: accumulators acc[u] of this warpgroup's 64-row
// tiles wg + 2 u of the pass, fresh[u] until their first product.
template <bool kHiLo, int T>
struct Consumer {
  using Mma = Wgmma<T>;
  static constexpr int kAcc = T / 2;

  // Release a slot: one arrive per consumer warpgroup on the slot's empty
  // barrier in every CTA of the cluster, once the warpgroup's products
  // that read it have retired.
  static __device__ __forceinline__ void release(uint64_t* empty, int lane,
                                                 int csize) {
    mbar_arrive_cluster(empty, lane, lane < csize);
  }

  // One stage's products as one straight-line block: S k-steps over the
  // warpgroup's tiles in kTiles (bit u: tile wg + 2 u). ptxas fences and
  // waits for every wgmma of a path it cannot prove warpgroup-uniform
  // (a branch on a value from shared memory is such a path), so a stage's
  // wgmmas issue back to back only when no branch lies between them.
  // da[u]: tile u's A descriptor at the first k-step, a_step its advance a
  // k-step (16-byte units); db[q]: B at k-step q; half, b_lo: the lo
  // planes' offsets (16-byte units); s[u]: 0 where the tile's accumulator
  // starts at zero.
  template <int kTnsp, int S, int kTiles>
  static __device__ __forceinline__ void block(
      float (&acc0)[kAcc], float (&acc1)[kAcc], const uint64_t (&da)[2],
      const uint32_t (&a_step)[2], const uint64_t (&db)[4],
      const uint32_t (&half)[2], uint32_t b_lo, const int (&s)[2]) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      if constexpr ((kTiles & 1) != 0) {
        const uint64_t a = da[0] + q * a_step[0];
        Mma::template mma<kTnsp>(acc0, a, db[q], q == 0 ? s[0] : 1);
        if (kHiLo) {
          Mma::template mma<kTnsp>(acc0, a, db[q] + b_lo, 1);
          Mma::template mma<kTnsp>(acc0, a + half[0], db[q], 1);
        }
      }
      if constexpr ((kTiles & 2) != 0) {
        const uint64_t a = da[1] + q * a_step[1];
        Mma::template mma<kTnsp>(acc1, a, db[q], q == 0 ? s[1] : 1);
        if (kHiLo) {
          Mma::template mma<kTnsp>(acc1, a, db[q] + b_lo, 1);
          Mma::template mma<kTnsp>(acc1, a + half[1], db[q], 1);
        }
      }
    }
  }

  template <int kTnsp>
  static __device__ __forceinline__ void dispatch(
      int steps, int tiles, float (&acc0)[kAcc], float (&acc1)[kAcc],
      const uint64_t (&da)[2], const uint32_t (&a_step)[2],
      const uint64_t (&db)[4], const uint32_t (&half)[2], uint32_t b_lo,
      const int (&s)[2]) {
#define MLP_TILE_BLOCK(S, TILES)                                           \
  case 4 * (S - 1) + TILES:                                                \
    block<kTnsp, S, TILES>(acc0, acc1, da, a_step, db, half, b_lo, s);     \
    break;
    switch (4 * (steps - 1) + tiles) {
      MLP_TILE_BLOCK(1, 1) MLP_TILE_BLOCK(1, 2) MLP_TILE_BLOCK(1, 3)
      MLP_TILE_BLOCK(2, 1) MLP_TILE_BLOCK(2, 2) MLP_TILE_BLOCK(2, 3)
      MLP_TILE_BLOCK(3, 1) MLP_TILE_BLOCK(3, 2) MLP_TILE_BLOCK(3, 3)
      MLP_TILE_BLOCK(4, 1) MLP_TILE_BLOCK(4, 2) MLP_TILE_BLOCK(4, 3)
      default:
        break;
    }
#undef MLP_TILE_BLOCK
  }

  // One operation's products over its stages, from ring position `pos`
  // (advanced): the accumulators hold the whole sum on return. `bufs`:
  // the buffer table (byte offset, columns, first column); `base`: shared
  // memory's address; `zero`: 128 zero bytes; `live`: a tile of real
  // points (else the stages are only waited on and released). A forward
  // stage holds at most 64 weight rows and a dX stage one 64-column
  // strip: at most four k-steps.
  //
  // Which products a stage issues (its k-steps, and u = 0 / 1 where either
  // warpgroup has tile wg + 2 u in the stage) depends on the operation
  // alone, never on the warpgroup: ptxas serializes every wgmma of a path
  // it cannot prove uniform over the warpgroup. A warpgroup without that
  // tile multiplies the zero block instead (lbo = sbo = 0: every core
  // matrix the same 128 zero bytes), which adds exactly nothing.
  static __device__ __forceinline__ void op(
      const int* o, Ring& pos, int stages, unsigned char* ring,
      int slot_bytes, int half, uint64_t* full, uint64_t* empty,
      const int* bufs, uint32_t base, uint32_t zero, int wg, int lane_wg,
      int csize, bool live, float (&acc0)[kAcc], float (&acc1)[kAcc]) {
    const int kind = o[cKind], nn = o[cN], c0 = o[cCol], wld = o[cWLd];
    const int pass_tiles = (nn + 63) >> 6;
    // The forward's strips of this warpgroup's tiles: cores a row group.
    const int sc0 = min(8, (wld >> 3) - 8 * ((c0 >> 6) + wg));
    const int sc1 = min(8, (wld >> 3) - 8 * ((c0 >> 6) + wg + 2));
    const uint32_t ring_at = smem_u32(ring);
    const uint64_t zero_desc = gmma_desc(zero, 0, 0, false);
    int fresh[2] = {0, 0};  // the scale of a tile's next product: 0 first
    int prev = -1;
    each_stage(o, [&](int x, int a, int r0, int rows) {
      mbar_wait(&full[pos.slot], pos.phase);
      if (live) {
        const int src = x ? o[cSrcB] : o[cSrcA];
        const uint32_t b_at = base + bufs[3 * src];
        const uint32_t b_lo = (T * bufs[3 * src + 1] * 2) >> 4;
        const int cb = bufs[3 * src + 2];
        const uint32_t slot = ring_at + pos.slot * slot_bytes;
        uint64_t da[2], db[4];
        uint32_t a_step[2], hf[2];
        bool mine[2];
        int steps, tiles;
        if (kind == kOpFwd) {
          // Tile mt's strip at mt * rows * 128 of the stage; 16 weight rows
          // (two row groups) a k-step.
          const int sc[2] = {sc0, sc1};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t at = slot + (wg + 2 * u) * rows * 128;
            const uint64_t sw = gmma_desc(at, 1024, 1024, true);
            const uint64_t un = gmma_desc(at, sc[u] * 128, 128, false);
            da[u] = sc[u] == 8 ? sw : un;
            a_step[u] = 2 * sc[u] * 8;
            mine[u] = wg + 2 * u < pass_tiles;
          }
          steps = rows >> 4;
          tiles = 1 | (pass_tiles > 2 ? 2 : 0);
#pragma unroll
          for (int q = 0; q < 4; ++q) db[q] = act_desc<T>(b_at, cb + a + 16 * q);
        } else {
          // Strip a of the block, rows r0.. of the pass: tile mt from row
          // group (64 mt - r0) / 8; 16 columns (two cores) a k-step: 32
          // bytes on in a swizzled row, two cores unswizzled.
          const int k = x ? o[cKB] : o[cKA];
          const int sc = min(8, (k >> 3) - 8 * a);
          const bool sw = sc == 8;
          const int t0 = r0 >> 6, t1 = min(pass_tiles, (r0 + rows + 63) >> 6);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int mt = wg + 2 * u;
            da[u] = gmma_desc(slot + ((mt * 64 - r0) >> 3) * sc * 128,
                              sw ? 16 : 128, sw ? 1024 : sc * 128, sw);
            a_step[u] = sw ? 2 : 16;
            mine[u] = mt >= t0 && mt < t1;
          }
          steps = sc >> 1;
          tiles = (t0 <= 1 && t1 > 0 ? 1 : 0) | (t1 > 2 ? 2 : 0);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            db[q] = act_desc<T>(b_at, cb + 64 * a + 16 * q);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          da[u] = mine[u] ? da[u] : zero_desc;
          a_step[u] = mine[u] ? a_step[u] : 0;
          hf[u] = mine[u] ? static_cast<uint32_t>(half) >> 4 : 0;
        }
        const int s[2] = {mine[0] ? fresh[0] : 1, mine[1] ? fresh[1] : 1};
        wgmma_fence();
        if (kind == kOpFwd)
          dispatch<1>(steps, tiles, acc0, acc1, da, a_step, db, hf, b_lo, s);
        else
          dispatch<0>(steps, tiles, acc0, acc1, da, a_step, db, hf, b_lo, s);
        wgmma_commit();
        fresh[0] |= static_cast<int>(mine[0]) & tiles;
        fresh[1] |= static_cast<int>(mine[1]) & (tiles >> 1);
        wgmma_wait<1>();
      }
      if (prev >= 0) release(&empty[prev], lane_wg, csize);
      prev = pos.slot;
      pos.next(stages);
    });
    if (live) {
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
    }
    if (prev >= 0) release(&empty[prev], lane_wg, csize);
  }
};

// Tile groups: a cluster of C CTAs walks groups of C neighbouring tiles of
// one scene, CTA r the group's tile r; a scene's last group is padded with
// empty tiles (no points, nothing written), so no group straddles two
// scenes. Group g: scene g / groups, tile (g % groups) * C + r.
__host__ __device__ inline int scene_groups(int tiles, int csize) {
  return (tiles + csize - 1) / csize;
}

// The ring's barriers: full[s] expects the producer's arrive (and the
// bytes), empty[s] two consumer warpgroups of each CTA of the cluster;
// after kMaxStages slots' barriers, the zero block.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int csize) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 2 * csize);
  }
  uint32_t* zero = reinterpret_cast<uint32_t*>(full + 2 * kMaxStages);
  for (int i = 0; i < kZeroBytes / 4; ++i) zero[i] = 0;
  fence_proxy_async();
  fence_barrier_init();
}

// Launch `kernel` on `clusters` clusters of `csize` CTAs of kThreads.
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), int clusters, int csize,
                            int smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of `csize` CTAs of `kernel` at `smem` bytes the card
// holds at once (the GPCs may not hold 132 / csize), asked once per
// (kernel, cluster, bytes, device).
template <typename... KArgs>
cudaError_t max_clusters(void (*kernel)(KArgs...), int csize, int smem,
                         int* out) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   csize, smem, dev);
  std::lock_guard<std::mutex> hold(lock);
  auto at = known.find(key);
  if (at != known.end()) {
    *out = at->second;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * 132);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel),
                                       &cfg);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidConfiguration;
  known[key] = n;
  *out = n;
  return cudaSuccess;
}

}  // namespace mlp_tile
