// Device routines shared by the fused NeRF-MLP kernels for Hopper (sm_90a):
// the forward (fused_mlp_fwd.cu) and the backward's phase 1, which
// recomputes the same forward (fused_mlp_bwd.cu). Both stream weights
// through a cp.async ring of k-slabs, feed mma.sync m16n8k16 (bf16 operands,
// fp32 accumulators) from shared memory by ldmatrix, and encode the points
// in-kernel with the same arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp_tile {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 of padding per shared-memory row: with a
                         // row stride of 16 B times an odd number, the 8
                         // rows an ldmatrix reads fall in 8 distinct banks

// The 16 warps of a block over a tile of T points and one output pass of
// up to 256 columns: kRG x kCG warps, each owning 16 * kMT rows and kWN
// columns (kNT n8 tiles). T = 128 or 64: 4 x 4 warps of 64 columns (two
// m16 tiles each at 128); T = 32: 2 x 8 warps of 32 columns; T = 16: 1 x
// 16 warps of 16 columns. A thread holds the same (row, column) positions
// of every pass, so each keeps its own ReLU mask bits: 4 kNT bits an m16
// tile, one word of type Mask.
template <int T>
struct WarpGrid {
  static constexpr int kMT = T >= 64 ? T / 64 : 1;
  static constexpr int kWN = T >= 64 ? 64 : T;
  static constexpr int kNT = kWN / 8;
  static constexpr int kCG = 256 / kWN;
  static constexpr int kRG = 16 / kCG;
  static_assert(kRG * 16 * kMT == T && kCG * kWN == 256, "a warp grid of 16");
};
template <int NT> struct MaskWord { using type = uint32_t; };
template <> struct MaskWord<4> { using type = uint16_t; };
template <> struct MaskWord<2> { using type = uint8_t; };

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

// Wait until at most `pending` (0..2) groups are in flight.
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  if (pending <= 0)
    cp_async_wait<0>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16(v0), __float2bfloat16(v1));
}

// Column j of point g's positional encoding, pts (n, 3) row-major:
// [x, sin(x * 2^0), cos(x * 2^0), sin(x * 2^1), ...], x * 2^l exact in
// fp32 and full-precision sinf/cosf (never the fast intrinsics: arguments
// reach |x| * 2^9, thousands, where __sinf is wrong).
__device__ __forceinline__ float encode(const float* __restrict__ pts,
                                        long long g, int j) {
  if (j < 3) return pts[3 * g + j];
  const int l = (j - 3) / 6, m = (j - 3) - 6 * l;
  const float a = pts[3 * g + m % 3] * ldexpf(1.f, l);
  return m < 3 ? sinf(a) : cosf(a);
}

}  // namespace mlp_tile
