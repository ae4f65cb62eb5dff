// Tensor-core tile helpers for the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async copies with zero-fill, ldmatrix, the
// mma.sync m16n8k16 bf16 product with f32 accumulators, and the repack
// of an accumulator tile into an A operand.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (PTX ISA,
// "Matrix fragments for mma.m16n8k16"), for lane = 4*g + t:
//   A (16x16, 4 x b32): a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same
//     cols), a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8..);
//   B (16x8, 2 x b32):  b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8..);
//   C (16x8, 4 x f32):  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row g+8.
// The lower column (or row) of each b32 pair sits in its low half.  So
// the accumulators of two neighbouring 8-column tiles, rounded to bf16
// and packed pairwise, are the A operand of the next product over those
// 16 columns (acc_to_a), as FlashAttention-2 chains P into PV.
//
// Tiles live in shared memory row-major with rows padded by 8 bf16 (16
// bytes): the eight 16-byte rows one ldmatrix phase reads then start in
// eight different 4-bank groups, so the reads are free of bank
// conflicts, and every row stays 16-byte aligned for cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mxt_mma {

// Lets kernel KERN take `bytes` of dynamic shared memory (above 48 KB it
// must be asked for) on the current device.  The driver call is made
// once per kernel and device, not at every launch.
template <auto KERN>
inline void allow_smem(int bytes) {
  static std::atomic<unsigned> done{0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return;
  if (cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
      cudaSuccess)
    done.fetch_or(bit);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; ok == false writes 16 zero
// bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous, zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of a (rows, DH) bf16 matrix whose rows are `stride`
// elements apart, into shared memory [R][DH + 8], by the block's NT
// threads in 16-byte pieces; rows at or past `rows` read as zeros.
template <int R, int DH, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int rows, size_t stride) {
  constexpr int PER_ROW = DH / 8;
  static_assert((R * PER_ROW) % NT == 0, "the tile must split evenly over the block");
#pragma unroll
  for (int i = 0; i < R * PER_ROW / NT; ++i) {
    const int c = (int)threadIdx.x + i * NT;
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * (DH + 8) + col, src + (size_t)(ok ? r0 + r : 0) * stride + col, ok);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] is this lane's (row g, cols 2t, 2t+1) of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldsm_x4, each matrix transposed: r[i] is (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Address, for this lane, of the A operand (16 rows x 16 cols) at
// (row0, col0) of a [.][LD] tile: matrices (rows 0-7 | 8-15) x (cols
// 0-7 | 8-15) in the order a0, a1, a2, a3.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* s, int row0,
                                                       int col0, int lane) {
  return s + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8;
}

// Address of the B operands of two 8-column tiles read from a [n][k]
// tile (n = rows of the tile, k = its columns), rows n0..n0+15, cols
// k0..k0+15: r = {b0, b1} of rows n0..n0+7, then {b0, b1} of n0+8..15.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* b_addr(const __nv_bfloat16* s, int n0,
                                                       int k0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8;
}

// Address of the B operands of two 8-column tiles read transposed from
// a [k][n] tile (k rows k0..k0+15, n cols n0..n0+15), for ldsm_x4_t:
// r = {b0, b1} of cols n0..n0+7, then {b0, b1} of n0+8..15.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* bt_addr(const __nv_bfloat16* s, int k0,
                                                        int n0, int lane) {
  return s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + n0 + (lane >> 4) * 8;
}

// c += a * b for one 16x8 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand over 16 columns from the accumulators of the two 8-column
// tiles c_lo (columns 0-7) and c_hi (8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c_lo)[4],
                                         const float (&c_hi)[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// The maximum (sum) of x over the 4 lanes of a quad: one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mxt_mma
