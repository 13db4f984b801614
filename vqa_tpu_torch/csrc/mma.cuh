// Shared helpers for the kernels on mma.sync with cp.async rings (every kernel
// but int8_matmul.cu, gru.cu, feed_gemm.cu and vocab_topk.cu, which run on
// wgmma: hopper.cuh).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

// d += a * b for one m16n8k16 tile: bf16 operands, f32 accumulators.
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16 with
// floating point type"), with g = lane / 4 and c = lane % 4:
//   a[0] = A[g][2c, 2c+1]      a[1] = A[g+8][2c, 2c+1]
//   a[2] = A[g][2c+8, 2c+9]    a[3] = A[g+8][2c+8, 2c+9]
//   b[0] = B[2c, 2c+1][g]      b[1] = B[2c+8, 2c+9][g]
//   d[0], d[1] = D[g][2c, 2c+1]     d[2], d[3] = D[g+8][2c, 2c+1]
// Each 32-bit register holds two bf16, the lower column in the low half.
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1 of each matrix: the fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of rows [row0, row0 + 16) x k [k0, k0 + 16) from a shared
// tile stored row-major with LD bf16 per row (k contiguous). Matrices in
// a[] order: rows 0-7 / 8-15 at k 0-7, then rows 0-7 / 8-15 at k 8-15.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile,
                                            int row0, int k0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles, columns [n0, n0 + 16) x k [k0, k0 + 16), from
// a shared tile stored n-major with LD bf16 per n (k contiguous), i.e. B
// transposed: b[0], b[1] for columns n0..n0+7 and b[2], b[3] for the next 8.
template <int LD>
__device__ __forceinline__ void load_b_frag2(uint32_t b[4],
                                             const __nv_bfloat16* tile,
                                             int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}

// 16-byte copy from global to shared memory that bypasses registers; with
// `valid` false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
