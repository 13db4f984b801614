// int8 x int8 tensor-core GEMM with exact int32 sums and a fused dequant
// epilogue.
//
// Replaces: vqa_tpu/ops/pallas/int8_matmul.py int8_matmul_dequant and
// int8_matmul_dequant_3d (the 3-D entry is a [B * G, K] view of its input,
// so one kernel serves both): the ReGAT serving path's attention
// v-projection over the int8 feed and the three GCN projections over the
// row-quantized layer input.
//
//   out[m, n] = relu((float(sum_k x_q[m, k] w[n, k]) * (x_scale[m] * w_scale[n]))
//                    -> out type, + bias[n])
//
// What bounds it on an H100: at B=8192 the GCN projections are M = 294,912
// rows (B x 36 boxes), K = N = 2048: 2.47 T int8 operations, 1.25 ms at the
// 1,979 TOP/s int8 tensor-core peak, against 0.6 GB of int8 input and
// 1.2 GB of bf16 output (0.55 ms at 3.35 TB/s). It is bound by operations.
// Without the epilogue in the kernel, the [M, N] int32 sums and their f32
// scaling would each make a round trip through device memory.
//
// Design: 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync m16n8k32
// s8.s8.s32 with fragments by ldmatrix (an 8 x 16-byte matrix gives each
// lane the 4 consecutive int8 of one row that the s8 fragments hold), K in
// steps of 64 bytes through a 4-stage cp.async ring in shared memory (80-byte
// rows: conflict-free ldmatrix). Both operands are plain copies, so no
// register staging. Rows past M and columns past N load as zeros and are
// not stored. The epilogue keeps the plain version's order with round-to-
// nearest intrinsics, so that no multiply-add is contracted: the int32 sum
// to f32, times the f32 product of the two scales, one cast to the output
// type, the bias added in f32 and rounded to the output type (PyTorch's
// order for a bf16 add), then max(0). The kernel therefore equals the plain
// version bit for bit. wgmma with TMA is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 64;               // bytes of K per stage
constexpr int kLd = kTileK + 16;         // padded row of 80 bytes
constexpr int kStages = 4;
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kChunks = kTileK / 16;     // 16-byte chunks per tile row

struct Stage {
  int8_t a[kTileM * kLd];
  int8_t b[kTileN * kLd];
};
constexpr int kSmem = kStages * sizeof(Stage);

// d += a * b for one m16n8k32 tile: s8 operands, s32 accumulators. Fragment
// layout (PTX ISA, "Matrix Fragments for mma.m16n8k32"), g = lane / 4,
// c = lane % 4, four int8 per register, the lowest k in the lowest byte:
//   a[0] = A[g][4c..4c+3]     a[1] = A[g+8][4c..4c+3]
//   a[2] = A[g][16+4c..]      a[3] = A[g+8][16+4c..]
//   b[0] = B[4c..4c+3][g]     b[1] = B[16+4c..16+4c+3][g]
//   d[0], d[1] = D[g][2c, 2c+1]     d[2], d[3] = D[g+8][2c, 2c+1]
__device__ __forceinline__ void mma_s8_16832(int d[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_b8(uint32_t r[4], const int8_t* p) {
  ldmatrix_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

// the A (x_q) and B (w, n-major) tiles of K step k0 into one stage; each
// thread copies two 16-byte chunks of each
__device__ __forceinline__ void load_stage(Stage& s, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ w, int m0,
                                           int n0, int k0, int M, int N, int K,
                                           int tid) {
#pragma unroll
  for (int idx = tid; idx < kTileM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, q = idx % kChunks;
    const int k = k0 + q * 16;
    const bool ok = m0 + r < M && k < K;
    cp_async16(s.a + r * kLd + q * 16,
               xq + static_cast<size_t>(ok ? m0 + r : 0) * K + (ok ? k : 0), ok);
  }
#pragma unroll
  for (int idx = tid; idx < kTileN * kChunks; idx += kThreads) {
    const int r = idx / kChunks, q = idx % kChunks;
    const int k = k0 + q * 16;
    const bool ok = n0 + r < N && k < K;
    cp_async16(s.b + r * kLd + q * 16,
               w + static_cast<size_t>(ok ? n0 + r : 0) * K + (ok ? k : 0), ok);
  }
}

__device__ __forceinline__ float load_scale(const void* xs, int row, int xs_bf16) {
  return xs_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(xs)[row])
                 : static_cast<const float*>(xs)[row];
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq,       // [M, K]
                   const void* __restrict__ xs,         // [M] f32 or bf16
                   const int8_t* __restrict__ w,        // [N, K]
                   const float* __restrict__ ws,        // [N]
                   const void* __restrict__ bias,       // [N] out type, or null
                   void* __restrict__ out,              // [M, N] f32 or bf16
                   int M, int K, int N, int xs_bf16, int out_bf16, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stages = reinterpret_cast<Stage*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int wm = (warp / (kTileN / kWarpN)) * kWarpM;
  const int wn = (warp % (kTileN / kWarpN)) * kWarpN;

  int acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int k_tiles = (K + kTileK - 1) / kTileK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(stages[s], xq, w, m0, n0, s * kTileK, M, N, K, tid);
    cp_async_commit();   // an empty group keeps the count of groups fixed
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed (for this thread)
    __syncthreads();                // ... and for all; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles)
      load_stage(stages[next % kStages], xq, w, m0, n0, next * kTileK, M, N, K, tid);
    cp_async_commit();

    const Stage& s = stages[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 32) {
      uint32_t a[kWarpM / 16][4], b[kWarpN / 16][4];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
        ldmatrix_x4_b8(a[i], s.a + (wm + i * 16 + (lane & 15)) * kLd + kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j)
        ldmatrix_x4_b8(b[j], s.b + (wn + j * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd + kk +
                                 ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j)
          mma_s8_16832(acc[i][j], a[i], b[j / 2] + 2 * (j % 2));
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < kWarpN / 8; ++j) {
    const int col = n0 + wn + j * 8 + 2 * c;
    if (col >= N) continue;   // N % 8 == 0, so col + 1 < N too
    const float w0 = ws[col], w1 = ws[col + 1];
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (out_bf16) {
        b0 = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col]);
        b1 = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col + 1]);
      } else {
        b0 = static_cast<const float*>(bias)[col];
        b1 = static_cast<const float*>(bias)[col + 1];
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
        const float x = load_scale(xs, row, xs_bf16);
        float y0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), __fmul_rn(x, w0));
        float y1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), __fmul_rn(x, w1));
        const size_t at = static_cast<size_t>(row) * N + col;
        if (out_bf16) {
          __nv_bfloat16 o0 = __float2bfloat16_rn(y0), o1 = __float2bfloat16_rn(y1);
          if (bias != nullptr) {
            o0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o0), b0));
            o1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o1), b1));
          }
          if (relu) {
            if (__bfloat162float(o0) < 0.f) o0 = __float2bfloat16_rn(0.f);
            if (__bfloat162float(o1) < 0.f) o1 = __float2bfloat16_rn(0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
              __halves2bfloat162(o0, o1);
        } else {
          if (bias != nullptr) {
            y0 = __fadd_rn(y0, b0);
            y1 = __fadd_rn(y1, b1);
          }
          if (relu) {
            y0 = y0 < 0.f ? 0.f : y0;
            y1 = y1 < 0.f ? 0.f : y1;
          }
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(y0, y1);
        }
      }
  }
}

}  // namespace

// out[M, N] = epilogue(x_q @ w_nk^T). x_scale is bf16 when xs_bf16 (else
// f32), out and bias are bf16 when out_bf16 (else f32); bias may be null.
// Requires K % 32 == 0, N % 8 == 0 and 16-byte aligned, contiguous operands.
extern "C" int int8_matmul_forward(const void* x_q, const void* x_scale,
                                   const void* w_nk, const void* w_scale,
                                   const void* bias, void* out, int M, int K,
                                   int N, int xs_bf16, int out_bf16, int relu,
                                   void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  int8_matmul_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_q), x_scale, static_cast<const int8_t*>(w_nk),
      static_cast<const float*>(w_scale), bias, out, M, K, N, xs_bf16, out_bf16, relu);
  return static_cast<int>(cudaGetLastError());
}
