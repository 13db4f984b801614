// Int8-feed dequant fused into a bf16 tensor-core GEMM.
//
// Replaces: vqa_tpu/ops/pallas/feed_gemm.py dequant_matmul, the attention
// v-projection (x_q * scale) @ W_v of the int8 feature feed.
//
// What bounds it on an H100: at B=16384 the product is M = 589,824 rows
// (B x 36 boxes), K = 2048, N = 1024: 2.5 TFLOP, about 2.5 ms at the bf16
// tensor-core peak, against 1.2 GB of int8 activations and 1.2 GB of bf16
// output (0.7 ms at 3.35 TB/s). It is compute-bound. Without this kernel,
// eager PyTorch writes the dequantized [M, K] bf16 activation (2.4 GB) and
// reads it back as the GEMM operand.
//
// Design: 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync m16n8k16 bf16
// with f32 accumulation, fragments by ldmatrix, K in steps of 64. The A
// tile is loaded as int8 (16 bytes a load), converted exactly to bf16 by
// integer and f32-add tricks (each value is converted once per 128-column
// tile, so the conversion unit's low rate would rival the tensor cores),
// multiplied by its row's scale with one bf16 rounding (the TPU kernel's
// rounding point: the bf16 product x_q * scale) on the way into shared
// memory, so the dequantized activation never reaches device memory. Two
// shared-memory stages: the weight tile is copied by cp.async and the next
// A tile waits in registers while the tensor cores work on the current one.
// Ragged M and N are masked: rows past the end load as zeros and are not
// stored. wgmma with TMA is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 64;
constexpr int kLd = kTileK + 8;          // padded row: conflict-free ldmatrix
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kARows = kThreads * 16 / kTileK;   // A rows one pass of loads covers

struct Stage {
  __nv_bfloat16 a[kTileM * kLd];
  __nv_bfloat16 b[kTileN * kLd];
};
constexpr int kSmem = 2 * sizeof(Stage);

// this thread's 16-byte chunks of the A tile: rows r0 + i * kARows, chunk q
struct ATile {
  int4 q[kTileM / kARows];
};

__device__ __forceinline__ void load_a(ATile& t, const int8_t* __restrict__ xq, int m0,
                                       int k0, int M, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kTileM / kARows; ++i) {
    const int row = m0 + tid / (kTileK / 16) + i * kARows;
    t.q[i] = make_int4(0, 0, 0, 0);
    if (row < M)
      t.q[i] = *reinterpret_cast<const int4*>(xq + static_cast<size_t>(row) * K + k0 +
                                              (tid % (kTileK / 16)) * 16);
  }
}

// Four int8 (one 32-bit word) -> two bf16 pairs, exactly: each byte, biased
// to unsigned, becomes the low byte of the f32 2^23 + byte, and subtracting
// 2^23 + 128 leaves q in f32 with at most 8 significant bits, so its upper
// half is q in bf16. This avoids the slow integer-to-float conversion unit.
__device__ __forceinline__ void int8x4_to_bf16x2x2(uint32_t word, uint32_t out[2]) {
  const uint32_t biased = word ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | i)) - 8388736.f;
  out[0] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  out[1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

__device__ __forceinline__ void store_a(const ATile& t, const __nv_bfloat162* scale,
                                        __nv_bfloat16* as, int tid) {
#pragma unroll
  for (int i = 0; i < kTileM / kARows; ++i) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&t.q[i]);
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t q2[2];
      int8x4_to_bf16x2x2(words[e], q2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bf16 x bf16 rounded once to bf16: the TPU kernel's x_q * scale
        const __nv_bfloat162 p =
            __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&q2[h]), scale[i]);
        v[2 * e + h] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(as + (tid / (kTileK / 16) + i * kARows) * kLd +
                                          (tid % (kTileK / 16)) * 16);
    dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
    dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ void copy_b(__nv_bfloat16* bs, const __nv_bfloat16* __restrict__ w,
                                       int n0, int k0, int N, int K, int tid) {
#pragma unroll
  for (int idx = tid; idx < kTileN * (kTileK / 8); idx += kThreads) {
    const int n = idx / (kTileK / 8), q = idx % (kTileK / 8);
    const int gn = min(n0 + n, N - 1);
    cp_async16(bs + n * kLd + q * 8, w + static_cast<size_t>(gn) * K + k0 + q * 8,
               n0 + n < N);
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const int8_t* __restrict__ xq,          // [M, K]
                      const __nv_bfloat16* __restrict__ xs,   // [M]
                      const __nv_bfloat16* __restrict__ w,    // [N, K]
                      __nv_bfloat16* __restrict__ out,        // [M, N]
                      int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stages = reinterpret_cast<Stage*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int wm = (warp / (kTileN / kWarpN)) * kWarpM;
  const int wn = (warp % (kTileN / kWarpN)) * kWarpN;
  // this thread's A rows are fixed over K, and so are their scales
  __nv_bfloat162 scale[kTileM / kARows];
#pragma unroll
  for (int i = 0; i < kTileM / kARows; ++i) {
    const int row = m0 + tid / (kTileK / 16) + i * kARows;
    scale[i] = __bfloat162bfloat162(row < M ? xs[row] : __float2bfloat16(0.f));
  }

  float acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  ATile at;
  copy_b(stages[0].b, w, n0, 0, N, K, tid);
  cp_async_commit();
  load_a(at, xq, m0, 0, M, K, tid);
  store_a(at, scale, stages[0].a, tid);
  cp_async_wait<0>();
  __syncthreads();

  const int k_tiles = K / kTileK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) {
      copy_b(stages[cur ^ 1].b, w, n0, (kt + 1) * kTileK, N, K, tid);
      cp_async_commit();
      load_a(at, xq, m0, (kt + 1) * kTileK, M, K, tid);
    }
    const Stage& s = stages[cur];
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a[kWarpM / 16][4], b[kWarpN / 16][4];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
        load_a_frag<kLd>(a[i], s.a, wm + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j)
        load_b_frag2<kLd>(b[j], s.b, wn + j * 16, kk, lane);
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j / 2] + 2 * (j % 2));
    }
    // the other stage was last read in iteration kt - 1, before its barrier
    if (more) {
      store_a(at, scale, stages[cur ^ 1].a, tid);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j) {
      const int col = n0 + wn + j * 8 + 2 * c;
      if (col >= N) continue;   // N % 8 == 0, so col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * N + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace

// out[M, N] = (x_q * scale) @ w_nk^T. Requires K % 64 == 0, N % 8 == 0 and
// 16-byte aligned, contiguous operands.
extern "C" int dequant_matmul_forward(const void* x_q, const void* scale,
                                      const void* w_nk, void* out, int M,
                                      int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  // above 48 KB of shared memory only by this opt-in (idempotent)
  cudaError_t err = cudaFuncSetAttribute(
      dequant_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  dequant_matmul_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_q), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(w_nk), static_cast<__nv_bfloat16*>(out),
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}
