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
// 1.2 GB of bf16 output (0.55 ms at 3.35 TB/s). It is bound by operations,
// so the tensor cores must be fed without pause: at the peak a block needs
// 86 GB/s of operand tiles from L2, and what it gets is its bytes in
// flight (the ring, at most 4 stages of 48 KB in shared memory) over the L2
// latency under load; that, not the tensor cores, bounds this design
// (about 39% of the peak at the path's shapes, PERF.md). Without the
// epilogue in the kernel, the [M, N] int32 sums and their f32 scaling would
// each make a round trip through device memory.
//
// Design (hopper.cuh's primitives): a persistent grid of one block an SM
// walks 128 x 256 output tiles, N fastest within a 128-row band of x_q, so
// that the blocks working at one time share their x_q bands and the weight
// in L2. A block is three warpgroups. The producer (one thread of the last)
// keeps TMA loads of 128-byte K stages (A 128 x 128, B 256 x 128 bytes, both
// K-major in the 128-byte swizzle) in flight through a 4-stage mbarrier
// ring that runs on across tiles; the two consumer warpgroups each own 64
// rows of the tile and issue wgmma m64n256k32 s8.s8.s32 on the stage (4 a
// stage), and hand the stage back to the producer as soon as those retire,
// so that three stages stay in flight while the other warpgroup's wgmma
// keeps the tensor cores busy. While the consumers run a tile's epilogue
// from their registers, the producer already loads the next tile's first
// stages. setmaxnreg moves registers from the producer to
// the consumers (128 s32 sums each). TMA zero-fills rows past M or N and K
// past the end, so any M and N and K a multiple of 32 (16-byte rows for
// TMA) are taken; stores past M or N are masked. The epilogue keeps the
// plain version's order with round-to-nearest intrinsics, so that no
// multiply-add is contracted: the int32 sum to f32, times the f32 product
// of the two scales, one cast to the output type, the bias added in f32 and
// rounded to the output type (PyTorch's order for a bf16 add), then max(0).
// wgmma's s32 sums are exact, so the kernel equals the plain version bit for
// bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTileM = 128;              // two consumer warpgroups of 64 rows
constexpr int kTileN = 256;              // one wgmma m64n256 a warpgroup
constexpr int kTileK = 128;              // bytes of K a stage: one swizzled row
constexpr int kStages = 4;
constexpr int kThreads = 384;            // 2 consumer warpgroups + the producer's
constexpr int kABytes = kTileM * kTileK;
constexpr int kBBytes = kTileN * kTileK;
constexpr int kStageBytes = kABytes + kBBytes;
// the ring (1024-byte aligned for the swizzle), then the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;

__device__ __forceinline__ float load_scale(const void* xs, int row, int xs_bf16) {
  return xs_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(xs)[row])
                 : static_cast<const float*>(xs)[row];
}

__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap xq_map,   // [M, K] int8
                   const __grid_constant__ CUtensorMap w_map,    // [N, K] int8
                   const void* __restrict__ xs,                  // [M] f32 or bf16
                   const float* __restrict__ ws,                 // [N]
                   const void* __restrict__ bias,                // [N] out type, or null
                   void* __restrict__ out,                       // [M, N] f32 or bf16
                   int M, int K, int N, int xs_bf16, int out_bf16, int relu) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int tiles = (M + kTileM - 1) / kTileM * n_tiles;
  const int k_tiles = (K + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2);     // one arrival from each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<40>();
    if (tid == 256) {
      tma_prefetch_map(&xq_map);
      tma_prefetch_map(&w_map);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kTileM, n0 = tile % n_tiles * kTileN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          unsigned char* st = ring + s * kStageBytes;
          tma_load_2d(st, &xq_map, &full[s], kt * kTileK, m0);
          tma_load_2d(st + kABytes, &w_map, &full[s], kt * kTileK, n0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile ----
    setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int g = lane >> 2, c = lane & 3;
    int acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kTileM, n0 = tile % n_tiles * kTileN;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const unsigned char* st = ring + s * kStageBytes;
        const uint64_t da = sw128_desc(st + wg * 64 * kTileK);
        const uint64_t db = sw128_desc(st + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 32; ++kk)
          // +2 in the descriptor's 16-byte units = 32 bytes further along K
          wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        wgmma_commit();
        // hand the stage back as soon as its group retires: the producer
        // then keeps kStages - 1 stages in flight, and the other warpgroup's
        // wgmma fills the tensor cores meanwhile
        wgmma_wait<0>();
        if ((tid & 127) == 0) mbar_arrive(&empty[s]);
      }
      fence_operands(acc);

      // epilogue: rows m0 + 64 wg + 16 warp + g (+8), columns n0 + 8j + 2c (+1)
      float x[2];
      int rows[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h] = m0 + wg * 64 + warp * 16 + g + h * 8;
        x[h] = rows[h] < M ? load_scale(xs, rows[h], xs_bf16) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * c;
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
        for (int h = 0; h < 2; ++h) {
          if (rows[h] >= M) continue;
          float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), __fmul_rn(x[h], w0));
          float y1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), __fmul_rn(x[h], w1));
          const size_t at = static_cast<size_t>(rows[h]) * N + col;
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
  CUtensorMap xq_map, w_map;
  const uint64_t xq_dims[2] = {uint64_t(K), uint64_t(M)}, w_dims[2] = {uint64_t(K), uint64_t(N)};
  const uint64_t strides[1] = {uint64_t(K)};
  const uint32_t xq_box[2] = {kTileK, kTileM}, w_box[2] = {kTileK, kTileN};
  cudaError_t err = make_tensor_map(&xq_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x_q, xq_dims,
                                    strides, xq_box);
  if (err == cudaSuccess)
    err = make_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w_nk, w_dims, strides, w_box);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  // persistent: one block an SM, at most one a tile
  const long long tiles =
      static_cast<long long>((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  int8_matmul_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      xq_map, w_map, x_scale, static_cast<const float*>(w_scale), bias, out, M, K, N, xs_bf16,
      out_bf16, relu);
  return static_cast<int>(cudaGetLastError());
}
