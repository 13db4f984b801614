// Int8-feed dequant fused into a bf16 tensor-core GEMM.
//
// Replaces: vqa_tpu/ops/pallas/feed_gemm.py dequant_matmul, the attention
// v-projection (x_q * scale) @ W_v of the int8 feature feed.
//
// What bounds it on an H100: at B=16384 the product is M = 589,824 rows
// (B x 36 boxes), K = 2048, N = 1024: 2.47 TFLOP, 2.50 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 1.2 GB of int8 activations and 1.2 GB of
// bf16 output (0.72 ms at 3.35 TB/s). It is bound by operations, so the
// tensor cores must be fed without pause. Without this kernel, eager
// PyTorch writes the dequantized [M, K] bf16 activation (2.4 GB) and reads
// it back as the GEMM operand.
//
// Design (hopper.cuh's primitives; of the two ways to feed wgmma an int8
// operand, a transform stage in shared memory, not A from registers): a
// persistent grid of one block an SM walks 128 x 256 output tiles, N
// fastest within a 128-row band of x_q, so that the blocks working at one
// time share their x_q bands and the 4 MB weight in L2. A block is three
// warpgroups and its shared memory a 4-stage mbarrier ring of 64-deep K
// stages that runs on across tiles. One thread of the third warpgroup (the
// producer) loads each stage's int8 A [128 x 64] (8 KB, unswizzled) and
// bf16 B [256 x 64] (w read [N, K], K-major, 32 KB, 128-byte swizzle) by
// TMA. The two consumer warpgroups each own 64 rows of the tile. Each
// turns its rows of a stage into bf16 A (8 KB of the stage's 16 KB) in the
// 128-byte swizzle that wgmma's descriptor reads: each value exactly to
// bf16 by integer and f32-add tricks (the conversion unit's low rate would
// rival the tensor cores: each value is converted once per 256-column
// tile, 4 times at N = 1024), times its row's scale with one bf16 rounding
// (the TPU kernel's rounding point: the bf16 product x_q * scale), then
// fence.proxy.async and a barrier of the warpgroup. It issues wgmma
// m64n256k16 bf16 -> f32 on the stage (4 a stage, both operands from
// shared memory), dequantizes the next stage while they run, and hands the
// stage back as soon as they retire; the other warpgroup's wgmma keep the
// tensor cores busy meanwhile. (A converter warpgroup beside the
// producer has only 96 threads to spare and puts each stage's conversion
// on the consumers' path; it measured slower.) A thread's rows, and so
// their scales, are fixed over a tile's K: it loads them once a tile.
// While the consumers store a tile's output, the producer already loads
// the next tile's stages. setmaxnreg moves registers from the producer's
// warpgroup to the consumers (128 f32 sums each). TMA zero-fills rows past
// M or N and K past the end of the last stage, so any M, N a multiple of 8
// and K a multiple of 16 (16-byte rows for TMA) are taken; stores past M
// or N are masked, and rows past M take a zero scale.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTileM = 128;              // two consumer warpgroups of 64 rows
constexpr int kTileN = 256;              // one wgmma m64n256 a warpgroup
constexpr int kTileK = 64;               // K of a stage: one swizzled bf16 row
constexpr int kStages = 4;
constexpr int kThreads = 384;            // 2 consumer warpgroups + the producer's
// 16-byte int8 chunks of a stage's A each consumer thread dequantizes: a
// warpgroup's 64 rows of 64 bytes over its 128 threads
constexpr int kConvChunks = 64 * kTileK / 16 / 128;
constexpr int kBBytes = kTileN * kTileK * 2;     // bf16 w, swizzled
constexpr int kAfBytes = kTileM * kTileK * 2;    // dequantized bf16 A, swizzled
constexpr int kA8Bytes = kTileM * kTileK;        // int8 A as TMA writes it
constexpr int kStageBytes = kBBytes + kAfBytes + kA8Bytes;
// the ring (1024-byte aligned for the swizzle), then the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kSmem <= 232448, "the ring fits the card's 227 KB a block");

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

// 8 int8 -> 8 bf16 times the row's scale, rounded once: a 16-byte chunk of
// the converted row
__device__ __forceinline__ uint4 dequant8(uint32_t w0, uint32_t w1, __nv_bfloat162 scale) {
  uint32_t q[4], v[4];
  int8x4_to_bf16x2x2(w0, q);
  int8x4_to_bf16x2x2(w1, q + 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // bf16 x bf16 rounded once to bf16: the TPU kernel's x_q * scale
    const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&q[e]), scale);
    v[e] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
dequant_matmul_kernel(const __grid_constant__ CUtensorMap xq_map,   // [M, K] int8
                      const __grid_constant__ CUtensorMap w_map,    // [N, K] bf16
                      const __nv_bfloat16* __restrict__ xs,         // [M]
                      __nv_bfloat16* __restrict__ out,              // [M, N]
                      int M, int K, int N) {
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
    setmaxnreg_dec<40>();
    if (tid == 256) {
      // ---- producer: one thread keeps the ring full ----
      tma_prefetch_map(&xq_map);
      tma_prefetch_map(&w_map);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kTileM, n0 = tile % n_tiles * kTileN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kBBytes + kA8Bytes);
          unsigned char* st = ring + s * kStageBytes;
          tma_load_2d(st, &w_map, &full[s], kt * kTileK, n0);
          tma_load_2d(st + kBBytes + kAfBytes, &xq_map, &full[s], kt * kTileK, m0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile ----
    setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int g = lane >> 2, c = lane & 3;
    const int ct = tid & 127;
    float acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kTileM, n0 = tile % n_tiles * kTileN;
      // The warpgroup dequantizes its own 64 rows of each stage: chunk
      // ct + 128 i (of 16 int8) is row 64 wg + (ct + 128 i) / 4, K bytes
      // [16 (ct % 4), +16), and becomes bf16 chunks 2 (ct % 4) and
      // 2 (ct % 4) + 1 of the row, whose places the swizzle XORs with
      // row % 8. Those rows, and so their scales, are fixed over the
      // tile's K: one load each a tile.
      const int q = ct & 3;
      __nv_bfloat162 scale[kConvChunks];
#pragma unroll
      for (int i = 0; i < kConvChunks; ++i) {
        const int row = m0 + wg * 64 + (ct + i * 128) / 4;
        scale[i] = __bfloat162bfloat162(row < M ? xs[row] : __float2bfloat16(0.f));
      }
      // ring position `pos` into this warpgroup's bf16 A of its slot,
      // visible to the warpgroup's wgmma when this returns
      auto dequant_stage = [&](int pos) {
        const int s = pos % kStages;
        mbar_wait(&full[s], (pos / kStages) & 1);
        unsigned char* st = ring + s * kStageBytes;
        const unsigned char* a8 = st + kBBytes + kAfBytes + wg * 64 * kTileK;
        unsigned char* af = st + kBBytes + wg * 64 * 128;
#pragma unroll
        for (int i = 0; i < kConvChunks; ++i) {
          const int r = (ct + i * 128) >> 2;
          const uint4 raw = *reinterpret_cast<const uint4*>(a8 + r * kTileK + q * 16);
          unsigned char* dst = af + r * 128;
          *reinterpret_cast<uint4*>(dst + (((2 * q) ^ (r & 7)) << 4)) =
              dequant8(raw.x, raw.y, scale[i]);
          *reinterpret_cast<uint4*>(dst + (((2 * q + 1) ^ (r & 7)) << 4)) =
              dequant8(raw.z, raw.w, scale[i]);
        }
        // every thread's writes before the warpgroup's wgmma read them
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      };
      dequant_stage(it);
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        const unsigned char* st = ring + s * kStageBytes;
        const uint64_t da = sw128_desc(st + kBBytes + wg * 64 * 128);
        const uint64_t db = sw128_desc(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
          // +2 in the descriptor's 16-byte units = 16 bf16 further along K
          wgmma_m64n256k16_bf16(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        wgmma_commit();
        // the next stage's dequantization runs while these products do
        if (kt + 1 < k_tiles) dequant_stage(it + 1);
        // hand the stage back as soon as its group retires: the producer
        // then keeps kStages - 1 stages in flight, and the other
        // warpgroup's wgmma fill the tensor cores meanwhile
        wgmma_wait<0>();
        if (ct == 0) mbar_arrive(&empty[s]);
      }
      fence_operands(acc);

      // epilogue: rows m0 + 64 wg + 16 warp + g (+8), columns n0 + 8j + 2c (+1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * 64 + warp * 16 + g + h * 8;
        if (row >= M) continue;
        __nv_bfloat16* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          const int col = n0 + j * 8 + 2 * c;
          if (col < N)   // N % 8 == 0, so col + 1 < N too
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace

// out[M, N] = (x_q * scale) @ w_nk^T. Requires K % 16 == 0, N % 8 == 0 and
// 16-byte aligned, contiguous operands.
extern "C" int dequant_matmul_forward(const void* x_q, const void* scale,
                                      const void* w_nk, void* out, int M,
                                      int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  CUtensorMap xq_map, w_map;
  const uint64_t xq_dims[2] = {uint64_t(K), uint64_t(M)}, w_dims[2] = {uint64_t(K), uint64_t(N)};
  const uint64_t xq_strides[1] = {uint64_t(K)}, w_strides[1] = {uint64_t(K) * 2};
  const uint32_t xq_box[2] = {kTileK, kTileM}, w_box[2] = {kTileK, kTileN};
  cudaError_t err = make_tensor_map(&xq_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x_q, xq_dims,
                                    xq_strides, xq_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = make_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_nk, w_dims, w_strides,
                          w_box);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dequant_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  // persistent: one block an SM, at most one a tile
  const long long tiles =
      static_cast<long long>((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  dequant_matmul_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      xq_map, w_map, static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
