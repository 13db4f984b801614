// Top-down MultiplyAttention and the attention-weighted pooling in one pass:
//   vp     = relu(v @ Wv + bv)                 [B, N, H]
//   qp     = relu(q @ Wq + bq)                 [B, H]
//   logits = (vp * qp[:, None]) @ wl + bl      [B, N]
//   att    = softmax_N(logits)
//   pooled = sum_n att[:, n] * v[:, n]         [B, Dv]
//
// Replaces: vqa_tpu/ops/pallas/fused_attention.py
// fused_multiply_attention_pool (a library kernel: no model path of the JAX
// package calls it).
//
// What bounds it on an H100: the v-projection. At B=16384, N=36, Dv=2048,
// H=1024 it is 2 * 589,824 * 2048 * 1024 = 2.47 TFLOP, 2.5 ms at the bf16
// tensor-core peak, against 2.4 GB of bf16 v (0.72 ms at 3.35 TB/s): it is
// compute-bound. Unfused, the [B, N, H] activations (1.2 GB in bf16) go to
// device memory and back, twice.
//
// Design: a block owns a tile of whole images (144 rows at N=36: 4 images)
// and loops over H in 128-column chunks, so the H reduction of the logits
// stays in the block and needs no atomics. For each chunk the block first
// computes that chunk of qp for its images ([16 x Hq] x [Hq x 128], the
// images padded to one 16-row tile), then the [144 x Dv] x [Dv x 128]
// product, both on mma.sync m16n8k16 bf16 with f32 accumulation, the
// operand tiles (64 deep in K) streamed through a 2-stage cp.async ring that
// runs on across the chunks, two blocks an SM. The epilogue of each chunk adds bv, applies the ReLU,
// multiplies by the chunk's qp and by wl and reduces over the chunk's
// columns into per-row partial logits in shared memory (one slot per warp
// column, so the sum order is fixed). After the last chunk: the softmax over
// each image's rows (one warp per image), att written, then pooled from a
// second read of the block's v rows, which L2 mostly still holds. The
// [rows, H] activations never leave registers. The block re-reads its v rows
// once per chunk (8 times at H=1024); wgmma with TMA and a larger reuse of
// v are later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps: 2 along rows x 4 along H
constexpr int kMaxRows = 144;            // rows of one block: 9 m-tiles
constexpr int kWarpMT = 5;               // m-tiles of one warp row (5 + 4)
constexpr int kTileH = 128;              // H columns of one chunk
constexpr int kWarpH = 32;               // H columns of one warp (4 n-tiles)
constexpr int kTileK = 64;
constexpr int kLd = kTileK + 8;          // padded row: conflict-free ldmatrix
constexpr int kStages = 2;               // and two blocks an SM
constexpr int kMaxImages = 16;           // the qp tile: one 16-row m-tile

struct Stage {
  __nv_bfloat16 a[kMaxRows * kLd];
  __nv_bfloat16 b[kTileH * kLd];
};
struct Smem {
  Stage stages[kStages];
  float qp[kMaxImages * kTileH];         // this chunk's qp of the block's images
  float part[kTileH / kWarpH][kMaxRows]; // partial logits by warp column
  float att[kMaxRows];
};

// one of the small f32-or-bf16 vectors bv, bq, wl, bl, upcast to f32
__device__ __forceinline__ float vec_at(const void* p, int i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// A tile: `rows_load` rows x kTileK of a row-major [*, K] operand from row
// `a` (rows at or past `rows_valid`, and k past K, zero-filled); B tile:
// kTileH rows h0.. of a [H, K] operand (rows past H zero-filled).
__device__ __forceinline__ void load_stage(Stage& s, const __nv_bfloat16* __restrict__ a,
                                           int rows_load, int rows_valid,
                                           const __nv_bfloat16* __restrict__ b, int h0, int H,
                                           int k0, int K, int tid) {
  constexpr int kChunks = kTileK / 8;
  for (int idx = tid; idx < rows_load * kChunks; idx += kThreads) {
    const int row = idx / kChunks, k = k0 + (idx % kChunks) * 8;
    const bool ok = row < rows_valid && k < K;
    cp_async16(s.a + row * kLd + (idx % kChunks) * 8,
               ok ? a + static_cast<size_t>(row) * K + k : a, ok);
  }
  for (int idx = tid; idx < kTileH * kChunks; idx += kThreads) {
    const int n = idx / kChunks, k = k0 + (idx % kChunks) * 8;
    const bool ok = h0 + n < H && k < K;
    cp_async16(s.b + n * kLd + (idx % kChunks) * 8,
               ok ? b + static_cast<size_t>(h0 + n) * K + k : b, ok);
  }
}

// two blocks an SM: 16 warps hide the ring's latency behind each other
__global__ void __launch_bounds__(kThreads, 2)
fused_attention_kernel(const __nv_bfloat16* __restrict__ v,    // [B, N, Dv]
                       const __nv_bfloat16* __restrict__ q,    // [B, Hq]
                       const __nv_bfloat16* __restrict__ wv,   // [H, Dv]
                       const __nv_bfloat16* __restrict__ wq,   // [H, Hq]
                       const void* bv, const void* bq, const void* wl, const void* bl,
                       float* __restrict__ pooled,             // [B, Dv]
                       float* __restrict__ att,                // [B, N]
                       int B, int N, int Dv, int H, int Hq, int images, int vec_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const bool bv16 = vec_bf16 & 1, bq16 = vec_bf16 & 2, wl16 = vec_bf16 & 4, bl16 = vec_bf16 & 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_h = warp & 3;
  const int g = lane >> 2, c = lane & 3;
  const int img0 = blockIdx.x * images;
  const int n_img = min(images, B - img0);       // images of this block
  const int rows = n_img * N;                     // valid rows
  const int m_tiles = (images * N + 15) / 16;     // row tiles of a full block
  const size_t row0 = static_cast<size_t>(img0) * N;
  const __nv_bfloat16* vb = v + row0 * Dv;
  const __nv_bfloat16* qb = q + static_cast<size_t>(img0) * Hq;

  for (int i = tid; i < (kTileH / kWarpH) * kMaxRows; i += kThreads)
    (&sm.part[0][0])[i] = 0.f;

  // the stream of operand tiles: per chunk, kq tiles of the qp product,
  // then kv tiles of the v product
  const int kq = (Hq + kTileK - 1) / kTileK, kv = (Dv + kTileK - 1) / kTileK;
  const int per_chunk = kq + kv;
  const int chunks = (H + kTileH - 1) / kTileH;
  const int total = chunks * per_chunk;
  auto issue = [&](int it) {
    if (it < total) {
      const int h0 = (it / per_chunk) * kTileH, i = it % per_chunk;
      Stage& s = sm.stages[it % kStages];
      if (i < kq)
        load_stage(s, qb, 16, n_img, wq, h0, H, i * kTileK, Hq, tid);
      else
        load_stage(s, vb, m_tiles * 16, rows, wv, h0, H, (i - kq) * kTileK, Dv, tid);
    }
    cp_async_commit();   // an empty group past the end keeps the count uniform
  };

  // acc[0] holds the qp product first (warp row 0), then m-tile 0's share
  // of the v product: each chunk's qp epilogue zeroes it again
  float acc[kWarpMT][kWarpH / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpMT; ++i)
#pragma unroll
    for (int j = 0; j < kWarpH / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // tile `it` has landed; tile it - 1 is consumed
    issue(it + kStages - 1);
    const Stage& s = sm.stages[it % kStages];
    const int i = it % per_chunk;
    const int h0 = (it / per_chunk) * kTileH;
    if (i < kq) {
      if (warp_m == 0) {
#pragma unroll
        for (int kk = 0; kk < kTileK; kk += 16) {
          uint32_t a[4], b0[4], b1[4];
          load_a_frag<kLd>(a, s.a, 0, kk, lane);
          load_b_frag2<kLd>(b0, s.b, warp_h * kWarpH, kk, lane);
          load_b_frag2<kLd>(b1, s.b, warp_h * kWarpH + 16, kk, lane);
          mma_bf16_16816(acc[0][0], a, b0);
          mma_bf16_16816(acc[0][1], a, b0 + 2);
          mma_bf16_16816(acc[0][2], a, b1);
          mma_bf16_16816(acc[0][3], a, b1 + 2);
        }
      }
      if (i == kq - 1) {
        // qp of this chunk: relu(q @ Wq + bq), rows g and g + 8 are images
        if (warp_m == 0) {
#pragma unroll
          for (int j = 0; j < kWarpH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int img = g + (e >> 1) * 8;
              const int col = warp_h * kWarpH + j * 8 + 2 * c + (e & 1);
              const int h = h0 + col;
              float x = 0.f;
              if (h < H) x = fmaxf(acc[0][j][e] + vec_at(bq, h, bq16), 0.f);
              sm.qp[img * kTileH + col] = x;
              acc[0][j][e] = 0.f;
            }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 16) {
        uint32_t b0[4], b1[4];
        load_b_frag2<kLd>(b0, s.b, warp_h * kWarpH, kk, lane);
        load_b_frag2<kLd>(b1, s.b, warp_h * kWarpH + 16, kk, lane);
#pragma unroll
        for (int mi = 0; mi < kWarpMT; ++mi) {
          const int mt = warp_m * kWarpMT + mi;
          if (mt < m_tiles) {
            uint32_t a[4];
            load_a_frag<kLd>(a, s.a, mt * 16, kk, lane);
            mma_bf16_16816(acc[mi][0], a, b0);
            mma_bf16_16816(acc[mi][1], a, b0 + 2);
            mma_bf16_16816(acc[mi][2], a, b1);
            mma_bf16_16816(acc[mi][3], a, b1 + 2);
          }
        }
      }
      if (i == per_chunk - 1) {
        // epilogue of the chunk: sum_h relu(vp + bv) * qp * wl per row; the
        // qp tile was written at least one barrier ago
#pragma unroll
        for (int mi = 0; mi < kWarpMT; ++mi) {
          const int mt = warp_m * kWarpMT + mi;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 16 + g + half * 8;
            const int img = min(row / N, kMaxImages - 1);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kWarpH / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = warp_h * kWarpH + j * 8 + 2 * c + e;
                if (h0 + col < H) {
                  const float x = fmaxf(acc[mi][j][2 * half + e] + vec_at(bv, h0 + col, bv16), 0.f);
                  sum += x * sm.qp[img * kTileH + col] * vec_at(wl, h0 + col, wl16);
                }
              }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (c == 0 && mt < m_tiles && row < rows) sm.part[warp_h][row] += sum;
          }
#pragma unroll
          for (int j = 0; j < kWarpH / 8; ++j)
            acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // softmax over each image's N rows: one warp per image, two rows a lane
  const float blv = vec_at(bl, 0, bl16);
  for (int img = warp; img < n_img; img += kThreads / 32) {
    float l[2];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = lane + 32 * r;
      l[r] = -INFINITY;
      if (n < N) {
        const int row = img * N + n;
        l[r] = sm.part[0][row] + sm.part[1][row] + sm.part[2][row] + sm.part[3][row] + blv;
        mx = fmaxf(mx, l[r]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float e[2], sum = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      e[r] = lane + 32 * r < N ? expf(l[r] - mx) : 0.f;
      sum += e[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = lane + 32 * r;
      if (n < N) {
        const float a = e[r] / sum;
        sm.att[img * N + n] = a;
        att[(row0 + img * N) + n] = a;
      }
    }
  }
  __syncthreads();

  // pooled[b, d] = sum_n att[b, n] * v[b, n, d]: a thread owns 8 d of one
  // image, 16-byte loads, neighbouring threads on neighbouring d
  const int d8 = Dv / 8;
  for (int task = tid; task < n_img * d8; task += kThreads) {
    const int img = task / d8, d = (task % d8) * 8;
    float sum[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = 0.f;
    const __nv_bfloat16* src = vb + static_cast<size_t>(img) * N * Dv + d;
    for (int n = 0; n < N; ++n) {
      const float a = sm.att[img * N + n];
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(n) * Dv);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(p[k]);
        sum[2 * k] += a * f.x;
        sum[2 * k + 1] += a * f.y;
      }
    }
    float4* dst = reinterpret_cast<float4*>(pooled + static_cast<size_t>(img0 + img) * Dv + d);
    dst[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
    dst[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
  }
}

}  // namespace

// pooled [B, Dv] and att [B, N] (f32) of v [B, N, Dv], q [B, Hq] and the
// weight-normed weights, with wv and wq given transposed ([H, Dv], [H, Hq],
// bf16) and the vectors bv [H], bq [H], wl [H], bl [1] each f32 or bf16
// (bits 0-3 of vec_bf16 set for bf16). Requires 1 <= N <= 64; Dv, H and Hq
// multiples of 8; 16-byte aligned, contiguous operands.
extern "C" int fused_attention_forward(const void* v, const void* q, const void* wv_t,
                                       const void* wq_t, const void* bv, const void* bq,
                                       const void* wl, const void* bl, void* pooled,
                                       void* att, int B, int N, int Dv, int H, int Hq,
                                       int vec_bf16, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (N < 1 || N > 64) return static_cast<int>(cudaErrorInvalidValue);
  // whole images to a block: as many as fill 144 rows, at most 16 (the qp tile)
  const int images = max(1, min(kMaxImages, kMaxRows / N));
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + images - 1) / images);
  fused_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(wv_t), static_cast<const __nv_bfloat16*>(wq_t),
      bv, bq, wl, bl, static_cast<float*>(pooled), static_cast<float*>(att), B, N, Dv, H,
      Hq, images, vec_bf16);
  return static_cast<int>(cudaGetLastError());
}
