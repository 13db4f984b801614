// Last hidden state of a 1-layer GRU from precomputed input gates.
//
// Replaces: vqa_tpu/ops/pallas/gru_v2.py gru_last_state_v2 (the question
// GRU of the Up-Down encoder, vqa_tpu/ops/rnn.py).
//
// What bounds it on an H100: each step is a [B, H] x [H, 3H] bf16 product
// (6.4 GFLOP at B=1024, 103 GFLOP at B=16384, H=1024) plus a read of the
// step's xi slice [B, 3H] bf16 and of h. Every block re-reads the 6 MB
// recurrent weight tile it needs and the h rows of its batch tile, so the
// traffic that bounds a step is L2's (W once per batch tile, h once per
// hidden tile); the steps are serial, so at small B the card is mostly
// launch- and latency-bound.
//
// Design: one launch per time step. The state h ping-pongs through device
// memory twice: in f32 (the state the TPU kernel carries, read for z * h)
// and as its bf16 rounding (the matmul operand, written by the previous
// step's epilogue), so operand tiles are plain 16-byte copies (cp.async,
// two stages). A block owns 128 batch rows x 32 hidden units j and
// computes the three gate columns j, H+j and 2H+j of h @ Wh with mma.sync
// bf16 (f32 accumulation); each thread then holds r, z and n of the same
// (row, j) in registers, so the gate math runs in the product's epilogue and
// hi never reaches device memory. The weight is read gate-major ([3H, H],
// torch's weight_hh layout) so both operands are k-contiguous. Rounding
// points are the TPU kernel's: h is rounded to bf16 only as the operand, xi
// and bh are upcast to f32, the state stays f32. A grid-synchronised
// persistent kernel that keeps Wh in shared memory across steps is later
// work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kTileJ = 32;              // hidden units per block
constexpr int kTileN = 3 * kTileJ;      // gate columns per block (r, z, n)
constexpr int kWarps = 8;
constexpr int kTileB = 16 * kWarps;     // batch rows per block
constexpr int kTileK = 32;
constexpr int kLd = kTileK + 8;         // padded row: conflict-free ldmatrix
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

struct Stage {
  __nv_bfloat16 h[kTileB * kLd];
  __nv_bfloat16 w[kTileN * kLd];
};

__device__ __forceinline__ void load_stage(Stage& s, const __nv_bfloat16* __restrict__ h16,
                                           const __nv_bfloat16* __restrict__ w, int b0,
                                           int j0, int k0, int B, int H, int tid) {
  // h tile: 128 rows x 32 k = 512 16-byte chunks; rows past B zero-fill
  for (int idx = tid; idx < kTileB * (kTileK / 8); idx += kThreads) {
    const int row = idx / (kTileK / 8), q = idx % (kTileK / 8);
    const int gb = min(b0 + row, B - 1);
    cp_async16(s.h + row * kLd + q * 8,
               h16 + static_cast<size_t>(gb) * H + k0 + q * 8, b0 + row < B);
  }
  // weight tile: 96 gate rows (j of gates r, z, n) x 32 k
  for (int idx = tid; idx < kTileN * (kTileK / 8); idx += kThreads) {
    const int n = idx / (kTileK / 8), q = idx % (kTileK / 8);
    const int grow = (n / kTileJ) * H + j0 + (n % kTileJ);
    cp_async16(s.w + n * kLd + q * 8, w + static_cast<size_t>(grow) * H + k0 + q * 8,
               true);
  }
}

// One time step: h_next = GRU(xi[:, t], h_prev). At t == 0 the state is
// zero, so the product is skipped and h_prev is not read.
__global__ void __launch_bounds__(kThreads)
gru_v2_step(const __nv_bfloat16* __restrict__ xi,     // [B, T, 3H]
            const __nv_bfloat16* __restrict__ w,      // [3H, H]
            const __nv_bfloat16* __restrict__ bh,     // [3H]
            const float* __restrict__ h32_prev,       // [B, H]
            const __nv_bfloat16* __restrict__ h16_prev,
            float* __restrict__ h32_next,
            __nv_bfloat16* __restrict__ h16_next,
            int B, int T, int H, int t) {
  __shared__ __align__(16) Stage stages[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kTileJ;
  const int b0 = blockIdx.y * kTileB;

  float acc[kTileN / 8][4];
#pragma unroll
  for (int i = 0; i < kTileN / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (t > 0) {
    const int k_tiles = H / kTileK;
    load_stage(stages[0], h16_prev, w, b0, j0, 0, B, H, tid);
    cp_async_commit();
    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles) {
        load_stage(stages[(kt + 1) & 1], h16_prev, w, b0, j0, (kt + 1) * kTileK, B, H, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const Stage& s = stages[kt & 1];
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 16) {
        uint32_t a[4];
        load_a_frag<kLd>(a, s.h, warp * 16, kk, lane);
#pragma unroll
        for (int nt = 0; nt < kTileN / 8; nt += 2) {
          uint32_t b[4];
          load_b_frag2<kLd>(b, s.w, nt * 8, kk, lane);
          mma_bf16_16816(acc[nt], a, b);
          mma_bf16_16816(acc[nt + 1], a, b + 2);
        }
      }
      __syncthreads();   // the stage is refilled in the next iteration
    }
  }

  // epilogue: n-tiles [0, 4) are gate r, [4, 8) gate z, [8, 12) gate n,
  // so acc[nt], acc[nt + 4] and acc[nt + 8] hold r, z, n of one (row, j);
  // each thread holds the pair of columns j, j + 1
  const int g = lane >> 2, c = lane & 3;
  const size_t G = 3 * static_cast<size_t>(H);
#pragma unroll
  for (int nt = 0; nt < kTileJ / 8; ++nt) {
    const int j = j0 + nt * 8 + 2 * c;
    const float2 br = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bh + j));
    const float2 bz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bh + H + j));
    const float2 bn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bh + 2 * H + j));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = b0 + warp * 16 + g + half * 8;
      if (row >= B) continue;
      const __nv_bfloat16* x = xi + (static_cast<size_t>(row) * T + t) * G;
      const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + j));
      const float2 xz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + H + j));
      const float2 xn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + 2 * H + j));
      const size_t at = static_cast<size_t>(row) * H + j;
      const float2 hp = t > 0 ? *reinterpret_cast<const float2*>(h32_prev + at)
                              : make_float2(0.f, 0.f);
      const float* ar = acc[nt] + 2 * half;
      const float* az = acc[nt + 4] + 2 * half;
      const float* an = acc[nt + 8] + 2 * half;
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float r = sigmoidf((e ? xr.y : xr.x) + ar[e] + (e ? br.y : br.x));
        const float z = sigmoidf((e ? xz.y : xz.x) + az[e] + (e ? bz.y : bz.x));
        const float n = tanhf((e ? xn.y : xn.x) + r * (an[e] + (e ? bn.y : bn.x)));
        h[e] = (1.f - z) * n + z * (e ? hp.y : hp.x);
      }
      *reinterpret_cast<float2*>(h32_next + at) = make_float2(h[0], h[1]);
      *reinterpret_cast<__nv_bfloat162*>(h16_next + at) = __floats2bfloat162_rn(h[0], h[1]);
    }
  }
}

}  // namespace

// Runs all T steps on `stream`. Step t reads the state in buffers t % 2 of
// h32 (f32) and h16 (its bf16 rounding), nothing at t = 0, and writes
// buffers (t + 1) % 2, so the result is in h32 buffer T % 2. Each buffer
// pair is two [B, H] halves, contiguous. Requires H % 32 == 0 and 16-byte
// aligned, contiguous operands.
extern "C" int gru_v2_forward(const void* xi, const void* w, const void* bh,
                              void* h32, void* h16, int B, int T, int H,
                              void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  float* s32[2] = {static_cast<float*>(h32),
                   static_cast<float*>(h32) + static_cast<size_t>(B) * H};
  __nv_bfloat16* s16[2] = {static_cast<__nv_bfloat16*>(h16),
                           static_cast<__nv_bfloat16*>(h16) + static_cast<size_t>(B) * H};
  const dim3 grid(H / kTileJ, (B + kTileB - 1) / kTileB);
  for (int t = 0; t < T; ++t) {
    gru_v2_step<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(xi),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bh), s32[t % 2], s16[t % 2],
        s32[(t + 1) % 2], s16[(t + 1) % 2], B, T, H, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
