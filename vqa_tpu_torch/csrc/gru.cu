// Last hidden state of a 1-layer GRU, the whole sequence in one launch.
//
// Replaces: vqa_tpu/ops/pallas/gru.py gru_last_state (v1: the input gates
// xi [B, T, 3H] precomputed) and vqa_tpu/ops/pallas/gru_v3.py
// gru_last_state_v3 (v3: xi = emb_t @ Wi + bi computed in the kernel from
// the embeddings [B, T, E]); both are library kernels, which no model path
// of the JAX package calls.
//
// What bounds it on an H100: the recurrent product, [B, H] x [H, 3H] a step
// after the first, whose state is zero (0.93 TFLOP over the 9 other steps
// of T=10 at B=16384, H=1024: 0.94 ms at the bf16 tensor-core peak; v3 adds
// the [B, E] x [E, 3H] input product of every step, 0.30 TFLOP).
// Steps are serial, and every block reads the whole 6 MB recurrent weight
// from L2 once a step: 15.7 GB of L2 reads at B=16384 with 64-row tiles,
// which with one block of 8 warps an SM bounds this first design.
//
// Design: rows of the batch are independent, so a block owns a 64-row batch
// tile across all 3H gate columns and all T steps, and needs no grid-wide
// synchronisation. The tile's state lives twice: its bf16 rounding (the
// product's operand, the TPU kernel's rounding point) resident in shared
// memory, and the f32 state in the output buffer, which only this block
// touches. A step runs H / 64 chunks of 64 hidden units j; a chunk's 192
// gate columns (j of r, z and n) are the product of the resident state with
// the gate-major weight rows ([3H, H], torch's weight_hh layout), streamed
// from L2 in 64-deep K tiles through a cp.async ring (3 stages, 2 for v3)
// that runs on across chunks, on mma.sync m16n8k16 bf16 with f32
// accumulation. Each thread then holds r, z and n of the same (row, j), so
// the gate math runs in the epilogue, which updates the f32 state in place.
// After the last chunk the new state is rounded into shared memory for the
// next step. v3 keeps the step's embedding tile in shared memory too,
// zero-padded along E (K) in the load, and streams the transposed input
// weight ([3H, E] zero-padded to 64 columns) before the recurrent one; its
// xi stays f32, not rounded to bf16. Gate math and rounding points are the
// TPU kernels': xi and the biases upcast to f32, gate order r, z, n, f32
// state.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kTileB = 64;              // batch rows of a block: 4 warps of 16
constexpr int kTileJ = 64;              // hidden units of a chunk
constexpr int kWarpJ = 32;              // hidden units of one warp: 4 n-tiles a gate
constexpr int kTileN = 3 * kTileJ;      // gate columns of a chunk (r, z, n)
constexpr int kTileK = 64;
constexpr int kLd = kTileK + 8;         // padded row: conflict-free ldmatrix
constexpr int kThreads = 256;           // 8 warps: 4 along rows x 2 along j
// ring depth: three weight tiles for v1; v3's embedding tile leaves room for two
template <bool kV3> constexpr int kStages = kV3 ? 2 : 3;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// 16 x 16 A fragment from a resident shared tile with a run-time row pitch
// (in bf16; pitch / 8 odd keeps ldmatrix conflict-free)
__device__ __forceinline__ void load_a_frag_ld(uint32_t a[4], const __nv_bfloat16* tile, int ld,
                                               int row0, int k0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// K of the state and the embeddings rounded up to whole K tiles
__host__ __device__ inline int k_pad(int k) { return (k + kTileK - 1) / kTileK * kTileK; }
// the shared-memory layout: resident bf16 state [kTileB, H64 + 8], the v3
// embedding tile [kTileB, E64 + 8] (both zero past H and E), the
// weight-tile ring; above the card's 227 KB a block, launch() returns
// cudaFuncSetAttribute's error and launches nothing
__host__ __device__ inline size_t h_bytes(int H) { return size_t(kTileB) * (k_pad(H) + 8) * 2; }
__host__ __device__ inline size_t e_bytes(int E64) { return E64 ? size_t(kTileB) * (E64 + 8) * 2 : 0; }
template <bool kV3> constexpr size_t kRingBytes = size_t(kStages<kV3>) * kTileN * kLd * 2;

template <bool kV3>
__global__ void __launch_bounds__(kThreads)
gru_seq_kernel(const __nv_bfloat16* __restrict__ xi,    // v1: [B, T, 3H]
               const __nv_bfloat16* __restrict__ emb,   // v3: [B, T, E]
               const __nv_bfloat16* __restrict__ wi,    // v3: [3H, E64], zero past E
               const __nv_bfloat16* __restrict__ bi,    // v3: [3H]
               const __nv_bfloat16* __restrict__ wh,    // [3H, H]
               const __nv_bfloat16* __restrict__ bh,    // [3H]
               float* __restrict__ out,                 // [B, H]: the f32 state
               int B, int T, int H, int E, int E64) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(smem_raw + h_bytes(H));
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + h_bytes(H) + e_bytes(E64));
  const int ldh = k_pad(H) + 8, lde = E64 + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 1, warp_j = warp & 1;
  const int g = lane >> 2, c = lane & 3;
  const int b0 = blockIdx.x * kTileB;
  const size_t G = 3 * static_cast<size_t>(H);
  const int chunks = (H + kTileJ - 1) / kTileJ;   // the last may pass H
  const int kx = kV3 ? E64 / kTileK : 0;       // input-weight tiles of a chunk

  for (int i = tid; i < kTileB * ldh; i += kThreads) hs[i] = __float2bfloat16(0.f);

  for (int t = 0; t < T; ++t) {
    if (kV3) {
      // the step's embedding rows, zero past E and past B
      for (int i = tid; i < kTileB * E64; i += kThreads) {
        const int r = i / E64, k = i % E64;
        es[r * lde + k] = (b0 + r < B && k < E)
            ? emb[(static_cast<size_t>(b0 + r) * T + t) * E + k] : __float2bfloat16(0.f);
      }
      __syncthreads();
    }
    // at t = 0 the state is zero; the last tile of an H not a multiple of
    // kTileK reads zeros past H, in the state and (zero-filled) in Wh
    const int kh = t > 0 ? k_pad(H) / kTileK : 0;
    const int per_chunk = kx + kh;
    const int total = chunks * per_chunk;
    // tile `it` of the step's stream: input-weight tiles, then recurrent ones
    auto issue = [&](int it) {
      if (it < total) {
        const int j0 = (it / per_chunk) * kTileJ, i = it % per_chunk;
        const bool x = i < kx;
        const __nv_bfloat16* w = x ? wi : wh;
        const int ldw = x ? E64 : H, k0 = (x ? i : i - kx) * kTileK;
        __nv_bfloat16* s = ring + (it % kStages<kV3>) * kTileN * kLd;
        for (int idx = tid; idx < kTileN * (kTileK / 8); idx += kThreads) {
          const int n = idx / (kTileK / 8), k = k0 + (idx % (kTileK / 8)) * 8;
          const size_t grow = static_cast<size_t>(n / kTileJ) * H + j0 + (n % kTileJ);
          const bool ok = k < ldw && j0 + (n % kTileJ) < H;
          cp_async16(s + n * kLd + (idx % (kTileK / 8)) * 8, ok ? w + grow * ldw + k : w, ok);
        }
      }
      cp_async_commit();
    };

    constexpr int kNT = kWarpJ / 8;          // n-tiles of one gate of a warp
    float acc_x[3 * kNT][4], acc_h[3 * kNT][4];
#pragma unroll
    for (int i = 0; i < 3 * kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_x[i][e] = acc_h[i][e] = 0.f;

    // the chunk's gate math: acc_*[kNT * gate + jt] hold gate (r, z, n) of
    // hidden units j0 + 32 warp_j + 8 jt + 2c + {0, 1}, rows g and g + 8
    auto epilogue = [&](int chunk) {
      const int j0 = chunk * kTileJ;
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) {
        const int j = j0 + warp_j * kWarpJ + jt * 8 + 2 * c;
        if (j >= H) continue;           // H % 32 == 0: j + 1 < H too
        float bhv[3][2], biv[3][2];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bh + gate * H + j));
          bhv[gate][0] = bb.x;
          bhv[gate][1] = bb.y;
          if (kV3) {
            const float2 ib = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bi + gate * H + j));
            biv[gate][0] = ib.x;
            biv[gate][1] = ib.y;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = b0 + warp_m * 16 + g + half * 8;
          if (row >= B) continue;
          float xv[3][2];
          if (kV3) {
#pragma unroll
            for (int gate = 0; gate < 3; ++gate)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                xv[gate][e] = acc_x[kNT * gate + jt][2 * half + e] + biv[gate][e];
          } else {
            const __nv_bfloat16* x = xi + (static_cast<size_t>(row) * T + t) * G;
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + gate * H + j));
              xv[gate][0] = f.x;
              xv[gate][1] = f.y;
            }
          }
          float* hp = out + static_cast<size_t>(row) * H + j;
          const float2 h_old = t > 0 ? *reinterpret_cast<const float2*>(hp)
                                     : make_float2(0.f, 0.f);
          float h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float hr = acc_h[jt][2 * half + e] + bhv[0][e];
            const float hz = acc_h[kNT + jt][2 * half + e] + bhv[1][e];
            const float hn = acc_h[2 * kNT + jt][2 * half + e] + bhv[2][e];
            const float r = sigmoidf(xv[0][e] + hr);
            const float z = sigmoidf(xv[1][e] + hz);
            const float n = tanhf(xv[2][e] + r * hn);
            h[e] = (1.f - z) * n + z * (e ? h_old.y : h_old.x);
          }
          *reinterpret_cast<float2*>(hp) = make_float2(h[0], h[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 3 * kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_x[i][e] = acc_h[i][e] = 0.f;
    };

    if (total == 0) {
      for (int chunk = 0; chunk < chunks; ++chunk) epilogue(chunk);
    } else {
      for (int s = 0; s < kStages<kV3> - 1; ++s) issue(s);
      for (int it = 0; it < total; ++it) {
        cp_async_wait<kStages<kV3> - 2>();
        __syncthreads();          // tile `it` has landed; tile it - 1 is consumed
        issue(it + kStages<kV3> - 1);
        const __nv_bfloat16* s = ring + (it % kStages<kV3>) * kTileN * kLd;
        const int i = it % per_chunk;
        const bool x = i < kx;
        const __nv_bfloat16* a_tile = x ? es : hs;
        const int lda = x ? lde : ldh, k0 = (x ? i : i - kx) * kTileK;
#pragma unroll
        for (int kk = 0; kk < kTileK; kk += 16) {
          uint32_t a[4];
          load_a_frag_ld(a, a_tile, lda, warp_m * 16, k0 + kk, lane);
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
#pragma unroll
            for (int jp = 0; jp < kNT; jp += 2) {
              uint32_t b[4];
              load_b_frag2<kLd>(b, s, gate * kTileJ + warp_j * kWarpJ + jp * 8, kk, lane);
              if (x) {
                mma_bf16_16816(acc_x[kNT * gate + jp], a, b);
                mma_bf16_16816(acc_x[kNT * gate + jp + 1], a, b + 2);
              } else {
                mma_bf16_16816(acc_h[kNT * gate + jp], a, b);
                mma_bf16_16816(acc_h[kNT * gate + jp + 1], a, b + 2);
              }
            }
        }
        if (i == per_chunk - 1) epilogue(it / per_chunk);
      }
      cp_async_wait<0>();
    }
    // every chunk's f32 state is written: round it into the resident operand
    __syncthreads();
    for (int i = tid; i < kTileB * (H / 2); i += kThreads) {
      const int r = i / (H / 2), k = (i % (H / 2)) * 2;
      float2 f = make_float2(0.f, 0.f);
      if (b0 + r < B) f = *reinterpret_cast<const float2*>(out + static_cast<size_t>(b0 + r) * H + k);
      *reinterpret_cast<__nv_bfloat162*>(hs + r * ldh + k) = __floats2bfloat162_rn(f.x, f.y);
    }
    __syncthreads();
  }
}

template <bool kV3>
int launch(const void* xi, const void* emb, const void* wi, const void* bi, const void* wh,
           const void* bh, void* out, int B, int T, int H, int E, int E64,
           cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = h_bytes(H) + e_bytes(E64) + kRingBytes<kV3>;
  cudaError_t err = cudaFuncSetAttribute(
      gru_seq_kernel<kV3>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // reset it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  gru_seq_kernel<kV3><<<(B + kTileB - 1) / kTileB, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xi), static_cast<const __nv_bfloat16*>(emb),
      static_cast<const __nv_bfloat16*>(wi), static_cast<const __nv_bfloat16*>(bi),
      static_cast<const __nv_bfloat16*>(wh), static_cast<const __nv_bfloat16*>(bh),
      static_cast<float*>(out), B, T, H, E, E64);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v1: out [B, H] f32 = the last GRU state of xi [B, T, 3H] under the
// gate-major recurrent weight w [3H, H] and bias bh [3H], all bf16.
// Requires T >= 1, H % 32 == 0 and 16-byte aligned, contiguous operands.
extern "C" int gru_last_state_forward(const void* xi, const void* w, const void* bh, void* out,
                                      int B, int T, int H, void* stream) {
  return launch<false>(xi, nullptr, nullptr, nullptr, w, bh, out, B, T, H, 0, 0,
                       static_cast<cudaStream_t>(stream));
}

// v3: the same from emb [B, T, E] with the input weight given transposed and
// zero-padded to wi [3H, E64] (E64 = E rounded up to 64) and bias bi [3H].
extern "C" int gru_last_state_v3_forward(const void* emb, const void* wi, const void* bi,
                                         const void* w, const void* bh, void* out, int B,
                                         int T, int H, int E, int E64, void* stream) {
  return launch<true>(nullptr, emb, wi, bi, w, bh, out, B, T, H, E, E64,
                      static_cast<cudaStream_t>(stream));
}
