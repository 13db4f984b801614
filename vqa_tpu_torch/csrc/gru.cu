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
// the [B, E] x [E, 3H] input product of every step, 0.30 TFLOP). Steps are
// serial and rows independent, so a block owns 64 batch rows (one wgmma M)
// for the whole sequence and needs no grid-wide synchronisation; but then
// each block reads the whole 6 MB recurrent weight from L2 once a step
// (14.2 GB at B=16384), and a 64-row tile does 64 operations a byte of
// weight, so an SM must receive ~118 bytes of weight each ns to keep its
// tensor cores busy. What a block receives is its bytes in flight (the
// ring: what shared memory leaves beside the 128 KB state) over the L2
// latency; measured, half a wave of blocks takes nearly as long as a full
// one, so that latency, not L2 bandwidth or the tensor cores, bounds this
// design (PERF.md). It keeps as many weight bytes in flight as shared
// memory allows and takes the barriers off the critical path.
//
// Design (hopper.cuh's primitives): three warpgroups a block. The 64-row
// bf16 state (the product's operand, rounded from the f32 state: the TPU
// kernel's rounding point) stays resident in shared memory, K-major in the
// 128-byte swizzle that wgmma's descriptor reads (128 KB at H=1024); the
// f32 state lives in the output buffer, which only this block touches. A
// step walks the hidden units in pairs of 32-unit chunks, one chunk a
// consumer warpgroup. The producer (one thread of the third warpgroup)
// streams each chunk's gate rows [r, z, n] x 32 units x 64 K of the
// gate-major weight (torch's weight_hh layout, [3H, H] viewed [3, H, H]) by
// TMA, 12 KB a chunk, into an mbarrier ring (4 stages of both chunks, 24 KB
// each; v3: 3 stages of 32 KB) that runs on across chunks and steps; the
// consumers wait on the tile's arrival alone, issue wgmma m64n96k16 (A =
// the resident state, B = the 96 gate rows) and hand the stage back as
// soon as they retire, so that all but one stage stay in flight. r and z take
// their input and recurrent products in one accumulator (they enter as
// sigmoid(x + h)); n keeps two, as it enters as tanh(xn + r hn). Each thread
// then holds r, z and n of the same (row, unit) and runs the gate math in
// its epilogue, which updates the f32 state in place, while the other
// warpgroup's wgmma keeps the tensor cores busy. After the step's last chunk
// the consumers round the f32 state into the swizzled bf16 operand.
// v3 adds, before a chunk's recurrent stages, its input stages: the
// embedding rows [64 x 64 K] of step t beside the chunk's rows of the
// gate-major input weight, both by TMA, into acc (r, z) and a third
// accumulator (xn) by wgmma m64n64k16 and m64n32k16; its xi stays f32, never
// rounded to bf16. TMA needs 16-byte row pitches, so the wrapper pads E to
// a multiple of 8 (E8) and TMA zero-fills each 64-deep K tile past it; the
// last K tile of the state is zero past H. Gate math and rounding points
// are the TPU kernels': xi and the biases upcast to f32, gate order r, z,
// n, f32 state.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTileB = 64;                      // batch rows of a block: one wgmma M
constexpr int kWgJ = 32;                        // hidden units of a warpgroup's chunk
constexpr int kPairJ = 2 * kWgJ;                // hidden units of a ring stage
constexpr int kTileK = 64;                      // K of a stage: one swizzled 128-byte row
constexpr int kThreads = 384;                   // 2 consumer warpgroups + the producer's
constexpr int kBBytes = 3 * kWgJ * kTileK * 2;  // a chunk's [3][32][64] weight tile
constexpr int kABytes = kTileB * kTileK * 2;    // a [64][64] operand tile (state K block, emb)
template <bool kV3> constexpr int kStages = kV3 ? 3 : 4;
// stage: the two chunks' weight tiles, then (v3) the embedding tile
template <bool kV3> constexpr int kStageBytes = 2 * kBBytes + (kV3 ? kABytes : 0);

__host__ __device__ inline int k_blocks(int k) { return (k + kTileK - 1) / kTileK; }
// the shared-memory layout, from a 1024-byte aligned base: the bf16 state
// [H / 64][64 rows][64 K] (zero past H), the ring, its barriers; above the
// card's 227 KB a block, launch() returns cudaFuncSetAttribute's error and
// launches nothing
template <bool kV3>
size_t smem_bytes(int H) {
  return 1024 + size_t(k_blocks(H)) * kABytes + size_t(kStages<kV3>) * kStageBytes<kV3> +
         2 * kStages<kV3> * sizeof(uint64_t);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// two floats rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <bool kV3>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_kernel(const __grid_constant__ CUtensorMap wh_map,   // [3, H, H]: w_gk [3H, H]
               const __grid_constant__ CUtensorMap wi_map,   // v3: [3, H, E8]: wi [3H, E8]
               const __grid_constant__ CUtensorMap emb_map,  // v3: [B, T, E8]
               const __nv_bfloat16* __restrict__ xi,         // v1: [B, T, 3H]
               const __nv_bfloat16* __restrict__ bi,         // v3: [3H]
               const __nv_bfloat16* __restrict__ bh,         // [3H]
               float* __restrict__ out,                      // [B, H]: the f32 state
               int B, int T, int H, int E8) {
  constexpr int S = kStages<kV3>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* hs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kh_blocks = k_blocks(H);
  unsigned char* ring = hs + kh_blocks * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStageBytes<kV3>);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int b0 = blockIdx.x * kTileB;
  const int pairs = (H + kPairJ - 1) / kPairJ;
  const int kx = kV3 ? k_blocks(E8) : 0;         // input stages of a chunk pair

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2);     // one arrival from each consumer warpgroup
    }
    mbar_init_fence();
  }
  for (int i = tid; i < kh_blocks * kABytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread streams every stage of every step ----
    if (tid == 256) {
      tma_prefetch_map(&wh_map);
      if (kV3) {
        tma_prefetch_map(&wi_map);
        tma_prefetch_map(&emb_map);
      }
      int it = 0;
      for (int t = 0; t < T; ++t) {
        const int n = kx + (t > 0 ? kh_blocks : 0);   // at t = 0 the state is zero
        for (int p = 0; p < pairs; ++p) {
          const int j0 = p * kPairJ;
          const int chunks = j0 + kWgJ < H ? 2 : 1;   // H % 32 == 0
          for (int i = 0; i < n; ++i, ++it) {
            const int s = it % S;
            const bool x = i < kx;
            mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], chunks * kBBytes + (x ? kABytes : 0));
            unsigned char* st = ring + s * kStageBytes<kV3>;
            for (int w = 0; w < chunks; ++w)
              tma_load_3d(st + w * kBBytes, x ? &wi_map : &wh_map, &full[s],
                          (x ? i : i - kx) * kTileK, j0 + w * kWgJ, 0);
            if (x) tma_load_3d(st + 2 * kBBytes, &emb_map, &full[s], i * kTileK, t, b0);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns units [j0, j0 + 32) of each pair ----
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int g = lane >> 2, c = lane & 3;
    const size_t G = 3 * static_cast<size_t>(H);
    // acc: r (registers 0-15) and z (16-31), input and recurrent products
    // together; acc_hn: n's recurrent product; acc_xn: n's input product (v3)
    float acc[32], acc_hn[16], acc_xn[16];
    int it = 0;
    for (int t = 0; t < T; ++t) {
      const int n = kx + (t > 0 ? kh_blocks : 0);
      for (int p = 0; p < pairs; ++p) {
        const int j0 = p * kPairJ + wg * kWgJ;
        const bool active = j0 < H;
        // the epilogue's inputs from device memory (v1's input gates, the
        // old f32 state), loaded now so that their latency hides behind the
        // chunk's stages: units j0 + 8q + 2c (+1), rows 16 warp + g (+8)
        uint32_t x_raw[kWgJ / 8][2][3];   // bf16 pairs
        float2 h_old[kWgJ / 8][2];
#pragma unroll
        for (int q = 0; q < kWgJ / 8; ++q)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = b0 + warp * 16 + g + half * 8, j = j0 + q * 8 + 2 * c;
            h_old[q][half] = make_float2(0.f, 0.f);
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) x_raw[q][half][gate] = 0;
            if (!active || row >= B) continue;
            if (t > 0) h_old[q][half] = *reinterpret_cast<const float2*>(
                           out + static_cast<size_t>(row) * H + j);
            if (!kV3) {
              const __nv_bfloat16* x = xi + (static_cast<size_t>(row) * T + t) * G + j;
#pragma unroll
              for (int gate = 0; gate < 3; ++gate)
                x_raw[q][half][gate] = *reinterpret_cast<const uint32_t*>(x + gate * H);
            }
          }
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc_hn[e] = acc_xn[e] = 0.f;
        for (int i = 0; i < n; ++i, ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          if (active) {
            const unsigned char* st = ring + s * kStageBytes<kV3>;
            const uint64_t db = sw128_desc(st + wg * kBBytes);
            wgmma_fence();
            if (kV3 && i < kx) {
              const uint64_t da = sw128_desc(st + 2 * kBBytes);
              // the n gate's rows start 64 rows (8 KB) into the chunk tile
              const uint64_t dn = sw128_desc(st + wg * kBBytes + 2 * kWgJ * kTileK * 2);
#pragma unroll
              for (int kk = 0; kk < kTileK / 16; ++kk) {
                // +2 in the descriptor's 16-byte units = 16 bf16 further along K
                wgmma_m64n64k16_bf16(acc, da + 2 * kk, db + 2 * kk, 1);
                wgmma_m64n32k16_bf16(acc_xn, da + 2 * kk, dn + 2 * kk, 1);
              }
            } else {
              const uint64_t da = sw128_desc(hs + (i - kx) * kABytes);
#pragma unroll
              for (int kk = 0; kk < kTileK / 16; ++kk)
                wgmma_m64n96k16_bf16(acc, acc_hn, da + 2 * kk, db + 2 * kk, 1);
            }
            wgmma_commit();
            wgmma_wait<0>();   // the stage is read: hand it back at once
          }
          if ((tid & 127) == 0) mbar_arrive(&empty[s]);
        }
        if (!active) continue;
        fence_operands(acc);
        fence_operands(acc_hn);
        fence_operands(acc_xn);

        // the chunk's gate math
#pragma unroll
        for (int q = 0; q < kWgJ / 8; ++q) {
          const int j = j0 + q * 8 + 2 * c;
          float2 bhv[3], biv[3];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            bhv[gate] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bh + gate * H + j));
            if (kV3)
              biv[gate] = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(bi + gate * H + j));
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = b0 + warp * 16 + g + half * 8;
            if (row >= B) continue;
            float2 xv[3];
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              __nv_bfloat162 pair;
              *reinterpret_cast<uint32_t*>(&pair) = x_raw[q][half][gate];
              xv[gate] = __bfloat1622float2(pair);
            }
            float* hp = out + static_cast<size_t>(row) * H + j;
            const float2 ho = h_old[q][half];
            float h[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = 4 * q + 2 * half + e;
              const float bhr = e ? bhv[0].y : bhv[0].x, bhz = e ? bhv[1].y : bhv[1].x;
              const float bhn = e ? bhv[2].y : bhv[2].x;
              float r, z, n_gate;
              if (kV3) {
                const float bir = e ? biv[0].y : biv[0].x, biz = e ? biv[1].y : biv[1].x;
                const float bin = e ? biv[2].y : biv[2].x;
                r = sigmoidf(acc[a] + bir + bhr);
                z = sigmoidf(acc[16 + a] + biz + bhz);
                n_gate = tanhf((acc_xn[a] + bin) + r * (acc_hn[a] + bhn));
              } else {
                const float xr = e ? xv[0].y : xv[0].x, xz = e ? xv[1].y : xv[1].x;
                const float xn = e ? xv[2].y : xv[2].x;
                r = sigmoidf(xr + (acc[a] + bhr));
                z = sigmoidf(xz + (acc[16 + a] + bhz));
                n_gate = tanhf(xn + r * (acc_hn[a] + bhn));
              }
              h[e] = (1.f - z) * n_gate + z * (e ? ho.y : ho.x);
            }
            *reinterpret_cast<float2*>(hp) = make_float2(h[0], h[1]);
          }
        }
      }
      if (t + 1 < T) {
        // every chunk's f32 state of step t is written: round it into the
        // swizzled operand (16-byte chunk q of row r at q ^ (r % 8))
        named_barrier(1, 256);
        const int row_chunks = H / 8;
        for (int idx = tid; idx < kTileB * row_chunks; idx += 256) {
          const int r = idx / row_chunks, k = (idx % row_chunks) * 8;
          float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
          if (b0 + r < B) {
            const float4* src =
                reinterpret_cast<const float4*>(out + static_cast<size_t>(b0 + r) * H + k);
            lo = src[0];
            hi = src[1];
          }
          unsigned char* dst =
              hs + (k / kTileK) * kABytes + r * 128 + ((((k % kTileK) / 8) ^ (r & 7)) * 16);
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                         pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
        }
        fence_proxy_async();
        named_barrier(1, 256);
      }
    }
  }
}

template <bool kV3>
int launch(const void* xi, const void* emb, const void* wi, const void* bi, const void* wh,
           const void* bh, void* out, int B, int T, int H, int E8, cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes<kV3>(H);
  CUtensorMap wh_map, wi_map, emb_map;
  const uint32_t w_box[3] = {kTileK, kWgJ, 3};
  const uint64_t wh_dims[3] = {uint64_t(H), uint64_t(H), 3};
  const uint64_t wh_strides[2] = {uint64_t(H) * 2, uint64_t(H) * H * 2};
  cudaError_t err = make_tensor_map(&wh_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wh, wh_dims,
                                    wh_strides, w_box);
  wi_map = emb_map = wh_map;   // v1 reads neither
  if (kV3 && err == cudaSuccess) {
    const uint64_t wi_dims[3] = {uint64_t(E8), uint64_t(H), 3};
    const uint64_t wi_strides[2] = {uint64_t(E8) * 2, uint64_t(H) * E8 * 2};
    err = make_tensor_map(&wi_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wi, wi_dims, wi_strides,
                          w_box);
    const uint64_t emb_dims[3] = {uint64_t(E8), uint64_t(T), uint64_t(B)};
    const uint64_t emb_strides[2] = {uint64_t(E8) * 2, uint64_t(T) * E8 * 2};
    const uint32_t emb_box[3] = {kTileK, 1, kTileB};
    if (err == cudaSuccess)
      err = make_tensor_map(&emb_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, emb, emb_dims,
                            emb_strides, emb_box);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gru_seq_kernel<kV3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // reset it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  gru_seq_kernel<kV3><<<(B + kTileB - 1) / kTileB, kThreads, smem, stream>>>(
      wh_map, wi_map, emb_map, static_cast<const __nv_bfloat16*>(xi),
      static_cast<const __nv_bfloat16*>(bi), static_cast<const __nv_bfloat16*>(bh),
      static_cast<float*>(out), B, T, H, E8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v1: out [B, H] f32 = the last GRU state of xi [B, T, 3H] under the
// gate-major recurrent weight w [3H, H] and bias bh [3H], all bf16.
// Requires T >= 1, H % 32 == 0 and 16-byte aligned, contiguous operands.
extern "C" int gru_last_state_forward(const void* xi, const void* w, const void* bh, void* out,
                                      int B, int T, int H, void* stream) {
  return launch<false>(xi, nullptr, nullptr, nullptr, w, bh, out, B, T, H, 0,
                       static_cast<cudaStream_t>(stream));
}

// v3: the same from emb [B, T, E8] (E8: E rounded up to 8, zero past E) with
// the input weight given gate-major, wi [3H, E8] (zero past E), and bias bi
// [3H]; E is the unpadded width, which the kernel does not need.
extern "C" int gru_last_state_v3_forward(const void* emb, const void* wi, const void* bi,
                                         const void* w, const void* bh, void* out, int B,
                                         int T, int H, int E, int E8, void* stream) {
  (void)E;
  return launch<true>(nullptr, emb, wi, bi, w, bh, out, B, T, H, E8,
                      static_cast<cudaStream_t>(stream));
}
