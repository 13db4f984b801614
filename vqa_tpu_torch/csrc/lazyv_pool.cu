// Lazy-v pooling over the int8 feature payload:
//   v_sum[b, d] = sum_n w[b, n] * x_q[b, n, d]     (w = att * img_scale)
//
// Replaces: vqa_tpu/ops/pallas/lazyv_pool.py pool_int8, the encoder's
// lazy-v pooling (vqa_tpu/models/encoder.py) that feeds the base predictor.
//
// What bounds it on an H100: memory. At B=16384, 36 boxes and D=2048 it
// reads 1.2 GB of int8 and writes 64 MB, about 0.4 ms at 3.35 TB/s, for
// 2.4 GFLOP. Eager PyTorch would first write and re-read the [B, 36, D]
// product in bf16 (2.4 GB each way).
//
// Design: one thread owns 16 consecutive d of one row b and loops over the
// boxes, loading 16 int8 (one 16-byte vector) a box, with neighbouring
// threads on neighbouring addresses; the product and the sum are f32 in
// registers, so device memory sees the int8 read and the output only.
// Blocks of 128 threads cover 2048 d of one row.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kVec = 16;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pool_int8_kernel(const __nv_bfloat16* __restrict__ w,   // [B, N]
                 const int8_t* __restrict__ xq,         // [B, N, D]
                 __nv_bfloat16* __restrict__ out,       // [B, D]
                 int N, int D) {
  const int b = blockIdx.x;   // x: the batch may exceed grid.y's 65535
  const int d0 = (blockIdx.y * kThreads + threadIdx.x) * kVec;
  if (d0 >= D) return;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  const int8_t* src = xq + static_cast<size_t>(b) * N * D + d0;
  const __nv_bfloat16* wb = w + static_cast<size_t>(b) * N;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float wn = __bfloat162float(wb[n]);
    const int4 raw = *reinterpret_cast<const int4*>(src + static_cast<size_t>(n) * D);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += wn * static_cast<float>(q[i]);
  }
  uint32_t v[kVec / 2];
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) v[i] = pack_bf16x2(acc[2 * i], acc[2 * i + 1]);
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * D + d0);
  dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
  dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

}  // namespace

// out[B, D] = einsum('bn,bnd->bd', w, x_q) in f32, rounded to bf16.
// Requires D % 16 == 0 and 16-byte aligned, contiguous operands.
extern "C" int pool_int8_forward(const void* w, const void* x_q, void* out,
                                 int B, int N, int D, void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(B, (D / kVec + kThreads - 1) / kThreads);
  pool_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const int8_t*>(x_q),
      static_cast<__nv_bfloat16*>(out), N, D);
  return static_cast<int>(cudaGetLastError());
}
