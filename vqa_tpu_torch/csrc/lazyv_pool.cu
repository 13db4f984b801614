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
//
// attended_int8 forms the attended features themselves, for the readers of
// the dense [B, N, D] product (ReGAT's graph stage, the caption decoders):
//   out[b, n, d] = bf16(att[b, n] * bf16(x_q[b, n, d] * scale[b, n]))
// It replaces no TPU kernel: XLA fuses the cast and the two multiplies of
// vqa_tpu/models/encoder.py into one pass, where eager PyTorch makes three
// (the cast, then two broadcast multiplies). Both f32 products are exact
// (7 x 8 and 8 x 8 significant bits), so rounding each to bf16 gives
// PyTorch's bits. Memory bounds it: at B=8192 it reads 0.60 GB of int8 and
// writes 1.21 GB, 0.54 ms at 3.35 TB/s. Each thread loads four 16-byte
// vectors of int8 (neighbouring threads on neighbouring vectors) and its
// rows' two scalars before it computes, so 64 bytes a thread are in flight,
// and stores each vector as two 16-byte bf16 stores; reads and writes are
// marked streaming, since nothing reads them again from L2.

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

constexpr int kAttThreads = 256;
constexpr int kAttUnroll = 4;

__global__ void __launch_bounds__(kAttThreads)
attended_int8_kernel(const __nv_bfloat16* __restrict__ att,    // [B N]
                     const __nv_bfloat16* __restrict__ scale,  // [B N]
                     const int8_t* __restrict__ xq,            // [B N, D]
                     __nv_bfloat16* __restrict__ out,          // [B N, D]
                     unsigned vectors, unsigned row_vectors) {
  // vector v covers d = 16 (v % row_vectors) .. +15 of row v / row_vectors
  const unsigned first = blockIdx.x * (kAttThreads * kAttUnroll) + threadIdx.x;
  int4 raw[kAttUnroll];
  float a[kAttUnroll], s[kAttUnroll];
#pragma unroll
  for (int u = 0; u < kAttUnroll; ++u) {
    const unsigned v = first + u * kAttThreads;
    if (v < vectors) {
      const unsigned row = v / row_vectors;
      raw[u] = __ldcs(reinterpret_cast<const int4*>(xq) + v);
      a[u] = __bfloat162float(att[row]);
      s[u] = __bfloat162float(scale[row]);
    }
  }
#pragma unroll
  for (int u = 0; u < kAttUnroll; ++u) {
    const unsigned v = first + u * kAttThreads;
    if (v >= vectors) break;
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw[u]);
    uint32_t p[kVec / 2];
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float x0 = __bfloat162float(__float2bfloat16_rn(static_cast<float>(q[2 * i]) * s[u]));
      const float x1 = __bfloat162float(__float2bfloat16_rn(static_cast<float>(q[2 * i + 1]) * s[u]));
      p[i] = pack_bf16x2(a[u] * x0, a[u] * x1);
    }
    uint4* dst = reinterpret_cast<uint4*>(out) + 2 * static_cast<size_t>(v);
    __stcs(dst, make_uint4(p[0], p[1], p[2], p[3]));
    __stcs(dst + 1, make_uint4(p[4], p[5], p[6], p[7]));
  }
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

// out[B, N, D] = bf16(att[..., None] * bf16(x_q * scale[..., None])).
// Requires D % 16 == 0, B N D / 16 < 2**31 and 16-byte aligned, contiguous
// operands.
extern "C" int attended_int8_forward(const void* att, const void* scale,
                                     const void* x_q, void* out, int B, int N,
                                     int D, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const unsigned row_vectors = static_cast<unsigned>(D / kVec);
  const unsigned vectors = static_cast<unsigned>(
      static_cast<size_t>(B) * N * row_vectors);
  const unsigned per_block = kAttThreads * kAttUnroll;
  const dim3 grid((vectors + per_block - 1) / per_block);
  attended_int8_kernel<<<grid, kAttThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(att), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const int8_t*>(x_q), static_cast<__nv_bfloat16*>(out), vectors,
      row_vectors);
  return static_cast<int>(cudaGetLastError());
}
