// Decode-step attention of the MTL caption-training scan, with the
// attention-dropout mask regenerated in the kernels from a counter-based
// generator (Philox4x32-10), never stored:
//
//   decode_att_fwd  att = softmax_n(sum_h keep * scale * vp[b,n,h] qp[b,h] k[h])
//                   att_v[b,d] = sum_n att[b,n] (w[b,n]) pool[b,n,d]
//   decode_att_bwd  m[b,n] = sum_d g[b,d] pool[b,n,d]; dl = softmax cotangent
//                   of d_att = m (* w); d_qp_pre[b,h] = sum_n dl keep vp
//   decode_att_dvp  d_vp[b,n,h] = scale k[h] sum_t keep_t dl_t[b,n] qp_t[b,h]
//
// Replaces: vqa_tpu/ops/pallas/decode_att.py decode_att_fwd (:175),
// decode_att_bwd (:300) and decode_att_dvp (:403), which the custom-VJP
// decode scan (vqa_tpu/ops/decode_scan.py) calls once per step forward, once
// per step in reverse, and once after the reverse scan.
//
// Mask contract (shared with keep_mask in ops/kernels/decode_att.py): key
// (seed, t), counter (b, n, h / 16, 0); byte j of output word i gates lane
// 16 (h / 16) + 4 i + j, kept when below thresh (thresh = 0: no dropout). The
// mask is a pure function of its coordinates, so the three kernels and the
// plain versions agree for any launch shape and any batch size.
//
// What bounds them on an H100: memory. At B=4096, 36 boxes, H=1024 and an
// int8 payload of D=2048, fwd and bwd each read vp (0.30 GB bf16) and the
// payload (0.30 GB) once: about 0.18 ms at 3.35 TB/s. dvp reads the T steps'
// dl and qp and writes d_vp (0.30 GB). The Philox draws are arithmetic on
// the side: one call per 16 mask bytes, about 9.4 M a step for fwd and bwd
// and T times that for dvp, where they, and not memory, may bound it.
//
// Design: fwd and bwd give one block of 256 threads to a batch row. The
// [objs] logits are one warp reduction per box (the box's 1024 lanes split
// into 16-lane groups, one Philox call and 16-element vector loads each),
// the softmax over <= 64 boxes is computed by one thread per box from shared
// memory, and the pooling over D is one pass with 16 f32 sums per thread. bwd
// splits the boxes over 4 thread groups for d_qp_pre and adds their partial
// rows in shared memory. dvp gives each thread one (row, box, 16-lane group)
// and loops over t, its 16 sums in registers: d_vp is written once and the
// [T, B, objs, H] product never exists.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kLanes = 16;     // mask lanes, and vector width, of one thread step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxObjs = 64;

// Philox4x32 with 10 rounds (Random123): counter (c0, c1, c2, 0), key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t k0,
                                               uint32_t k1) {
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Bit 4 i + j set where byte j of word i of the (b, n, g) draw is < thresh;
// all 16 set when thresh == 0 (no dropout).
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed, uint32_t t,
                                              uint32_t b, uint32_t n,
                                              uint32_t g, uint32_t thresh) {
  if (thresh == 0) return 0xFFFFu;
  const uint4 r = philox4x32_10(b, n, g, seed, t);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bits |= static_cast<uint32_t>(((w[i] >> (8 * j)) & 0xFFu) < thresh)
              << (4 * i + j);
  return bits;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 consecutive elements (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float x[kLanes]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 r = q[v];
    x[4 * v] = r.x;
    x[4 * v + 1] = r.y;
    x[4 * v + 2] = r.z;
    x[4 * v + 3] = r.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float x[kLanes]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 r = q[v];
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[8 * v + 2 * i] = __uint_as_float(u[i] << 16);
      x[8 * v + 2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float x[kLanes]) {
  const int4 r = *reinterpret_cast<const int4*>(p);
  const int8_t* q = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < kLanes; ++i) x[i] = static_cast<float>(q[i]);
}

__device__ __forceinline__ void store16(float* p, const float x[kLanes]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    q[v] = make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float x[kLanes]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int v = 0; v < 2; ++v)
    q[v] = make_uint4(pack_bf16x2(x[8 * v], x[8 * v + 1]),
                      pack_bf16x2(x[8 * v + 2], x[8 * v + 3]),
                      pack_bf16x2(x[8 * v + 4], x[8 * v + 5]),
                      pack_bf16x2(x[8 * v + 6], x[8 * v + 7]));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// The 16 mask bytes of keep bits, as the uint8 layout of the emitted mask.
__device__ __forceinline__ uint4 mask_bytes(uint32_t bits) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[i] |= ((bits >> (4 * i + j)) & 1u) << (8 * j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct FwdArgs {
  const void* vp;
  const void* pool;
  const void* w;
  const void* qp;
  const void* k;
  void* att;
  void* att_v;
  uint8_t* mask;
  uint32_t seed, t, thresh;
  int objs, H, D;
  float att_scale;
};

template <typename T, typename P, bool kFactored>
__global__ void __launch_bounds__(kThreads) decode_att_fwd_kernel(FwdArgs a) {
  extern __shared__ float qk[];     // [H]: qp * k * scale of this row
  __shared__ float logits[kMaxObjs];
  __shared__ float aw[kMaxObjs];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int objs = a.objs, H = a.H, D = a.D, G = H / kLanes;
  const T* qp = static_cast<const T*>(a.qp) + static_cast<size_t>(b) * H;
  const T* k = static_cast<const T*>(a.k);
  const float scale = a.thresh ? a.att_scale : 1.f;
  for (int h = tid; h < H; h += kThreads) qk[h] = to_f(qp[h]) * to_f(k[h]) * scale;
  __syncthreads();

  const T* vrow = static_cast<const T*>(a.vp) + static_cast<size_t>(b) * objs * H;
  for (int n = warp; n < objs; n += kWarps) {
    float part = 0.f;
    for (int g = lane; g < G; g += 32) {
      float x[kLanes];
      load16(vrow + static_cast<size_t>(n) * H + g * kLanes, x);
      const uint32_t bits = keep_bits(a.seed, a.t, b, n, g, a.thresh);
      if (a.mask)
        *reinterpret_cast<uint4*>(a.mask + (static_cast<size_t>(b) * objs + n) * H +
                                  g * kLanes) = mask_bytes(bits);
#pragma unroll
      for (int i = 0; i < kLanes; ++i)
        if ((bits >> i) & 1u) part += x[i] * qk[g * kLanes + i];
    }
    part = warp_sum(part);
    if (lane == 0) logits[n] = part;
  }
  __syncthreads();

  if (tid < objs) {
    float mx = logits[0];
    for (int j = 1; j < objs; ++j) mx = fmaxf(mx, logits[j]);
    float sum = 0.f;
    for (int j = 0; j < objs; ++j) sum += expf(logits[j] - mx);
    const float p = expf(logits[tid] - mx) / sum;
    static_cast<T*>(a.att)[static_cast<size_t>(b) * objs + tid] = from_f<T>(p);
    aw[tid] = kFactored
                  ? p * to_f(static_cast<const T*>(a.w)[static_cast<size_t>(b) * objs + tid])
                  : p;
  }
  __syncthreads();

  const P* prow = static_cast<const P*>(a.pool) + static_cast<size_t>(b) * objs * D;
  T* out = static_cast<T*>(a.att_v) + static_cast<size_t>(b) * D;
  for (int d0 = tid * kLanes; d0 < D; d0 += kThreads * kLanes) {
    float acc[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) acc[i] = 0.f;
    for (int n = 0; n < objs; ++n) {
      float x[kLanes];
      load16(prow + static_cast<size_t>(n) * D + d0, x);
      const float s = aw[n];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) acc[i] += s * x[i];
    }
    store16(out + d0, acc);
  }
}

struct BwdArgs {
  const void* vp;
  const void* pool;
  const void* w;
  const void* att;
  const void* g;
  void* d_qp;
  void* m;
  void* dl;
  uint32_t seed, t, thresh;
  int objs, H, D, splits;
};

template <typename T, typename P, bool kFactored>
__global__ void __launch_bounds__(kThreads) decode_att_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];   // g row [D], then partial d_qp rows [splits, H]
  __shared__ float m_s[kMaxObjs];
  __shared__ float dl_s[kMaxObjs];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int objs = a.objs, H = a.H, D = a.D, G = H / kLanes, S = a.splits;
  float* g_s = smem;
  float* part = smem + D;
  const T* grow = static_cast<const T*>(a.g) + static_cast<size_t>(b) * D;
  for (int d = tid; d < D; d += kThreads) g_s[d] = to_f(grow[d]);
  __syncthreads();

  const P* prow = static_cast<const P*>(a.pool) + static_cast<size_t>(b) * objs * D;
  for (int n = warp; n < objs; n += kWarps) {
    float s = 0.f;
    for (int d0 = lane * kLanes; d0 < D; d0 += 32 * kLanes) {
      float x[kLanes];
      load16(prow + static_cast<size_t>(n) * D + d0, x);
#pragma unroll
      for (int i = 0; i < kLanes; ++i) s += x[i] * g_s[d0 + i];
    }
    s = warp_sum(s);
    if (lane == 0) m_s[n] = s;
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(b) * objs;
  if (tid < objs) {
    const T* att = static_cast<const T*>(a.att) + row;
    const T* w = static_cast<const T*>(a.w) + row;
    float dot = 0.f;   // sum_j att_j d_att_j, the same order in every thread
    for (int j = 0; j < objs; ++j)
      dot += to_f(att[j]) * (kFactored ? m_s[j] * to_f(w[j]) : m_s[j]);
    const float d_att = kFactored ? m_s[tid] * to_f(w[tid]) : m_s[tid];
    const float dl = to_f(att[tid]) * (d_att - dot);
    dl_s[tid] = dl;
    static_cast<T*>(a.m)[row + tid] = from_f<T>(m_s[tid]);
    static_cast<T*>(a.dl)[row + tid] = from_f<T>(dl);
  }
  __syncthreads();

  // d_qp_pre: thread (g, s) sums boxes s, s + S, ... of its 16-lane group
  const T* vrow = static_cast<const T*>(a.vp) + row * H;
  for (int p = tid; p < G * S; p += kThreads) {
    const int g = p % G, s = p / G;
    float acc[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) acc[i] = 0.f;
    for (int n = s; n < objs; n += S) {
      float x[kLanes];
      load16(vrow + static_cast<size_t>(n) * H + g * kLanes, x);
      const uint32_t bits = keep_bits(a.seed, a.t, b, n, g, a.thresh);
      const float d = dl_s[n];
#pragma unroll
      for (int i = 0; i < kLanes; ++i)
        if ((bits >> i) & 1u) acc[i] += d * x[i];
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) part[s * H + g * kLanes + i] = acc[i];
  }
  __syncthreads();
  T* out = static_cast<T*>(a.d_qp) + static_cast<size_t>(b) * H;
  for (int h = tid; h < H; h += kThreads) {
    float s = 0.f;
    for (int j = 0; j < S; ++j) s += part[j * H + h];
    out[h] = from_f<T>(s);
  }
}

struct DvpArgs {
  const void* dls;
  const void* qps;
  const void* k;
  void* out;
  uint32_t seed, thresh;
  int T, B, objs, H;
  float att_scale;
};

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) decode_att_dvp_kernel(DvpArgs a) {
  const int b = blockIdx.x;
  const int G = a.H / kLanes;
  const int p = blockIdx.y * kThreads + threadIdx.x;   // (box, lane group)
  if (p >= a.objs * G) return;
  const int n = p / G, g = p % G;
  const T* dls = static_cast<const T*>(a.dls);
  const T* qps = static_cast<const T*>(a.qps);
  float acc[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) acc[i] = 0.f;
  for (int t = 0; t < a.T; ++t) {
    const size_t tb = static_cast<size_t>(t) * a.B + b;
    const float d = to_f(dls[tb * a.objs + n]);
    float q[kLanes];
    load16(qps + tb * a.H + g * kLanes, q);
    const uint32_t bits = keep_bits(a.seed, t, b, n, g, a.thresh);
#pragma unroll
    for (int i = 0; i < kLanes; ++i)
      if ((bits >> i) & 1u) acc[i] += d * q[i];
  }
  const T* k = static_cast<const T*>(a.k) + g * kLanes;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) acc[i] *= a.att_scale * to_f(k[i]);
  store16(static_cast<O*>(a.out) + (static_cast<size_t>(b) * a.objs + n) * a.H +
              g * kLanes,
          acc);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename P, bool F>
cudaError_t fwd_launch(const FwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(a.H) * sizeof(float);
  cudaError_t e = set_smem(decode_att_fwd_kernel<T, P, F>, smem);
  if (e != cudaSuccess) return e;
  decode_att_fwd_kernel<T, P, F><<<B, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P, bool F>
cudaError_t bwd_launch(const BwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(a.D) + static_cast<size_t>(a.splits) * a.H) *
                      sizeof(float);
  cudaError_t e = set_smem(decode_att_bwd_kernel<T, P, F>, smem);
  if (e != cudaSuccess) return e;
  decode_att_bwd_kernel<T, P, F><<<B, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int objs, int H, int D) {
  return objs <= 0 || objs > kMaxObjs || H <= 0 || H % kLanes || D <= 0 ||
         D % kLanes;
}

template <typename T, typename P>
cudaError_t fwd_typed(const FwdArgs& a, int B, cudaStream_t s) {
  return a.w ? fwd_launch<T, P, true>(a, B, s) : fwd_launch<T, P, false>(a, B, s);
}
template <typename T, typename P>
cudaError_t bwd_typed(const BwdArgs& a, int B, cudaStream_t s) {
  return a.w ? bwd_launch<T, P, true>(a, B, s) : bwd_launch<T, P, false>(a, B, s);
}

}  // namespace

// att [B, objs], att_v [B, D] (and the uint8 keep mask [B, objs * H] when
// `mask` is not null); `w` null for the dense payload. act: 0 f32, 1 bf16
// (vp, w, qp, k and the outputs); pool_kind: 0 the activations' type, 1 int8. Operands contiguous and
// 16-byte aligned; H and D multiples of 16; objs <= 64.
extern "C" int decode_att_fwd(const void* vp, const void* pool, const void* w,
                              const void* qp, const void* k, void* att, void* att_v,
                              void* mask, unsigned seed, int t, int B, int objs,
                              int H, int D, float att_scale, int thresh, int act,
                              int pool_kind, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(objs, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{vp, pool, w, qp, k, att, att_v, static_cast<uint8_t*>(mask),
                  seed, static_cast<uint32_t>(t), static_cast<uint32_t>(thresh),
                  objs, H, D, att_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (act == 0)
    e = pool_kind ? fwd_typed<float, int8_t>(a, B, s) : fwd_typed<float, float>(a, B, s);
  else
    e = pool_kind ? fwd_typed<__nv_bfloat16, int8_t>(a, B, s)
                  : fwd_typed<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  return static_cast<int>(e);
}

// d_qp_pre [B, H], m [B, objs], dl [B, objs]; as decode_att_fwd otherwise.
extern "C" int decode_att_bwd(const void* vp, const void* pool, const void* w,
                              const void* att, const void* g, void* d_qp, void* m,
                              void* dl, unsigned seed, int t, int B, int objs, int H,
                              int D, int thresh, int act, int pool_kind,
                              void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(objs, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = H / kLanes;
  const int splits = groups >= kThreads ? 1 : kThreads / groups;
  const BwdArgs a{vp, pool, w, att, g, d_qp, m, dl, seed, static_cast<uint32_t>(t),
                  static_cast<uint32_t>(thresh), objs, H, D, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (act == 0)
    e = pool_kind ? bwd_typed<float, int8_t>(a, B, s) : bwd_typed<float, float>(a, B, s);
  else
    e = pool_kind ? bwd_typed<__nv_bfloat16, int8_t>(a, B, s)
                  : bwd_typed<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  return static_cast<int>(e);
}

// d_vp [B, objs * H] from dls [T, B, objs], qps [T, B, H] and k [H]; act as
// above for the inputs, out_kind 0 f32 / 1 bf16 for the output.
extern "C" int decode_att_dvp(const void* dls, const void* qps, const void* k,
                              void* out, unsigned seed, int T, int B, int objs,
                              int H, float att_scale, int thresh, int act,
                              int out_kind, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (T < 0 || bad_shape(objs, H, kLanes)) return static_cast<int>(cudaErrorInvalidValue);
  const DvpArgs a{dls, qps, k, out, seed, static_cast<uint32_t>(thresh), T, B, objs,
                  H, att_scale};
  const dim3 grid(B, (objs * (H / kLanes) + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == 0 && out_kind == 0)
    decode_att_dvp_kernel<float, float><<<grid, kThreads, 0, s>>>(a);
  else if (act == 0)
    decode_att_dvp_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  else if (out_kind == 0)
    decode_att_dvp_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, s>>>(a);
  else
    decode_att_dvp_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
