// The graph-local chain of one ReGAT correlated graph convolution, fused.
//
// Replaces: vqa_tpu/ops/pallas/gcn_chain.py gcn_chain_fused. Per image b
// (N = 36 boxes, L labels, D features), with every operand in the model's
// type T (bf16 or f32) and every product summed in f32:
//
//   adj[i, j] = graph[i, j] != 0        counts[i, l] = #{j : graph[i, j] = l}
//   o   = out_self + adj @ proj + counts @ bias                    [N, D] f32
//   aa  = softmax over i (axis 1 of [B, i, j]) of adj @ alpha_raw  [N, N]
//         -> T (the reference's nn.Softmax(dim=1))
//   out = aa @ T(o) -> T
//
// Label 0 counts: bias row 0 is added once for every non-edge j, as the
// one-hot label sum does.
//
// What bounds it on an H100: at B=8192, D=2048 in bf16 it moves 3.69 GB
// (out_self, proj and out, each [B, 36, 2048], plus alpha_raw and graph):
// 1.10 ms at 3.35 TB/s. Its products, run here as f32 FMAs, are 51 G FMAs
// (1.7 ms at the 67 TFLOP/s f32 rate), so this version is bound by the FMA
// units, not by the bytes; bf16 tensor-core MMAs would lift that.
//
// Design: the TPU kernel packs 8 images block-diagonally to fill the
// 128 x 128 MXU; here one block takes one image. Its 192 threads first build
// the image's [N, N] operands in shared memory (adj and the label counts as
// one [N + L, N] matrix, transposed, and the softmaxed aa, transposed), then
// walk D in tiles of 128 columns: the tile's proj rows, its bias rows and
// its out_self rows are copied to shared memory with cp.async, each thread
// forms o for 12 rows x 2 columns in registers (the [N + L] operand rows as
// broadcast 16-byte loads, six FMAs per shared load), writes T(o) over the
// out_self tile, and then forms out for the same 12 x 2 outputs and writes
// them. out_self, proj and out are each read or written once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kN = 36;                   // boxes per image: the kernel is built for 36
constexpr int kMaxL = 16;                // labels: 12 spatial, 15 semantic
constexpr int kK = kN + kMaxL;           // rows of the first product's operands
constexpr int kTile = 128;               // columns of D per step
constexpr int kRows = 12;                // rows of an image per thread
constexpr int kThreads = (kN / kRows) * (kTile / 2);   // 192: 12 rows x 2 columns each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the cast to the model type between the steps
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// two neighbouring values of T as floats, and back
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the 12 floats at p (16-byte aligned), three broadcast loads
__device__ __forceinline__ void load12(float v[kRows], const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int h = 0; h < kRows / 4; ++h) {
    const float4 x = q[h];
    v[4 * h] = x.x, v[4 * h + 1] = x.y, v[4 * h + 2] = x.z, v[4 * h + 3] = x.w;
  }
}

// shared memory: the image's operands, then the two tiles (the preamble's
// scratch lies over the tiles)
constexpr int kMtBytes = kK * kN * 4;    // mt[k][i]: adj[i][k], then counts[i][k - N]
constexpr int kAtBytes = kN * kN * 4;    // at[j][i]: T(aa[i][j])
template <typename T>
constexpr int smem_bytes() {
  return kMtBytes + kAtBytes + (kK + kN) * kTile * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gcn_chain_kernel(const T* __restrict__ out_self,   // [B, N, D]
                 const T* __restrict__ proj,       // [B, N, D]
                 const T* __restrict__ alpha,      // [B, N, N]
                 const int* __restrict__ graph,    // [B, N, N]
                 const T* __restrict__ bias,       // [L, D]
                 T* __restrict__ out,              // [B, N, D]
                 int D, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* mt = reinterpret_cast<float*>(smem);
  float* at = reinterpret_cast<float*>(smem + kMtBytes);
  T* pt = reinterpret_cast<T*>(smem + kMtBytes + kAtBytes);   // [N + L][kTile]: proj, bias
  T* st = pt + kK * kTile;                                    // [N][kTile]: out_self, then T(o)
  int* gs = reinterpret_cast<int*>(pt);                       // preamble: graph [N][N]
  float* al = reinterpret_cast<float*>(gs + kN * kN);         // alpha_raw [N][N]
  float* raw = al + kN * kN;                                  // adj @ alpha_raw [N][N]
  __shared__ float col_max[kN], col_sum[kN];

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t img = static_cast<size_t>(b) * kN * kN;
  for (int idx = tid; idx < kN * kN; idx += kThreads) {
    gs[idx] = graph[img + idx];
    al[idx] = to_f32(alpha[img + idx]);
  }
  __syncthreads();
  for (int idx = tid; idx < kK * kN; idx += kThreads) {
    const int k = idx / kN, i = idx % kN;
    float v = 0.f;
    if (k < kN) {
      v = gs[i * kN + k] != 0 ? 1.f : 0.f;
    } else if (k - kN < L) {
      int n = 0;
      for (int j = 0; j < kN; ++j) n += gs[i * kN + j] == k - kN;
      v = static_cast<float>(n);
    }
    mt[idx] = v;
  }
  for (int idx = tid; idx < kN * kN; idx += kThreads) {
    const int i = idx / kN, j = idx % kN;
    float s = 0.f;
    for (int k = 0; k < kN; ++k)
      if (gs[i * kN + k] != 0) s += al[k * kN + j];
    raw[idx] = s;
  }
  __syncthreads();
  // softmax over i for each column j, rounded to T: the column maxima, the
  // exponentials on all threads, the column sums, the quotients
  if (tid < kN) {
    float m = raw[tid];
    for (int i = 1; i < kN; ++i) m = fmaxf(m, raw[i * kN + tid]);
    col_max[tid] = m;
  }
  __syncthreads();
  for (int idx = tid; idx < kN * kN; idx += kThreads)
    raw[idx] = expf(raw[idx] - col_max[idx % kN]);
  __syncthreads();
  if (tid < kN) {
    float s = 0.f;
    for (int i = 0; i < kN; ++i) s += raw[i * kN + tid];
    col_sum[tid] = s;
  }
  __syncthreads();
  for (int idx = tid; idx < kN * kN; idx += kThreads) {
    const int i = idx / kN, j = idx % kN;
    at[j * kN + i] = round_to<T>(raw[idx] / col_sum[j]);
  }
  __syncthreads();   // the scratch is free for the tiles

  const int i0 = (tid / (kTile / 2)) * kRows;   // one warp, one row group:
  const int c0 = 2 * (tid % (kTile / 2));       // broadcast operand loads
  constexpr int kVec = 16 / sizeof(T);          // values of a 16-byte copy
  constexpr int kChunks = kTile / kVec;
  const int kn = kN + L;
  const size_t base = static_cast<size_t>(b) * kN * D;
  for (int d0 = 0; d0 < D; d0 += kTile) {
    // rows 0..N-1 proj and N..N+L-1 bias into pt, then N rows of out_self
    // into st; columns past D load as zeros
    for (int idx = tid; idx < (kn + kN) * kChunks; idx += kThreads) {
      const int r = idx / kChunks, col = d0 + (idx % kChunks) * kVec;
      const bool ok = col < D;
      const T* src;
      T* dst;
      if (r < kN) {
        src = proj + base + static_cast<size_t>(r) * D + col;
        dst = pt + r * kTile + col - d0;
      } else if (r < kn) {
        src = bias + static_cast<size_t>(r - kN) * D + col;
        dst = pt + r * kTile + col - d0;
      } else {
        src = out_self + base + static_cast<size_t>(r - kn) * D + col;
        dst = st + (r - kn) * kTile + col - d0;
      }
      cp_async16(dst, ok ? src : proj, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float acc[kRows][2], m[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 v = load2(st + (i0 + r) * kTile + c0);
      acc[r][0] = v.x, acc[r][1] = v.y;
    }
    for (int k = 0; k < kn; ++k) {
      const float2 p = load2(pt + k * kTile + c0);
      load12(m, mt + k * kN + i0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][0] = fmaf(m[r], p.x, acc[r][0]);
        acc[r][1] = fmaf(m[r], p.y, acc[r][1]);
      }
    }
    __syncthreads();   // every out_self row is read: T(o) takes its place
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      store2(st + (i0 + r) * kTile + c0, acc[r][0], acc[r][1]);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int j = 0; j < kN; ++j) {
      const float2 o = load2(st + j * kTile + c0);
      load12(m, at + j * kN + i0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][0] = fmaf(m[r], o.x, acc[r][0]);
        acc[r][1] = fmaf(m[r], o.y, acc[r][1]);
      }
    }
    if (d0 + c0 < D) {   // D % 8 == 0: both columns or neither
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        store2(out + base + static_cast<size_t>(i0 + r) * D + d0 + c0, acc[r][0], acc[r][1]);
    }
    __syncthreads();   // the tiles are read: the next step may overwrite them
  }
}

template <typename T>
int launch(const void* out_self, const void* proj, const void* alpha, const void* graph,
           const void* bias, void* out, int B, int D, int L, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      gcn_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gcn_chain_kernel<T><<<B, kThreads, bytes, stream>>>(
      static_cast<const T*>(out_self), static_cast<const T*>(proj),
      static_cast<const T*>(alpha), static_cast<const int*>(graph),
      static_cast<const T*>(bias), static_cast<T*>(out), D, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, 36, D] = the chain above; every float operand is bf16 when
// is_bf16, else f32; graph is int32; L <= 16; D % 8 == 0; the [B, 36, D]
// operands and bias contiguous and 16-byte aligned.
extern "C" int gcn_chain_forward(const void* out_self, const void* proj,
                                 const void* alpha, const void* graph,
                                 const void* bias, void* out, int B, int D,
                                 int L, int is_bf16, void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(out_self, proj, alpha, graph, bias, out, B, D, L, s)
                 : launch<float>(out_self, proj, alpha, graph, bias, out, B, D, L, s);
}
