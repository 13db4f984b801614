// Fused vocab head of the beam search: logits = h @ w^T + b streamed over
// the vocabulary, with an exact running top-k and an online logsumexp, so
// the [R, V] logits never reach device memory.
//
// Replaces: vqa_tpu/ops/pallas/vocab_topk.py vocab_topk_lse, called by every
// step of vqa_tpu/tools/beam.py with fused_vocab=True.
//
// What bounds it on an H100: at the serving shape (B=4096 images x k=3
// beams, so R = 12288 rows; H = 1024; V = 20000) one call is 2 R H V = 0.50
// TFLOP against 25 MB of h and 41 MB of w: compute-bound. The unfused form
// writes 0.49 GB of bf16 logits (or 0.98 GB in f32) and reads them back for
// the top-k and again for the logsumexp.
//
// Design: the GEMM of feed_gemm.cu (128 x 128 output tiles, mma.sync
// m16n8k16 bf16 with f32 accumulation, ldmatrix fragments, two cp.async
// stages over K in steps of 64), here with 8 warps of 32 rows x 64 columns.
// A block owns 128 rows of h and a contiguous range of vocabulary tiles.
// The reduction is the GEMM's epilogue, in registers: each thread keeps, for
// each of its 4 rows, a top-k sorted by (value desc, index asc) and an
// online (max, sum of exp) over the columns it holds. It sees its columns
// in increasing order, so a strict '>' keeps the lowest index among equal
// values, the tie rule of jnp.argmax / lax.top_k. The (tile, k-step) loop
// is flattened so the next tile's first loads fly during the epilogue. At
// the end the four threads of a quad merge by __shfl_xor, the two warps
// along N through shared memory, and the block writes one partial top-k
// and (max, sum) per row. The vocabulary is split over blocks to fill the
// card (96 row blocks alone at R = 12288 would leave SMs idle); a second
// small kernel merges the splits. Ragged R and V are masked, not padded:
// rows past R load as zeros and are not stored, columns past V take no
// part in either reduction. wgmma with TMA is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kTile = 128;               // rows of h, and vocab columns, per tile
constexpr int kTileK = 64;
constexpr int kLd = kTileK + 8;          // padded row: conflict-free ldmatrix
constexpr int kThreads = 256;            // 8 warps: 4 along M x 2 along N
constexpr int kWarpM = 32;
constexpr int kWarpN = 64;
constexpr int kMi = kWarpM / 16;         // m16 tiles per warp
constexpr int kNj = kWarpN / 8;          // n8 tiles per warp
constexpr int kRows = 2 * kMi;           // rows a thread holds accumulators of
constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;           // the TPU kernel's mask value
constexpr int kNoIndex = 0x7fffffff;

struct Stage {
  __nv_bfloat16 a[kTile * kLd];
  __nv_bfloat16 b[kTile * kLd];
};
constexpr int kSmem = 2 * sizeof(Stage);

template <int K>
struct RowState {
  float v[K];
  int i[K];
  float m, s;
};
static_assert(kTile * sizeof(RowState<kMaxK>) <= kSmem, "row states fit the stages");

// (v1, i1) ranks before (v2, i2): larger value, then lower index
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// insert (v, i) into the sorted list, which it must rank before the last of;
// branch-free with constant indices, so the lists stay in registers
template <int K>
__device__ __forceinline__ void insert(float (&tv)[K], int (&ti)[K], float v, int i) {
  bool above = true;   // (v, i) ranks before the old entry j
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const bool above_prev = j > 0 && better(v, i, tv[j > 0 ? j - 1 : 0], ti[j > 0 ? j - 1 : 0]);
    if (j > 0) {
      tv[j] = above ? (above_prev ? tv[j - 1] : v) : tv[j];
      ti[j] = above ? (above_prev ? ti[j - 1] : i) : ti[j];
    } else {
      tv[0] = above ? v : tv[0];
      ti[0] = above ? i : ti[0];
    }
    above = above_prev;
  }
}

template <int K>
__device__ __forceinline__ void merge_list(float (&tv)[K], int (&ti)[K], const float (&pv)[K],
                                           const int (&pi)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q)
    if (better(pv[q], pi[q], tv[K - 1], ti[K - 1])) insert<K>(tv, ti, pv[q], pi[q]);
}

// (m, s) <- the logsumexp state of the union of two column sets
__device__ __forceinline__ void merge_lse(float& m, float& s, float pm, float ps) {
  const float mn = fmaxf(m, pm);
  s = s * __expf(m - mn) + ps * __expf(pm - mn);
  m = mn;
}

// a [128, 64] tile of a K-contiguous [rows, H] bf16 matrix; rows past the end
// are zero-filled and not read
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int k0, int rows, int H, int tid) {
#pragma unroll
  for (int idx = tid; idx < kTile * (kTileK / 8); idx += kThreads) {
    const int r = idx / (kTileK / 8), q = idx % (kTileK / 8);
    const int gr = min(r0 + r, rows - 1);
    cp_async16(dst + r * kLd + q * 8, src + static_cast<size_t>(gr) * H + k0 + q * 8,
               r0 + r < rows);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
vocab_topk_kernel(const __nv_bfloat16* __restrict__ h,   // [R, H]
                  const __nv_bfloat16* __restrict__ w,   // [V, H]
                  const __nv_bfloat16* __restrict__ b,   // [V]
                  float* __restrict__ part_v,            // [splits, R, K]
                  int* __restrict__ part_i,              // [splits, R, K]
                  float2* __restrict__ part_ms,          // [splits, R]
                  int R, int H, int V, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stages = reinterpret_cast<Stage*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int warp_n = warp % (kTile / kWarpN);
  const int wm = (warp / (kTile / kWarpN)) * kWarpM, wn = warp_n * kWarpN;
  const int m0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (V + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  const int k_steps = H / kTileK;
  const int steps = (t1 - t0) * k_steps;

  float tv[kRows][K];
  int ti[kRows][K];
  float rm[kRows], rs[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      tv[r][q] = kNeg;
      ti[r][q] = kNoIndex;
    }
    rm[r] = kNeg;
    rs[r] = 0.f;
  }

  float acc[kMi][kNj][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNj; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (steps > 0) {
    copy_tile(stages[0].a, h, m0, 0, R, H, tid);
    copy_tile(stages[0].b, w, t0 * kTile, 0, V, H, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const int kt = step % k_steps;
    const int n0 = (t0 + step / k_steps) * kTile;
    if (step + 1 < steps) {
      const int nk = ((step + 1) % k_steps) * kTileK;
      const int nn = (t0 + (step + 1) / k_steps) * kTile;
      copy_tile(stages[cur ^ 1].a, h, m0, nk, R, H, tid);
      copy_tile(stages[cur ^ 1].b, w, nn, nk, V, H, tid);
      cp_async_commit();
    }
    const Stage& s = stages[cur];
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a[kMi][4], bf[kNj / 2][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i) load_a_frag<kLd>(a[i], s.a, wm + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < kNj / 2; ++j) load_b_frag2<kLd>(bf[j], s.b, wn + j * 16, kk, lane);
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNj; ++j) mma_bf16_16816(acc[i][j], a[i], bf[j / 2] + 2 * (j % 2));
    }

    if (kt == k_steps - 1) {
      // epilogue of one [128, 128] logits tile, in registers
      float bias[kNj][2];
#pragma unroll
      for (int j = 0; j < kNj; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + 2 * c + e;
          bias[j][e] = col < V ? __bfloat162float(b[col]) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 2 * i + hh;
          float lmax = kNeg;
#pragma unroll
          for (int j = 0; j < kNj; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + wn + j * 8 + 2 * c + e;
              const float x = col < V ? acc[i][j][2 * hh + e] + bias[j][e] : kNeg;
              acc[i][j][2 * hh + e] = x;
              lmax = fmaxf(lmax, x);
            }
          const float mn = fmaxf(rm[r], lmax);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kNj; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + wn + j * 8 + 2 * c + e;
              sum += col < V ? __expf(acc[i][j][2 * hh + e] - mn) : 0.f;
            }
          rs[r] = rs[r] * __expf(rm[r] - mn) + sum;
          rm[r] = mn;
          // columns in increasing order: '>' keeps the lowest index of a tie
#pragma unroll
          for (int j = 0; j < kNj; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = acc[i][j][2 * hh + e];
              if (x > tv[r][K - 1]) insert<K>(tv[r], ti[r], x, n0 + wn + j * 8 + 2 * c + e);
            }
        }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNj; ++j)
          acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // merge the four threads of a quad (same rows, other columns)
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float pv[K];
      int pi[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        pv[q] = __shfl_xor_sync(0xffffffffu, tv[r][q], off);
        pi[q] = __shfl_xor_sync(0xffffffffu, ti[r][q], off);
      }
      const float pm = __shfl_xor_sync(0xffffffffu, rm[r], off);
      const float ps = __shfl_xor_sync(0xffffffffu, rs[r], off);
      merge_list<K>(tv[r], ti[r], pv, pi);
      merge_lse(rm[r], rs[r], pm, ps);
    }

  // then the two warps along N, through shared memory (the stages are idle:
  // the loop ended on a barrier with no copy in flight)
  RowState<K>* states = reinterpret_cast<RowState<K>*>(smem);
  if (warp_n == 1 && c == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      RowState<K>& st = states[wm + (r / 2) * 16 + g + (r % 2) * 8];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        st.v[q] = tv[r][q];
        st.i[q] = ti[r][q];
      }
      st.m = rm[r];
      st.s = rs[r];
    }
  }
  __syncthreads();
  if (warp_n == 0 && c == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row_local = wm + (r / 2) * 16 + g + (r % 2) * 8;
      const int row = m0 + row_local;
      if (row >= R) continue;
      const RowState<K>& st = states[row_local];
      float pv[K];
      int pi[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        pv[q] = st.v[q];
        pi[q] = st.i[q];
      }
      merge_list<K>(tv[r], ti[r], pv, pi);
      merge_lse(rm[r], rs[r], st.m, st.s);
      const size_t base = static_cast<size_t>(split) * R + row;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        part_v[base * K + q] = tv[r][q];
        part_i[base * K + q] = ti[r][q];
      }
      part_ms[base] = make_float2(rm[r], rs[r]);
    }
  }
}

// one thread per row: merge the splits' partial top-k and (max, sum)
template <int K>
__global__ void vocab_topk_merge_kernel(const float* __restrict__ part_v,
                                        const int* __restrict__ part_i,
                                        const float2* __restrict__ part_ms,
                                        float* __restrict__ vals, int* __restrict__ idx,
                                        float* __restrict__ lse, int R, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float tv[K];
  int ti[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    tv[q] = kNeg;
    ti[q] = kNoIndex;
  }
  float m = kNeg, s = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t base = static_cast<size_t>(sp) * R + row;
    float pv[K];
    int pi[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      pv[q] = part_v[base * K + q];
      pi[q] = part_i[base * K + q];
    }
    merge_list<K>(tv, ti, pv, pi);
    const float2 ms = part_ms[base];
    merge_lse(m, s, ms.x, ms.y);
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vals[static_cast<size_t>(row) * K + q] = tv[q];
    idx[static_cast<size_t>(row) * K + q] = ti[q];
  }
  lse[row] = m + logf(s);
}

template <int K>
cudaError_t launch_k(const void* h, const void* w, const void* b, void* part_v, void* part_i,
                     void* part_ms, void* vals, void* idx, void* lse, int R, int H, int V,
                     int tiles_per_split, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vocab_topk_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + kTile - 1) / kTile;
  const int splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid((R + kTile - 1) / kTile, splits);
  vocab_topk_kernel<K><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float2*>(part_ms), R, H, V, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vocab_topk_merge_kernel<K><<<(R + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float2*>(part_ms), static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), R, splits);
  return cudaGetLastError();
}

template <int K>
cudaError_t blocks_per_sm(int* out) {
  cudaError_t err = cudaFuncSetAttribute(vocab_topk_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, vocab_topk_kernel<K>, kThreads,
                                                       kSmem);
}

cudaError_t occupancy(int k, int* out) {
  switch (k) {
    case 1: return blocks_per_sm<1>(out);
    case 2: return blocks_per_sm<2>(out);
    case 3: return blocks_per_sm<3>(out);
    case 4: return blocks_per_sm<4>(out);
    case 5: return blocks_per_sm<5>(out);
    case 6: return blocks_per_sm<6>(out);
    case 7: return blocks_per_sm<7>(out);
    case 8: return blocks_per_sm<8>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// How many vocabulary tiles each block sweeps, chosen so that the grid of
// (row blocks x vocabulary splits) fills whole waves of the card's SMs with
// as little idle tile time as possible; writes it to *tiles_per_split. The
// number of splits is ceil(ceil(V / 128) / tiles_per_split).
extern "C" int vocab_topk_lse_plan(int R, int V, int k, int* tiles_per_split) {
  if (R <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = occupancy(k, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long slots = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
  const long row_blocks = (R + kTile - 1) / kTile;
  const int n_tiles = (V + kTile - 1) / kTile;
  int best = n_tiles;
  double best_score = -1.0;
  for (int want = 1; want <= n_tiles && want <= 64; ++want) {
    const int tps = (n_tiles + want - 1) / want;
    const int splits = (n_tiles + tps - 1) / tps;
    if (splits != want) continue;
    const long waves = (row_blocks * splits + slots - 1) / slots;
    // useful tile sweeps over the time the waves take, counting a block's
    // first loads and final merges as about one tile sweep
    const double score = static_cast<double>(row_blocks) * n_tiles /
                         (static_cast<double>(waves) * slots * (tps + 1));
    if (score > best_score) {
      best_score = score;
      best = tps;
    }
  }
  *tiles_per_split = best;
  return static_cast<int>(cudaSuccess);
}

// vals [R, k] f32, idx [R, k] int32 and lse [R] f32 of logits = h @ w^T + b,
// h [R, H], w [V, H], b [V] bf16, through the partial buffers part_v
// [splits, R, k] f32, part_i [splits, R, k] int32 and part_ms [splits, R, 2]
// f32. Requires 1 <= k <= 8, H % 64 == 0, V >= k and 16-byte aligned,
// contiguous operands.
extern "C" int vocab_topk_lse_forward(const void* h, const void* w, const void* b,
                                      void* part_v, void* part_i, void* part_ms, void* vals,
                                      void* idx, void* lse, int R, int H, int V, int k,
                                      int tiles_per_split, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (H <= 0 || H % kTileK || V < k || tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOCAB_TOPK_LAUNCH(K) \
  static_cast<int>(launch_k<K>(h, w, b, part_v, part_i, part_ms, vals, idx, lse, R, H, V, \
                               tiles_per_split, s))
  switch (k) {
    case 1: return VOCAB_TOPK_LAUNCH(1);
    case 2: return VOCAB_TOPK_LAUNCH(2);
    case 3: return VOCAB_TOPK_LAUNCH(3);
    case 4: return VOCAB_TOPK_LAUNCH(4);
    case 5: return VOCAB_TOPK_LAUNCH(5);
    case 6: return VOCAB_TOPK_LAUNCH(6);
    case 7: return VOCAB_TOPK_LAUNCH(7);
    case 8: return VOCAB_TOPK_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOCAB_TOPK_LAUNCH
}
