// Fused vocab head of the beam search: logits = h @ w^T + b streamed over
// the vocabulary, with an exact running top-k and an online logsumexp, so
// the [R, V] logits never reach device memory.
//
// Replaces: vqa_tpu/ops/pallas/vocab_topk.py vocab_topk_lse, called by every
// step of vqa_tpu/tools/beam.py with fused_vocab=True.
//
// What bounds it on an H100: at the serving shape (B=4096 images x k=3
// beams, so R = 12288 rows; H = 1024; V = 20000) one call is 2 R H V = 0.50
// TFLOP, 0.51 ms at the 989 TFLOP/s bf16 tensor-core peak, against 25 MB of
// h and 41 MB of w: bound by operations. Beside the product, every logit
// takes a bias add, a mask, a max, an exp (on the special-function units,
// far slower than the tensor cores) and a compare with the running k-th
// value; if that epilogue ran between tiles on the warps that issue the
// products, the tensor cores would idle through it. The
// unfused form writes 0.49 GB of bf16 logits and reads them back for the
// top-k and again for the logsumexp.
//
// Design (hopper.cuh's primitives): the consumer warpgroups ping-pong.
// Work is cut into units of (128-row band of h, split of the vocabulary),
// split-major, so that the blocks running at one time sweep the same few
// MB of w while all of h (25 MB) stays in L2 and w is read from HBM about
// once. A persistent grid walks the units; a block takes them in pairs, one
// a consumer warpgroup, and interleaves their 128 x 128 logit tiles (128
// rows of h against 128 vocabulary rows of w, K in 64-deep stages of 2 x 16
// KB) in one 6-stage mbarrier ring that one producer thread fills by TMA
// (128-byte swizzle, zero-fill past R, V and H). So while one warpgroup's
// wgmma m64n128k16 bf16 -> f32 (two a k16 step: both 64-row halves against
// the stage's w) run on a tile, the other runs the previous tile's
// epilogue in registers. A pair of named barriers makes them take turns:
// a warpgroup starts a tile's products once the other has issued all of
// its previous tile's (which also keeps it from waiting on a stage's
// barrier a whole ring phase early). Each keeps one wgmma group in flight
// and hands a stage back when the next group's wait shows it retired. The
// epilogue works from the wgmma accumulator layout: a thread holds 4 rows x
// 32 columns of a tile and keeps, per row, a top-k sorted by (value desc,
// index asc) and an online (max, sum of exp). It visits its columns in
// increasing order, so a strict '>' keeps the lowest index among equal
// values, the tie rule of lax.top_k. Columns past V are -inf: no part of
// either reduction. At a unit's end the four threads of a quad merge by
// __shfl_xor, and one writes the unit's partial top-k and (max, sum) per
// row; a second small kernel merges the splits, always with index
// tie-breaks. The split count comes from the wrapper's plan
// (vocab_topk.py _plan). setmaxnreg moves registers from the producer's
// warpgroup to the consumers (128 f32 sums and 4 rows of state each; from
// k = 6 the state spills to local memory).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTileR = 128;              // rows of h a tile: two wgmma M halves
constexpr int kTileV = 128;              // vocabulary rows of w a tile: wgmma N
constexpr int kTileK = 64;               // K of a stage: one swizzled 128-byte row
constexpr int kStages = 6;
constexpr int kThreads = 384;            // 2 consumer warpgroups + the producer's
constexpr int kHBytes = kTileR * kTileK * 2;
constexpr int kWBytes = kTileV * kTileK * 2;
constexpr int kStageBytes = kHBytes + kWBytes;
// the ring (1024-byte aligned for the swizzle), then the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kSmem <= 232448, "the ring fits the card's 227 KB a block");
constexpr float kNeg = -1e30f;           // the TPU kernel's mask value
constexpr int kNoIndex = 0x7fffffff;

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

// the running reduction of one row of a thread
template <int K>
struct RowState {
  float v[K];
  int i[K];
  float m, s;
};

template <int K>
__device__ __forceinline__ void reset(RowState<K>& st) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    st.v[q] = kNeg;
    st.i[q] = kNoIndex;
  }
  st.m = kNeg;
  st.s = 0.f;
}

// One 64-row half of a logit tile, from its accumulator: rows 16 warp + g
// (row state a) and + 8 (row state b), columns n0 + 8j + 2c (+1). Adds the
// bias, masks columns past V to -inf, and folds the 32 columns of each row
// into its state.
template <int K>
__device__ __forceinline__ void fold_half(float (&acc)[64], RowState<K>& a, RowState<K>& b,
                                         const __nv_bfloat16* __restrict__ bias, int n0, int c,
                                         int V) {
  float lmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * c;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = col + e < V;
      const float bv = ok ? __bfloat162float(bias[col + e]) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float x = ok ? acc[4 * j + 2 * hh + e] + bv : -INFINITY;
        acc[4 * j + 2 * hh + e] = x;
        lmax[hh] = fmaxf(lmax[hh], x);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    RowState<K>& st = hh ? b : a;
    // st.m starts at the finite kNeg, so mn is finite and a -inf column
    // adds exp(-inf) = 0
    const float mn = fmaxf(st.m, lmax[hh]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = acc[4 * j + 2 * hh + e];
        sum += __expf(x - mn);
        // columns in increasing order: '>' keeps the lowest index of a tie
        if (x > st.v[K - 1]) insert<K>(st.v, st.i, x, n0 + 8 * j + 2 * c + e);
      }
    st.s = st.s * __expf(st.m - mn) + sum;
    st.m = mn;
  }
}

// the quad's four states of one row merged into every lane's
template <int K>
__device__ __forceinline__ void merge_quad(RowState<K>& st) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    float pv[K];
    int pi[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      pv[q] = __shfl_xor_sync(0xffffffffu, st.v[q], off);
      pi[q] = __shfl_xor_sync(0xffffffffu, st.i[q], off);
    }
    const float pm = __shfl_xor_sync(0xffffffffu, st.m, off);
    const float ps = __shfl_xor_sync(0xffffffffu, st.s, off);
    merge_list<K>(st.v, st.i, pv, pi);
    merge_lse(st.m, st.s, pm, ps);
  }
}

// The units a block takes, in pairs (2p for warpgroup 0, 2p + 1 for 1):
// unit u is (split u / bands, band u % bands), tiles [t0, t0 + nt) of the
// vocabulary. nt is 0 past the last unit.
struct Unit {
  int m0, t0, nt;
};

__device__ __forceinline__ Unit unit_of(int u, int units, int bands, int n_tiles, int tps) {
  Unit x{0, 0, 0};
  if (u < units) {
    const int split = u / bands;
    x.m0 = (u % bands) * kTileR;
    x.t0 = split * tps;
    x.nt = min(n_tiles - x.t0, tps);
  }
  return x;
}

// The owner (0 or 1) of the ring's tile after a pair's tile (j, cw), or -1
// at the end: the pair's tiles alternate while both units have some, then
// the longer unit's follow, then the next pair's (its first is 0's).
__device__ __forceinline__ int next_owner(int j, int cw, int nt0, int nt1, bool next_pair) {
  if (cw == 0 && j < nt1) return 1;
  if (j + 1 < nt0) return 0;
  if (j + 1 < nt1) return 1;
  return next_pair ? 0 : -1;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
vocab_topk_kernel(const __grid_constant__ CUtensorMap h_map,   // [R, H] bf16
                  const __grid_constant__ CUtensorMap w_map,   // [V, H] bf16
                  const __nv_bfloat16* __restrict__ b,         // [V]
                  float* __restrict__ part_v,                  // [splits, R, K]
                  int* __restrict__ part_i,                    // [splits, R, K]
                  float2* __restrict__ part_ms,                // [splits, R]
                  int R, int H, int V, int tps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int bands = (R + kTileR - 1) / kTileR;
  const int n_tiles = (V + kTileV - 1) / kTileV;
  const int splits = (n_tiles + tps - 1) / tps;
  const int units = bands * splits;
  const int k_tiles = (H + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 1);     // the consuming warpgroup's arrival
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread fills the ring, the two units' tiles in turn ----
    setmaxnreg_dec<40>();
    if (tid == 256) {
      tma_prefetch_map(&h_map);
      tma_prefetch_map(&w_map);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += 2 * gridDim.x) {
        const Unit x0 = unit_of(u, units, bands, n_tiles, tps);
        const Unit x1 = unit_of(u + gridDim.x, units, bands, n_tiles, tps);
        for (int j = 0; j < max(x0.nt, x1.nt); ++j)
          for (int cw = 0; cw < 2; ++cw) {
            const Unit x = cw ? x1 : x0;
            if (j >= x.nt) continue;
            const int v0 = (x.t0 + j) * kTileV;
            for (int kt = 0; kt < k_tiles; ++kt, ++it) {
              const int s = it % kStages;
              mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
              mbar_arrive_expect_tx(&full[s], kStageBytes);
              unsigned char* st = ring + s * kStageBytes;
              tma_load_2d(st, &h_map, &full[s], kt * kTileK, x.m0);
              tma_load_2d(st + kHBytes, &w_map, &full[s], kt * kTileK, v0);
            }
          }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes the even or odd unit of each pair ----
    setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int g = lane >> 2, c = lane & 3;
    float acc0[64], acc1[64];
    RowState<K> rows[4];   // rows 16 warp + g + {0, 8, 64, 72} of the band
    int it = 0, last = -1;   // ring position; the owner of the ring's last tile
    for (int u = blockIdx.x; u < units; u += 2 * gridDim.x) {
      const Unit x0 = unit_of(u, units, bands, n_tiles, tps);
      const Unit x1 = unit_of(u + gridDim.x, units, bands, n_tiles, tps);
      const Unit mine = wg ? x1 : x0;
      const bool next_pair = u + 2 * gridDim.x < units;
#pragma unroll
      for (int r = 0; r < 4; ++r) reset<K>(rows[r]);
      for (int j = 0; j < max(x0.nt, x1.nt); ++j)
        for (int cw = 0; cw < 2; ++cw) {
          if (j >= (cw ? x1.nt : x0.nt)) continue;
          const int prev = last;
          last = cw;
          if (cw != wg) {
            it += k_tiles;   // the other warpgroup's tile
            continue;
          }
          // Ping-pong: the products of one tile start once the other
          // warpgroup has issued all of its previous tile's, so that the
          // two take turns on the tensor cores and each one's epilogue
          // overlaps the other's products. It also keeps a warpgroup from
          // waiting on a stage's barrier a whole phase early: the stages of
          // the tile before it have all been waited for.
          if (prev >= 0 && prev != wg) named_barrier(1 + wg, 256);
          for (int kt = 0; kt < k_tiles; ++kt, ++it) {
            const int s = it % kStages;
            mbar_wait(&full[s], (it / kStages) & 1);
            const unsigned char* st = ring + s * kStageBytes;
            const uint64_t da0 = sw128_desc(st), da1 = sw128_desc(st + 64 * 128);
            const uint64_t db = sw128_desc(st + kHBytes);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kTileK / 16; ++kk) {
              // +2 in the descriptor's 16-byte units = 16 bf16 further along K
              wgmma_m64n128k16_bf16(acc0, da0 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
              wgmma_m64n128k16_bf16(acc1, da1 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
            }
            wgmma_commit();
            // one group stays in flight; the one before it has retired, so
            // its stage goes back to the producer
            wgmma_wait<1>();
            if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);
          }
          const int next = next_owner(j, cw, x0.nt, x1.nt, next_pair);
          if (next >= 0 && next != wg) named_barrier_arrive(1 + next, 256);
          wgmma_wait<0>();
          if ((tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);
          fence_operands(acc0);
          fence_operands(acc1);
          // the epilogue, while the other warpgroup's wgmma run
          const int v0 = (mine.t0 + j) * kTileV;
          fold_half<K>(acc0, rows[0], rows[1], b, v0, c, V);
          fold_half<K>(acc1, rows[2], rows[3], b, v0, c, V);
        }
      if (mine.nt == 0) continue;
      const int split = mine.t0 / tps;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        merge_quad<K>(rows[r]);
        const int row = mine.m0 + (r / 2) * 64 + warp * 16 + g + (r % 2) * 8;
        if (c != 0 || row >= R) continue;
        const size_t base = static_cast<size_t>(split) * R + row;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          part_v[base * K + q] = rows[r].v[q];
          part_i[base * K + q] = rows[r].i[q];
        }
        part_ms[base] = make_float2(rows[r].m, rows[r].s);
      }
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
cudaError_t launch_k(const CUtensorMap& h_map, const CUtensorMap& w_map, const void* b,
                     void* part_v, void* part_i, void* part_ms, void* vals, void* idx,
                     void* lse, int R, int H, int V, int tps, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vocab_topk_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  vocab_topk_kernel<K><<<grid, kThreads, kSmem, stream>>>(
      h_map, w_map, static_cast<const __nv_bfloat16*>(b), static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float2*>(part_ms), R, H, V, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + kTileV - 1) / kTileV;
  vocab_topk_merge_kernel<K><<<(R + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float2*>(part_ms), static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), R, (n_tiles + tps - 1) / tps);
  return cudaGetLastError();
}

}  // namespace

// vals [R, k] f32, idx [R, k] int32 and lse [R] f32 of logits = h @ w^T + b,
// h [R, H], w [V, H], b [V] bf16, through the partial buffers part_v
// [splits, R, k] f32, part_i [splits, R, k] int32 and part_ms [splits, R, 2]
// f32, where splits = ceil(ceil(V / 128) / tiles_per_split), on `grid`
// persistent blocks (the wrapper's plan). Requires 1 <= k <= 8, H % 8 == 0
// (16-byte rows for TMA), V >= k and 16-byte aligned, contiguous operands.
extern "C" int vocab_topk_lse_forward(const void* h, const void* w, const void* b,
                                      void* part_v, void* part_i, void* part_ms, void* vals,
                                      void* idx, void* lse, int R, int H, int V, int k,
                                      int tiles_per_split, int grid, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (H <= 0 || H % 8 || V < k || tiles_per_split <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap h_map, w_map;
  const uint64_t h_dims[2] = {uint64_t(H), uint64_t(R)}, w_dims[2] = {uint64_t(H), uint64_t(V)};
  const uint64_t strides[1] = {uint64_t(H) * 2};
  const uint32_t h_box[2] = {kTileK, kTileR}, w_box[2] = {kTileK, kTileV};
  cudaError_t err = make_tensor_map(&h_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, h_dims,
                                    strides, h_box);
  if (err == cudaSuccess)
    err = make_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, strides, w_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOCAB_TOPK_LAUNCH(K)                                                              \
  static_cast<int>(launch_k<K>(h_map, w_map, b, part_v, part_i, part_ms, vals, idx, lse, R, \
                               H, V, tiles_per_split, grid, s))
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
