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
// one-hot label sum does. The TPU kernel packs 8 images block-diagonally to
// fill its 128 x 128 MXU; on this card that would only multiply zeros.
//
// What bounds it on an H100: bytes. At B=8192, D=2048 in bf16 it moves 3.69
// GB (out_self, proj and out, each [B, 36, 2048], plus alpha_raw and
// graph): 1.10 ms at 3.35 TB/s. Its products are 50.7 G multiply-adds; on
// the tensor cores, padded to 48 rows and depths of 64 and 48, about 0.2 ms
// at the bf16 peak, so the bytes bound it. (The first design ran them as
// f32 FMAs, 1.5 ms at the f32 peak, and took 3.66 ms.)
//
// Design (bf16). A persistent grid, one block an SM (gcn_chain.py _plan),
// walks (image, 64-column D tile) items: block i takes the images
// i / groups + (grid / groups) q and the tiles of its column group
// i % groups (one group while D <= 2048). In a block:
// - a producer thread issues TMA loads of each item's proj and out_self
//   boxes ([36 rows, 64 columns], 128-byte swizzle) into an mbarrier ring
//   of up to 8 stages; each slot is 48 rows (a whole number of the
//   swizzle's 8-row periods), rows 36-47 zeroed once and never written;
// - two builder warps make the next image's operands while this image's
//   tiles stream: A1 = [adj | 0 | counts] as bf16 [48, 64] (bias in its own
//   16-deep k step; the label counts four labels a compare) and A2 = the
//   softmaxed aa as bf16 [48, 48] (adj @ alpha_raw on the tensor cores, the
//   softmax over i in registers and shuffles), both zero-padded,
//   double-buffered, handed over on mbarriers; all of an image's graph and
//   alpha_raw loads are issued at once;
// - eight consumer warps hold the image's A1 fragments in registers (48
//   registers, loaded once an image; A2's are read each item) and work in
//   four pairs, each pair on its own item (items pr, pr + 4, ...), so four
//   items' dependent product chains overlap; a warp takes 32 columns:
//   o = its out_self fragments + 4
//   mma.sync.m16n8k16 k steps (B by ldmatrix.trans from the proj slot and
//   from the block's resident bias tile, 16 rows x 64 columns a tile,
//   loaded once per kernel), T(o) written over its out_self columns, out =
//   3 k steps over them; each stage goes back as soon as it is read;
// - out is staged in shared memory (a swizzled tile a pair) and written
//   by one TMA store a tile, which overlaps the pair's next item.
// The ring's depth is a multiple of 4, so that a stage always serves the
// same pair, in order: a parity wait never meets a phase two ahead.
// mma.sync rather than wgmma: wgmma's 64-row tile would need two images
// packed block-diagonally and waste 44% of it, and the tensor work is a
// fifth of the bytes' time.
//
// f32 (no model path runs the chain in f32) keeps the first design: one
// block an image, f32 FMAs on the CUDA cores (no TF32), cp.async tiles of
// 128 columns.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): bf16
// 1.3443 ms at B=8192, D=2048 (82% of the byte bound; the first design
// 3.66) and 0.1027 ms at B=512 (67%).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kN = 36;                   // boxes per image: the kernels are built for 36
constexpr int kMaxL = 16;                // labels: 12 spatial, 15 semantic

// ---- f32: the first design, on the CUDA cores ------------------------------

constexpr int kK = kN + kMaxL;           // rows of the first product's operands
constexpr int kTile = 128;               // columns of D per step
constexpr int kRows = 12;                // rows of an image per thread
constexpr int kThreads = (kN / kRows) * (kTile / 2);   // 192: 12 rows x 2 columns each

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x rounded to T and back: the cast to the model type between the steps
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// two neighbouring values of T as floats, and back
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

// ---- bf16: tensor cores behind a TMA ring ------------------------------------

constexpr int kDT = 64;                        // columns of a D tile: one 128-byte row
constexpr int kRowsP = 48;                     // rows of a slot: 36 + 12 zero rows
constexpr int kSlotBytes = kRowsP * 128;       // 6144, whole 1024-byte swizzle periods
constexpr int kStageBytes = 2 * kSlotBytes;    // proj, out_self
constexpr int kBoxBytes = kN * kDT * 2;        // what one TMA box moves
constexpr int kBiasTileBytes = 16 * 128;       // 16 label rows of a tile
constexpr int kOpBytes = 2 * kSlotBytes;       // A1 [48][64], A2 [48][64 (48 used)]
constexpr int kOutBytes = 5 * 1024;            // 36 rows of 128 bytes, padded
constexpr int kPairs = 4;                      // consumer warp pairs, each on its own item
constexpr int kOutBufs = kPairs;               // staged out tiles, one a pair
constexpr int kATileBytes = kSlotBytes;        // the builders' alpha_raw B tile [48][64]
constexpr int kLabelBytes = kN * kN;           // the builders' labels [36][36] as bytes
constexpr int kConsumerWarps = 8, kBuilderWarps = 2;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kBuilders = kBuilderWarps * 32;
constexpr int kChainThreads = kConsumers + 32 + kBuilders;   // 352
constexpr int kPerBuilder = (kN * kN + kBuilders - 1) / kBuilders;   // 21 labels and alphas

struct ChainPlan {
  int groups, tiles_per_group, stages;
};

size_t chain_smem(const ChainPlan& pl) {
  return 1024 + size_t(pl.stages) * kStageBytes + size_t(pl.tiles_per_group) * kBiasTileBytes +
         2 * kOpBytes + kOutBufs * kOutBytes + kATileBytes + kLabelBytes +
         (2 * size_t(pl.stages) + 4) * 8;
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 1024-aligned tile
// of 128-byte rows, as the 128-byte swizzle places it
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) { return pack_bf16x2(lo, hi); }

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const unsigned char* p) {
  ldmatrix_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

__global__ void __launch_bounds__(kChainThreads, 1)
gcn_chain_bf16_kernel(const __grid_constant__ CUtensorMap self_map,   // [B * 36, D]
                      const __grid_constant__ CUtensorMap proj_map,   // [B * 36, D]
                      const __grid_constant__ CUtensorMap out_map,    // [B * 36, D]
                      const __nv_bfloat16* __restrict__ alpha,        // [B, N, N]
                      const int* __restrict__ graph,                  // [B, N, N]
                      const __nv_bfloat16* __restrict__ bias,         // [L, D]
                      int B, int D, int L, ChainPlan pl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_smem<1024>(smem_raw);
  const int S = pl.stages, TPG = pl.tiles_per_group, G = pl.groups;
  unsigned char* bias_s = ring + S * kStageBytes;
  unsigned char* ops = bias_s + TPG * kBiasTileBytes;   // [2]: A1, A2
  unsigned char* outs = ops + 2 * kOpBytes;             // [kOutBufs] staged out tiles
  unsigned char* atile = outs + kOutBufs * kOutBytes;   // alpha_raw [k][j], zero-padded
  unsigned char* labels = atile + kATileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(labels + kLabelBytes);
  uint64_t* empty = full + S;
  uint64_t* opfull = empty + S;
  uint64_t* opempty = opfull + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = blockIdx.x % G, per_group = gridDim.x / G, img0 = blockIdx.x / G;
  const int n_tiles = (D + kDT - 1) / kDT;
  const int t0 = group * TPG, t1 = min(n_tiles, t0 + TPG);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2);                // one arrival from each warp of its pair
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(&opfull[p], 1);               // the builders, once the operands are made
      mbar_init(&opempty[p], kConsumerWarps); // each consumer warp, done with the image
    }
    mbar_init_fence();
  }
  // the operand buffers and the alpha_raw tile start zero: their padded
  // rows and columns are never written again
  for (int idx = tid; idx < (2 * kOpBytes + kATileBytes) / 16; idx += kChainThreads) {
    unsigned char* dst = idx < 2 * kOpBytes / 16 ? ops + idx * 16 : atile + idx * 16 - 2 * kOpBytes;
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  // rows 36-47 of every slot are zero for the whole kernel: the padded
  // rows of both products' B operands (0 x NaN would be NaN)
  constexpr int kPadChunks = (kRowsP - kN) * 8;   // 16-byte chunks of rows 36-47
  for (int idx = tid; idx < 2 * S * kPadChunks; idx += kChainThreads) {
    unsigned char* slot = ring + (idx / kPadChunks) * kSlotBytes;
    *reinterpret_cast<uint4*>(slot + kN * 128 + (idx % kPadChunks) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  // the column group's bias tiles, resident: rows >= L and columns >= D zero
  for (int idx = tid; idx < TPG * 16 * 8; idx += kChainThreads) {
    const int tt = idx >> 7, r = (idx >> 3) & 15, ch = idx & 7;
    const int c = (t0 + tt) * kDT + ch * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < L && c < D) v = *reinterpret_cast<const uint4*>(bias + size_t(r) * D + c);
    *reinterpret_cast<uint4*>(bias_s + tt * kBiasTileBytes + swz(r, ch)) = v;
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      tma_prefetch_map(&self_map);
      tma_prefetch_map(&proj_map);
      int it = 0;
      for (int b = img0; b < B; b += per_group) {
        for (int t = t0; t < t1; ++t, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * kBoxBytes);
          unsigned char* st = ring + s * kStageBytes;
          tma_load_2d(st, &proj_map, &full[s], t * kDT, b * kN);
          tma_load_2d(st + kSlotBytes, &self_map, &full[s], t * kDT, b * kN);
        }
      }
    }
    return;
  }

  if (warp > kConsumerWarps) {
    // ---- builders: the next image's A1 and A2, while this one streams ----
    const int bw = warp - kConsumerWarps - 1, bt = tid - kConsumers - 32;
    const int g = lane >> 2, c = lane & 3;
    const int a_row = lane & 15, a_ch = lane >> 4;
    const int b_row2 = 8 * ((lane >> 3) & 1) + (lane & 7);
    int q = 0;
    for (int b = img0; b < B; b += per_group, ++q) {
      const int p = q & 1;
      mbar_wait(&opempty[p], ((q >> 1) & 1) ^ 1);
      unsigned char* a1 = ops + p * kOpBytes;
      unsigned char* a2 = a1 + kSlotBytes;
      const int* gimg = graph + size_t(b) * kN * kN;
      const __nv_bfloat16* aimg = alpha + size_t(b) * kN * kN;
      // every load of the image at once: the labels as bytes [i][j] (4 a
      // word), alpha_raw into the [k][j] B tile of adj @ alpha_raw
      int lab[kPerBuilder];
      __nv_bfloat16 av[kPerBuilder];
#pragma unroll
      for (int m = 0; m < kPerBuilder; ++m) {
        const int idx = bt + kBuilders * m;
        lab[m] = idx < kN * kN ? gimg[idx] : 0;
        av[m] = idx < kN * kN ? aimg[idx] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int m = 0; m < kPerBuilder; ++m) {
        const int idx = bt + kBuilders * m;
        if (idx < kN * kN) {
          const int k = idx / kN, j = idx % kN;
          labels[idx] = static_cast<unsigned char>(lab[m]);
          *reinterpret_cast<__nv_bfloat16*>(atile + swz(k, j >> 3) + (j & 7) * 2) = av[m];
        }
      }
      named_barrier(1 + kPairs, kBuilders);
      // A1 row i, chunk ch (task ch * 36 + i, so that the count chunks
      // spread over the threads): k < 36 adj, 36..47 zero, 48 + l the count
      // of label l (four labels a word compared at once); rows 36-47 stay
      // zero
      for (int task = bt; task < kN * 8; task += kBuilders) {
        const int i = task % kN, ch = task / kN;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(labels + i * kN);
        float v[8];
        if (ch < 5) {
          const uint32_t w0 = row[2 * ch], w1 = ch < 4 ? row[2 * ch + 1] : 0u;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (((e < 4 ? w0 : w1) >> (8 * (e & 3))) & 0xFFu) != 0 ? 1.f : 0.f;
        } else {
          uint32_t w[kN / 4];
#pragma unroll
          for (int x = 0; x < kN / 4; ++x) w[x] = row[x];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int l = 8 * (ch - 6) + e;
            int n = 0;
#pragma unroll
            for (int x = 0; x < kN / 4; ++x) n += __popc(__vcmpeq4(w[x], l * 0x01010101u));
            v[e] = ch >= 6 && l < L ? static_cast<float>(n >> 3) : 0.f;
          }
        }
        *reinterpret_cast<uint4*>(a1 + swz(i, ch)) = make_uint4(
            pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
      named_barrier(1 + kPairs, kBuilders);
      // raw = adj @ alpha_raw on the tensor cores: this warp's 24 columns
      // (n tiles 3 bw .. 3 bw + 2), 48 rows, depth 48 (36 real)
      float raw[3][3][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) raw[mt][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        uint32_t af[3][4];
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) ldsm_x4(af[mt], a1 + swz(16 * mt + a_row, 2 * ks + a_ch));
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, atile + swz(16 * ks + b_row2, 3 * bw + nt));
#pragma unroll
          for (int mt = 0; mt < 3; ++mt) mma_bf16_16816(raw[mt][nt], af[mt], bb);
        }
      }
      // softmax over i of each column j < 36 (rows 16 mt + g + 8 h of this
      // lane, the other g by shuffles), rounded to bf16 into A2; rows and
      // columns past 36 zero
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = 8 * (3 * bw + nt) + 2 * c + cc;
          float m = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < 3; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (16 * mt + g + 8 * h < kN) m = fmaxf(m, raw[mt][nt][2 * h + cc]);
          m = fmaxf(m, __shfl_xor_sync(~0u, m, 4));
          m = fmaxf(m, __shfl_xor_sync(~0u, m, 8));
          m = fmaxf(m, __shfl_xor_sync(~0u, m, 16));
          float sum = 0.f;
#pragma unroll
          for (int mt = 0; mt < 3; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& x = raw[mt][nt][2 * h + cc];
              x = 16 * mt + g + 8 * h < kN ? expf(x - m) : 0.f;
              sum += x;
            }
          sum += __shfl_xor_sync(~0u, sum, 4);
          sum += __shfl_xor_sync(~0u, sum, 8);
          sum += __shfl_xor_sync(~0u, sum, 16);
#pragma unroll
          for (int mt = 0; mt < 3; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& x = raw[mt][nt][2 * h + cc];
              x = j < kN ? x / sum : 0.f;
            }
        }
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 3; ++nt)
            *reinterpret_cast<uint32_t*>(a2 + swz(16 * mt + g + 8 * h, 3 * bw + nt) + 4 * c) =
                pack2(raw[mt][nt][2 * h], raw[mt][nt][2 * h + 1]);
      named_barrier(1 + kPairs, kBuilders);   // operands written; the B tile free again
      if (bt == 0) mbar_arrive(&opfull[p]);
    }
    return;
  }

  // ---- consumers: pair pr of warps takes items pr, pr + 4, ...; warp wi
  // of the pair its columns [32 wi, 32 wi + 32) ----
  const int pr = warp >> 1, wi = warp & 1;
  const int g = lane >> 2, c = lane & 3;
  // ldmatrix row addresses: A (rows 16 mt + lane % 16, k chunk 2 ks + lane / 16),
  // B by .trans (k rows 8 (lane / 8) + lane % 8 of a 32-row band; x2: 16)
  const int a_row = lane & 15, a_ch = lane >> 4;
  const int b_row4 = 8 * (lane >> 3) + (lane & 7), b_row2 = 8 * ((lane >> 3) & 1) + (lane & 7);
  const bool leader = wi == 0 && lane == 0;
  uint32_t a1f[3][4][4];
  int it = 0, q = 0;
  for (int b = img0; b < B; b += per_group, ++q) {
    // every warp takes part in every image's hand-over: A1 into registers
    // where it has an item of the image, A2 read from shared memory each
    // item, the buffers handed back once the image's items are done
    const int p = q & 1, n_items = t1 - t0;
    const unsigned char* a1 = ops + p * kOpBytes;
    const unsigned char* a2 = a1 + kSlotBytes;
    mbar_wait(&opfull[p], (q >> 1) & 1);
    if (n_items >= kPairs || (pr - it % kPairs + kPairs) % kPairs < n_items) {
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldsm_x4(a1f[mt][ks], a1 + swz(16 * mt + a_row, 2 * ks + a_ch));
    }

    for (int t = t0; t < t1; ++t, ++it) {
      if (it % kPairs != pr) continue;
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      unsigned char* ps = ring + s * kStageBytes;
      unsigned char* os = ps + kSlotBytes;
      const unsigned char* bs = bias_s + (t - t0) * kBiasTileBytes;
      float acc[3][4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            const uint32_t v =
                *reinterpret_cast<const uint32_t*>(os + swz(r, 4 * wi + nt) + 4 * c);
            acc[mt][nt][2 * h] = __uint_as_float(v << 16);
            acc[mt][nt][2 * h + 1] = __uint_as_float(v & 0xFFFF0000u);
          }
      // o: proj rows 0-31, 32-47 (36-47 zero), then the tile's bias rows
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = 4 * wi + nt;
        uint32_t bq[4], b2[2], bb[2];
        ldmatrix_x4_trans(bq, ps + swz(b_row4, ch));
        ldmatrix_x2_trans(b2, ps + swz(32 + b_row2, ch));
        ldmatrix_x2_trans(bb, bs + swz(b_row2, ch));
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          mma_bf16_16816(acc[mt][nt], a1f[mt][0], bq);
          mma_bf16_16816(acc[mt][nt], a1f[mt][1], bq + 2);
          mma_bf16_16816(acc[mt][nt], a1f[mt][2], b2);
          mma_bf16_16816(acc[mt][nt], a1f[mt][3], bb);
        }
      }
      // T(o) over this warp's out_self columns, rows < 36 (36-47 stay zero)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            if (r < kN)
              *reinterpret_cast<uint32_t*>(os + swz(r, 4 * wi + nt) + 4 * c) =
                  pack2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
      __syncwarp();
      uint32_t a2f[3][3][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int ks = 0; ks < 3; ++ks)
          ldsm_x4(a2f[mt][ks], a2 + swz(16 * mt + a_row, 2 * ks + a_ch));
      float out[3][4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = 4 * wi + nt;
        uint32_t bq[4], b2[2];
        ldmatrix_x4_trans(bq, os + swz(b_row4, ch));
        ldmatrix_x2_trans(b2, os + swz(32 + b_row2, ch));
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) out[mt][nt][e] = 0.f;
          mma_bf16_16816(out[mt][nt], a2f[mt][0], bq);
          mma_bf16_16816(out[mt][nt], a2f[mt][1], bq + 2);
          mma_bf16_16816(out[mt][nt], a2f[mt][2], b2);
        }
      }
      // the stage is read (and written by this warp: order those writes
      // before the next TMA load into it)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);

      // out through the pair's staged tile and one TMA store: the pair's
      // previous store has read the tile before either warp writes it
      unsigned char* ob = outs + pr * kOutBytes;
      if (leader) bulk_wait_group_read<0>();
      named_barrier(1 + pr, 64);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            if (r < kN)
              *reinterpret_cast<uint32_t*>(ob + swz(r, 4 * wi + nt) + 4 * c) =
                  pack2(out[mt][nt][2 * h], out[mt][nt][2 * h + 1]);
          }
      fence_proxy_async();
      named_barrier(1 + pr, 64);
      if (leader) {
        tma_store_2d(&out_map, ob, t * kDT, b * kN);
        bulk_commit_group();
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&opempty[p]);
  }
  if (leader) bulk_wait_group<0>();
}

cudaError_t launch_f32(const void* out_self, const void* proj, const void* alpha,
                       const void* graph, const void* bias, void* out, int B, int D, int L,
                       cudaStream_t stream) {
  constexpr int bytes = smem_bytes<float>();
  const cudaError_t err = cudaFuncSetAttribute(
      gcn_chain_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  gcn_chain_kernel<float><<<B, kThreads, bytes, stream>>>(
      static_cast<const float*>(out_self), static_cast<const float*>(proj),
      static_cast<const float*>(alpha), static_cast<const int*>(graph),
      static_cast<const float*>(bias), static_cast<float*>(out), D, L);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* out_self, const void* proj, const void* alpha,
                        const void* graph, const void* bias, void* out, int B, int D, int L,
                        const ChainPlan& pl, int grid, cudaStream_t stream) {
  if (pl.groups <= 0 || pl.tiles_per_group <= 0 || pl.stages < kPairs || pl.stages % kPairs ||
      grid % pl.groups ||
      pl.groups * pl.tiles_per_group < (D + kDT - 1) / kDT)
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {out_self, proj, out};
  const uint64_t dims[2] = {uint64_t(D), uint64_t(B) * kN}, strides[1] = {uint64_t(D) * 2};
  const uint32_t box[2] = {kDT, kN};
  cudaError_t err = cudaSuccess;
  for (int m = 0; m < 3 && err == cudaSuccess; ++m)
    err = make_tensor_map(&maps[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptrs[m], dims, strides,
                          box);
  const size_t bytes = chain_smem(pl);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gcn_chain_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  gcn_chain_bf16_kernel<<<grid, kChainThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(alpha),
      static_cast<const int*>(graph), static_cast<const __nv_bfloat16*>(bias), B, D, L, pl);
  return cudaGetLastError();
}

}  // namespace

// out [B, 36, D] = the chain above; every float operand is bf16 when
// is_bf16, else f32; graph is int32; L <= 16; D % 8 == 0; the [B, 36, D]
// operands and bias contiguous and 16-byte aligned. bf16 takes the plan of
// gcn_chain.py _plan: `groups` column groups of `tiles_per_group` 64-column
// tiles, `stages` ring stages, a grid that is a multiple of `groups`; f32
// ignores it.
extern "C" int gcn_chain_forward(const void* out_self, const void* proj,
                                 const void* alpha, const void* graph,
                                 const void* bias, void* out, int B, int D,
                                 int L, int is_bf16, int groups,
                                 int tiles_per_group, int stages, int grid,
                                 void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (L < 0 || L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return static_cast<int>(launch_f32(out_self, proj, alpha, graph, bias, out, B, D, L, s));
  const ChainPlan pl{groups, tiles_per_group, stages};
  return static_cast<int>(
      launch_bf16(out_self, proj, alpha, graph, bias, out, B, D, L, pl, grid, s));
}
