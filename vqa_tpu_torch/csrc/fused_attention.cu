// Top-down MultiplyAttention and the attention-weighted pooling in one call:
//   vp     = relu(v @ Wv + bv)                 [B, N, H]
//   qp     = relu(q @ Wq + bq)                 [B, H]
//   logits = (vp * qp[:, None]) @ wl + bl      [B, N]
//   att    = softmax_N(logits)
//   pooled = sum_n att[:, n] * v[:, n]         [B, Dv]
//
// Replaces: vqa_tpu/ops/pallas/fused_attention.py
// fused_multiply_attention_pool (a library kernel: no model path of the JAX
// package calls it).
//
// What bounds it on an H100: the v-projection. At B=16384, N=36, Dv=2048,
// H=1024 it is 2 * 589,824 * 2048 * 1024 = 2.47 TFLOP, 2.5 ms at the bf16
// tensor-core peak, against 2.4 GB of bf16 v (0.72 ms at 3.35 TB/s): it is
// bound by operations. Unfused, the [B, N, H] activations (1.2 GB in bf16)
// go to device memory and back, twice.
//
// Two launches, one call (hopper.cuh's primitives, feed_gemm.cu's ring):
//
// 1. qp_kernel: qp = relu(q @ Wq + bq) in f32 into a scratch tensor the
//    wrapper allocates ([B, Hp], Hp = H rounded up to 128 columns, zero
//    past H: 64 MB at B=16384), with f32 copies of bv and wl (zero past H),
//    so that the second kernel's epilogue reads whole column tiles with no
//    masks and no dtype branches: 128 x 128 tiles on mma.sync m16n8k16
//    behind a 3-stage cp.async ring. 34 GFLOP at the serving shape, 1.4% of
//    the whole; hoisting it out of the v stream takes the q and Wq tiles off
//    the main kernel's ring. qp stays f32 (the TPU kernel's rounding point).
// 2. attention_pool_kernel: persistent; thread block clusters of C blocks
//    along H. A cluster walks M tiles of 256 rows that begin at an image boundary and hold floor(rows / N) whole images
//    (7 at N = 36: 252 of 256 rows; rows past the tile's images are
//    computed and dropped), so the softmax and the pooling need no second
//    pass. Block r of the cluster takes H columns [128 (p C + r), +128) in
//    pass p. A block is three warpgroups:
//    - the producer (one thread) keeps a ring of 64-deep K stages full:
//      each stage's A tile (the M tile's rows of v, 128-byte swizzle) is
//      loaded from L2 once for the cluster, block r loading rows
//      [r rows / C, (r + 1) rows / C) and multicasting them into all C
//      blocks (cp.async.bulk.tensor ... multicast::cluster), and its B tile
//      is the block's own 128 rows of Wv [H, Dv]. Every block's producer
//      writes into every block's stage, so a stage goes back to the
//      producers when the consumers of all C blocks have released it (its
//      empty barrier counts 2 C arrivals, made remotely and relaxed: the
//      stage's wgmma have retired, so they order nothing; in development
//      builds, not in the repository, arrivals released at cluster scope
//      made the kernel several times slower);
//    - two consumer warpgroups, each 128 rows of the tile, issue wgmma
//      m64n128k16 bf16 -> f32 (both operands in shared memory; 128 f32 sums
//      a thread), keep one stage's group in flight and release
//      the stage before it. At the end of a pass each thread reduces
//      relu(acc + bv) * qp[img(row)] * wl over its columns into one partial
//      logit per row (its operands loaded four 8-column blocks at a time,
//      qp through L1: 3.5 KB of a tile's images a pass), quads sum by
//      shuffles, and after the last pass the block's partials go to shared
//      memory and every block of the cluster is told (remote mbarrier
//      arrivals, released at cluster scope). Then the consumers start the
//      next tile: double-buffered partials let them run a tile ahead of
//      the tail below;
//    - the other three warps of the producer's warpgroup (the poolers) read
//      the C blocks' partials over distributed shared memory in rank order,
//      so the logits are the same on every block and bit-stable from run to
//      run, hand the buffer back, run the softmax of each image (one warp
//      an image), write att (block 0), and pool columns
//      [r Dv / C, (r + 1) Dv / C) of the tile's images from v rows that L2
//      mostly still holds, each pooler copying 18 rows of 16 bytes at a
//      time into its own slot of shared memory by cp.async (no registers
//      hold them in flight). This tail overlaps the next tile's products.
//    setmaxnreg moves registers from the producer's warpgroup to the
//    consumers.
//
// The plan (fused_attention.py _plan) takes C = 4 at H = 1024, two passes
// a tile: per M tile a cluster then moves 32 KB of v and 4 x 16 KB of Wv a
// stage from L2, about 14.7 GB a call at the serving shape, against about
// 45 GB for the first design (mma.sync on 144-row tiles that re-read v for
// each 128 columns of H and interleaved the qp product's tiles). Clusters
// of 8 taking one column tile each move less (11.8 GB) but wait on every
// block's hand-back of a stage, and 128-row tiles of 3 images leave 16% of
// their rows idle at N = 36 (1.6% here): both measured slower at the
// serving shape (PERF.md), so the kernel has neither. Its time: chip_smoke.py
// phase 12 and PERF.md's table.
//
// Shapes: Dv, H and Hq multiples of 8 (16-byte TMA and cp.async rows; TMA
// zero-fills K past Dv, rows past B N and rows of Wv past H), N from 1 to
// 256, any B. C is the largest of 4, 2, 1 that divides the H column tiles
// (H = 1040: 9 tiles, C = 1 and 9 passes).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

// one of the small f32-or-bf16 vectors bv, bq, wl, bl, upcast to f32
__device__ __forceinline__ float vec_at(const void* p, int i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// ---- 1. qp = relu(q @ Wq + bq), f32 ----------------------------------------

constexpr int kQpThreads = 256;          // 8 warps: 2 along rows x 4 along H
constexpr int kQpTile = 128;             // rows and columns of a block
constexpr int kQpK = 64;
constexpr int kQpLd = kQpK + 8;          // padded row: conflict-free ldmatrix
constexpr int kQpStages = 3;

struct QpStage {
  __nv_bfloat16 a[kQpTile * kQpLd];
  __nv_bfloat16 b[kQpTile * kQpLd];
};
constexpr int kQpSmem = kQpStages * static_cast<int>(sizeof(QpStage));

// kQpTile rows of a row-major [rows, K] operand from row r0, k0.. (rows
// past `rows` and k past K zero-filled)
__device__ __forceinline__ void qp_load(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                        int r0, int rows, int k0, int K, int tid) {
  constexpr int kChunks = kQpK / 8;
  for (int idx = tid; idx < kQpTile * kChunks; idx += kQpThreads) {
    const int r = idx / kChunks, k = k0 + (idx % kChunks) * 8;
    const bool ok = r0 + r < rows && k < K;
    cp_async16(dst + r * kQpLd + (idx % kChunks) * 8,
               ok ? src + static_cast<size_t>(r0 + r) * K + k : src, ok);
  }
}

// qp [B, Hp] f32 (Hp: H rounded up to the 128-column tiles, zero past H),
// and, from the first row of blocks, bv and wl as f32 [Hp] (zero past H):
// the attention kernel's epilogue then reads whole column tiles unmasked
__global__ void __launch_bounds__(kQpThreads, 2)
qp_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hq]
          const __nv_bfloat16* __restrict__ wq,     // [H, Hq]
          const void* bq, const void* bv, const void* wl,
          float* __restrict__ qp,                   // [B, Hp], then bv, wl [Hp]
          int B, int H, int Hp, int Hq, int vec_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QpStage* st = reinterpret_cast<QpStage*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, c = lane & 3;
  const int r0 = blockIdx.x * kQpTile, h0 = blockIdx.y * kQpTile;
  const int kt_n = (Hq + kQpK - 1) / kQpK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto issue = [&](int kt) {
    if (kt < kt_n) {
      qp_load(st[kt % kQpStages].a, q, r0, B, kt * kQpK, Hq, tid);
      qp_load(st[kt % kQpStages].b, wq, h0, H, kt * kQpK, Hq, tid);
    }
    cp_async_commit();   // an empty group past the end keeps the count uniform
  };
  for (int s = 0; s < kQpStages - 1; ++s) issue(s);
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kQpStages - 2>();
    __syncthreads();     // stage kt has landed; stage kt - 1 is consumed
    issue(kt + kQpStages - 1);
    const QpStage& s = st[kt % kQpStages];
#pragma unroll
    for (int kk = 0; kk < kQpK; kk += 16) {
      uint32_t b0[4], b1[4];
      load_b_frag2<kQpLd>(b0, s.b, wn * 32, kk, lane);
      load_b_frag2<kQpLd>(b1, s.b, wn * 32 + 16, kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        load_a_frag<kQpLd>(a, s.a, wm * 64 + i * 16, kk, lane);
        mma_bf16_16816(acc[i][0], a, b0);
        mma_bf16_16816(acc[i][1], a, b0 + 2);
        mma_bf16_16816(acc[i][2], a, b1);
        mma_bf16_16816(acc[i][3], a, b1 + 2);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int h = h0 + wn * 32 + j * 8 + 2 * c;
    const bool in = h < H;   // H % 8 == 0: h + 1 < H too
    const bool bq16 = vec_bf16 & 2;
    const float b0 = in ? vec_at(bq, h, bq16) : 0.f, b1 = in ? vec_at(bq, h + 1, bq16) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wm * 64 + i * 16 + g + half * 8;
        if (row < B)
          *reinterpret_cast<float2*>(qp + static_cast<size_t>(row) * Hp + h) =
              in ? make_float2(fmaxf(acc[i][j][2 * half] + b0, 0.f),
                               fmaxf(acc[i][j][2 * half + 1] + b1, 0.f))
                 : make_float2(0.f, 0.f);
      }
  }
  if (blockIdx.x == 0 && tid < kQpTile) {
    const int h = h0 + tid;
    float* vecs = qp + static_cast<size_t>(B) * Hp;
    vecs[h] = h < H ? vec_at(bv, h, vec_bf16 & 1) : 0.f;
    vecs[Hp + h] = h < H ? vec_at(wl, h, vec_bf16 & 4) : 0.f;
  }
}

// ---- 2. the attention and the pooling, clustered along H -------------------

constexpr int kThreads = 384;            // 2 consumer warpgroups + the producer's
constexpr int kMSub = 2;                 // m64 sub-tiles of a consumer warpgroup
constexpr int kTileM = 128 * kMSub;      // rows of an M tile
constexpr int kTileN = 128;              // H columns of a block's pass: one wgmma n
constexpr int kTileK = 64;               // K of a stage: one swizzled bf16 row
constexpr int kABytes = kTileM * kTileK * 2;
constexpr int kBBytes = kTileN * kTileK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kPoolers = 96;             // warps 1-3 of the producer's warpgroup
constexpr int kPoolRows = 18;            // v rows a pooler has in flight, by cp.async
constexpr int kPoolSlot = kPoolRows + 1; // 16-byte rows of a pooler's slot: conflict-free

struct Params {
  const __nv_bfloat16* v;                // [B, N, Dv]
  const float* qp;                       // [B, Hp], zero past H
  const float* bv;                       // [Hp] f32, zero past H
  const float* wl;                       // [Hp] f32, zero past H
  const void* bl;                        // [1], bf16 if bit 3 of vec_bf16
  float* pooled;                         // [B, Dv]
  float* att;                            // [B, N]
  int B, N, Dv, Hp, images, passes, stages, vec_bf16;
};

// the ring (1024-byte aligned for the swizzle), the poolers' slots, the
// partials (two buffers), the poolers' logits, then the barriers
constexpr int smem_bytes(int stages) {
  return 1024 + stages * kStageBytes + kPoolers * kPoolSlot * 16 + 3 * kTileM * 4 +
         (2 * stages + 4) * 8;
}

__global__ void __launch_bounds__(kThreads, 1)
attention_pool_kernel(const __grid_constant__ CUtensorMap v_map,    // [B N, Dv] bf16
                      const __grid_constant__ CUtensorMap wv_map,   // [H, Dv] bf16
                      const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_smem<1024>(smem_raw);
  const int S = p.stages;
  uint4* slots = reinterpret_cast<uint4*>(ring + S * kStageBytes);  // [kPoolers][kPoolSlot]
  float* part = reinterpret_cast<float*>(slots + kPoolers * kPoolSlot);   // [2][kTileM]
  float* logit = part + 2 * kTileM;                                  // [kTileM]
  uint64_t* full = reinterpret_cast<uint64_t*>(logit + kTileM);
  uint64_t* empty = full + S;
  uint64_t* part_full = empty + S;        // [2]: every block's partials are in
  uint64_t* part_empty = part_full + 2;   // [2]: every block has read this one's

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int C = static_cast<int>(cluster_size()), rank = static_cast<int>(cluster_rank());
  const int n_clusters = static_cast<int>(gridDim.x) / C;
  const int cid = static_cast<int>(cluster_id_x());
  const int tiles = (p.B + p.images - 1) / p.images;
  const int k_tiles = (p.Dv + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);          // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2 * C);     // each consumer warpgroup of the cluster
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&part_full[b], C);     // each block's consumers
      mbar_init(&part_empty[b], C);    // each block's poolers
    }
    mbar_init_fence();
  }
  // every block's barriers are initialised before a peer arrives on them or
  // multicasts into this block
  cluster_sync();

  if (wg == 2) {
    setmaxnreg_dec<56>();
    if (tid == 256) {
      // ---- producer: one thread keeps the ring full ----
      tma_prefetch_map(&v_map);
      tma_prefetch_map(&wv_map);
      const int slice = kTileM / C;
      const uint16_t mask = static_cast<uint16_t>((1u << C) - 1);
      int it = 0;
      for (int t = cid; t < tiles; t += n_clusters) {
        const int m0 = t * p.images * p.N;
        for (int pass = 0; pass < p.passes; ++pass) {
          const int h0 = (pass * C + rank) * kTileN;
          for (int kt = 0; kt < k_tiles; ++kt, ++it) {
            const int s = it % S;
            // every block of the cluster has released the stage: this
            // block's slice lands in all of them
            mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], kABytes + kBBytes);
            unsigned char* st = ring + s * kStageBytes;
            if (C > 1)
              tma_load_2d_multicast(st + rank * slice * 128, &v_map, &full[s], kt * kTileK,
                                    m0 + rank * slice, mask);
            else
              tma_load_2d(st, &v_map, &full[s], kt * kTileK, m0);
            tma_load_2d(st + kABytes, &wv_map, &full[s], kt * kTileK, h0);
          }
        }
      }
    } else if (tid >= kThreads - kPoolers) {
      // ---- poolers: logits over the cluster, softmax, att, pooling ----
      const int pt = tid - (kThreads - kPoolers), lane = tid & 31, pw = pt >> 5;
      const float blv = vec_at(p.bl, 0, p.vec_bf16 & 8);
      const int chunks = p.Dv / 8;
      const int c_lo = rank * chunks / C, my = (rank + 1) * chunks / C - c_lo;
      int lt = 0;
      for (int t = cid; t < tiles; t += n_clusters, ++lt) {
        const int img0 = t * p.images;
        const int n_img = min(p.images, p.B - img0);
        const int rows = n_img * p.N;
        const int b = lt & 1;
        mbar_wait_cluster(&part_full[b], (lt >> 1) & 1);
        for (int row = pt; row < rows; row += kPoolers) {
          float s = 0.f;
          for (int r = 0; r < C; ++r) s += ld_shared_cluster_f32(part + b * kTileM + row, r);
          logit[row] = s + blv;
        }
        named_barrier(2, kPoolers);
        if (pt == 0)
          for (int r = 0; r < C; ++r) mbar_arrive_remote(&part_empty[b], r);
        // softmax over each image's N rows, one warp an image; logit then
        // holds att
        for (int img = pw; img < n_img; img += kPoolers / 32) {
          float* l = logit + img * p.N;
          float mx = -INFINITY;
          for (int n = lane; n < p.N; n += 32) mx = fmaxf(mx, l[n]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          float sum = 0.f;
          for (int n = lane; n < p.N; n += 32) {
            const float e = expf(l[n] - mx);
            l[n] = e;
            sum += e;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          float* dst = p.att + static_cast<size_t>(img0 + img) * p.N;
          for (int n = lane; n < p.N; n += 32) {
            const float a = l[n] / sum;
            l[n] = a;
            if (rank == 0) dst[n] = a;
          }
        }
        named_barrier(2, kPoolers);
        // pooled[b, d] = sum_n att[b, n] v[b, n, d] over this block's
        // columns: a task is 8 columns of one image, its rows copied 16
        // bytes a row into the pooler's slot, kPoolRows at a time
        uint4* slot = slots + pt * kPoolSlot;
        for (int task = pt; task < n_img * my; task += kPoolers) {
          const int img = task / my, d = (c_lo + task % my) * 8;
          const __nv_bfloat16* src = p.v + static_cast<size_t>(img0 + img) * p.N * p.Dv + d;
          const float* a = logit + img * p.N;
          float sum[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) sum[k] = 0.f;
          for (int n0 = 0; n0 < p.N; n0 += kPoolRows) {
            const int cnt = min(kPoolRows, p.N - n0);
            for (int u = 0; u < cnt; ++u)
              cp_async16(slot + u, src + static_cast<size_t>(n0 + u) * p.Dv, true);
            cp_async_commit();
            cp_async_wait<0>();
            for (int u = 0; u < cnt; ++u) {
              const uint4 raw = slot[u];
              const float w = a[n0 + u];
              const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 f = __bfloat1622float2(h2[k]);
                sum[2 * k] += w * f.x;
                sum[2 * k + 1] += w * f.y;
              }
            }
          }
          float4* out = reinterpret_cast<float4*>(p.pooled + static_cast<size_t>(img0 + img) * p.Dv + d);
          out[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
          out[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
        }
        named_barrier(2, kPoolers);   // att read before the next tile's logits
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [128 wg, +128) ----
    setmaxnreg_inc<224>();
    const int ct = tid & 127, warp = ct >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    // a stage goes back to every producer of the cluster, thread r of the
    // warpgroup arriving at block r: the stage's wgmma have retired, so the
    // arrivals order nothing at cluster scope
    auto release = [&](int s) {
      if (ct < C) mbar_arrive_remote_relaxed(&empty[s], ct);
    };
    float acc[kMSub][64];
    int it = 0, lt = 0;
    for (int t = cid; t < tiles; t += n_clusters, ++lt) {
      const int img0 = t * p.images;
      const int n_img = min(p.images, p.B - img0);
      // this thread's rows 64 (kMSub wg + i) + 16 warp + g + 8 h of the
      // tile, and the offsets of their images' qp rows (rows past the
      // tile's images take its last image: their sums are dropped)
      int qoff[kMSub][2];
      float lsum[kMSub][2];
#pragma unroll
      for (int i = 0; i < kMSub; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * (kMSub * wg + i) + 16 * warp + g + 8 * h;
          qoff[i][h] = (img0 + min(row / p.N, n_img - 1)) * p.Hp;
          lsum[i][h] = 0.f;
        }
      for (int pass = 0; pass < p.passes; ++pass) {
        const int h0 = (pass * C + rank) * kTileN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          const unsigned char* st = ring + s * kStageBytes;
          const uint64_t db = sw128_desc(st + kABytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
            for (int i = 0; i < kMSub; ++i)
              // +2 in the descriptor's 16-byte units = 16 bf16 further along K
              wgmma_m64n128k16_bf16(acc[i], sw128_desc(st + 64 * (kMSub * wg + i) * 128) + 2 * kk,
                                    db + 2 * kk, kt > 0 || kk > 0);
          wgmma_commit();
          // the previous stage's group has retired once at most this one
          // is in flight: that stage goes back
          wgmma_wait<1>();
          if (kt > 0) release((it - 1) % S);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kMSub; ++i) fence_operands(acc[i]);
        release((it - 1) % S);
        // sum over this pass's columns h0 + 8 j + 2 c + e of
        // relu(vp + bv) * qp * wl, four 8-column blocks' operands loaded at
        // once (columns past H have wl = 0, qp = 0)
        const int hc = h0 + 2 * c;
#pragma unroll
        for (int j0 = 0; j0 < kTileN / 8; j0 += 4) {
          float2 bv2[4], wl2[4], qp2[kMSub][2][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int h = hc + 8 * (j0 + jj);
            bv2[jj] = __ldg(reinterpret_cast<const float2*>(p.bv + h));
            wl2[jj] = __ldg(reinterpret_cast<const float2*>(p.wl + h));
#pragma unroll
            for (int i = 0; i < kMSub; ++i)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                qp2[i][hh][jj] = __ldg(reinterpret_cast<const float2*>(p.qp + qoff[i][hh] + h));
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int i = 0; i < kMSub; ++i)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int a = 4 * (j0 + jj) + 2 * hh;
                lsum[i][hh] += fmaxf(acc[i][a] + bv2[jj].x, 0.f) * qp2[i][hh][jj].x * wl2[jj].x;
                lsum[i][hh] += fmaxf(acc[i][a + 1] + bv2[jj].y, 0.f) * qp2[i][hh][jj].y *
                               wl2[jj].y;
              }
        }
      }
      // the row's partial logit over this block's columns: its quad's sum
      const int b = lt & 1;
      // every block has read this buffer's partials of tile lt - 2
      if (lt >= 2) mbar_wait_cluster(&part_empty[b], ((lt >> 1) - 1) & 1);
#pragma unroll
      for (int i = 0; i < kMSub; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float s = lsum[i][hh];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (c == 0) part[b * kTileM + 64 * (kMSub * wg + i) + 16 * warp + g + 8 * hh] = s;
        }
      named_barrier(1, 256);
      if (tid == 0)
        for (int r = 0; r < C; ++r) mbar_arrive_remote(&part_full[b], r);
    }
  }
  // no block leaves while a peer may still read its partials, arrive on its
  // barriers or multicast into it
  __syncwarp();
  cluster_sync();
}

cudaError_t launch_attention(const void* v, const void* wv_t, const Params& prm, int cluster,
                             int grid, int H, cudaStream_t stream) {
  CUtensorMap v_map, wv_map;
  const uint64_t rows = static_cast<uint64_t>(prm.B) * prm.N;
  const uint64_t v_dims[2] = {uint64_t(prm.Dv), rows}, w_dims[2] = {uint64_t(prm.Dv), uint64_t(H)};
  const uint64_t strides[1] = {uint64_t(prm.Dv) * 2};
  const uint32_t v_box[2] = {kTileK, uint32_t(kTileM / cluster)}, w_box[2] = {kTileK, kTileN};
  cudaError_t err = make_tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, v_dims,
                                    strides, v_box);
  if (err == cudaSuccess)
    err = make_tensor_map(&wv_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wv_t, w_dims, strides,
                          w_box);
  const int smem = smem_bytes(prm.stages);
  const void* kernel = reinterpret_cast<const void*>(attention_pool_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the plan's grid, cut to the clusters the card holds at once: a
  // persistent grid past one wave would leave clusters waiting for a second
  int active = 0;
  cfg.gridDim = dim3(grid);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err == cudaSuccess && active < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) {
    cudaGetLastError();   // reset it, or the next launch's check would report it
    return err;
  }
  cfg.gridDim = dim3(min(grid, active * cluster));
  void* params[] = {&v_map, &wv_map, const_cast<Params*>(&prm)};
  err = cudaLaunchKernelExC(&cfg, kernel, params);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// an attribute of the current device
cudaError_t device_attr(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaDeviceGetAttribute(value, attr, dev) : err;
}

}  // namespace

// For the wrapper's plan (launches nothing): the attention kernel's dynamic
// shared memory as `fixed` bytes plus `per_stage` bytes a ring stage, the
// most a block of the current device may take, and its SM count.
extern "C" int fused_attention_query(int* fixed, int* per_stage, int* limit, int* sms) {
  *fixed = smem_bytes(0);
  *per_stage = smem_bytes(1) - smem_bytes(0);
  cudaError_t err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, limit);
  if (err == cudaSuccess) err = device_attr(cudaDevAttrMultiProcessorCount, sms);
  return static_cast<int>(err);
}

// pooled [B, Dv] and att [B, N] (f32) of v [B, N, Dv], q [B, Hq] and the
// weight-normed weights, with wv and wq given transposed ([H, Dv], [H, Hq],
// bf16) and the vectors bv [H], bq [H], wl [H], bl [1] each f32 or bf16
// (bits 0-3 of vec_bf16 set for bf16); qp is f32 scratch of B Hp + 2 Hp
// values, Hp = H rounded up to a multiple of 128. The plan
// (fused_attention.py _plan): `images` whole images an M tile of 256 rows,
// clusters of `cluster` blocks (1, 2 or 4), each block `passes` column
// tiles of 128, a ring of `stages` stages, `grid` blocks at most (a
// multiple of `cluster`). Requires 1 <= images N <= 256; cluster passes
// 128 >= H; the ring within the device's shared memory; Dv, H and Hq
// multiples of 8; B N and B H below 2^31; 16-byte aligned, contiguous
// operands.
extern "C" int fused_attention_forward(const void* v, const void* q, const void* wv_t,
                                       const void* wq_t, const void* bv, const void* bq,
                                       const void* wl, const void* bl, void* qp, void* pooled,
                                       void* att, int B, int N, int Dv, int H, int Hq,
                                       int vec_bf16, int images, int cluster, int passes,
                                       int stages, int grid, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  int limit = 0;
  cudaError_t err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &limit);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  if (N < 1 || images < 1 || images * N > kTileM ||
      (cluster != 1 && cluster != 2 && cluster != 4) || passes * cluster * kTileN < H ||
      stages < 2 || grid < cluster || grid % cluster || smem_bytes(stages) > limit ||
      Dv % 8 || H % 8 || Hq % 8 ||
      static_cast<long long>(B) * (N > H + 128 ? N : H + 128) >= (1LL << 31))   // int offsets
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(qp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQpSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const int Hp = (H + kTileN - 1) / kTileN * kTileN;
  const dim3 qp_grid((B + kQpTile - 1) / kQpTile, Hp / kQpTile);
  float* scratch = static_cast<float*>(qp);
  qp_kernel<<<qp_grid, kQpThreads, kQpSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(wq_t), bq, bv, wl,
      scratch, B, H, Hp, Hq, vec_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* vecs = scratch + static_cast<size_t>(B) * Hp;
  const Params prm{static_cast<const __nv_bfloat16*>(v), scratch, vecs, vecs + Hp, bl,
                   static_cast<float*>(pooled), static_cast<float*>(att), B, N, Dv, Hp,
                   images, passes, stages, vec_bf16};
  return static_cast<int>(launch_attention(v, wv_t, prm, cluster, grid, H, st));
}
