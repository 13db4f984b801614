// Last hidden state of a 1-layer GRU, the whole sequence in one launch, its
// 64-row state tiles shared by the blocks of a thread block cluster.
//
// Replaces: vqa_tpu/ops/pallas/gru_v2.py gru_last_state_v2 (the question
// GRU of the Up-Down encoder, vqa_tpu/ops/rnn.py) and
// vqa_tpu/ops/pallas/gru.py gru_last_state (v1), both from the input gates
// xi [B, T, 3H] precomputed (the same function, one entry point), and
// vqa_tpu/ops/pallas/gru_v3.py gru_last_state_v3 (v3: xi = emb_t @ Wi + bi
// computed in the kernel from the embeddings [B, T, E]). v1 and v3 are
// library kernels, which no model path of the JAX package calls.
//
// What bounds it on an H100: the recurrent product, [B, H] x [H, 3H] a step
// after the first, whose state is zero (0.93 TFLOP over the 9 other steps
// of T=10 at B=16384, H=1024: 0.94 ms at the bf16 tensor-core peak; v3 adds
// the [B, E] x [E, 3H] input product of every step, 0.30 TFLOP). Steps are
// serial and rows independent, so the 64 batch rows of one wgmma M stay
// with the same blocks for the whole sequence and no grid-wide
// synchronisation is needed. Each block streams the recurrent weight rows
// of the hidden units it owns from L2 once a step, and a 64-row tile does
// 64 operations a byte of weight, so what a block receives in a step (its
// bytes in flight over the L2 latency; measured, half a wave of single-block
// tiles takes nearly as long as a full one, PERF.md) bounds it.
//
// Design (hopper.cuh's primitives). A cluster of c blocks (c = 1, 2, 4, 8
// or 16, chosen by ops/kernels/gru_v2.py _plan from B so that the grid fills
// the card: at the question GRU's B=512 there are only 8 row tiles) owns one
// 64-row tile; block r of the cluster owns hidden units [r H/c, (r+1) H/c),
// so it streams only those units' 3 x H/c gate rows of the weight a step.
// Three warpgroups a block. The 64-row bf16 state (the product's operand,
// rounded from the f32 state: the TPU kernel's rounding point) stays
// resident in each block's shared memory, the whole K range, K-major in the
// 128-byte swizzle that wgmma's descriptor reads (128 KB at H=1024); the f32
// state of a block's units lives in the output buffer, which only that
// block touches. A step walks the block's units in 32-unit chunks, which
// the two consumer warpgroups take in turn (ping-pong): the producer (one
// thread of the third warpgroup) streams each chunk's gate rows [r, z, n] x
// 32 units x 64 K of the gate-major weight (torch's weight_hh layout, [3H,
// H] viewed [3, H, H]) by TMA, 12 KB a stage, into an mbarrier ring (8
// stages; v3: 4 of 20 KB) that runs on across chunks and steps; the chunk's
// warpgroup waits on each tile's arrival alone, issues wgmma m64n96k16 (A =
// the resident state, B = the 96 gate rows), keeps one stage's group in
// flight and hands each stage back as soon as its group retires, then
// passes the turn (named barriers 2 and 3) and
// runs the chunk's gate math while the other warpgroup's products stream:
// the epilogue (expf, tanhf and IEEE divisions, about as long as a chunk's
// stages) is hidden but for a step's last chunk. r and z take their input
// and recurrent products in one accumulator (they enter as sigmoid(x + h));
// n keeps two, as it enters as tanh(xn + r hn). Each thread then holds r,
// z and n of the same (row, unit), and its epilogue updates the f32 state
// in place. After the step, each block rounds its own units' new state into
// bf16, stores it swizzled into its own state, and copies those whole
// 64-unit K tiles into the same place of every peer's state by bulk copies
// through distributed shared memory (cp.async.bulk shared::cta to
// shared::cluster), which count their bytes on the peer's mbarrier: a block
// starts the next step when its peers' bytes have landed. The state is
// single-buffered, so the copies also wait for a cluster-scope mbarrier
// exchange: every warpgroup's last read of the state (arrived, released at
// cluster scope, as soon as its last chunk's wgmma retire, before its
// epilogue) before any peer overwrites it. At c = 1 neither is needed.
// v3 adds, before a chunk's recurrent stages, its input stages: the
// embedding rows [64 x 64 K] of step t beside the chunk's rows of the
// gate-major input weight, both by TMA, into acc (r, z) and a third
// accumulator (xn) by wgmma m64n64k16 and m64n32k16; its xi stays f32,
// never rounded to bf16. TMA needs 16-byte row pitches, so the wrapper pads
// E to a multiple of 8 (E8) and TMA zero-fills each 64-deep K tile past it;
// the last K tile of the state is zero past H.
// Where the resident state and the ring do not fit in shared memory (H
// above 1024 at 227 KB a block), the state lives in device memory instead,
// double-buffered in bf16 [2, B, H]: each stage of the ring then carries the
// state's 64 x 64 K tile beside the weight tile (8 stages of 20 KB), blocks
// store their units' rounded state there, and the producer waits for the
// cluster's stores of the previous step before it loads the next.
// Gate math and rounding points are the TPU kernels': xi and the biases
// upcast to f32, gate order r, z, n, f32 state.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): T=10,
// H=1024, gru_v2 0.288 ms at B=512 (clusters of 8: the card holds only 7
// clusters of 16), 0.860 at B=4096 (clusters of 2), 1.631 at B=8192 and
// 3.234 at B=16384 (single blocks; 29% of the 0.938 ms bound), against
// 0.31, 1.54, 2.95 and 5.7-5.9 ms for the per-step mma.sync design this
// replaced (vqa_tpu_torch/tools/time_kernels.py on that tree). v3 takes
// 4.264 ms at B=16384, 7% above its earlier 3.980: its one-chunk stages
// carry the embedding tile's slot, so a 4-stage ring holds half the
// recurrent weight bytes in flight that v1's 8 stages do.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTileB = 64;                      // batch rows of a cluster: one wgmma M
constexpr int kWgJ = 32;                        // hidden units of a warpgroup's chunk
constexpr int kTileK = 64;                      // K of a stage: one swizzled 128-byte row
constexpr int kThreads = 384;                   // 2 consumer warpgroups + the producer's
constexpr int kBBytes = 3 * kWgJ * kTileK * 2;  // a chunk's [3][32][64] weight tile
constexpr int kABytes = kTileB * kTileK * 2;    // a [64][64] operand tile (state K block, emb)
constexpr int kMaxStages = 8;
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};
constexpr int kNumClusterSizes = 5;

__host__ __device__ inline int k_blocks(int k) { return (k + kTileK - 1) / kTileK; }

// c blocks can share a tile of width H: each takes H / c units, whole
// 64-unit K tiles of the state when c > 1 (the bulk copies move them)
bool cluster_fits(int H, int c) {
  return c >= 1 && c <= 16 && (c & (c - 1)) == 0 && H % (32 * c) == 0 &&
         (c == 1 || H % (kTileK * c) == 0);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// two floats rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

struct SeqArgs {
  const __nv_bfloat16* xi;   // v1: [B, T, 3H]
  const __nv_bfloat16* bi;   // v3: [3H]
  const __nv_bfloat16* bh;   // [3H]
  float* out;                // [B, H]: the f32 state
  __nv_bfloat16* h16;        // [2, B, H]: the state when not resident
  int B, T, H, E8;
};

// the ring of a kernel: 8 stages (v3 with the state resident: 4); a stage
// holds one chunk's weight tile, then an A tile where one is needed (v3's
// embedding tile, or the state's K tile when it is not resident)
template <bool kV3, bool kRes> constexpr int kStages = kV3 && kRes ? 4 : kMaxStages;
template <bool kV3, bool kRes>
constexpr int kStageBytes = kBBytes + (kV3 || !kRes ? kABytes : 0);

// The shared-memory layout, from a 1024-byte aligned base: the resident
// bf16 state [H / 64][64 rows][64 K] (zero past H), the ring, its
// barriers (full, empty, and the two cluster exchanges). Each stage holds
// the two chunks' weight tiles, then an A tile where the stage needs one
// (v3's embedding tile, or the state's K tile when the state is not
// resident). The state is resident unless that does not fit in `max_smem`.
struct Layout {
  bool resident;
  size_t smem;
};

Layout layout(int H, bool v3, size_t max_smem) {
  const size_t bars = (2 * kMaxStages + 2) * sizeof(uint64_t);
  Layout L;
  L.resident = true;
  L.smem = 1024 + size_t(k_blocks(H)) * kABytes +
           size_t(v3 ? kStages<true, true> * kStageBytes<true, true>
                     : kStages<false, true> * kStageBytes<false, true>) + bars;
  if (L.smem > max_smem) {
    L.resident = false;
    L.smem = 1024 + size_t(v3 ? kStages<true, false> * kStageBytes<true, false>
                              : kStages<false, false> * kStageBytes<false, false>) + bars;
  }
  return L;
}

template <bool kV3, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_kernel(const __grid_constant__ CUtensorMap wh_map,   // [3, H, H]: w_gk [3H, H]
               const __grid_constant__ CUtensorMap wi_map,   // v3: [3, H, E8]: wi [3H, E8]
               const __grid_constant__ CUtensorMap emb_map,  // v3: [B, T, E8]
               const __grid_constant__ CUtensorMap h_map,    // not resident: [2, B, H]
               const SeqArgs a) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int S = kStages<kV3, kRes>, SB = kStageBytes<kV3, kRes>;
  constexpr bool resident = kRes;
  const int B = a.B, T = a.T, H = a.H;
  unsigned char* hs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kh_blocks = k_blocks(H);
  unsigned char* ring = hs + (resident ? kh_blocks * kABytes : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SB);
  uint64_t* empty = full + kMaxStages;
  uint64_t* rd_done = empty + kMaxStages;   // every block of the cluster has read the state
  uint64_t* wr_done = rd_done + 1;          // every block has stored its units' new state

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int c = static_cast<int>(cluster_size()), rank = static_cast<int>(cluster_rank());
  const int b0 = static_cast<int>(cluster_id_x()) * kTileB;
  const int units = H / c, u0 = rank * units;   // this block's hidden units
  const int nch = units / kWgJ;                 // its 32-unit chunks
  const int kx = kV3 ? k_blocks(a.E8) : 0;      // input stages of a chunk

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 1);     // the arrival of the chunk's warpgroup
    }
    mbar_init(rd_done, 2 * c);     // one from each consumer warpgroup of the cluster
    // resident: this block's expected bytes from its peers' copies; in
    // device memory: one arrival from each block of the cluster
    mbar_init(wr_done, kRes ? 1 : c);
    mbar_init_fence();
  }
  if (kRes)
    for (int i = tid; i < kh_blocks * kABytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(hs)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  // barriers initialised and state zeroed in every block before any peer
  // arrives on or stores into them
  cluster_sync();

  if (wg == 2) {
    // ---- producer: one thread streams every stage of every step ----
    if (tid == 256) {
      tma_prefetch_map(&wh_map);
      if (kV3) {
        tma_prefetch_map(&wi_map);
        tma_prefetch_map(&emb_map);
      }
      if (!resident) tma_prefetch_map(&h_map);
      int it = 0;
      for (int t = 0; t < T; ++t) {
        const int n = kx + (t > 0 ? kh_blocks : 0);   // at t = 0 the state is zero
        if (!resident && t > 0) {
          // the state of step t - 1 is in device memory, stored by every
          // block of the cluster, before its tiles are loaded
          mbar_wait_cluster(wr_done, (t - 1) & 1);
          fence_proxy_async_all();
        }
        for (int k = 0; k < nch; ++k) {
          const int j0 = u0 + k * kWgJ;
          for (int i = 0; i < n; ++i, ++it) {
            const int s = it % S;
            const bool x = i < kx;
            const bool with_a = x || !resident;
            mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], kBBytes + (with_a ? kABytes : 0));
            unsigned char* st = ring + s * SB;
            tma_load_3d(st, x ? &wi_map : &wh_map, &full[s], (x ? i : i - kx) * kTileK, j0, 0);
            if (x)
              tma_load_3d(st + kBBytes, &emb_map, &full[s], i * kTileK, t, b0);
            else if (!resident)
              tma_load_3d(st + kBBytes, &h_map, &full[s], (i - kx) * kTileK, b0, t & 1);
          }
        }
      }
    }
  } else {
    // ---- consumers: the warpgroups take the chunks in turn (wg: the even
    // ones, 1: the odd), so that one's epilogue runs while the other's
    // products stream; named barriers 2 and 3 pass the turn ----
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int g = lane >> 2, cq = lane & 3;
    const size_t G = 3 * static_cast<size_t>(H);
    float* out = a.out;
    // acc: r (registers 0-15) and z (16-31), input and recurrent products
    // together; acc_hn: n's recurrent product; acc_xn: n's input product (v3)
    float acc[32], acc_hn[16], acc_xn[16];
    const bool exchange_reads = resident && c > 1;
    int it = 0;
    for (int t = 0; t < T; ++t) {
      const int n = kx + (t > 0 ? kh_blocks : 0);
      for (int k = 0; k < nch; ++k) {
        if ((k & 1) != wg) {   // the other warpgroup's chunk
          it += n;
          continue;
        }
        const int j0 = u0 + k * kWgJ;
        // the epilogue's inputs from device memory (v1's input gates, the
        // old f32 state), loaded now so that their latency hides behind the
        // chunk's stages: units j0 + 8q + 2cq (+1), rows 16 warp + g (+8)
        uint32_t x_raw[kWgJ / 8][2][3];   // bf16 pairs
        float2 h_old[kWgJ / 8][2];
#pragma unroll
        for (int q = 0; q < kWgJ / 8; ++q)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = b0 + warp * 16 + g + half * 8, j = j0 + q * 8 + 2 * cq;
            h_old[q][half] = make_float2(0.f, 0.f);
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) x_raw[q][half][gate] = 0;
            if (row >= B) continue;
            if (t > 0) h_old[q][half] = *reinterpret_cast<const float2*>(
                           out + static_cast<size_t>(row) * H + j);
            if (!kV3) {
              const __nv_bfloat16* x = a.xi + (static_cast<size_t>(row) * T + t) * G + j;
#pragma unroll
              for (int gate = 0; gate < 3; ++gate)
                x_raw[q][half][gate] = *reinterpret_cast<const uint32_t*>(x + gate * H);
            }
          }
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc_hn[e] = acc_xn[e] = 0.f;
        // the other warpgroup has issued the previous chunk's products
        if (k > 0) named_barrier(2 + wg, 256);
        for (int i = 0; i < n; ++i, ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          const unsigned char* st = ring + s * SB;
          const uint64_t db = sw128_desc(st);
          wgmma_fence();
          if (kV3 && i < kx) {
            const uint64_t da = sw128_desc(st + kBBytes);
            // the n gate's rows start 64 rows (8 KB) into the chunk tile
            const uint64_t dn = sw128_desc(st + 2 * kWgJ * kTileK * 2);
#pragma unroll
            for (int kk = 0; kk < kTileK / 16; ++kk) {
              // +2 in the descriptor's 16-byte units = 16 bf16 further along K
              wgmma_m64n64k16_bf16(acc, da + 2 * kk, db + 2 * kk, 1);
              wgmma_m64n32k16_bf16(acc_xn, da + 2 * kk, dn + 2 * kk, 1);
            }
          } else {
            const uint64_t da = sw128_desc(resident ? hs + (i - kx) * kABytes : st + kBBytes);
#pragma unroll
            for (int kk = 0; kk < kTileK / 16; ++kk)
              wgmma_m64n96k16_bf16(acc, acc_hn, da + 2 * kk, db + 2 * kk, 1);
          }
          wgmma_commit();
          // one group in flight: the previous stage is read, hand it back
          wgmma_wait<1>();
          if (i > 0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % S]);
        }
        wgmma_wait<0>();
        if (n > 0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % S]);
        // the next chunk's products are the other warpgroup's turn
        if (k + 1 < nch) named_barrier_arrive(2 + (wg ^ 1), 256);
        // this warpgroup's last chunk of the step: it reads the resident
        // state no more, which the cluster's stores of step t wait for
        if (exchange_reads && t + 1 < T && k + 2 >= nch && (tid & 127) == 0)
          for (int q = 0; q < c; ++q) mbar_arrive_remote(rd_done, q);
        fence_operands(acc);
        fence_operands(acc_hn);
        fence_operands(acc_xn);

        // the chunk's gate math
#pragma unroll
        for (int q = 0; q < kWgJ / 8; ++q) {
          const int j = j0 + q * 8 + 2 * cq;
          float2 bhv[3], biv[3];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            bhv[gate] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(a.bh + gate * H + j));
            if (kV3)
              biv[gate] = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(a.bi + gate * H + j));
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
              const int ai = 4 * q + 2 * half + e;
              const float bhr = e ? bhv[0].y : bhv[0].x, bhz = e ? bhv[1].y : bhv[1].x;
              const float bhn = e ? bhv[2].y : bhv[2].x;
              float r, z, n_gate;
              if (kV3) {
                const float bir = e ? biv[0].y : biv[0].x, biz = e ? biv[1].y : biv[1].x;
                const float bin = e ? biv[2].y : biv[2].x;
                r = sigmoidf(acc[ai] + bir + bhr);
                z = sigmoidf(acc[16 + ai] + biz + bhz);
                n_gate = tanhf((acc_xn[ai] + bin) + r * (acc_hn[ai] + bhn));
              } else {
                const float xr = e ? xv[0].y : xv[0].x, xz = e ? xv[1].y : xv[1].x;
                const float xn = e ? xv[2].y : xv[2].x;
                r = sigmoidf(xr + (acc[ai] + bhr));
                z = sigmoidf(xz + (acc[16 + ai] + bhz));
                n_gate = tanhf(xn + r * (acc_hn[ai] + bhn));
              }
              h[e] = (1.f - z) * n_gate + z * (e ? ho.y : ho.x);
            }
            *reinterpret_cast<float2*>(hp) = make_float2(h[0], h[1]);
          }
        }
      }
      // a warpgroup without a chunk this step (one chunk a block) reads nothing
      if (exchange_reads && t + 1 < T && nch <= wg && (tid & 127) == 0)
        for (int q = 0; q < c; ++q) mbar_arrive_remote(rd_done, q);
      if (t + 1 < T) {
        // every chunk's f32 state of step t is written and every wgmma of
        // the step has retired
        named_barrier(1, 256);
        // the stores wait until no block of the cluster reads the resident
        // state any more (one block: its wgmma retired before the barrier)
        bool readers_done = !exchange_reads;
        // round this block's units into every block's operand (16-byte
        // chunk k / 8 % 8 of row r at (k / 8 % 8) ^ (r % 8) in the swizzle),
        // or into the device-memory state of step t + 1
        // (the f32 state read back in batches of 4 chunks a thread, so that
        // their latencies overlap, the first batch while the cluster's
        // readers finish)
        constexpr int kBatch = 4;
        const int row_chunks = units / 8, total = kTileB * row_chunks;
        for (int base = tid; base < total; base += 256 * kBatch) {
          float4 lo[kBatch], hi[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int idx = base + u * 256;
            const int r = idx / row_chunks, k = u0 + (idx % row_chunks) * 8;
            lo[u] = hi[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (idx < total && b0 + r < B) {
              const float4* src =
                  reinterpret_cast<const float4*>(out + static_cast<size_t>(b0 + r) * H + k);
              lo[u] = src[0];
              hi[u] = src[1];
            }
          }
          if (!readers_done) {
            mbar_wait_cluster(rd_done, t & 1);
            readers_done = true;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int idx = base + u * 256;
            if (idx >= total) break;
            const int r = idx / row_chunks, k = u0 + (idx % row_chunks) * 8;
            const uint4 v =
                make_uint4(pack_bf16x2(lo[u].x, lo[u].y), pack_bf16x2(lo[u].z, lo[u].w),
                           pack_bf16x2(hi[u].x, hi[u].y), pack_bf16x2(hi[u].z, hi[u].w));
            if (resident) {
              *reinterpret_cast<uint4*>(hs + (k / kTileK) * kABytes + r * 128 +
                                        ((((k % kTileK) / 8) ^ (r & 7)) * 16)) = v;
            } else if (b0 + r < B) {
              *reinterpret_cast<uint4*>(
                  a.h16 + (static_cast<size_t>((t + 1) & 1) * B + b0 + r) * H + k) = v;
            }
          }
        }
        fence_proxy_async_all();
        named_barrier(1, 256);
        if (exchange_reads) {
          // this block's units, whole 64-unit K tiles, copied into the same
          // place of every peer's state by bulk copies that count their
          // bytes on the peer's wr_done; this block waits for its peers'
          const uint32_t bytes = static_cast<uint32_t>(units / kTileK) * kABytes;
          if (tid == 0) {
            mbar_arrive_expect_tx(wr_done, (c - 1) * bytes);
            for (int q = 1; q < c; ++q)   // each block starting at its next peer
              bulk_copy_to_peer(hs + (u0 / kTileK) * kABytes, bytes, wr_done, (rank + q) % c);
          }
          mbar_wait(wr_done, t & 1);
        } else if (!resident) {
          // every block's stores of step t are in device memory (the
          // producer waits for this too before it loads step t + 1's state)
          if (tid == 0)
            for (int q = 0; q < c; ++q) mbar_arrive_remote(wr_done, q);
          mbar_wait_cluster(wr_done, t & 1);
          fence_proxy_async_all();
        }
      }
    }
  }
}

size_t max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(bytes);
}

template <bool kV3>
const void* kernel_for(const Layout& L) {
  return L.resident ? reinterpret_cast<const void*>(gru_seq_kernel<kV3, true>)
                    : reinterpret_cast<const void*>(gru_seq_kernel<kV3, false>);
}

template <bool kV3>
cudaError_t prepare(const Layout& L, int cluster) {
  const void* kernel = kernel_for<kV3>(L);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.smem));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(dim3 grid, size_t smem, cudaStream_t stream, int cluster,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kV3>
int launch(const void* xi, const void* emb, const void* wi, const void* bi, const void* wh,
           const void* bh, void* out, void* h16, int B, int T, int H, int E8, int cluster,
           cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (!cluster_fits(H, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(H, kV3, max_smem());
  if (!L.resident && h16 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wh_map, wi_map, emb_map, h_map;
  const uint32_t w_box[3] = {kTileK, kWgJ, 3};
  const uint64_t wh_dims[3] = {uint64_t(H), uint64_t(H), 3};
  const uint64_t wh_strides[2] = {uint64_t(H) * 2, uint64_t(H) * H * 2};
  cudaError_t err = make_tensor_map(&wh_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wh, wh_dims,
                                    wh_strides, w_box);
  wi_map = emb_map = h_map = wh_map;   // maps a launch does not read
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
  if (!L.resident && err == cudaSuccess) {
    const uint64_t h_dims[3] = {uint64_t(H), uint64_t(B), 2};
    const uint64_t h_strides[2] = {uint64_t(H) * 2, uint64_t(B) * H * 2};
    const uint32_t h_box[3] = {kTileK, kTileB, 1};
    err = make_tensor_map(&h_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, h16, h_dims, h_strides,
                          h_box);
  }
  if (err == cudaSuccess) err = prepare<kV3>(L, cluster);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reset it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  const SeqArgs args{static_cast<const __nv_bfloat16*>(xi),
                     static_cast<const __nv_bfloat16*>(bi),
                     static_cast<const __nv_bfloat16*>(bh),
                     static_cast<float*>(out),
                     static_cast<__nv_bfloat16*>(h16),
                     B, T, H, E8};
  cudaLaunchAttribute attr[1];
  const int tiles = (B + kTileB - 1) / kTileB;
  cudaLaunchConfig_t cfg = config(dim3(tiles * cluster), L.smem, stream, cluster, attr);
  if (cluster == 1) cfg.numAttrs = 0;   // a plain launch: each block its own cluster
  void* params[] = {&wh_map, &wi_map, &emb_map, &h_map, const_cast<SeqArgs*>(&args)};
  err = cudaLaunchKernelExC(&cfg, kernel_for<kV3>(L), params);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kV3>
int query(int H, int* resident, int* capacity, int* sms) {
  const Layout L = layout(H, kV3, max_smem());
  *resident = L.resident ? 1 : 0;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < kNumClusterSizes; ++i) {
    const int c = kClusterSizes[i];
    capacity[i] = 0;
    if (!cluster_fits(H, c)) continue;
    cudaError_t err = prepare<kV3>(L, c);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(dim3(c), L.smem, nullptr, c, attr);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel_for<kV3>(L), &cfg);
    if (err != cudaSuccess) {
      // a cluster size the card cannot schedule with this layout
      cudaGetLastError();
      continue;
    }
    capacity[i] = clusters;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// v1 and v2: out [B, H] f32 = the last GRU state of xi [B, T, 3H] under the
// gate-major recurrent weight w [3H, H] and bias bh [3H], all bf16, by
// clusters of `cluster` blocks a 64-row tile. h16 [2, B, H] bf16 is scratch
// for the state where gru_query reports it not resident (else unused, may
// be null). Requires T >= 1, H % (32 cluster) == 0, cluster a power of two
// up to 16, and 16-byte aligned, contiguous operands.
extern "C" int gru_last_state_forward(const void* xi, const void* w, const void* bh, void* out,
                                      void* h16, int B, int T, int H, int cluster,
                                      void* stream) {
  return launch<false>(xi, nullptr, nullptr, nullptr, w, bh, out, h16, B, T, H, 0, cluster,
                       static_cast<cudaStream_t>(stream));
}

// v3: the same from emb [B, T, E8] (E8: E rounded up to 8, zero past E) with
// the input weight given gate-major, wi [3H, E8] (zero past E), and bias bi
// [3H]; E is the unpadded width, which the kernel does not need.
extern "C" int gru_last_state_v3_forward(const void* emb, const void* wi, const void* bi,
                                         const void* w, const void* bh, void* out, void* h16,
                                         int B, int T, int H, int E, int E8, int cluster,
                                         void* stream) {
  (void)E;
  return launch<true>(nullptr, emb, wi, bi, w, bh, out, h16, B, T, H, E8, cluster,
                      static_cast<cudaStream_t>(stream));
}

// For the wrappers' plan: whether the state of width H stays resident in
// shared memory (else the launch needs h16), for each cluster size 1, 2, 4,
// 8, 16 how many such clusters the card holds at once (0: not schedulable,
// or H not a multiple of 32 c), and the card's SM count. v3 selects the
// kernel.
extern "C" int gru_query(int H, int v3, int* resident, int* capacity, int* sms) {
  return v3 ? query<true>(H, resident, capacity, sms)
            : query<false>(H, resident, capacity, sms);
}
