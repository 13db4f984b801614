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
// What bounds them on an H100. fwd and bwd: memory. At B=4096, 36 boxes,
// H=1024 and an int8 payload of D=2048 each reads vp (0.30 GB bf16) and the
// payload (0.30 GB) once: 0.188 ms at 3.35 TB/s; their Philox draws (one
// call per 16 mask bytes, 9.4 M a step) take 0.011 ms at one instruction a
// lane a clock, 40 instructions a draw. dvp: the issue of its draws. Over
// T=19 steps it draws 179 M times (0.214 ms by that count) and moves 0.47
// GB (0.139 ms). The count is a floor: a draw's twenty 32 x 32 -> 64-bit
// multiplies are not full-rate instructions, and masking its 16 lanes
// adds a compare each (tools/time_kernels.py times dvp with dropout off
// beside it, which isolates what the draws cost).
//
// Design. fwd is a streaming pipeline, so that a row's payload is in
// flight while its logits and softmax run: a persistent grid of two blocks
// an SM, or three where each gets at least two rows (16 or 24 consumer
// warps to share the Philox draws and the products), takes rows
// b = blockIdx.x + grid i; in each block one producer thread issues 1-D
// bulk copies (cp.async.bulk, no tensor map: rows of qp, vp2 and pool2 are
// contiguous) into an mbarrier ring of 16 KB stages (192 KB an SM, shared
// by its blocks; larger stages where one box is larger), in the order qp
// row b, vp boxes of row b (8 a stage in bf16 at H=1024), payload boxes of
// row b (8 a stage in int8 at D=2048), then row b + 1, so the ring's depth
// covers the softmax between the two. Eight consumer warps take each stage
// as it lands: the qp stage becomes each lane's qp * k * scale for its
// 16-lane groups, in registers (the same groups of every box); a vp stage
// gives a box to a warp (or to `wpb` warps, each a share of the groups),
// one Philox draw a group, its bytes compared with thresh four at a time
// (__vcmpltu4) into masks that zero the dropped lanes' raw bits before one
// 16-lane product, the first draw computed before the stage's bytes are
// waited for; warp 0 runs the softmax over the <= 64 boxes with shuffles;
// in a payload stage each of the 256 consumer threads owns 8 lanes of D (at
// D=2048 every thread is busy) and sums att * w * pool over the boxes in
// registers, in box order. Each stage goes back to the producer as soon as
// the warps have read it.
//
// bwd gives one block of 256 threads to a batch row: m is one warp
// reduction per box over D, the softmax cotangent one thread per box, and
// d_qp_pre splits the boxes over 4 thread groups whose partial rows are
// added in shared memory.
//
// dvp stages each batch row once and spends its threads on the draws: a
// persistent grid of two blocks an SM takes block items (decode_att.py
// _dvp_plan): one row's slice of up to 256 lane groups by a slice of its
// box sets. One producer warp fills an mbarrier ring of 4 stages, each 8
// steps of the slice's qp rows (bulk copies, 2 KB a step at H=1024 in
// bf16) and of the row's dl (4-byte cp.async copies of the words that hold
// it, whose landing each lane counts on the stage's barrier, so the
// producer never waits on a load). Each of the 256 consumer threads owns
// one 16-lane group and 3 boxes (nb, from the plan; at 36 boxes and
// H=1024 a row is 3 items and every thread is busy): per step it unpacks
// qp_t's 16 lanes to f32 once for its boxes, draws each box's mask, keeps
// lane 4 i + j where byte j of word i, shifted to the top, is below
// thresh << 24 (one compare, which predicates the lane's FMA), and keeps
// its 16 sums a box in registers, summed over t in ascending order and
// then multiplied by att_scale * k. Every thread runs every step (the idle
// ones on a clamped box), so the warp stays converged, the step and key
// schedule are uniform, and the boxes' draws interleave (cuobjdump -sass:
// each round two IMAD.WIDE.U32 and two LOP3, the keys in UIADD3s). d_vp is written
// once, 16-byte stores, neighbouring threads on neighbouring groups.
//
// Measured (chip_smoke.py and tools/time_kernels.py, NVIDIA H100 80GB HBM3,
// 700 W; PERF.md): fwd 0.2742 ms at B=4096 (69% of its bound) and 0.0595
// at B=512; dvp 1.0872 ms at B=4096, 20% of its 0.214 ms issue bound (0.43
// ms with dropout off, which draws nothing; the first design, one thread a
// (row, box, group) reading qp again for every box, 1.51), and 0.1380 at
// B=512.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
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

// The byte masks of the (b, n, g) draw: byte j of word i is 0xFF where
// byte j of output word i is below thresh (lane 16 g + 4 i + j kept), else
// 0; all 0xFF when thresh == 0. The same contract as keep_bits.
__device__ __forceinline__ uint4 keep_words(uint32_t seed, uint32_t t, uint32_t b,
                                            uint32_t n, uint32_t g, uint32_t thresh) {
  if (thresh == 0) return make_uint4(~0u, ~0u, ~0u, ~0u);
  const uint4 r = philox4x32_10(b, n, g, seed, t);
  const uint32_t th = thresh * 0x01010101u;
  return make_uint4(__vcmpltu4(r.x, th), __vcmpltu4(r.y, th), __vcmpltu4(r.z, th),
                    __vcmpltu4(r.w, th));
}

__device__ __forceinline__ uint32_t word_of(uint4 m, int i) {
  return i == 0 ? m.x : i == 1 ? m.y : i == 2 ? m.z : m.w;
}

// sum_l keep_l x[l] qk[l] over the 16 lanes at p (16-byte aligned), the
// dropped lanes zeroed in their raw bits by the byte masks m
__device__ __forceinline__ float masked_dot16(const __nv_bfloat16* p, uint4 m,
                                              const float qk[kLanes]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 r = q[v];
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // bf16 lanes 8 v + 2 w (+1): mask bytes 2 w, 2 w + 1 of word v * 2 + w / 2
      const uint32_t mw = word_of(m, 2 * v + w / 2);
      const uint32_t keep = __byte_perm(mw, 0, (w & 1) ? 0x3322 : 0x1100);
      const uint32_t x = u[w] & keep;
      const int l = 8 * v + 2 * w;
      s += __uint_as_float(x << 16) * qk[l];
      s += __uint_as_float(x & 0xFFFF0000u) * qk[l + 1];
    }
  }
  return s;
}
__device__ __forceinline__ float masked_dot16(const float* p, uint4 m,
                                              const float qk[kLanes]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 r = q[i];
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
    const uint32_t mw = word_of(m, i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t keep = __byte_perm(mw, 0, 0x1111 * j);
      s += __uint_as_float(u[j] & keep) * qk[4 * i + j];
    }
  }
  return s;
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

// The forward's streaming ring: one producer warp (one elected thread) and
// 8 consumer warps; stages of `stage_bytes` (at least 16 KB, a multiple of
// 128) hold, for each batch row in turn, its qp row, then its vp boxes
// `nb_v` at a time, then its payload boxes `nb_p` at a time. In the logits,
// `wpb` warps share a box (each lane then owns at most kLaneGroups 16-lane
// groups of it, the same ones for every box).
constexpr int kFwdConsumers = 256;
constexpr int kFwdWarps = kFwdConsumers / 32;
constexpr int kFwdThreads = kFwdConsumers + 32;
// two blocks an SM, or three where each takes at least two rows; the
// SM's 192 KB of ring shared between them
constexpr int kFwdMaxBlocksPerSm = 3;
constexpr int kSmRingBytes = 192 * 1024;
constexpr int kMinStageBytes = 16 * 1024;
constexpr int kMaxFwdStages = 8;
constexpr int kLaneGroups = 2;
constexpr int kPoolGroups = 4;         // 8-lane groups of D a thread owns
constexpr int kMaxFwdWidth = 8192;     // H and D: kLaneGroups, kPoolGroups

struct FwdPlan {
  int stage_bytes, stages, nb_v, nb_p, wpb;
};

int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

int fwd_blocks_per_sm(int B, int sms) {
  return B >= 2 * kFwdMaxBlocksPerSm * sms ? kFwdMaxBlocksPerSm : 2;
}

FwdPlan fwd_plan(int t_size, int p_size, int objs, int H, int D, int blocks_per_sm) {
  const int box_v = H * t_size, box_p = D * p_size;
  FwdPlan pl;
  int sb = box_v > box_p ? box_v : box_p;
  if (sb < kMinStageBytes) sb = kMinStageBytes;
  pl.stage_bytes = (sb + 127) / 128 * 128;
  pl.stages = kSmRingBytes / blocks_per_sm / pl.stage_bytes;
  if (pl.stages > kMaxFwdStages) pl.stages = kMaxFwdStages;
  if (pl.stages < 2) pl.stages = 2;
  pl.nb_v = pl.stage_bytes / box_v;
  pl.nb_p = pl.stage_bytes / box_p;
  if (pl.nb_v > objs) pl.nb_v = objs;
  if (pl.nb_p > objs) pl.nb_p = objs;
  const int G = H / kLanes;
  int wpb = 1;   // enough warps a box that a lane holds <= kLaneGroups groups
  while (wpb < kFwdWarps && wpb * 32 * kLaneGroups < G) wpb *= 2;
  const int fill = kFwdWarps / pow2_floor(pl.nb_v < kFwdWarps ? pl.nb_v : kFwdWarps);
  pl.wpb = wpb > fill ? wpb : fill;   // and every warp busy when few boxes fit
  return pl;
}

size_t fwd_smem(const FwdPlan& pl, int H) {
  return size_t(pl.stages) * pl.stage_bytes + size_t(H) * sizeof(float) +
         size_t(kMaxObjs) * (kFwdWarps + 1) * sizeof(float) +
         2 * size_t(pl.stages) * sizeof(uint64_t);
}

// 8 consecutive payload elements (8, 16 or 32 bytes, aligned) as f32
__device__ __forceinline__ void load8(const int8_t* p, float x[8]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const int8_t* q = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(q[i]);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float x[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float x[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]),
                                            pack_bf16x2(x[4], x[5]), pack_bf16x2(x[6], x[7]));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

template <typename T, typename P, bool kFactored>
__global__ void __launch_bounds__(kFwdThreads, kFwdMaxBlocksPerSm)
decode_att_fwd_kernel(const FwdArgs a, const FwdPlan pl, int B) {
  extern __shared__ __align__(128) unsigned char fsmem[];
  const int S = pl.stages, SB = pl.stage_bytes;
  const int objs = a.objs, H = a.H, D = a.D, G = H / kLanes;
  unsigned char* ring = fsmem;
  float* ks = reinterpret_cast<float*>(ring + size_t(S) * SB);   // [H]: k * scale
  float* lpart = ks + H;                 // [kMaxObjs][kFwdWarps]: logit partials
  float* aw = lpart + kMaxObjs * kFwdWarps;   // [kMaxObjs]: the pooling weights
  uint64_t* full = reinterpret_cast<uint64_t*>(aw + kMaxObjs);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);           // the producer's arrival, plus the bytes
      mbar_init(&empty[s], kFwdWarps);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  const T* k = static_cast<const T*>(a.k);
  const float scale = a.thresh ? a.att_scale : 1.f;
  for (int h = tid; h < H; h += kFwdThreads) ks[h] = to_f(k[h]) * scale;
  __syncthreads();

  const size_t box_v = size_t(H) * sizeof(T), box_p = size_t(D) * sizeof(P);
  if (warp == kFwdWarps) {
    // ---- producer: row by row, its qp, vp and payload, in ring order ----
    if (lane == 0) {
      int it = 0;
      auto issue = [&](const void* src, size_t bytes) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], static_cast<uint32_t>(bytes));
        bulk_load(ring + size_t(s) * SB, src, static_cast<uint32_t>(bytes), &full[s]);
        ++it;
      };
      const unsigned char* qp = static_cast<const unsigned char*>(a.qp);
      const unsigned char* vp = static_cast<const unsigned char*>(a.vp);
      const unsigned char* pool = static_cast<const unsigned char*>(a.pool);
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        issue(qp + size_t(b) * box_v, box_v);
        for (int n0 = 0; n0 < objs; n0 += pl.nb_v)
          issue(vp + (size_t(b) * objs + n0) * box_v,
                size_t(min(pl.nb_v, objs - n0)) * box_v);
        for (int n0 = 0; n0 < objs; n0 += pl.nb_p)
          issue(pool + (size_t(b) * objs + n0) * box_p,
                size_t(min(pl.nb_p, objs - n0)) * box_p);
      }
    }
    return;
  }

  // ---- consumers ----
  const int wpb = pl.wpb, sub = warp % wpb, i0 = warp / wpb, istep = kFwdWarps / wpb;
  int it = 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t row = size_t(b) * objs;
    // the factored weights of the softmax's boxes (warp 0), early
    float w0 = 1.f, w1 = 1.f;
    if (kFactored && warp == 0) {
      const T* w = static_cast<const T*>(a.w) + row;
      if (lane < objs) w0 = to_f(w[lane]);
      if (lane + 32 < objs) w1 = to_f(w[lane + 32]);
    }
    // qp * k * scale of this lane's groups, in registers for every box
    float qk[kLaneGroups][kLanes];
    {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const T* q = reinterpret_cast<const T*>(ring + size_t(s) * SB);
#pragma unroll
      for (int j = 0; j < kLaneGroups; ++j) {
        const int g = (j * wpb + sub) * 32 + lane;
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          qk[j][l] = g < G ? to_f(q[g * kLanes + l]) * ks[g * kLanes + l] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++it;
    }
    // the logits: the draw of a lane's first group before its bytes
    for (int n0 = 0; n0 < objs; n0 += pl.nb_v, ++it) {
      const int nbs = min(pl.nb_v, objs - n0);
      const int s = it % S;
      const int n_first = n0 + i0;
      const int g_first = sub * 32 + lane;
      const uint4 m0 = i0 < nbs && g_first < G
                           ? keep_words(a.seed, a.t, b, n_first, g_first, a.thresh)
                           : make_uint4(0, 0, 0, 0);
      mbar_wait(&full[s], (it / S) & 1);
      const T* st = reinterpret_cast<const T*>(ring + size_t(s) * SB);
      for (int i = i0; i < nbs; i += istep) {
        const int n = n0 + i;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kLaneGroups; ++j) {
          const int g = (j * wpb + sub) * 32 + lane;
          if (g < G) {
            const uint4 m = (i == i0 && j == 0)
                                ? m0
                                : keep_words(a.seed, a.t, b, n, g, a.thresh);
            if (a.mask)
              *reinterpret_cast<uint4*>(a.mask + (row + n) * H + g * kLanes) =
                  make_uint4(m.x & 0x01010101u, m.y & 0x01010101u, m.z & 0x01010101u,
                             m.w & 0x01010101u);
            part += masked_dot16(st + size_t(i) * H + g * kLanes, m, qk[j]);
          }
        }
        part = warp_sum(part);
        if (lane == 0) lpart[n * kFwdWarps + sub] = part;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    named_barrier(1, kFwdConsumers);

    // the softmax over <= 64 boxes, two a lane of warp 0
    if (warp == 0) {
      float l0 = -INFINITY, l1 = -INFINITY;
      if (lane < objs) {
        l0 = 0.f;
        for (int j = 0; j < wpb; ++j) l0 += lpart[lane * kFwdWarps + j];
      }
      if (lane + 32 < objs) {
        l1 = 0.f;
        for (int j = 0; j < wpb; ++j) l1 += lpart[(lane + 32) * kFwdWarps + j];
      }
      const float mx = warp_max(fmaxf(l0, l1));
      const float e0 = lane < objs ? expf(l0 - mx) : 0.f;
      const float e1 = lane + 32 < objs ? expf(l1 - mx) : 0.f;
      const float sum = warp_sum(e0 + e1);
      T* att = static_cast<T*>(a.att) + row;
      if (lane < objs) {
        const float p = e0 / sum;
        att[lane] = from_f<T>(p);
        aw[lane] = kFactored ? p * w0 : p;
      }
      if (lane + 32 < objs) {
        const float p = e1 / sum;
        att[lane + 32] = from_f<T>(p);
        aw[lane + 32] = kFactored ? p * w1 : p;
      }
    }
    named_barrier(1, kFwdConsumers);

    // the pooling: thread tid owns 8-lane groups tid + 256 q of D, every box
    float acc[kPoolGroups][8];
#pragma unroll
    for (int q = 0; q < kPoolGroups; ++q)
#pragma unroll
      for (int l = 0; l < 8; ++l) acc[q][l] = 0.f;
    for (int n0 = 0; n0 < objs; n0 += pl.nb_p, ++it) {
      const int nbs = min(pl.nb_p, objs - n0);
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const P* st = reinterpret_cast<const P*>(ring + size_t(s) * SB);
      for (int i = 0; i < nbs; ++i) {
        const float sc = aw[n0 + i];
#pragma unroll
        for (int q = 0; q < kPoolGroups; ++q) {
          const int d = (tid + q * kFwdConsumers) * 8;
          if (d < D) {
            float x[8];
            load8(st + size_t(i) * D + d, x);
#pragma unroll
            for (int l = 0; l < 8; ++l) acc[q][l] += sc * x[l];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    T* out = static_cast<T*>(a.att_v) + size_t(b) * D;
#pragma unroll
    for (int q = 0; q < kPoolGroups; ++q) {
      const int d = (tid + q * kFwdConsumers) * 8;
      if (d < D) store8(out + d, acc[q]);
    }
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

// The deferred reduction's plan (decode_att.py _dvp_plan): a thread owns
// one 16-lane group and `nb` boxes; a block item is one batch row's `gc`
// groups (a slice of the row) by 256 / gc box sets of nb boxes; a ring
// stage holds `tc` steps of that slice of qp, and of the row's dl (as the
// 4-byte words that hold it, at the row's offset in its first word).
struct DvpPlan {
  int nb, gc, tc, stages;
};
constexpr int kDvpConsumers = 256;
constexpr int kDvpWarps = kDvpConsumers / 32;
constexpr int kDvpThreads = kDvpConsumers + 32;
constexpr int kDvpMaxBoxes = 4;

int round128(int x) { return (x + 127) / 128 * 128; }

struct DvpShape {
  int G, S, sc, g_items, s_items, row_bytes, q_bytes, dl_stride, stage_bytes;
};

DvpShape dvp_shape(const DvpPlan& pl, int objs, int H, int t_size) {
  DvpShape sh;
  sh.G = H / kLanes;
  sh.S = (objs + pl.nb - 1) / pl.nb;
  sh.sc = kDvpConsumers / pl.gc;
  sh.g_items = (sh.G + pl.gc - 1) / pl.gc;
  sh.s_items = (sh.S + sh.sc - 1) / sh.sc;
  sh.row_bytes = pl.gc * kLanes * t_size;
  sh.q_bytes = round128(pl.tc * sh.row_bytes);
  sh.dl_stride = (objs * t_size + 4 + 15) / 16 * 16;   // a row and its misalignment
  sh.stage_bytes = sh.q_bytes + round128(pl.tc * sh.dl_stride);
  return sh;
}

size_t dvp_smem(const DvpPlan& pl, const DvpShape& sh) {
  return 128 + size_t(pl.stages) * sh.stage_bytes + 2 * size_t(pl.stages) * sizeof(uint64_t);
}

template <typename T, typename O, int NB, bool kDropout>
__global__ void __launch_bounds__(kDvpThreads, 2)
decode_att_dvp_kernel(const DvpArgs a, const DvpPlan pl, const DvpShape sh) {
  extern __shared__ unsigned char dsmem_raw[];
  unsigned char* ring = align_smem<128>(dsmem_raw);
  const int RS = pl.stages, SB = sh.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + size_t(RS) * SB);
  uint64_t* empty = full + RS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int objs = a.objs, H = a.H, steps = a.T, B = a.B, tc = pl.tc;
  const int ipr = sh.g_items * sh.s_items;
  const long long items = static_cast<long long>(B) * ipr;

  if (tid == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(&full[s], 33);          // each producer lane's copies, lane 0, the bytes
      mbar_init(&empty[s], kDvpWarps);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kDvpWarps) {
    // ---- producer warp: each stage's qp rows by bulk copies (lane 0), its
    // dl rows by 4-byte cp.async copies (all lanes) of the aligned words
    // that hold them, each lane's landing counted on the stage's barrier ----
    const unsigned char* qps = static_cast<const unsigned char*>(a.qps);
    const unsigned char* dls = static_cast<const unsigned char*>(a.dls);
    const size_t dl_row = size_t(objs) * sizeof(T);
    int it = 0;
    for (long long j = blockIdx.x; j < items; j += gridDim.x) {
      const int b = static_cast<int>(j / ipr), gb = static_cast<int>(j % ipr) / sh.s_items;
      const int g0 = gb * pl.gc, gcount = min(pl.gc, sh.G - g0);
      const uint32_t bytes = static_cast<uint32_t>(gcount * kLanes * sizeof(T));
      for (int t0 = 0; t0 < steps; t0 += tc, ++it) {
        const int s = it % RS, nt = min(tc, steps - t0);
        mbar_wait(&empty[s], ((it / RS) & 1) ^ 1);
        unsigned char* st = ring + size_t(s) * SB;
        for (int i = 0; i < nt; ++i) {
          const size_t r0 = (size_t(t0 + i) * B + b) * dl_row, w0 = r0 & ~size_t(3);
          const int words = static_cast<int>((r0 + dl_row - w0 + 3) / 4);
          for (int x = lane; x < words; x += 32)
            cp_async4(st + sh.q_bytes + i * sh.dl_stride + 4 * x, dls + w0 + 4 * x);
        }
        cp_async_mbar_arrive(&full[s]);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], bytes * nt);
          for (int i = 0; i < nt; ++i)
            bulk_load(st + size_t(i) * sh.row_bytes,
                      qps + ((size_t(t0 + i) * B + b) * H + size_t(g0) * kLanes) * sizeof(T),
                      bytes, &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: thread (gl, sl) of an item owns group g0 + gl and the
  // boxes nb (s0 + sl) .. + nb - 1 ----
  const int gl = tid % pl.gc, sl = tid / pl.gc;
  // lane 4 i + j is kept where byte j of word i is below thresh: that byte
  // shifted to the top, compared with thresh << 24 (one unsigned compare)
  const uint32_t t24 = a.thresh << 24;
  const T* kp = static_cast<const T*>(a.k);
  O* out = static_cast<O*>(a.out);
  int it = 0;
  for (long long j = blockIdx.x; j < items; j += gridDim.x) {
    const int b = static_cast<int>(j / ipr), r = static_cast<int>(j % ipr);
    const int g = (r / sh.s_items) * pl.gc + gl;
    const int set = (r % sh.s_items) * sh.sc + sl;
    const bool active = sl < sh.sc && g < sh.G && set < sh.S;
    const int n0 = set * NB;
    float acc[NB][kLanes];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) acc[i][l] = 0.f;
    for (int t0 = 0; t0 < steps; t0 += tc, ++it) {
      const int s = it % RS, nt = min(tc, steps - t0);
      mbar_wait(&full[s], (it / RS) & 1);
      const unsigned char* st = ring + size_t(s) * SB;
      const unsigned char* dl_s = st + sh.q_bytes;
      // every thread runs the steps, the idle ones on box objs - 1, so that
      // the warp stays converged: t, b and the key schedule stay uniform,
      // and the boxes' draws have no branch between them to interleave
      for (int i = 0; i < nt; ++i) {
        const uint32_t t = static_cast<uint32_t>(t0 + i);
        // qp_t's 16 lanes as f32, once for all of this thread's boxes
        float q[kLanes];
        load16(reinterpret_cast<const T*>(st + size_t(i) * sh.row_bytes) + gl * kLanes, q);
        const T* dl_t = reinterpret_cast<const T*>(
            dl_s + i * sh.dl_stride + (((size_t(t) * B + b) * objs * sizeof(T)) & 3));
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          const int n = min(n0 + bx, objs - 1);
          const float d = to_f(dl_t[n]);
          if constexpr (kDropout) {
            const uint4 w = philox4x32_10(b, n, g, a.seed, t);
            const uint32_t m[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int l = 0; l < kLanes; ++l)
              if ((m[l >> 2] << (24 - 8 * (l & 3))) < t24) acc[bx][l] = fmaf(d, q[l], acc[bx][l]);
          } else {
#pragma unroll
            for (int l = 0; l < kLanes; ++l) acc[bx][l] = fmaf(d, q[l], acc[bx][l]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (active) {
      float kk[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) kk[l] = to_f(kp[g * kLanes + l]);
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        const int n = n0 + bx;
        if (n < objs) {
#pragma unroll
          for (int l = 0; l < kLanes; ++l) acc[bx][l] *= a.att_scale * kk[l];
          store16(out + (size_t(b) * objs + n) * H + g * kLanes, acc[bx]);
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename P, bool F>
cudaError_t fwd_launch(const FwdArgs& a, int B, cudaStream_t s) {
  if (a.H > kMaxFwdWidth || a.D > kMaxFwdWidth) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int bps = fwd_blocks_per_sm(B, sms);
  const FwdPlan pl = fwd_plan(sizeof(T), sizeof(P), a.objs, a.H, a.D, bps);
  const size_t smem = fwd_smem(pl, a.H);
  e = set_smem(decode_att_fwd_kernel<T, P, F>, smem);
  if (e != cudaSuccess) return e;
  // persistent: bps blocks an SM, each taking rows blockIdx.x + grid i
  const int grid = B < bps * sms ? B : bps * sms;
  decode_att_fwd_kernel<T, P, F><<<grid, kFwdThreads, smem, s>>>(a, pl, B);
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

namespace {

// the kernel with NB boxes a thread (its sums stay in registers)
template <typename T, typename O, int NB, bool kDropout>
cudaError_t dvp_launch_k(const DvpArgs& a, const DvpPlan& pl, int grid, cudaStream_t s) {
  const DvpShape sh = dvp_shape(pl, a.objs, a.H, sizeof(T));
  const size_t smem = dvp_smem(pl, sh);
  cudaError_t e = set_smem(decode_att_dvp_kernel<T, O, NB, kDropout>, smem);
  if (e != cudaSuccess) return e;
  decode_att_dvp_kernel<T, O, NB, kDropout><<<grid, kDvpThreads, smem, s>>>(a, pl, sh);
  return cudaGetLastError();
}

template <typename T, typename O, int NB>
cudaError_t dvp_launch_nb(const DvpArgs& a, const DvpPlan& pl, int grid, cudaStream_t s) {
  return a.thresh ? dvp_launch_k<T, O, NB, true>(a, pl, grid, s)
                  : dvp_launch_k<T, O, NB, false>(a, pl, grid, s);
}

template <typename T, typename O>
cudaError_t dvp_launch(const DvpArgs& a, const DvpPlan& pl, int grid, cudaStream_t s) {
  switch (pl.nb) {
    case 1: return dvp_launch_nb<T, O, 1>(a, pl, grid, s);
    case 2: return dvp_launch_nb<T, O, 2>(a, pl, grid, s);
    case 3: return dvp_launch_nb<T, O, 3>(a, pl, grid, s);
    default: return dvp_launch_nb<T, O, 4>(a, pl, grid, s);
  }
}

}  // namespace

// d_vp [B, objs * H] from dls [T, B, objs], qps [T, B, H] and k [H]; act as
// above for the inputs, out_kind 0 f32 / 1 bf16 for the output. The plan
// (nb boxes a thread, gc groups and tc steps a stage, ring stages, grid) is
// decode_att.py _dvp_plan's; qps and out 16-byte aligned.
extern "C" int decode_att_dvp(const void* dls, const void* qps, const void* k,
                              void* out, unsigned seed, int T, int B, int objs,
                              int H, float att_scale, int thresh, int act,
                              int out_kind, int nb, int gc, int tc, int stages,
                              int grid, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (T < 0 || bad_shape(objs, H, kLanes) || nb < 1 || nb > kDvpMaxBoxes || gc < 1 ||
      gc > kDvpConsumers || gc > H / kLanes || tc < 1 || stages < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DvpArgs a{dls, qps, k, out, seed, static_cast<uint32_t>(thresh), T, B, objs,
                  H, att_scale};
  const DvpPlan pl{nb, gc, tc, stages};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (act == 0 && out_kind == 0)
    e = dvp_launch<float, float>(a, pl, grid, s);
  else if (act == 0)
    e = dvp_launch<float, __nv_bfloat16>(a, pl, grid, s);
  else if (out_kind == 0)
    e = dvp_launch<__nv_bfloat16, float>(a, pl, grid, s);
  else
    e = dvp_launch<__nv_bfloat16, __nv_bfloat16>(a, pl, grid, s);
  return static_cast<int>(e);
}
