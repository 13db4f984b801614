// vqa_native: the host side of the port's feed (the port's own copy of
// native/vqa_native.cpp; the same four C entry points, the same bytes out).
//
// The reference reads one small .npz per image per item inside DataLoader
// workers (its dataset.py:93-104) and builds the spatial-relation graphs
// with a per-image O(N^2) Python loop (its util/relation.py:65-79). This
// library provides the native equivalents used by the packed-shard store
// and the offline graph construction:
//
//   - gather_rows_*: multithreaded gather of feature rows from the
//     memory-mapped packed shard into a contiguous batch buffer, with
//     optional f16 -> f32 widening: the host-side batch assembly that
//     precedes the copy to the card.
//   - spatial_relation_graphs: the 12-class bbox relation classifier over
//     all pairs of all images, threaded over images. Semantics match
//     vqa_tpu_torch/data/relation.py exactly.
//   - densify_answers: the soft answer scores min(count, 3) / 3 of a batch.
//
// Exposed as a plain C ABI loaded with ctypes (vqa_tpu_torch/data/native.py
// builds it with g++ into build/host/ at first use).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __F16C__
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- threading

template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn&& fn) {
  if (n_threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// IEEE 754 half -> float. Scalar fallback below; the gather uses the
// F16C hardware converter when the build target has it (VCVTPH2PS is
// bit-exact IEEE incl. subnormals/inf/nan) — the scalar path's subnormal
// branch defeats auto-vectorization and measured only ~1.9 GB/s of
// widened output on one core vs ~4 GB/s for raw memcpy gathers
// (the JAX package's scripts/bench_feed.py, on a CPU host).
inline float half_to_float(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {        // subnormal: normalize
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      // subnormal exponent is 1-15 = -14, minus the normalization shift
      bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

}  // namespace

extern "C" {

// Gather rows[i] of `src` (row_bytes each) into dst[i], threaded.
void gather_rows_bytes(const uint8_t* src, const int64_t* rows, int64_t n_rows,
                       int64_t row_bytes, uint8_t* dst, int n_threads) {
  parallel_for(n_rows, n_threads, [&](int64_t i) {
    std::memcpy(dst + i * row_bytes, src + rows[i] * row_bytes, row_bytes);
  });
}

// Gather float16 rows and widen to float32.
void gather_rows_f16_to_f32(const uint16_t* src, const int64_t* rows,
                            int64_t n_rows, int64_t row_elems, float* dst,
                            int n_threads) {
  parallel_for(n_rows, n_threads, [&](int64_t i) {
    const uint16_t* in = src + rows[i] * row_elems;
    float* out = dst + i * row_elems;
    int64_t j = 0;
#ifdef __F16C__
    for (; j + 8 <= row_elems; j += 8) {
      __m128i h = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + j));
      _mm256_storeu_ps(out + j, _mm256_cvtph_ps(h));
    }
#endif
    for (; j < row_elems; ++j) out[j] = half_to_float(in[j]);
  });
}

// ------------------------------------------------------- relation classifier

// Pairwise 12-class spatial relation (util/relation.py:3-45 semantics):
//   1/2 contains/inside (exact-equality intersection test), 3 overlap
//   IoU >= 0.5, 4..11 angle bucket when center distance <= 0.5 * diag,
//   0 otherwise. Matches the Python port bit-for-bit in double precision.
static void relation_pair(const double* a, const double* b, double w, double h,
                          int8_t* ab, int8_t* ba) {
  const double ix0 = std::max(a[0], b[0]);
  const double iy0 = std::max(a[1], b[1]);
  const double ix1 = std::min(a[2], b[2]);
  const double iy1 = std::min(a[3], b[3]);

  if (ix0 == b[0] && iy0 == b[1] && ix1 == b[2] && iy1 == b[3]) {
    *ab = 1;
    *ba = 2;
    return;
  }
  if (ix0 == a[0] && iy0 == a[1] && ix1 == a[2] && iy1 == a[3]) {
    *ab = 2;
    *ba = 1;
    return;
  }

  const double area_i = (iy1 - iy0) * (ix1 - ix0);
  const double area_a = (a[3] - a[1]) * (a[2] - a[0]);
  const double area_b = (b[3] - b[1]) * (b[2] - b[0]);
  const double iou = area_i / (area_a + area_b - area_i);
  if (iou >= 0.5) {
    *ab = 3;
    *ba = 3;
    return;
  }

  const double cax = a[0] + (a[2] - a[0]) / 2.0;
  const double cay = a[1] + (a[3] - a[1]) / 2.0;
  const double cbx = b[0] + (b[2] - b[0]) / 2.0;
  const double cby = b[1] + (b[3] - b[1]) / 2.0;
  const double dx = cbx - cax;
  const double dy = cby - cay;
  const double dist = std::sqrt(dx * dx + dy * dy) / std::sqrt(w * w + h * h);
  if (dist <= 0.5) {
    // delta = rad2deg(atan2(dx, dy)) - 90; bucket = ceil((delta mod 360)/45)+3
    const double delta = std::atan2(dx, dy) * (180.0 / M_PI) - 90.0;
    auto bucket = [](double x) {
      double m = std::fmod(x, 360.0);
      if (m < 0) m += 360.0;
      return static_cast<int8_t>(std::ceil(m / 45.0) + 3.0);
    };
    *ab = bucket(delta);
    *ba = bucket(delta + 180.0);
    return;
  }
  *ab = 0;
  *ba = 0;
}

// bbox: [B, N, 4] doubles; w, h: [B]; out: [B, N, N] int8 labels.
void spatial_relation_graphs(const double* bbox, int64_t n_imgs, int64_t n_objs,
                             const double* w, const double* h, int8_t* out,
                             int n_threads) {
  parallel_for(n_imgs, n_threads, [&](int64_t img) {
    const double* boxes = bbox + img * n_objs * 4;
    int8_t* g = out + img * n_objs * n_objs;
    std::memset(g, 0, n_objs * n_objs);
    for (int64_t i = 0; i < n_objs; ++i) {
      for (int64_t j = i + 1; j < n_objs; ++j) {
        relation_pair(boxes + i * 4, boxes + j * 4, w[img], h[img],
                      &g[i * n_objs + j], &g[j * n_objs + i]);
      }
    }
  });
}

// Densify sparse answer dicts: for each row, scatter min(count,3)/3 at the
// given indices (dataset.py:85-90). idx/cnt are flattened with row offsets.
void densify_answers(const int64_t* offsets, const int32_t* indices,
                     const int32_t* counts, int64_t n_rows, int64_t ans_dim,
                     float* out, int n_threads) {
  parallel_for(n_rows, n_threads, [&](int64_t r) {
    float* row = out + r * ans_dim;
    std::memset(row, 0, ans_dim * sizeof(float));
    for (int64_t k = offsets[r]; k < offsets[r + 1]; ++k) {
      const int32_t c = counts[k] < 3 ? counts[k] : 3;
      row[indices[k]] = static_cast<float>(c) / 3.0f;
    }
  });
}

}  // extern "C"
