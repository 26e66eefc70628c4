// Host band fill for the port's compact band upload.
//
// Copied from the JAX package's native ingest library
// (mustache_tpu/io/native/normalize.cpp:186-565: mtpu_fill_band,
// mtpu_fill_band_u16, mtpu_classify_values, mtpu_fill_band_compact,
// mtpu_values_fit_u16, mtpu_classify_values4, mtpu_pack_band4,
// mtpu_fill_band_compact_range), unchanged but for this header. The
// host normalize of that file (mtpu_normalize_coo) is normalize.cpp
// beside this one.
//
// Built at first use by mustache_tpu_torch/kernels/build.py with
//   g++ -O3 -fPIC -shared -std=c++17 band_fill.cpp -lpthread
// and bound with ctypes in mustache_tpu_torch/io/native/__init__.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Raw band scatter-fill for the on-device normalize path: band[x, y-x] = v
// for entries with 0 <= y-x < ldb and 0 <= x < n_rows, in one threaded pass
// over the COO triplets (no intermediate mask/gather allocations — this
// replaces four 18M-element numpy passes on the throttled-host path).
// Index arrays are int32 or int64 (xy_is64), values float32 or float64
// (v_is64). Threads partition by ROW ownership (each scans all entries but
// writes only rows [r0, r1)): duplicate (x, y) triplets — legal in text /
// HiC-Pro input — are then written by exactly one thread in input order,
// preserving the last-write-wins semantics of the reference densify
// (mustache.py:923) with no data race.
int mtpu_fill_band(const void* xs, const void* ys, int32_t xy_is64,
                   const void* vs, int32_t v_is64, int64_t n_entries,
                   float* band, int64_t n_rows, int64_t ldb,
                   int32_t n_threads) {
  if (n_entries < 0 || ldb <= 0) return -1;
  auto run = [&](int64_t r0, int64_t r1) {
    const int32_t* x32 = static_cast<const int32_t*>(xs);
    const int32_t* y32 = static_cast<const int32_t*>(ys);
    const int64_t* x64 = static_cast<const int64_t*>(xs);
    const int64_t* y64 = static_cast<const int64_t*>(ys);
    const float* v32 = static_cast<const float*>(vs);
    const double* v64 = static_cast<const double*>(vs);
    for (int64_t e = 0; e < n_entries; ++e) {
      const int64_t x = xy_is64 ? x64[e] : static_cast<int64_t>(x32[e]);
      if (x < r0 || x >= r1) continue;
      const int64_t y = xy_is64 ? y64[e] : static_cast<int64_t>(y32[e]);
      const int64_t d = y - x;
      if (d < 0 || d >= ldb || x < 0 || x >= n_rows) continue;
      band[x * ldb + d] =
          v_is64 ? static_cast<float>(v64[e]) : v32[e];
    }
  };
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(0, n_rows);
    return 0;
  }
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min(n_rows, r0 + chunk);
    if (r0 >= r1) break;
    pool.emplace_back(run, r0, r1);
  }
  for (auto& th : pool) th.join();
  return 0;
}

// uint16 variant of mtpu_fill_band for the compact raw-band transfer path:
// integer counts < 65536 (every raw Hi-C text/.hic/.cool workload) upload
// at half the bytes and cast back to f32 on device losslessly. Same row-
// ownership threading / last-write-wins semantics as mtpu_fill_band.
// Caller must have verified the values are non-negative integers < 65536
// (mtpu_values_fit_u16); out-of-range values here would truncate silently.
int mtpu_fill_band_u16(const void* xs, const void* ys, int32_t xy_is64,
                       const double* vs, int64_t n_entries,
                       uint16_t* band, int64_t n_rows, int64_t ldb,
                       int32_t n_threads) {
  if (n_entries < 0 || ldb <= 0) return -1;
  auto run = [&](int64_t r0, int64_t r1) {
    const int32_t* x32 = static_cast<const int32_t*>(xs);
    const int32_t* y32 = static_cast<const int32_t*>(ys);
    const int64_t* x64 = static_cast<const int64_t*>(xs);
    const int64_t* y64 = static_cast<const int64_t*>(ys);
    for (int64_t e = 0; e < n_entries; ++e) {
      const int64_t x = xy_is64 ? x64[e] : static_cast<int64_t>(x32[e]);
      if (x < r0 || x >= r1) continue;
      const int64_t y = xy_is64 ? y64[e] : static_cast<int64_t>(y32[e]);
      const int64_t d = y - x;
      if (d < 0 || d >= ldb || x < 0 || x >= n_rows) continue;
      band[x * ldb + d] = static_cast<uint16_t>(vs[e]);
    }
  };
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(0, n_rows);
    return 0;
  }
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min(n_rows, r0 + chunk);
    if (r0 >= r1) break;
    pool.emplace_back(run, r0, r1);
  }
  for (auto& th : pool) th.join();
  return 0;
}

// Exception census for the compact band transfer: counts values NOT exactly
// representable as uint8 / uint16 (non-negative integers below 256 / 65536;
// non-finite values never fit). out[0] = u8 misfits, out[1] = u16 misfits.
// The Python side picks the narrowest band dtype whose band bytes plus
// 12-byte exception records beat the f32 band.
int mtpu_classify_values(const double* vs, int64_t n_entries,
                         int32_t n_threads, int64_t* out) {
  if (n_entries < 0 || !out) return -1;
  std::atomic<int64_t> n8{0}, n16{0};
  auto run = [&](int64_t e0, int64_t e1) {
    int64_t l8 = 0, l16 = 0;
    for (int64_t e = e0; e < e1; ++e) {
      const double v = vs[e];
      const bool is_int =
          v >= 0.0 && v == std::floor(v) && std::isfinite(v);
      if (!is_int || v >= 256.0) ++l8;
      if (!is_int || v >= 65536.0) ++l16;
    }
    n8.fetch_add(l8, std::memory_order_relaxed);
    n16.fetch_add(l16, std::memory_order_relaxed);
  };
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(0, n_entries);
  } else {
    const int64_t chunk = (n_entries + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t e0 = t * chunk;
      const int64_t e1 = std::min(n_entries, e0 + chunk);
      if (e0 >= e1) break;
      pool.emplace_back(run, e0, e1);
    }
    for (auto& th : pool) th.join();
  }
  out[0] = n8.load();
  out[1] = n16.load();
  return 0;
}

// Compact band fill: integer-fitting values go into a narrow (u8 or u16)
// band; the misfits are emitted as an (row, col, f32 value) exception list
// the device scatters over the widened band before normalizing — lossless
// relative to the f32 band fill (the scattered float32 cast is exactly the
// cast mtpu_fill_band performs). Same row-ownership threading as
// mtpu_fill_band; exception order across threads is irrelevant because the
// ingest paths guarantee unique (x, y) pairs (duplicate triplets are NOT
// supported on this path — callers with possibly-duplicated input must use
// the f32 band). Returns the exception count, or -1 when exc_cap would
// overflow (caller falls back to the f32 band).
int mtpu_fill_band_compact(const void* xs, const void* ys, int32_t xy_is64,
                           const double* vs, int64_t n_entries, void* band,
                           int32_t elem_is16, int64_t n_rows, int64_t ldb,
                           int32_t* exc_r, int32_t* exc_c, float* exc_v,
                           int64_t exc_cap, int32_t n_threads) {
  if (n_entries < 0 || ldb <= 0) return -1;
  const double limit = elem_is16 ? 65536.0 : 256.0;
  std::atomic<int64_t> n_exc{0};
  std::atomic<int> overflow{0};
  auto run = [&](int64_t r0, int64_t r1) {
    const int32_t* x32 = static_cast<const int32_t*>(xs);
    const int32_t* y32 = static_cast<const int32_t*>(ys);
    const int64_t* x64 = static_cast<const int64_t*>(xs);
    const int64_t* y64 = static_cast<const int64_t*>(ys);
    uint8_t* b8 = static_cast<uint8_t*>(band);
    uint16_t* b16 = static_cast<uint16_t*>(band);
    for (int64_t e = 0; e < n_entries; ++e) {
      const int64_t x = xy_is64 ? x64[e] : static_cast<int64_t>(x32[e]);
      if (x < r0 || x >= r1) continue;
      const int64_t y = xy_is64 ? y64[e] : static_cast<int64_t>(y32[e]);
      const int64_t d = y - x;
      if (d < 0 || d >= ldb || x < 0 || x >= n_rows) continue;
      const double v = vs[e];
      if (v >= 0.0 && v < limit && v == std::floor(v)) {
        if (elem_is16) b16[x * ldb + d] = static_cast<uint16_t>(v);
        else b8[x * ldb + d] = static_cast<uint8_t>(v);
      } else {
        const int64_t slot = n_exc.fetch_add(1, std::memory_order_relaxed);
        if (slot >= exc_cap) {
          overflow.store(1, std::memory_order_relaxed);
          return;
        }
        exc_r[slot] = static_cast<int32_t>(x);
        exc_c[slot] = static_cast<int32_t>(d);
        exc_v[slot] = static_cast<float>(v);
      }
    }
  };
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(0, n_rows);
  } else {
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t r0 = t * chunk;
      const int64_t r1 = std::min(n_rows, r0 + chunk);
      if (r0 >= r1) break;
      pool.emplace_back(run, r0, r1);
    }
    for (auto& th : pool) th.join();
  }
  if (overflow.load()) return -1;
  return static_cast<int>(n_exc.load());
}

// Threaded eligibility check for the uint16 band path: every value a
// non-negative integer in [0, 65536). Returns 1 when eligible, 0 otherwise.
int mtpu_values_fit_u16(const double* vs, int64_t n_entries,
                        int32_t n_threads) {
  std::atomic<int> ok{1};
  auto run = [&](int64_t e0, int64_t e1) {
    for (int64_t e = e0; e < e1; ++e) {
      const double v = vs[e];
      if (!(v >= 0.0) || v >= 65536.0 ||
          v != static_cast<double>(static_cast<uint16_t>(v))) {
        ok.store(0, std::memory_order_relaxed);
        return;
      }
      if ((e & 0xFFFFF) == 0xFFFFF &&
          !ok.load(std::memory_order_relaxed)) return;
    }
  };
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(0, n_entries);
    return ok.load();
  }
  const int64_t chunk = (n_entries + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t e0 = t * chunk;
    const int64_t e1 = std::min(n_entries, e0 + chunk);
    if (e0 >= e1) break;
    pool.emplace_back(run, e0, e1);
  }
  for (auto& th : pool) th.join();
  return ok.load();
}


// 4-bit census for the nibble-packed band transfer: counts values not
// exactly representable as a 4-bit count (non-negative integers below 16).
// Same contract as mtpu_classify_values; out[0] = u4 misfits.
int mtpu_classify_values4(const double* vs, int64_t n_entries,
                          int32_t n_threads, int64_t* out) {
  if (n_entries < 0 || !out) return -1;
  std::atomic<int64_t> n4{0};
  auto run = [&](int64_t e0, int64_t e1) {
    int64_t l4 = 0;
    for (int64_t e = e0; e < e1; ++e) {
      const double v = vs[e];
      const bool is_int =
          v >= 0.0 && v == std::floor(v) && std::isfinite(v);
      if (!is_int || v >= 16.0) ++l4;
    }
    n4.fetch_add(l4, std::memory_order_relaxed);
  };
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(0, n_entries);
  } else {
    const int64_t chunk = (n_entries + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t e0 = t * chunk;
      const int64_t e1 = std::min(n_entries, e0 + chunk);
      if (e0 >= e1) break;
      pool.emplace_back(run, e0, e1);
    }
    for (auto& th : pool) th.join();
  }
  out[0] = n4.load();
  return 0;
}

// Nibble-pack a filled uint8 band: two counts per output byte (even column
// in the low nibble). In-band values >= 16 are appended to the exception
// list (device scatters them over the unpacked band) and packed as 0.
// Exception order across threads is irrelevant (unique (row, col) pairs).
// Returns the exception count, or -1 when exc_cap would overflow.
int mtpu_pack_band4(const uint8_t* band, int64_t n_rows, int64_t ldb,
                    uint8_t* packed, int32_t* exc_r, int32_t* exc_c,
                    float* exc_v, int64_t exc_cap, int32_t n_threads) {
  if (n_rows < 0 || ldb <= 0 || (ldb & 1)) return -1;
  std::atomic<int64_t> n_exc{0};
  std::atomic<bool> overflow{false};
  const int64_t ldp = ldb / 2;
  auto run = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const uint8_t* src = band + r * ldb;
      uint8_t* dst = packed + r * ldp;
      for (int64_t c = 0; c < ldb; c += 2) {
        uint8_t lo = src[c], hi = src[c + 1];
        if (lo >= 16) {
          const int64_t i = n_exc.fetch_add(1, std::memory_order_relaxed);
          if (i < exc_cap) {
            exc_r[i] = (int32_t)r; exc_c[i] = (int32_t)c;
            exc_v[i] = (float)lo;
          } else overflow.store(true, std::memory_order_relaxed);
          lo = 0;
        }
        if (hi >= 16) {
          const int64_t i = n_exc.fetch_add(1, std::memory_order_relaxed);
          if (i < exc_cap) {
            exc_r[i] = (int32_t)r; exc_c[i] = (int32_t)(c + 1);
            exc_v[i] = (float)hi;
          } else overflow.store(true, std::memory_order_relaxed);
          hi = 0;
        }
        dst[c / 2] = (uint8_t)(lo | (hi << 4));
      }
    }
  };
  if (n_threads <= 1 || n_rows < 64) {
    run(0, n_rows);
  } else {
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t r0 = t * chunk;
      const int64_t r1 = std::min(n_rows, r0 + chunk);
      if (r0 >= r1) break;
      pool.emplace_back(run, r0, r1);
    }
    for (auto& th : pool) th.join();
  }
  if (overflow.load()) return -1;
  return (int)n_exc.load();
}


// Row-windowed variant of mtpu_fill_band_compact for slab-streamed
// host-fill/H2D overlap: fills ONLY global rows [g0, g1) into a slab
// buffer whose row 0 is global row g0. Exception rows are GLOBAL row
// indices (the device scatter runs on the concatenated band). Same
// unique-(x, y) contract; returns the exception count or -1 on overflow.
int mtpu_fill_band_compact_range(const void* xs, const void* ys,
                                 int32_t xy_is64, const double* vs,
                                 int64_t n_entries, void* band,
                                 int32_t elem_is16, int64_t g0, int64_t g1,
                                 int64_t ldb, int32_t* exc_r,
                                 int32_t* exc_c, float* exc_v,
                                 int64_t exc_cap, int32_t n_threads) {
  if (n_entries < 0 || ldb <= 0 || g1 < g0) return -1;
  const double limit = elem_is16 ? 65536.0 : 256.0;
  std::atomic<int64_t> n_exc{0};
  std::atomic<int> overflow{0};
  auto run = [&](int64_t r0, int64_t r1) {
    const int32_t* x32 = static_cast<const int32_t*>(xs);
    const int32_t* y32 = static_cast<const int32_t*>(ys);
    const int64_t* x64 = static_cast<const int64_t*>(xs);
    const int64_t* y64 = static_cast<const int64_t*>(ys);
    uint8_t* b8 = static_cast<uint8_t*>(band);
    uint16_t* b16 = static_cast<uint16_t*>(band);
    for (int64_t e = 0; e < n_entries; ++e) {
      const int64_t x = xy_is64 ? x64[e] : static_cast<int64_t>(x32[e]);
      if (x < r0 || x >= r1) continue;
      const int64_t y = xy_is64 ? y64[e] : static_cast<int64_t>(y32[e]);
      const int64_t d = y - x;
      if (d < 0 || d >= ldb) continue;
      const int64_t rloc = x - g0;
      const double v = vs[e];
      if (v >= 0.0 && v < limit && v == std::floor(v)) {
        if (elem_is16) b16[rloc * ldb + d] = static_cast<uint16_t>(v);
        else b8[rloc * ldb + d] = static_cast<uint8_t>(v);
      } else {
        const int64_t slot = n_exc.fetch_add(1, std::memory_order_relaxed);
        if (slot >= exc_cap) {
          overflow.store(1, std::memory_order_relaxed);
          return;
        }
        exc_r[slot] = static_cast<int32_t>(x);
        exc_c[slot] = static_cast<int32_t>(d);
        exc_v[slot] = static_cast<float>(v);
      }
    }
  };
  const int64_t span = g1 - g0;
  if (n_threads <= 1 || n_entries < (1 << 16)) {
    run(g0, g1);
  } else {
    const int64_t chunk = (span + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t r0 = g0 + t * chunk;
      const int64_t r1 = std::min(g1, r0 + chunk);
      if (r0 >= r1) break;
      pool.emplace_back(run, r0, r1);
    }
    for (auto& th : pool) th.join();
  }
  if (overflow.load()) return -1;
  return static_cast<int>(n_exc.load());
}

}  // extern "C"
