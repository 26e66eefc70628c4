// Host band fill for the port's compact band upload.
//
// Started as a copy of the JAX package's native ingest library
// (mustache_tpu/io/native/normalize.cpp:186-565). mtpu_fill_band is an
// unchanged copy; mtpu_classify_values counts the copy's two censuses
// (mtpu_classify_values and mtpu_classify_values4 there) in one pass. The
// compact fills differ: mtpu_fill_band_compact and
// mtpu_fill_band_compact_range are one loop over a row window
// (fill_compact below) that, on a COO sorted by row, walks only each
// thread's own rows' entries, found by binary search on x, where the copy
// made every thread read every entry; they fill a u8, u16 or nibble-packed
// u4 band, the u4 one straight from the COO where the copy filled a u8
// band and packed it (mtpu_pack_band4 there); mtpu_fill_band_compact also
// counts mtpu_classify_values' u8 and u16 census in that pass and can
// hold its exceptions for mtpu_take_exceptions. A COO not sorted by row
// gets -2 and its band untouched or zeroed, and the `scan` argument runs
// the copy's loop. The host normalize of that file (mtpu_normalize_coo)
// is normalize.cpp beside this one.
//
// Built at first use by mustache_tpu_torch/kernels/build.py with
//   g++ -O3 -fPIC -shared -std=c++17 band_fill.cpp -lpthread
// and bound with ctypes in mustache_tpu_torch/io/native/__init__.py.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

// The first entry whose row is >= r, by binary search; the rows must be
// sorted for the answer to mean anything, which fill_compact proves.
template <typename I>
int64_t lower_row(const I* xs, int64_t n, int64_t r) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (static_cast<int64_t>(xs[mid]) < r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Exceptions one thread found, or, held for the caller (mtpu_fill_band_
// compact's `held`), those of every thread.
struct Exceptions {
  std::vector<int32_t> r, c;
  std::vector<float> v;
};
using Held = std::vector<Exceptions>;

// The compact band's element kinds: BITS 8 and 16 hold one value a
// cell, BITS 4 two a byte (the even diagonal in the low nibble), so a row
// of ldb diagonals takes ldb / 2 bytes.
template <int BITS>
using Elem = typename std::conditional<BITS == 16, uint16_t, uint8_t>::type;

// The compact fill of rows [g0, g1) into `band` (row 0 = global row g0):
// band[x - g0, y - x] = v for the values that fit the band's kind
// (non-negative integers below 16 for u4, 256 for u8, 65536 for u16), an
// (x, y - x, f32 v) exception for the others; entries outside the rows
// or the band's ldb diagonals are skipped. Threads own rows, so each
// (x, y) pair is written by one thread in input order, and no two
// threads share a byte of a u4 band.
//
// A u4 band is written as the u8 fill and a nibble pack of its band
// would leave it: a value in [16, 256) clears its nibble. Its output may
// hold anything on entry (a pinned slab the caller reuses): each thread
// zeroes its own rows before its walk, since a nibble write keeps the
// other half of its byte. The u8 and u16 bands come zeroed.
//
// With `scan`, each thread reads every entry and keeps its own rows (the
// loop this file copied). Otherwise each thread walks only the entry
// range of its rows, found by binary search on x, and the entries
// outside [g0, g1) are read in pieces for their order alone. Every piece
// checks that x never decreases, and the pieces' seams are checked after
// the join: together that proves the COO sorted by row, and so the
// binary searches right. A COO that is not gets -2, mostly before any
// write (the band untouched), else with the band zeroed.
// `census` (non-null): the walk also counts mtpu_classify_values' two
// misfit counts over every entry into census[0] (u8) and census[1] (u16).
//
// Each thread keeps its exceptions in its own list (misfits sit near the
// diagonal of every row, and one shared slot counter made the threads
// queue on its cache line). After the join they are copied to exc_r,
// exc_c, exc_v, or, with `held`, handed over whole in *held with no
// capacity, for mtpu_take_exceptions.
//
// One thread, or fewer than 2^16 entries: one pass over every entry in
// input order, the same for any order of rows.
//
// Returns the exception count, -1 when exc_cap would overflow, -2 when
// the COO is not sorted by row.
template <int BITS, typename I>
int fill_compact(const I* xs, const I* ys, const double* vs, int64_t n,
                 Elem<BITS>* band, int64_t g0, int64_t g1, int64_t ldb,
                 int32_t* exc_r, int32_t* exc_c, float* exc_v,
                 int64_t exc_cap, int32_t n_threads, bool scan,
                 int64_t* census, Held** held) {
  using B = Elem<BITS>;
  // elements a row of the output holds
  const int64_t ldo = BITS == 4 ? ldb / 2 : ldb;
  Held excs(std::max<int32_t>(n_threads, 1));
  if (held) exc_cap = INT64_MAX;
  std::atomic<int64_t> ne8{0}, ne16{0};
  std::atomic<int> overflow{0}, unsorted{0};
  const bool count = census != nullptr && !scan;
  // rows [r0, r1) of a u4 output zeroed; the others come zeroed
  auto clear = [&](int64_t r0, int64_t r1) {
    if constexpr (BITS == 4)
      if (r1 > r0)
        std::memset(band + (r0 - g0) * ldo, 0, sizeof(B) * (r1 - r0) * ldo);
  };
  // entries [e0, e1) in input order, filling rows [r0, r1); `order`
  // stops at the first x that decreases (or another thread's)
  auto pass = [&](Exceptions& ex, int64_t e0, int64_t e1, int64_t r0,
                  int64_t r1, bool order) {
    int64_t l8 = 0, l16 = 0, prev = INT64_MIN;
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t x = xs[e];
      if (order) {
        if (x < prev || ((e & 0xFFFF) == 0 &&
                         unsorted.load(std::memory_order_relaxed))) {
          unsorted.store(1, std::memory_order_relaxed);
          return;
        }
        prev = x;
      }
      bool in = x >= r0 && x < r1;
      int64_t d = 0;
      if (in) {
        d = static_cast<int64_t>(ys[e]) - x;
        in = d >= 0 && d < ldb;
      }
      if (!in && !count) continue;
      // the census's test (a non-negative integer below the limit) with
      // no libm call: below 2^16 the int32 cast keeps integers and
      // changes every fraction; NaN and infinities fail the range test
      const double v = vs[e];
      const bool f16 = v >= 0.0 && v < 65536.0 &&
                       static_cast<double>(static_cast<int32_t>(v)) == v;
      const bool f8 = f16 && v < 256.0;
      l16 += !f16;
      l8 += !f8;
      if (!in) continue;
      if constexpr (BITS == 4) {
        const bool f4 = f8 && v < 16.0;
        if (f8) {
          B& b = band[(x - g0) * ldo + d / 2];
          const int s = static_cast<int>(d & 1) * 4;
          b = static_cast<B>((b & ~(0xF << s)) |
                             ((f4 ? static_cast<int>(v) : 0) << s));
        }
        if (f4) continue;
      } else if (BITS == 16 ? f16 : f8) {
        band[(x - g0) * ldb + d] = static_cast<B>(v);
        continue;
      }
      if (static_cast<int64_t>(ex.r.size()) >= exc_cap) {
        overflow.store(1, std::memory_order_relaxed);
        return;
      }
      ex.r.push_back(static_cast<int32_t>(x));
      ex.c.push_back(static_cast<int32_t>(d));
      ex.v.push_back(static_cast<float>(v));
    }
    if (count) {
      ne8.fetch_add(l8, std::memory_order_relaxed);
      ne16.fetch_add(l16, std::memory_order_relaxed);
    }
  };
  const int64_t span = g1 - g0;
  auto finish = [&]() -> int {
    if (unsorted.load()) {
      std::memset(band, 0, sizeof(B) * span * ldo);
      return -2;
    }
    int64_t total = 0;
    for (const auto& ex : excs) total += ex.r.size();
    if (overflow.load() || total > exc_cap) return -1;
    if (count) {
      census[0] = ne8.load();
      census[1] = ne16.load();
    }
    if (held) {
      *held = new Held(std::move(excs));
      return static_cast<int>(total);
    }
    int64_t at = 0;
    for (const auto& ex : excs) {
      std::copy(ex.r.begin(), ex.r.end(), exc_r + at);
      std::copy(ex.c.begin(), ex.c.end(), exc_c + at);
      std::copy(ex.v.begin(), ex.v.end(), exc_v + at);
      at += ex.r.size();
    }
    return static_cast<int>(total);
  };
  if (n_threads <= 1 || n < (1 << 16) || span <= 0) {
    clear(g0, g1);
    pass(excs[0], 0, n, g0, g1, false);
    return finish();
  }
  // each thread's rows, as the copied loop splits them
  const int64_t chunk = (span + n_threads - 1) / n_threads;
  std::vector<int64_t> r0s;
  for (int32_t t = 0; t < n_threads && g0 + t * chunk < g1; ++t)
    r0s.push_back(g0 + t * chunk);
  const int64_t T = static_cast<int64_t>(r0s.size());
  auto r1_of = [&](int64_t t) { return std::min(g1, r0s[t] + chunk); };
  std::vector<std::thread> pool;
  if (scan) {
    for (int64_t t = 0; t < T; ++t)
      pool.emplace_back([&, t] {
        clear(r0s[t], r1_of(t));
        pass(excs[t], 0, n, r0s[t], r1_of(t), false);
      });
    for (auto& th : pool) th.join();
    return finish();
  }
  // before any write, two necessary conditions, so that a COO in
  // another order (a .hic file's block order) is mostly refused with its
  // band untouched: the rows at 4096 evenly spaced entries never
  // decrease, nor the binary searches' entries. lo[t]: the first entry
  // of thread t's rows; lo[T]: of rows >= g1
  for (int64_t k = 1; k < 4096; ++k)
    if (xs[(k - 1) * n / 4096] > xs[k * n / 4096]) return -2;
  std::vector<int64_t> lo(T + 1);
  for (int64_t t = 0; t < T; ++t) lo[t] = lower_row(xs, n, r0s[t]);
  lo[T] = lower_row(xs, n, g1);
  for (int64_t t = 0; t < T; ++t)
    if (lo[t] > lo[t + 1]) return -2;
  // the pieces tile [0, n): T of the rows before g0, the T walks, T of
  // the rows from g1 on
  const int64_t pre = lo[0], post = n - lo[T];
  auto piece = [&](int64_t base, int64_t len, int64_t t) {
    return base + len * t / T;
  };
  std::vector<int64_t> seams;
  for (int64_t t = 0; t < T; ++t) {
    seams.push_back(piece(0, pre, t));
    seams.push_back(lo[t]);
    seams.push_back(piece(lo[T], post, t));
  }
  for (int64_t t = 0; t < T; ++t) {
    pool.emplace_back([&, t] {
      Exceptions& ex = excs[t];
      clear(r0s[t], r1_of(t));
      pass(ex, piece(0, pre, t), piece(0, pre, t + 1), 0, 0, true);
      pass(ex, lo[t], lo[t + 1], r0s[t], r1_of(t), true);
      pass(ex, piece(lo[T], post, t), piece(lo[T], post, t + 1), 0, 0, true);
    });
  }
  for (auto& th : pool) th.join();
  for (const int64_t s : seams)
    if (s > 0 && s < n && xs[s - 1] > xs[s]) unsorted.store(1);
  return finish();
}

template <int BITS>
int compact_kind(const void* xs, const void* ys, int32_t xy_is64,
                 const double* vs, int64_t n_entries, void* band, int64_t g0,
                 int64_t g1, int64_t ldb, int32_t* exc_r, int32_t* exc_c,
                 float* exc_v, int64_t exc_cap, int32_t n_threads, bool scan,
                 int64_t* census, Held** held) {
  Elem<BITS>* b = static_cast<Elem<BITS>*>(band);
  if (xy_is64)
    return fill_compact<BITS>(static_cast<const int64_t*>(xs),
                              static_cast<const int64_t*>(ys), vs, n_entries,
                              b, g0, g1, ldb, exc_r, exc_c, exc_v, exc_cap,
                              n_threads, scan, census, held);
  return fill_compact<BITS>(static_cast<const int32_t*>(xs),
                            static_cast<const int32_t*>(ys), vs, n_entries, b,
                            g0, g1, ldb, exc_r, exc_c, exc_v, exc_cap,
                            n_threads, scan, census, held);
}

// elem_bits: 4 (nibble-packed, an even ldb), 8 or 16
int compact(const void* xs, const void* ys, int32_t xy_is64,
            const double* vs, int64_t n_entries, void* band,
            int32_t elem_bits, int64_t g0, int64_t g1, int64_t ldb,
            int32_t* exc_r, int32_t* exc_c, float* exc_v, int64_t exc_cap,
            int32_t n_threads, int32_t scan, int64_t* census, Held** held) {
  if (n_entries < 0 || ldb <= 0 || g1 < g0) return -1;
  const bool sc = scan != 0;
  switch (elem_bits) {
    case 4:
      if (ldb & 1) return -1;
      return compact_kind<4>(xs, ys, xy_is64, vs, n_entries, band, g0, g1,
                             ldb, exc_r, exc_c, exc_v, exc_cap, n_threads,
                             sc, census, held);
    case 8:
      return compact_kind<8>(xs, ys, xy_is64, vs, n_entries, band, g0, g1,
                             ldb, exc_r, exc_c, exc_v, exc_cap, n_threads,
                             sc, census, held);
    case 16:
      return compact_kind<16>(xs, ys, xy_is64, vs, n_entries, band, g0, g1,
                              ldb, exc_r, exc_c, exc_v, exc_cap, n_threads,
                              sc, census, held);
  }
  return -1;
}

}  // namespace

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

// Exception census for the compact band transfer, in one pass: counts
// values NOT exactly representable as uint8 / uint16 / a 4-bit count
// (non-negative integers below 256 / 65536 / 16; non-finite values never
// fit). out[0] = u8 misfits, out[1] = u16 misfits, out[2] = u4 misfits.
// The Python side picks the narrowest band dtype whose band bytes plus
// 12-byte exception records beat the f32 band.
int mtpu_classify_values(const double* vs, int64_t n_entries,
                         int32_t n_threads, int64_t* out) {
  if (n_entries < 0 || !out) return -1;
  std::atomic<int64_t> n8{0}, n16{0}, n4{0};
  auto run = [&](int64_t e0, int64_t e1) {
    int64_t l8 = 0, l16 = 0, l4 = 0;
    for (int64_t e = e0; e < e1; ++e) {
      const double v = vs[e];
      const bool is_int =
          v >= 0.0 && v == std::floor(v) && std::isfinite(v);
      if (!is_int || v >= 256.0) ++l8;
      if (!is_int || v >= 65536.0) ++l16;
      if (!is_int || v >= 16.0) ++l4;
    }
    n8.fetch_add(l8, std::memory_order_relaxed);
    n16.fetch_add(l16, std::memory_order_relaxed);
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
  out[0] = n8.load();
  out[1] = n16.load();
  out[2] = n4.load();
  return 0;
}

// Compact band fill: integer-fitting values go into a narrow (u8, u16
// or nibble-packed u4: elem_bits 8, 16 or 4, ldb the band's diagonals)
// band; the misfits are emitted as an (row, col, f32 value) exception list
// the device scatters over the widened band before normalizing — lossless
// relative to the f32 band fill (the scattered float32 cast is exactly the
// cast mtpu_fill_band performs). Rows [0, n_rows) of fill_compact, row-
// owned threads walking their own rows of a COO sorted by row (`scan`:
// reading every entry); exception order across threads is irrelevant
// because the ingest paths guarantee unique (x, y) pairs (duplicate
// triplets are NOT supported on this path — callers with possibly-
// duplicated input must use the f32 band). `census` (nullable, two
// int64): mtpu_classify_values' u8 and u16 counts over every entry, from
// the same pass. `held` (nullable): the exceptions are kept, with no capacity,
// for mtpu_take_exceptions (exc_* and exc_cap are not read). Returns the
// exception count, -1 when exc_cap would overflow (caller falls back to
// the f32 band), -2 when the COO is not sorted by row (the band
// untouched or zeroed; `scan` fills it).
int mtpu_fill_band_compact(const void* xs, const void* ys, int32_t xy_is64,
                           const double* vs, int64_t n_entries, void* band,
                           int32_t elem_bits, int64_t n_rows, int64_t ldb,
                           int32_t* exc_r, int32_t* exc_c, float* exc_v,
                           int64_t exc_cap, int32_t n_threads, int32_t scan,
                           int64_t* census, void** held) {
  return compact(xs, ys, xy_is64, vs, n_entries, band, elem_bits, 0, n_rows,
                 ldb, exc_r, exc_c, exc_v, exc_cap, n_threads, scan, census,
                 reinterpret_cast<Held**>(held));
}

// Copy the exceptions mtpu_fill_band_compact held into exc_r, exc_c,
// exc_v (sized to the count it returned), and free them; with null
// buffers, only free them.
void mtpu_take_exceptions(void* held, int32_t* exc_r, int32_t* exc_c,
                          float* exc_v) {
  Held* h = static_cast<Held*>(held);
  if (exc_r && exc_c && exc_v) {
    int64_t at = 0;
    for (const auto& ex : *h) {
      std::copy(ex.r.begin(), ex.r.end(), exc_r + at);
      std::copy(ex.c.begin(), ex.c.end(), exc_c + at);
      std::copy(ex.v.begin(), ex.v.end(), exc_v + at);
      at += ex.r.size();
    }
  }
  delete h;
}

// Row-windowed variant of mtpu_fill_band_compact for slab-streamed
// host-fill/H2D overlap: fills ONLY global rows [g0, g1) into a slab
// buffer whose row 0 is global row g0. Exception rows are GLOBAL row
// indices (the device scatter runs on the concatenated band). Same
// unique-(x, y) contract and return codes, with no census.
int mtpu_fill_band_compact_range(const void* xs, const void* ys,
                                 int32_t xy_is64, const double* vs,
                                 int64_t n_entries, void* band,
                                 int32_t elem_bits, int64_t g0, int64_t g1,
                                 int64_t ldb, int32_t* exc_r,
                                 int32_t* exc_c, float* exc_v,
                                 int64_t exc_cap, int32_t n_threads,
                                 int32_t scan) {
  return compact(xs, ys, xy_is64, vs, n_entries, band, elem_bits, g0, g1,
                 ldb, exc_r, exc_c, exc_v, exc_cap, n_threads, scan,
                 nullptr, nullptr);
}

}  // extern "C"
