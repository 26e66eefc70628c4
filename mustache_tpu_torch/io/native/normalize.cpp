// Host per-diagonal z-score normalize for the port's host-normalize modes
// (the native fast path of normalize.py's local regime).
//
// Copied from the JAX package's native ingest library
// (mustache_tpu/io/native/normalize.cpp:12-185: process_diag_coo and
// mtpu_normalize_coo), unchanged but for this header. The band half of
// that file is band_fill.cpp.
//
// Built at first use by mustache_tpu_torch/kernels/build.py with
//   g++ -O3 -fPIC -shared -std=c++17 normalize.cpp -lpthread
// (no -march=native, unlike the JAX package's Makefile, so the compiler
// contracts no multiply-add into an FMA; tests/test_torch_normalize.py
// states the measured difference) and bound with ctypes in
// mustache_tpu_torch/io/native/__init__.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Indirect variant: entries stay in caller order; `order` maps the
// diagonal-grouped position to the original entry index, z is written back
// in place of v, and (optionally) into a zeroed f32 band buffer
// band[x * ldb + d] for the device transfer layout.
struct CooArgs {
  const int64_t* xs;        // position along the diagonal: min(x, y)
  const int64_t* ds;        // |y - x| per entry
  double* v;                // in-out: raw value -> z
  const int64_t* order;     // grouped position -> original entry index
  const int64_t* row_off;   // [Dv+1]
  int64_t n_bins;
  int32_t Dv;
  int32_t F;
  const double* g_mean;
  const double* g_std;
  const double* weights;
  float* band_out;          // nullable [n_rows, ldb] zero-initialized
  int64_t ldb;
};

void process_diag_coo(const CooArgs& a, int32_t d) {
  const int64_t m = a.n_bins - d;
  if (m <= 0) return;
  const int64_t e0 = a.row_off[d], e1 = a.row_off[d + 1];
  if (e0 == e1) return;

  std::vector<double> vals(m, 0.0);
  for (int64_t e = e0; e < e1; ++e) {
    vals[a.xs[a.order[e]]] = a.v[a.order[e]] + 0.001;  // last write wins
  }

  std::vector<double> c0(m + 1, 0.0), c1(m + 1, 0.0), c2(m + 1, 0.0);
  for (int64_t i = 0; i < m; ++i) {
    const double val = vals[i];
    c0[i + 1] = c0[i] + (val != 0.0 ? 1.0 : 0.0);
    c1[i + 1] = c1[i] + val;
    c2[i + 1] = c2[i] + val * val;
  }

  const double gm = a.g_mean[d];
  const double gs2 = a.g_std[d] * a.g_std[d];
  const double w = a.weights[d];
  const int64_t F = a.F;
  const int64_t off = (std::min<int64_t>(m, F) - 1) / 2;

  for (int64_t e = e0; e < e1; ++e) {
    const int64_t orig = a.order[e];
    const int64_t i = a.xs[orig];
    const int64_t lo = std::max<int64_t>(0, i + off - F + 1);
    const int64_t hi = std::min<int64_t>(m, i + off + 1);
    const double cnt = c0[hi] - c0[lo];
    const double s1 = c1[hi] - c1[lo];
    const double s2 = c2[hi] - c2[lo];

    double lv = (s2 - s1 * s1 / cnt) / (cnt - 1.0);
    double lm = s1 / cnt;
    if (!std::isfinite(lv)) lv = gs2;
    if (cnt < 30.0) { lm = gm; lv = gs2; }
    if (!std::isfinite(lm)) lm = gm;

    double z = (vals[i] - lm) / std::sqrt(lv);
    if (!std::isfinite(z)) z = 0.0;
    z *= w;
    a.v[orig] = z;
    if (a.band_out) a.band_out[i * a.ldb + d] = static_cast<float>(z);
  }
}

}  // namespace

extern "C" {

// One-call local-regime normalize over raw COO triplets (in caller order):
// per-diagonal global stats (two-pass, matching numpy's mean-then-deviation
// order), stable counting sort by diagonal, windowed z-score per entry
// written back into `v`, weights_out[d] = 1 + log30(1 + g_mean[d]), and an
// optional fused f32 band fill band_out[x * ldb + (y - x)] = z for the
// device transfer layout (caller passes a zeroed buffer, or null).
// Entries with y - x >= Dv are left untouched (reference semantics).
int mtpu_normalize_coo(const int64_t* xs, const int64_t* ys, double* v,
                       int64_t n_entries, int64_t n_bins, int32_t Dv,
                       int32_t F, double* weights_out, float* band_out,
                       int64_t ldb, int64_t* n_skipped, int32_t n_threads) {
  if (Dv <= 0 || n_entries < 0) return -1;
  // pos = min(x, y): lower-triangle input is treated as its mirrored
  // upper-triangle cell (the map is symmetric); entries outside the
  // [0, n_bins) square are counted skipped, never indexed (the per-diagonal
  // vector has only n_bins - d slots — raw x would run off the heap).
  std::vector<int64_t> ds(n_entries);
  std::vector<int64_t> pos_lo(n_entries);
  std::vector<int64_t> cnt(Dv, 0);
  for (int64_t e = 0; e < n_entries; ++e) {
    const int64_t lo = std::min(xs[e], ys[e]);
    const int64_t hi = std::max(xs[e], ys[e]);
    const int64_t d = (lo < 0 || hi >= n_bins) ? Dv : hi - lo;
    ds[e] = d;
    pos_lo[e] = lo;
    if (d < Dv) ++cnt[d];
  }

  // two-pass global per-diagonal stats (biased std, NaN-guard -> 0/1)
  std::vector<double> g_sum(Dv, 0.0), g_mean(Dv, 0.0), g_var(Dv, 0.0),
      g_std(Dv, 1.0);
  for (int64_t e = 0; e < n_entries; ++e) {
    const int64_t d = ds[e];
    if (d < Dv) g_sum[d] += v[e];
  }
  for (int32_t d = 0; d < Dv; ++d) {
    if (cnt[d] > 0) g_mean[d] = g_sum[d] / static_cast<double>(cnt[d]);
  }
  for (int64_t e = 0; e < n_entries; ++e) {
    const int64_t d = ds[e];
    if (d < Dv) {
      const double dev = v[e] - g_mean[d];
      g_var[d] += dev * dev;
    }
  }
  for (int32_t d = 0; d < Dv; ++d) {
    if (cnt[d] > 0) {
      const double s = std::sqrt(g_var[d] / static_cast<double>(cnt[d]));
      if (std::isfinite(s)) g_std[d] = s;
    }
    const double gm = std::isfinite(g_mean[d]) ? g_mean[d] : 0.0;
    g_mean[d] = gm;
    weights_out[d] = 1.0 + std::log1p(gm) / std::log(30.0);
  }

  // stable counting sort by diagonal (original order kept within a group,
  // preserving the last-write-wins duplicate semantics)
  std::vector<int64_t> row_off(Dv + 1, 0);
  for (int32_t d = 0; d < Dv; ++d) row_off[d + 1] = row_off[d] + cnt[d];
  if (n_skipped) *n_skipped = n_entries - row_off[Dv];
  std::vector<int64_t> order(row_off[Dv]);
  {
    std::vector<int64_t> pos(row_off.begin(), row_off.end() - 1);
    for (int64_t e = 0; e < n_entries; ++e) {
      const int64_t d = ds[e];
      if (d < Dv) order[pos[d]++] = e;
    }
  }

  CooArgs a{pos_lo.data(), ds.data(),    v,
            order.data(), row_off.data(), n_bins,
            Dv,          F,              g_mean.data(),
            g_std.data(), weights_out,   band_out,
            ldb};
  if (n_threads <= 1 || Dv < 4) {
    for (int32_t d = 0; d < Dv; ++d) process_diag_coo(a, d);
    return 0;
  }
  std::atomic<int32_t> next{0};
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      while (true) {
        const int32_t d = next.fetch_add(1);
        if (d >= Dv) break;
        process_diag_coo(a, d);
      }
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
