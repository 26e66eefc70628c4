// Native sift of a cooler fetch's pixel rows (mustache_tpu_torch/io/cool.py).
//
// A fetch reads a chromosome's pixel rows whole: every distance, and for a
// cis fetch the rows' trans pixels too. One pass over the three decoded
// columns (bin1_id, bin2_id as int64, count as float64) keeps the rows of
// the requested band or rectangle, shifts their bins to the chromosomes'
// own, balances them and drops the masked, non-finite and non-positive
// values:
//
//   keep   c_lo <= b2 < c_hi  and  |b2 - b1| <= kmax
//   shift  x = b1 - xlo,  y = b2 - ylo
//   weigh  t = v * wx[x], then t = t * wy[y] (two roundings, numpy's order)
//   drop   unless t > 0 and t is finite
//
// Without weights only the drop applies. The kept rows come out in input
// order, so a COO sorted by row stays sorted. The rows are split into
// contiguous ranges, one a thread: mtpu_cool_count counts each range's kept
// rows, the caller sizes the outputs and takes the prefix sum, and
// mtpu_cool_write writes each range straight into its slice of them. Both
// calls split the rows alike and decide each row by the same function.
// A kept row whose shifted bin lies outside its weight vector (a malformed
// file) makes either call return COOL_OUTSIDE. The numpy code this replaces
// is kept as io/cool.py's _select_plain, the twin the tests hold this one
// to. Built at first use by mustache_tpu_torch/kernels/build.py (g++ -O3
// -shared); plain C ABI, bound with ctypes in
// mustache_tpu_torch/io/native/__init__.py.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int COOL_OUTSIDE = -1;

struct Sift {
  const int64_t* b1;
  const int64_t* b2;
  const double* v;
  int64_t c_lo, c_hi, kmax, xlo, ylo;
  const double* wx;  // both null, or both given
  const double* wy;
  int64_t nwx, nwy;

  // 1 when row i is kept (its shifted bins and value in x, y, t), 0 when
  // dropped, COOL_OUTSIDE when a kept row's bin lies outside its weights.
  inline int row(int64_t i, int64_t* x, int64_t* y, double* t) const {
    const int64_t p = b1[i], q = b2[i];
    if (q < c_lo || q >= c_hi || kmax < 0) return 0;
    // |q - p| in unsigned arithmetic: no signed overflow on any input
    const uint64_t d = q >= p ? uint64_t(q) - uint64_t(p)
                              : uint64_t(p) - uint64_t(q);
    if (d > uint64_t(kmax)) return 0;
    *x = p - xlo;
    *y = q - ylo;
    double val = v[i];
    if (wx != nullptr) {
      if (*x < 0 || *x >= nwx || *y < 0 || *y >= nwy) return COOL_OUTSIDE;
      val = val * wx[*x];
      val = val * wy[*y];
    }
    if (!(val > 0.0) || !std::isfinite(val)) return 0;
    *t = val;
    return 1;
  }
};

// Range r of n rows split into n_ranges contiguous ranges.
inline void range_of(int64_t n, int32_t n_ranges, int32_t r, int64_t* lo,
                     int64_t* hi) {
  const int64_t q = n / n_ranges, m = n % n_ranges;
  *lo = q * r + (r < m ? r : m);
  *hi = *lo + q + (r < m ? 1 : 0);
}

// Runs fn(r) for every range r, one thread each (the last on the caller's);
// the first nonzero code any range returned, or 0.
template <class Fn>
int each_range(int32_t n_ranges, Fn fn) {
  std::atomic<int> rc{0};
  auto one = [&](int32_t r) {
    const int code = fn(r);
    if (code != 0) {
      int zero = 0;
      rc.compare_exchange_strong(zero, code);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_ranges > 0 ? n_ranges - 1 : 0);
  for (int32_t r = 0; r + 1 < n_ranges; ++r) pool.emplace_back(one, r);
  if (n_ranges > 0) one(n_ranges - 1);
  for (auto& t : pool) t.join();
  return rc.load();
}

Sift make(const int64_t* b1, const int64_t* b2, const double* v,
          const int64_t* bounds, const double* wx, int64_t nwx,
          const double* wy, int64_t nwy) {
  return Sift{b1, b2, v, bounds[0], bounds[1], bounds[2], bounds[3],
              bounds[4], wx, wy, nwx, nwy};
}

}  // namespace

extern "C" {

// counts[r] = the kept rows of range r of [0, n), for n_ranges ranges.
// bounds = {c_lo, c_hi, kmax, xlo, ylo}; wx, wy null for no balancing.
int mtpu_cool_count(const int64_t* b1, const int64_t* b2, const double* v,
                    int64_t n, const int64_t* bounds, const double* wx,
                    int64_t nwx, const double* wy, int64_t nwy,
                    int32_t n_ranges, int64_t* counts) {
  const Sift s = make(b1, b2, v, bounds, wx, nwx, wy, nwy);
  return each_range(n_ranges, [&](int32_t r) {
    int64_t lo, hi, kept = 0, x, y;
    double t;
    range_of(n, n_ranges, r, &lo, &hi);
    for (int64_t i = lo; i < hi; ++i) {
      const int k = s.row(i, &x, &y, &t);
      if (k < 0) return k;
      kept += k;
    }
    counts[r] = kept;
    return 0;
  });
}

// Writes the kept rows of range r from offsets[r] on, in input order, into
// x_out, y_out and v_out; offsets as the prefix sum of mtpu_cool_count's
// counts for the same n, bounds, weights and n_ranges.
int mtpu_cool_write(const int64_t* b1, const int64_t* b2, const double* v,
                    int64_t n, const int64_t* bounds, const double* wx,
                    int64_t nwx, const double* wy, int64_t nwy,
                    int32_t n_ranges, const int64_t* offsets, int64_t* x_out,
                    int64_t* y_out, double* v_out) {
  const Sift s = make(b1, b2, v, bounds, wx, nwx, wy, nwy);
  return each_range(n_ranges, [&](int32_t r) {
    int64_t lo, hi, at = offsets[r], x, y;
    double t;
    range_of(n, n_ranges, r, &lo, &hi);
    for (int64_t i = lo; i < hi; ++i) {
      const int k = s.row(i, &x, &y, &t);
      if (k < 0) return k;
      if (k) {
        x_out[at] = x;
        y_out[at] = y;
        v_out[at] = t;
        ++at;
      }
    }
    return 0;
  });
}

}  // extern "C"
