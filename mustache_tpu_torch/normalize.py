"""Per-diagonal z-score normalization of sparse contact maps, on the host.

A copy of ``mustache_tpu/normalize.py`` (numpy; the port must not import
the JAX package), for the port's host-normalize modes, float64 and
``exact_normalize=True``. The float32 default normalizes on the device
(``bandnorm.py``); ``normalize=False`` skips normalizing.

Reimplements the reference ``normalize_sparse`` (mustache.py:622-686).
Three implementations share the semantics: a threaded C++ core
(io/native/normalize.cpp, the default fast path), a vectorized numpy
band-matrix fallback (cumsum moving windows + per-entry gathers), and an
``exact=True`` mode that reproduces the reference's np.convolve summation
order bit-for-bit for golden comparisons.

Two regimes, selected exactly as in the reference:

* **local** (``(n - d_px) * res > 2Mb``): per-diagonal moving-window
  (window ``2Mb/res`` bins) mean/variance with global fallback when a
  window holds < 30 samples; the z-scored values are then scaled by
  ``1 + log30(1 + mean_d)`` (reference line :667).
* **global** (small maps): plain per-diagonal z-score.

``exact=True`` switches the local regime's window sums to ``np.convolve``
per diagonal, reproducing the reference's floating-point summation order
bit-for-bit (used by golden tests; the cumsum fast path agrees to ~1e-10).
Where no host C++ compiler can build the native core
(``io.native.available()``), the local regime's fast pass runs its numpy
twin, as the JAX package's does without its prebuilt library.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

from mustache_tpu_torch.io import native


def _moving_window_sums(a: np.ndarray, F: int, exact: bool,
                        row_lengths: np.ndarray) -> np.ndarray:
    """Row-wise moving-window sums matching ``np.convolve(row, ones(F), 'same')``
    where row ``d`` has true length ``row_lengths[d]`` (zero-padded in ``a``).

    numpy's 'same' mode centers with offset ``(min(len, F) - 1) // 2`` (it
    swaps arguments when the kernel is longer than the row), so
    ``out[i] = sum(row[i + off - F + 1 : i + off + 1])`` with zero padding.
    Short rows (len < F) take a per-row fallback to reproduce the swapped
    centering exactly; only out[:, :len] entries are meaningful.
    """
    D, n = a.shape
    csum = np.zeros((D, n + 1), dtype=np.float64)
    np.cumsum(a, axis=1, out=csum[:, 1:])
    off = (F - 1) // 2
    idx = np.arange(n)
    lo = np.clip(idx + off - F + 1, 0, n)
    hi = np.clip(idx + off + 1, 0, n)
    if exact:
        kernel = np.ones(F)
        out = np.zeros((D, n))
        for d in range(D):
            m = int(row_lengths[d])
            if m <= 0:
                continue
            out[d, :m] = np.convolve(a[d, :m], kernel, mode="same")[:m]
        return out
    out = csum[:, hi] - csum[:, lo]
    for d in np.nonzero(row_lengths < F)[0]:
        m = int(row_lengths[d])
        if m <= 0:
            out[d] = 0.0
            continue
        roff = (m - 1) // 2
        rlo = np.clip(idx[:m] + roff - F + 1, 0, m)
        rhi = np.clip(idx[:m] + roff + 1, 0, m)
        out[d, :m] = csum[d, rhi] - csum[d, rlo]
        out[d, m:] = 0.0
    return out


def _grouped_mean_std(d: np.ndarray, v: np.ndarray, D: int):
    """Per-diagonal mean/std (ddof=0) of COO values grouped by distance.

    Empty groups get mean=0, std=1 (reference NaN-guards :640-643)."""
    cnt = np.bincount(d, minlength=D).astype(np.float64)
    s = np.bincount(d, weights=v, minlength=D)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s / cnt
        # np.std is the biased estimator: E[(x-mean)^2]
        dev = v - mean[d]
        var = np.bincount(d, weights=dev * dev, minlength=D) / cnt
        std = np.sqrt(var)
    mean[~np.isfinite(mean)] = 0.0
    std[~np.isfinite(std)] = 1.0
    return mean, std


def normalize_sparse(x, y, v, resolution: int, distance_in_px: int, *,
                     exact: bool = False, work_dtype=np.float64,
                     band_out=None, n: int | None = None):
    """Normalize COO values ``v`` in place; returns per-diagonal p-weights.

    Mirrors the reference contract: ``v`` is mutated, and the returned
    ``pval_weights`` list (one ``1 + log30(1+mean_d)`` entry per local-regime
    diagonal) is computed for API parity (its downstream use is disabled in
    the reference as well, mustache.py:781-788).

    ``work_dtype=np.float32`` halves the band-matrix elementwise cost for
    the f32 detection path (moving-window sums are still accumulated in
    float64 — differencing long float32 cumsums would be catastrophic).

    ``band_out``: optional zeroed f32 ``[rows, Dl]`` buffer; when given,
    the normalized value of every entry is also scattered to
    ``band_out[x, y-x]`` (the device transfer layout) in the same pass —
    only entries with ``y-x < band_out.shape[1]`` are written.

    ``n``: bin count if the caller already knows it (saves two 18M-entry
    reductions at 1kb scale; this host throttles hard on memory passes).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if n is None:
        n = int(max(x.max(), y.max())) + 1
    dists = None  # computed lazily: the native path never needs it
    pval_weights: list[float] = []

    def fill_band(lo_d=0):
        if band_out is None:
            return
        d = np.abs(y - x) if dists is None else dists
        sel = (d >= lo_d) & (d < band_out.shape[1])
        band_out[x[sel], d[sel]] = v[sel]

    if (n - distance_in_px) * resolution > 2_000_000:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            F = int(2_000_000 / resolution)
            D = 2 + distance_in_px
            if n <= 0:
                return pval_weights

            Dv = min(D, n)  # diagonals beyond n are empty rows of size 0

            if not exact and native.available():
                # fast path: one call into the threaded C++ core (grouping,
                # global stats, windowed z, write-back, and the band fill
                # all native — the numpy glue dominated at 1kb scale); a
                # failed build raises
                vv = np.ascontiguousarray(v, np.float64)
                weights, n_skipped = native.normalize_coo(
                    x, y, vv, n, Dv, F, band_out=band_out)
                if vv is not v:
                    v[:] = vv
                if n_skipped:
                    # rare d in [Dv, Dl) raw entries (possible only
                    # for API callers bypassing the ingest filters)
                    fill_band(lo_d=Dv)
                return [float(w) for w in weights]

            dists = np.abs(y - x).astype(np.int64)
            g_mean, g_std = _grouped_mean_std(dists, v, D)

            # Band layout: row d holds the dense diagonal-d vector (+0.001 at
            # occupied bins, reference :635). Duplicate (x,d) entries:
            # last-write-wins, same as numpy fancy assignment.
            band = np.zeros((Dv, n), dtype=work_dtype)
            sel = dists < Dv
            band[dists[sel], x[sel]] = (v[sel] + 0.001).astype(work_dtype)

            row_lengths = n - np.arange(Dv)
            occ = band != 0
            counts = _moving_window_sums(occ.astype(np.float64), F, exact,
                                         row_lengths)
            s1 = _moving_window_sums(band, F, exact, row_lengths)
            s2 = _moving_window_sums(band * band, F, exact, row_lengths)

            # Only occupied positions are ever read back (the reference
            # assigns v from vals[x[indices]]), so gather the window sums
            # at those positions and do the per-entry math on the COO
            # vector instead of the whole [D, n] band — the band-wide work
            # is just the scatter + three cumsum window passes.
            flat = dists[sel] * np.int64(n) + x[sel]
            cnt_i = counts.reshape(-1).take(flat).astype(work_dtype)
            s1_i = s1.reshape(-1).take(flat).astype(work_dtype)
            s2_i = s2.reshape(-1).take(flat).astype(work_dtype)
            band_i = band.reshape(-1).take(flat)
            gm_i = g_mean.astype(work_dtype)[dists[sel]]
            gs2_i = (g_std.astype(work_dtype) ** 2)[dists[sel]]

            with np.errstate(invalid="ignore", divide="ignore"):
                lv = (s2_i - s1_i ** 2 / cnt_i) / (cnt_i - 1)
                lm = s1_i / cnt_i
            lv = np.where(np.isfinite(lv), lv, gs2_i)
            low = cnt_i < 30
            lm = np.where(low, gm_i, lm)
            lv = np.where(low, gs2_i, lv)
            lm = np.where(np.isfinite(lm), lm, gm_i)

            with np.errstate(invalid="ignore", divide="ignore"):
                z = (band_i - lm) / np.sqrt(lv)
            z = np.where(np.isfinite(z), z, work_dtype(0.0))
            weights = 1.0 + np.log1p(g_mean[:Dv]) / math.log(30)
            z = z * weights.astype(work_dtype)[dists[sel]]

            # One weight per diagonal that has a nonempty dense vector
            # (d < n), matching the reference's `continue` on empty rows.
            pval_weights = [float(w) for w in weights]

            v[sel] = z
            # Entries on diagonals >= Dv (only possible when n < D) keep
            # their raw values, as in the reference (loop range is capped by
            # vals.size == 0 `continue`).
            fill_band()
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            np.nan_to_num(v, copy=False, neginf=0, posinf=0, nan=0)
            dpx = min(distance_in_px, n)
            dists = np.abs(y - x).astype(np.int64)
            g_mean, g_std = _grouped_mean_std(dists, v, max(dpx, 1))
            sel = dists < dpx
            z = (v[sel] - g_mean[dists[sel]]) / g_std[dists[sel]]
            z[~np.isfinite(z)] = 0.0
            v[sel] = z
        fill_band()
    return pval_weights
