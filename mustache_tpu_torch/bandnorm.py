"""On-device per-diagonal z-score normalization of the chromosome band.

Torch port of ``mustache_tpu/bandnorm.py``. The transfer layout is the
diagonal band ``band[i, d] = map[i, i+d]``; diagonal ``d`` is column ``d``
of that array, so the reference's per-diagonal moving-window statistics
(mustache.py:622-686) become column-wise cumulative sums on the device.

Semantics match ``normalize.normalize_sparse`` for ingested data (finite
values, v > 0, unique (x, y) pairs), with the JAX module's two documented
deviations (v == 0 entries are unoccupied here; the global regime's
grouped statistics exclude non-finite/zero entries).

f32 precision: window sums run on globally-centered values (subtracting
each diagonal's mean turns the cumulative sums into zero-drift random
walks, so differencing them is stable), and the cumulative sums
accumulate in f64 on every device (see _RollingCumsum). The port's tests hold
it to the JAX package at rtol 2e-4, atol 2e-4, the tolerance
``tests/test_bandnorm.py`` uses for the f32 band.

Compact bands: the raw band may arrive as uint8 / uint16, or as uint8
nibble-packed two counts per byte, with a (row, col, f32 value) exception
list of the values that do not fit (``pipeline.fill_raw_band_compact``);
:func:`widen_with_exceptions` unpacks and scatters them (the JAX
package's ``_build_exc_fn``), which reproduces the f32 band bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# a slab of the normalize is a sixteenth of the band's rows, at least
# 2^22 cells (a small band goes in few slabs, so in few launches) and at
# most 2^24 cells. A slab holds about 110 bytes a cell of temporaries
# (the rolling f64 cumsums of its three sums over slab + F rows, the
# window sums and the z-score's elementwise steps), so on a whole
# chromosome at 1 kb (chr1: 273,904 x 2048 cells, 4.5 GB per band-sized
# f64 array) the slabs stay under one f32 band, where the whole-band
# form held about fifteen
_SLAB_MIN_CELLS = 1 << 22
_SLAB_CELLS = 1 << 24


def slab_rows_for(rows: int, Dl: int) -> int:
    """Rows of one normalize slab of a ``rows`` x ``Dl`` band."""
    return max(1, min(max(rows // 16, _SLAB_MIN_CELLS // Dl),
                      _SLAB_CELLS // Dl))


class _RollingCumsum:
    """Column cumsums ``cs[k] = sum(a[:k])`` in float64 over a sliding
    range ``[base, top]`` of k. Window sums difference two cumsums, so
    their rounding is the cumsum's: torch's CPU cumsum accumulates f32 in
    double, its CUDA cumsum in f32, which moved chr21-scale q values by
    ~7e-4 relative on the GPU; asking for f64 makes both devices agree.

    :meth:`extend` scans the next rows on from the last cs row (a
    carried row, so every column stays in each launch): both devices'
    cumsums along dim 0 add one row at a time per column, so each cs row
    is the same chain of additions as one scan of the whole band. The
    columns may be stacked (``[rows, 3, Dl]``: the normalize's three
    sums in one launch, whose time on the card goes with the rows it
    walks, not with its columns)."""

    def __init__(self, cols: tuple, device):
        self.base = 0
        self.cs = torch.zeros((1,) + cols, dtype=torch.float64,
                              device=device)

    @property
    def top(self) -> int:
        return self.base + self.cs.shape[0] - 1

    def extend(self, rows: torch.Tensor):
        """Append cs rows ``top + 1 .. top + len(rows)`` from the next
        source rows: they are scanned in place in the new buffer, from
        the carried row (which the scan adds to 0, unchanged). One
        ``bandnorm.cumsum`` profiler range."""
        with torch.profiler.record_function("bandnorm.cumsum"):
            k = self.cs.shape[0]
            cs = self.cs.new_empty((k + rows.shape[0],) + self.cs.shape[1:])
            cs[:k] = self.cs
            cs[k:] = rows
            cs[k - 1:].cumsum_(0)
            self.cs = cs

    def drop_below(self, k: int):
        if k > self.base:
            self.cs = self.cs[k - self.base:]
            self.base = k

    def rows(self, k0: int, n: int, kmax: int) -> torch.Tensor:
        """``cs[clip(k0 + j, 0, kmax)]`` for ``j < n``: a view of the
        kept rows, with the clipped rows at either end repeated (only
        the first and last slabs clip)."""
        lo = min(n, max(0, -k0))
        hi = min(n - lo, max(0, k0 + n - 1 - kmax))
        a = max(k0, 0) - self.base
        mid = self.cs[a: a + n - lo - hi]
        if not (lo or hi):
            return mid
        tail = self.cs.shape[1:]
        parts = [mid]
        if lo:                            # clipped to cs[0]: base is 0
            parts.insert(0, self.cs[0].expand((lo,) + tail))
        if hi:
            parts.append(self.cs[kmax - self.base].expand((hi,) + tail))
        return torch.cat(parts)

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """``cs[idx]`` for per-cell indices ``idx`` ``[S, Dl]`` (the same
        for every stacked sum)."""
        shape = (idx.shape[0],) + self.cs.shape[1:]
        return torch.gather(self.cs, 0, (idx - self.base).unsqueeze(-2)
                            .expand(shape))


def _winsum_indices(Dl: int, F: int, rows: int, n: int, r0: int, r1: int):
    """cs indices ``(hi, lo)`` of the moving-window sums (numpy 'same'
    centering) of output rows ``[r0, r1)``, for the short-column regime:
    numpy's centering swap (rows shorter than the window recentre at
    (len-1)//2) is a per-column offset, so the indices are ``[S, Dl]``
    (the JAX module's gather indices, a slab of them)."""
    lend = np.clip(n - np.arange(Dl), 0, rows)
    offd = np.where(lend < F, (np.maximum(lend, 1) - 1) // 2, (F - 1) // 2)
    i = np.arange(r0, r1)[:, None]
    hi_idx = np.clip(i + offd[None, :] + 1, 0, lend[None, :])
    lo_idx = np.clip(i + offd[None, :] - F + 1, 0, lend[None, :])
    return hi_idx, lo_idx


def _column_stats(band: torch.Tensor):
    """Per-column mean/std over occupied cells of the raw band, with the
    host path's NaN guards (empty column -> mean 0, std 1), plus the
    p-value weight vector 1 + log30(1 + mean). Whole-band reductions (a
    slab's sums would add in another order); the squared deviations are
    one band-sized temporary, made in place."""
    occ = band != 0
    # a count of ones in f32 is exact in any order below 2^24 rows
    cnt = occ.sum(0, dtype=band.dtype)
    mean = band.sum(0) / cnt                             # NaN when empty
    mean = torch.where(torch.isfinite(mean), mean, 0.0)
    sq = band - mean[None, :]
    sq *= sq
    sq.masked_fill_(~occ, 0.0)
    var = sq.sum(0) / cnt
    del sq, occ
    std = torch.sqrt(var)
    std = torch.where(torch.isfinite(std), std, 1.0)
    weights = 1.0 + torch.log1p(mean) / math.log(30.0)
    return mean, std, weights


def _normalize_band_local(band: torch.Tensor, out: torch.Tensor, *, n: int,
                          F: int, Dv: int, rows: int, short_cols: bool,
                          slab_rows: int):
    """Local (windowed) regime: normalize.normalize_sparse's >2Mb branch
    evaluated column-wise on the band, into ``out`` (which may be
    ``band`` itself), ``slab_rows`` output rows at a time.

    The three window sums (occupancy, centered values, their squares,
    stacked in one cumsum) of output rows ``[r0, r1)`` read cs rows
    ``[r0 - F + 1, r1 + F//2]``, so each slab extends the rolling
    cumsums by its rows and drops the rows
    no later slab reads (the short-column regime's indices reach back to
    short columns' ends, so it keeps them all: its bands are small). A
    slab reads band rows from ``r0`` on only, so ``out`` may overwrite
    the band behind it. Every value is the whole-band computation's, bit
    for bit: elementwise ops per cell, whole-band column statistics, and
    cumsums that add in the same order."""
    mean_g, std_g, weights = _column_stats(band)
    mcol = mean_g + 0.001
    gs2 = (std_g * std_g)[None, :]
    gm = mean_g[None, :]
    Dl = band.shape[1]
    dev = band.device
    off = (F - 1) // 2
    zcols = torch.arange(Dl, device=dev)[None, :] < Dv   # z-scored columns

    def sources(rows_):
        occ = rows_ != 0
        bandp = torch.where(occ, rows_ + 0.001, 0.0)
        bc = torch.where(occ, bandp - mcol[None, :], 0.0)
        return occ, bandp, bc

    # the three window sums' sources stacked [rows, 3, Dl]: occupancy,
    # centred values, their squares
    sums = _RollingCumsum((3, Dl), dev)
    for r0 in range(0, rows, slab_rows):
        r1 = min(r0 + slab_rows, rows)
        # extend the cumsums to the slab's highest window end
        k_hi = min(r1 + off, rows)
        if k_hi > sums.top:
            occ, _, bc = sources(band[sums.top:k_hi])
            sums.extend(torch.stack([occ.to(band.dtype), bc, bc * bc], 1))
        if short_cols:
            hi, lo = (sums.gather(torch.as_tensor(ix, dtype=torch.int64,
                                                  device=dev))
                      for ix in _winsum_indices(Dl, F, rows, n, r0, r1))
        else:
            # hi = cs[min(i + off + 1, rows)], lo = cs[max(i + off - F + 1,
            # 0)] (cs[0] = 0) for output rows i
            hi = sums.rows(r0 + off + 1, r1 - r0, rows)
            lo = sums.rows(r0 + off - F + 1, r1 - r0, rows)
        cnt, s1c, s2c = (hi - lo).to(band.dtype).unbind(1)
        del hi, lo
        if not short_cols:
            sums.drop_below(max(r1 + off - F + 1, 0))

        rows_ = band[r0:r1]
        occ, bandp, _ = sources(rows_)
        # identical algebra to the host path's raw sums: with the
        # global-mean centering, s2 - s1^2/cnt is invariant and
        # lm = mcol + s1c/cnt
        lm = mcol[None, :] + s1c / cnt
        lv = (s2c - s1c * s1c / cnt) / (cnt - 1)
        lv = torch.where(torch.isfinite(lv), lv, gs2)
        low = cnt < 30
        lm = torch.where(low, gm, lm)
        lv = torch.where(low, gs2, lv)
        lm = torch.where(torch.isfinite(lm), lm, gm)

        z = (bandp - lm) / torch.sqrt(lv)
        z = torch.where(torch.isfinite(z), z, 0.0)
        z = z * weights[None, :]
        out[r0:r1] = torch.where(occ & zcols, z, rows_)
    # host contract (normalize_sparse): one weight per diagonal d < Dv
    return out, weights[:Dv]


def _normalize_band_global(band: torch.Tensor, out: torch.Tensor, *,
                           dpx: int, slab_rows: int):
    """Global regime (small maps): plain per-diagonal z-score of the raw
    values for d < dpx; other cells keep their raw values. Into ``out``
    (which may be ``band``), a slab of rows at a time."""
    mean_g, std_g, _ = _column_stats(band)
    zcols = torch.arange(band.shape[1], device=band.device)[None, :] < dpx
    for r0 in range(0, band.shape[0], slab_rows):
        rows_ = band[r0:r0 + slab_rows]
        z = (rows_ - mean_g[None, :]) / std_g[None, :]
        z = torch.where(torch.isfinite(z), z, 0.0)
        out[r0:r0 + slab_rows] = torch.where((rows_ != 0) & zcols, z,
                                             rows_)
    return out, band.new_zeros((0,))


def bucket_rows(rows: int, minimum: int = 512) -> int:
    """Round a band row count up the geometric bucket ladder (ratio 9/8,
    8-aligned). Kept from the JAX module so the port's band has the same
    row count, and so the same pad rows (unoccupied, inert)."""
    b = minimum
    while b < rows:
        b = -(-b * 9 // 8 // 8) * 8
    return b


def _norm_regime(rows: int, Dl: int, n: int, resolution: int,
                 distance_in_px: int):
    """Regime choice of the JAX module's ``_norm_key``: ("local", F, Dv,
    short_cols) when the chromosome spans more than 2 Mb beyond the band,
    else ("global", dpx)."""
    if (n - distance_in_px) * resolution > 2_000_000:
        F = int(2_000_000 / resolution)
        short_cols = n - (Dl - 1) < F
        return ("local", F, min(2 + distance_in_px, n), short_cols)
    return ("global", min(distance_in_px, n))


def widen_band(band: torch.Tensor) -> torch.Tensor:
    """Raw counts band as f32. uint16 widens through its int16 bit view
    (``& 0xFFFF`` on int32), which needs only the arithmetic every torch
    build has for signed types; torch's own uint16 ops are partial on
    CUDA. Lossless for integer counts below 2^16."""
    if band.dtype == torch.float32:
        return band
    if band.dtype == torch.uint16:
        return (band.view(torch.int16).to(torch.int32) & 0xFFFF).to(
            torch.float32)
    if band.dtype == torch.uint8:
        return band.to(torch.float32)
    raise TypeError(f"raw band dtype {band.dtype} not supported "
                    "(float32, uint16 or uint8)")


def pad_exceptions(exc, rows: int):
    """Pad a (rows, cols, values) exception triple to a power-of-two bucket
    (at least 16) as int32 / int32 / f32; pad slots carry row index
    ``rows`` and are dropped by the scatter. Copied from
    ``mustache_tpu/bandnorm.py:228-241``: the port keeps the buckets so
    the exception buffers come in few sizes (the caching allocator reuses
    them)."""
    r, c, v = (np.asarray(e) for e in exc)
    ne = len(r)
    bucket = max(16, 1 << max(ne - 1, 0).bit_length())
    pr = np.full(bucket, rows, np.int32)
    pc = np.zeros(bucket, np.int32)
    pv = np.zeros(bucket, np.float32)
    pr[:ne] = r
    pc[:ne] = c
    pv[:ne] = v
    return pr, pc, pv


def widen_with_exceptions(band_raw: torch.Tensor, exceptions=None,
                          packed4: bool = False) -> torch.Tensor:
    """The raw band as f32 [rows, Dl] on its device: unpacked when
    ``packed4`` (a [rows, Dl // 2] uint8 band, even logical column in the
    low nibble), widened otherwise, then with the exception triple
    (padded, see :func:`pad_exceptions`; host arrays or tensors) scattered
    over it. The port of ``mustache_tpu/bandnorm.py::_build_exc_fn``
    (:245-274): torch bit ops and one ``index_put_``. Pad slots land in a
    scratch row past the end, which is cut off, so nothing waits on the
    device to drop them."""
    rows = band_raw.shape[0]
    if not packed4 and exceptions is None:
        return widen_band(band_raw)
    dev = band_raw.device
    Dl = band_raw.shape[1] * (2 if packed4 else 1)
    out = torch.empty((rows + 1, Dl), dtype=torch.float32, device=dev)
    if packed4:
        if band_raw.dtype != torch.uint8:
            raise TypeError(f"packed4 band must be uint8, got {band_raw.dtype}")
        pairs = out[:rows].view(rows, Dl // 2, 2)
        pairs[..., 0] = band_raw & 0x0F
        pairs[..., 1] = band_raw >> 4
    else:
        out[:rows] = widen_band(band_raw)
    if exceptions is not None:
        r, c, v = (torch.as_tensor(e, device=dev) for e in exceptions)
        out.index_put_((r.long(), c.long()), v.to(torch.float32))
    return out[:rows]


def normalize_band_device(band_raw: torch.Tensor, n: int, resolution: int,
                          distance_in_px: int, exceptions=None,
                          packed4: bool = False):
    """Normalize a raw chromosome band where it lies.

    ``band_raw``: [rows, Dl] raw counts band, f32 or uint16 / uint8
    (widened here), or [rows, Dl // 2] nibble-packed uint8 when
    ``packed4``. ``exceptions``: optional padded (rows, cols, f32 values)
    triple scattered over the widened band before normalizing (see
    :func:`widen_with_exceptions`). It runs :func:`slab_rows_for` rows
    at a time; the values do not depend on the slab.
    Returns ``(band_norm, weights)`` on the band's device; both are new
    tensors (the input is not modified). The widened band, when it is a
    new tensor, is normalized in place, so the device holds one f32 band
    and a slab's temporaries beyond the raw band.
    """
    band = widen_with_exceptions(band_raw, exceptions, packed4)
    rows, Dl = band.shape
    out = torch.empty_like(band) if band is band_raw else band
    slab = slab_rows_for(rows, Dl)
    regime = _norm_regime(rows, Dl, n, resolution, distance_in_px)
    if regime[0] == "local":
        _, F, Dv, short_cols = regime
        return _normalize_band_local(band, out, n=n if short_cols else rows,
                                     F=F, Dv=Dv, rows=rows,
                                     short_cols=short_cols, slab_rows=slab)
    return _normalize_band_global(band, out, dpx=regime[1], slab_rows=slab)
