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
accumulate in f64 on every device (see _cumsum0). The port's tests hold
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


def _cumsum0(a: torch.Tensor) -> torch.Tensor:
    """Column cumsum with a leading zero row, cs[k] = sum(a[:k]),
    accumulated and returned in float64. Window sums difference two
    cumsums, so their rounding is the cumsum's: torch's CPU cumsum
    accumulates f32 in double, its CUDA cumsum in f32, which moved
    chr21-scale q values by ~7e-4 relative on the GPU. Asking for f64
    makes both devices agree; callers cast the differences back."""
    cs = torch.cumsum(a, dim=0, dtype=torch.float64)
    return torch.cat([torch.zeros_like(cs[:1]), cs], 0)


def _winsum_fast(a: torch.Tensor, F: int, rows: int) -> torch.Tensor:
    """Column-wise moving-window sums, numpy-'same' centering, for columns
    whose true length is >= F. Clamps are free: the cumulative sum is flat
    wherever the data is zero-padded, and the low clamp lands on cs[0]=0."""
    off = (F - 1) // 2
    cs = _cumsum0(a)
    # hi = cs[i + off + 1] for i in [0, rows): indices reach rows + off
    hi_src = torch.cat([cs, cs[-1:].expand(off, cs.shape[1])], 0)
    hi = hi_src[off + 1: off + 1 + rows]
    # lo = cs[max(i + off - F + 1, 0)]: negative indices clamp to cs[0]=0
    sh = off - F + 1  # <= 0
    lo = torch.cat([cs.new_zeros((-sh, cs.shape[1])), cs[: rows + sh]], 0)
    return (hi - lo).to(a.dtype)


def _winsum_indices(Dl: int, F: int, rows: int, n: int):
    """Gather indices for the short-column regime: numpy's centering swap
    (rows shorter than the window recentre at (len-1)//2) is a per-column
    offset. Host numpy, computed once per call and shared by all three
    window sums (same as the JAX module)."""
    lend = np.clip(n - np.arange(Dl), 0, rows)
    offd = np.where(lend < F, (np.maximum(lend, 1) - 1) // 2, (F - 1) // 2)
    i = np.arange(rows)[:, None]
    hi_idx = np.clip(i + offd[None, :] + 1, 0, lend[None, :]).astype(np.int32)
    lo_idx = np.clip(i + offd[None, :] - F + 1, 0,
                     lend[None, :]).astype(np.int32)
    return hi_idx, lo_idx


def _winsum_general(a: torch.Tensor, hi_idx: torch.Tensor,
                    lo_idx: torch.Tensor) -> torch.Tensor:
    """Window sums via per-cell cumsum gather indices (int64 tensors on
    ``a``'s device; short-column regime, see _winsum_indices)."""
    cs = _cumsum0(a)
    return (torch.gather(cs, 0, hi_idx)
            - torch.gather(cs, 0, lo_idx)).to(a.dtype)


def _column_stats(band: torch.Tensor, occ: torch.Tensor):
    """Per-column mean/std over occupied cells of the raw band, with the
    host path's NaN guards (empty column -> mean 0, std 1), plus the
    p-value weight vector 1 + log30(1 + mean)."""
    cnt = occ.to(band.dtype).sum(0)
    mean = band.sum(0) / cnt                             # NaN when empty
    mean = torch.where(torch.isfinite(mean), mean, 0.0)
    var = torch.where(occ, (band - mean[None, :]) ** 2, 0.0).sum(0) / cnt
    std = torch.sqrt(var)
    std = torch.where(torch.isfinite(std), std, 1.0)
    weights = 1.0 + torch.log1p(mean) / math.log(30.0)
    return mean, std, weights


def _normalize_band_local(band: torch.Tensor, *, n: int, F: int, Dv: int,
                          rows: int, short_cols: bool):
    """Local (windowed) regime: normalize.normalize_sparse's >2Mb branch
    evaluated column-wise on the band."""
    occ = band != 0
    mean_g, std_g, weights = _column_stats(band, occ)

    bandp = torch.where(occ, band + 0.001, 0.0)
    mcol = mean_g + 0.001
    bc = torch.where(occ, bandp - mcol[None, :], 0.0)

    if short_cols:
        hi_idx, lo_idx = (torch.as_tensor(a, dtype=torch.int64,
                                          device=band.device)
                          for a in _winsum_indices(band.shape[1], F, rows, n))

        def win(a):
            return _winsum_general(a, hi_idx, lo_idx)
    else:
        def win(a):
            return _winsum_fast(a, F, rows)
    cnt = win(occ.to(band.dtype))
    s1c = win(bc)
    s2c = win(bc * bc)

    # identical algebra to the host path's raw sums: with the global-mean
    # centering, s2 - s1^2/cnt is invariant and lm = mcol + s1c/cnt
    lm = mcol[None, :] + s1c / cnt
    lv = (s2c - s1c * s1c / cnt) / (cnt - 1)
    gs2 = (std_g * std_g)[None, :].expand_as(lv)
    gm = mean_g[None, :].expand_as(lm)
    lv = torch.where(torch.isfinite(lv), lv, gs2)
    low = cnt < 30
    lm = torch.where(low, gm, lm)
    lv = torch.where(low, gs2, lv)
    lm = torch.where(torch.isfinite(lm), lm, gm)

    z = (bandp - lm) / torch.sqrt(lv)
    z = torch.where(torch.isfinite(z), z, 0.0)
    z = z * weights[None, :]

    dcol = torch.arange(band.shape[1], device=band.device)[None, :]
    out = torch.where(occ & (dcol < Dv), z, band)
    # host contract (normalize_sparse): one weight per diagonal d < Dv
    return out, weights[:Dv]


def _normalize_band_global(band: torch.Tensor, *, dpx: int):
    """Global regime (small maps): plain per-diagonal z-score of the raw
    values for d < dpx; other cells keep their raw values."""
    occ = band != 0
    mean_g, std_g, _ = _column_stats(band, occ)
    z = (band - mean_g[None, :]) / std_g[None, :]
    z = torch.where(torch.isfinite(z), z, 0.0)
    dcol = torch.arange(band.shape[1], device=band.device)[None, :]
    out = torch.where(occ & (dcol < dpx), z, band)
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
    :func:`widen_with_exceptions`). Returns ``(band_norm, weights)`` on
    the band's device; both are new tensors (the input is not modified).
    """
    band = widen_with_exceptions(band_raw, exceptions, packed4)
    rows, Dl = band.shape
    regime = _norm_regime(rows, Dl, n, resolution, distance_in_px)
    if regime[0] == "local":
        _, F, Dv, short_cols = regime
        return _normalize_band_local(band, n=n if short_cols else rows, F=F,
                                     Dv=Dv, rows=rows, short_cols=short_cols)
    return _normalize_band_global(band, dpx=regime[1])
