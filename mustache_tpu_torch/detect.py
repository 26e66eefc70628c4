"""Single-block scale-space loop detection: the port's two detection
routes, its device epilogue and host finish.

Torch port of ``mustache_tpu/detect.py``. A configuration takes one of
two routes (:func:`resolve_route`, the JAX ``_resolve_pallas``), decided
from the configuration alone and the same on every device:

* ``"kernel"`` (the float32 default): the fused kernel
  (``kernels/fused_ladder.py``; its plain version on the CPU) gives each
  block's best DoG response and plane per band cell plus the per-plane
  exponential-fit partials, and log p is recovered from them;
* ``"ladder"`` (float64, ``use_pallas="off"``, or a ladder too large for
  the kernel's shared memory): the JAX package's XLA path in torch ops
  (``ladder.py``), the blur ladder on the band and a scan over the DoG
  planes that fits each plane and keeps the best log p, all in the
  block's dtype.

From either state this module runs Benjamini-Hochberg FDR, candidate
selection, the sparsity and enrichment filters and the 3x3 neighbour
export on the device, packs each batch into one buffer for one D2H, and
finishes each block on the host (clustering and emission, copied from
``mustache_tpu/detect.py:981-1060``; :func:`emit_components` and
:func:`_maybe_regrow` serve the single-map, differential and inter
finishes alike).

BH has the JAX package's two modes (``_BH_MODE``): ``"count"``, the one
the program runs, marks the superset of the significant set in one
O(N·Dl) pass, compacts it into the K-slot table and sorts only the table;
``"sort"``, the reference the tests patch in, sorts all N·Dl keys of a
block. Both give the same sig_count, valid table and loop rows. Count
mode decides overflow exactly, from a histogram of each tested pixel's
least admitting rank, where the JAX package's one-pass test misses overflow
on tied p-values (ROADMAP Queue 3 item 2). The epilogue runs once per
batch on ``[B, N, Dl]`` band state (the JAX package vmaps it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.kernels import fused_ladder
from mustache_tpu_torch.ladder import ladder_best, ladder_window
from mustache_tpu_torch.scalespace import (
    LadderSpec, build_ladder, ladder_tensor, radii_tensor,
)

SENTINEL = 2.0        # fills the masked wedges; participates in the blurs
LOG2 = math.log(2.0)  # log-space image of the "untested" marker q=2
_INF = float("inf")

# BH strategy of _band_candidates (mustache_tpu/detect.py:55): "count"
# (count pass + compaction of the marked set, no full-array sort) or
# "sort" (one stable sort of all N*Dl keys; the tests' reference).
# Identical loop rows.
_BH_MODE = "count"


def band_width(n: int, d_px: int) -> int:
    """Diagonal-band width: data rows (d <= d_px+1 after the ingest
    distance filters) + stencil halo, rounded up to 128 (kept from the JAX
    package so both build the same band)."""
    return min(-(-min(d_px + 4, n) // 128) * 128, n)


def dense_from_band(band_blk: torch.Tensor) -> torch.Tensor:
    """Dense [..., N, N] blocks from band images [..., N, Dl] with
    band[i, d] = dense[i, i+d], via the flat [N, N+1] reinterpret: cell
    (i, d) of the widened band sits at flat index i*(N+1)+d = i*N + (i+d).
    Band cells beyond dense column N-1 wrap into the lower triangle of the
    next row, which the sentinel fill overwrites before anything reads
    it."""
    N, Dl = band_blk.shape[-2:]
    lead = band_blk.shape[:-2]
    wide = F.pad(band_blk, (0, N + 1 - Dl))
    return wide.reshape(*lead, N * (N + 1))[..., : N * N].reshape(*lead, N, N)


def band_of(x: torch.Tensor, Dl: int, fill) -> torch.Tensor:
    """Band image ``[..., N, Dl]`` of dense ``[..., N, N]`` maps, ``band[i,
    d] = x[i, i+d]``, with ``fill`` where ``i + d >= N``: the flat
    ``[N, N+1]`` reinterpret of ``mustache_tpu/diff.py:375-382``."""
    N = x.shape[-1]
    lead = x.shape[:-2]
    flat = x.reshape(*lead, N * N)
    ext = torch.cat([flat, flat[..., :N]], dim=-1)
    bnd = ext.reshape(*lead, N, N + 1)[..., :Dl]
    r = torch.arange(N, device=x.device)
    validl = (r[:, None] + r[None, :Dl]) < N
    return torch.where(validl, bnd, fill)


def _preamble(c: torch.Tensor, d_px: int, row0: int = 0):
    """Support mask + sentinel fill of [..., N, N] blocks
    (mustache.py:699-706, intra-chromosomal), or of the rows ``[row0,
    row0 + rows)`` of such blocks (``c`` ``[..., rows, N]``): the fill is
    elementwise, so a row window needs only its offset."""
    rows, N = c.shape[-2:]
    diag = (torch.arange(N, device=c.device)[None, :]
            - torch.arange(row0, row0 + rows, device=c.device)[:, None])
    nz = (c != 0) & (diag >= 4)
    c = torch.where(diag <= 4, SENTINEL, c)
    c = torch.where(diag >= d_px + 1, SENTINEL, c)
    return c, nz


class _BandGeom:
    """Band-space geometry of one [N, N] block: band[i, d] <-> dense[i,
    i+d], width Dl = band_width(N, d_px); of its band rows ``[row0, row0 +
    rows)`` when given (``band_il`` holds the block's row indices)."""

    def __init__(self, N: int, d_px: int, device, row0: int = 0,
                 rows: int | None = None):
        rows = N if rows is None else rows
        self.N = N
        self.Dl = Dl = band_width(N, d_px)
        self.band_dl = torch.arange(Dl, device=device)[None, :].expand(
            rows, Dl)
        self.band_il = torch.arange(row0, row0 + rows,
                                    device=device)[:, None].expand(rows, Dl)
        self.band_yl = self.band_il + self.band_dl
        self.band_validl = self.band_yl < N


def _suffix_cummin(a: torch.Tensor) -> torch.Tensor:
    """Reverse cummin along the last dim (exact: min is associative)."""
    return torch.flip(torch.cummin(torch.flip(a, (-1,)), -1).values, (-1,))


def _logq_from_sorted(sp: torch.Tensor, n_tested: torch.Tensor):
    """BH log q for log p sorted ascending along the last dim (statsmodels
    fdr_bh: q_(i) = cummin_{j>=i} p_(j) * n / j, clipped at 1 = log 0);
    ``n_tested`` broadcasts against ``sp`` (a scalar for one vector,
    ``[B, 1]`` for a batch of rows)."""
    ranks = torch.arange(1, sp.shape[-1] + 1, device=sp.device).to(sp.dtype)
    q = sp + torch.log(n_tested.to(sp.dtype)) - torch.log(ranks)
    return torch.clamp(_suffix_cummin(q), max=0.0)


def _bh_lookup(sp, qs, vals):
    """q-value lookup by log-p value: BH gives equal q to equal p (the
    suffix cummin flattens rank ties), so a value search is exact. For a
    batch of rows ``sp``, ``qs`` ``[B, M]``, ``vals`` is ``[B, ...]``."""
    flat = vals.reshape(*sp.shape[:-1], -1)
    pos = torch.searchsorted(sp, flat).clamp(0, sp.shape[-1] - 1)
    return qs.gather(-1, pos).reshape(vals.shape)


def _box_counts_band(cs_flat, x, y, s, smax: int, N: int, Dl: int):
    """Window sums of the support over [x-s, x+s+1) x [y-s, y+s+1) with
    numpy slice semantics (negative start => empty, overruns clamp;
    mustache.py:800-810) for candidates ``x``, ``y``, ``s`` ``[B, K]``,
    from each block's per-column inclusive prefix ``cs[b, i, d] = #{i' <=
    i : nz[b, i', i'+d]}`` flattened to ``cs_flat`` ``[B, N*Dl]``: the
    dense box decomposes by diagonal into at most 4*smax+1 column
    ranges."""
    B = x.shape[0]
    rel = torch.arange(-2 * smax, 2 * smax + 1, device=x.device)
    x_, y_, s_ = x[..., None], y[..., None], s[..., None]
    d = (y_ - x_) + rel                                   # [B, K, L]
    lo = torch.maximum(x_ - s_, y_ - s_ - d)
    hi1 = torch.minimum(x_ + s_, y_ + s_ - d) + 1         # exclusive
    lo_c = lo.clamp(0, N)
    hi_c = hi1.clamp(0, N)
    dc = d.clamp(0, Dl - 1)
    valid = (d >= 0) & (d < Dl) & (hi_c > lo_c) & (rel.abs() <= 2 * s_)

    def prefix(row):
        flat = (row.clamp(min=0) * Dl + dc).reshape(B, -1)
        return cs_flat.gather(1, flat).reshape(d.shape)

    cnt = (torch.where(hi_c > 0, prefix(hi_c - 1), 0)
           - torch.where(lo_c > 0, prefix(lo_c - 1), 0))
    total = torch.where(valid, cnt, 0).sum(-1)
    empty = ((x - s) < 0) | ((y - s) < 0)
    return torch.where(empty, 0, total)


def _bh_sort(found, logp, n_tested, log_pt: float, K: int):
    """Sort-mode BH of a batch of blocks' flat keys ``[B, M]``: one stable
    sort of every key (+inf = untested) serves BH and selection, the K
    smallest-p pixels (row-major on ties, like the reference argsort)
    with their q; BH q is non-decreasing along this order, so they hold
    every q < pt pixel whenever sig_count <= K (the regrow contract).
    Returns ``(cand_logq [B, K], flat index [B, K], sig_count [B],
    lookup)``, ``lookup`` mapping neighbour log p to log q."""
    sp, sidx = torch.sort(torch.where(found, logp, _INF), dim=-1,
                          stable=True)
    qs = _logq_from_sorted(sp, n_tested[:, None])
    sig_count = (qs < log_pt).sum(-1, dtype=torch.int32)
    return qs[:, :K], sidx[:, :K], sig_count, \
        lambda vals: _bh_lookup(sp, qs, vals)


def _row_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sums along the rows of ``a`` ``[B, L]``,
    exactly, as ONE scan of the flattened rows less each row's start: on
    the card a 1-D scan is one device-wide scan, while a scan along the
    last dim of a few long rows gives each row one thread block.

    The running count spans the whole batch, so it must stay below 2^31:
    it is at most the batch's cells (marks) or ranks (histogram), B·N·Dl,
    131 M at the batch rule's 16 blocks of 4000^2 with Dl 2048 (1 kb).
    One ``detect.scan`` profiler range."""
    B, L = a.shape
    if B * L >= 2 ** 31:
        raise ValueError(f"a [{B}, {L}] batch overflows the int32 prefix sum")
    with torch.profiler.record_function("detect.scan"):
        flat = torch.cumsum(a.reshape(-1), 0,
                            dtype=torch.int32).reshape(B, L)
        return flat - torch.cat([flat.new_zeros(1), flat[:-1, -1]])[:, None]


def _bh_cutoff(found, logp, n_tested, log_pt: float):
    """The BH step-up cutoff of each row of ``[B, M]`` keys, exactly: ``k*
    = max{k : F(k) >= k}`` with ``F(k) = #{i : log p_i < log pt + log k -
    log n}``. One pass takes each tested pixel's least admitting rank ``r
    = floor(p n / pt) + 1`` in float64, one step low where the compute
    dtype's rounding could admit it at the rank below (a spurious
    overflow costs a regrow; a missed one would drop loops); a histogram
    of r and its prefix sum give F. Ranks beyond n never admit: their
    pixels go to dump bins past F's range, spread so that their atomic
    adds do not pile onto one address."""
    B, M = logp.shape
    dev = logp.device
    eps = torch.finfo(logp.dtype).eps
    log_n = torch.log(n_tested.to(torch.float64))[:, None]
    lp = torch.where(found, logp, 0.0).to(torch.float64)
    slack = 64 * eps * (lp.abs() + log_n.abs() + abs(log_pt) + 1.0)
    r = torch.floor(torch.exp(lp + log_n - log_pt - slack).clamp(max=M + 1))
    r = r + 1
    keep = found & (r <= n_tested[:, None])
    dump = (M + 2 + (torch.arange(M, device=dev) & 4095)).to(r.dtype)
    hist = torch.zeros((B, M + 2 + 4096), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, torch.where(keep, r, dump).long(),
                      torch.ones((), dtype=torch.int32,
                                 device=dev).expand(B, M))
    F = _row_cumsum(hist[:, :M + 2])                       # F[k], k <= M+1
    k = torch.arange(M + 2, dtype=torch.int32, device=dev)
    return torch.where(F >= k, k, 0).amax(-1)


def _bh_count(found, logp, n_tested, log_pt: float, K: int):
    """Count-mode BH of a batch of blocks' flat keys ``[B, M]``
    (``mustache_tpu/detect.py:519-592``), returning what :func:`_bh_sort`
    returns without a sort of all M keys.

    One pass marks ``log p < log pt + log(K+1) - log n`` (the JAX mark:
    F(K+1) pixels, a prefix of the p-sorted order). When the cutoff k* is
    at most K that prefix holds every significant pixel and every suffix
    term BH can take for one (terms at ranks beyond k* are >= log pt), so
    the marked set, compacted into the K-slot table in row-major order (a
    prefix sum of the marks, searched for each slot) and stable-sorted,
    gives each significant pixel the q of the full sort, bit for bit.
    Overflow is decided exactly (:func:`_bh_cutoff`; also when more than
    K are marked, as then k* > K): sig_count is then ``max(k*, K+1)``, so
    the regrow sizes its rerun in one step; else the table's own count of
    q < pt. A tested neighbour beyond the table looks up q = 1 (log 0),
    which never wins the host argmin against the component's significant
    center."""
    B, M = logp.shape
    dev, dt = logp.device, logp.dtype
    cthr = (torch.full((), log_pt, dtype=dt, device=dev) + math.log(K + 1)
            - torch.log(n_tested.to(dt))[:, None])
    # stream compaction: slot j holds the (j+1)-th mark in flat order, the
    # first index where the marks' running count reaches j+1 (M = empty)
    count = _row_cumsum(found & (logp < cthr))
    marked = count[:, -1]                                  # F(K+1)
    want = torch.arange(1, K + 1, dtype=torch.int32, device=dev)
    table = torch.searchsorted(count, want.expand(B, K).contiguous())
    real = table < M
    vals = torch.where(real, logp.gather(1, table.clamp(max=M - 1)), _INF)
    sp, order = torch.sort(vals, dim=-1, stable=True)
    flat_idx = torch.where(real, table, 0).gather(1, order)
    qs = _logq_from_sorted(sp, n_tested[:, None])
    kstar = _bh_cutoff(found, logp, n_tested, log_pt)
    overflow = (kstar > K) | (marked > K)
    sig_count = torch.where(overflow, kstar.clamp(min=K + 1),
                            (qs < log_pt).sum(-1, dtype=torch.int32))
    in_table = marked.clamp(max=K)[:, None]

    def lookup(nb_vals):
        flat = nb_vals.reshape(B, -1).contiguous()
        pos = torch.searchsorted(sp, flat)
        q = qs.gather(1, pos.clamp(max=K - 1))
        return torch.where(pos < in_table, q, 0.0).reshape(nb_vals.shape)

    return qs, flat_idx, sig_count, lookup


def _band_candidates(geom: _BandGeom, *, band_logp, band_sigidx, band_nz,
                     band_c, ceil_table, ceil_max: int, st: float,
                     log_pt: float, K: int, extras=()):
    """Fixed-capacity candidate tables of a batch of blocks from their
    band-space detection state ``[B, N, Dl]``: BH FDR (``_BH_MODE``),
    selection, sparsity/enrichment filters and the exported 3x3
    neighbourhoods for host clustering (mustache.py:774-841). Every
    output has a leading B. Each int32 prefix sum (the support's column
    sums; count mode's marks and rank histogram, :func:`_row_cumsum`) is
    one ``detect.scan`` profiler range: three a batch in count mode, one
    in sort mode.

    ``extras``: tuples ``(name, band_arr, inside_fill, outside_fill)``,
    each exported as ``neigh_<name>`` over the candidate neighbourhoods,
    with ``inside_fill`` at in-matrix cells beyond the band and
    ``outside_fill`` outside the matrix (``mustache_tpu/detect.py:489-494,
    679-683``; the differential path carries its pair p and both maps'
    best responses this way)."""
    N, Dl = geom.N, geom.Dl
    B, M = band_logp.shape[0], N * Dl
    bh = {"count": _bh_count, "sort": _bh_sort}[_BH_MODE]
    found = band_nz & (band_logp < _INF)
    n_tested = found.sum(dim=(-2, -1), dtype=torch.int32)
    cand_logq, flat_idx, sig_count, lookup = bh(
        found.reshape(B, M), band_logp.reshape(B, M), n_tested, log_pt, K)
    cand_valid = cand_logq < log_pt
    cx = flat_idx // Dl
    cd = flat_idx % Dl
    cy = cx + cd

    def take(band, idx):
        """``band`` ``[B, N, Dl]`` at flat band indices ``idx``."""
        return band.reshape(B, M).gather(1, idx.reshape(B, -1)).reshape(
            idx.shape)

    band_sigidx = torch.where(band_nz, band_sigidx, -1)
    cand_sigidx = take(band_sigidx, flat_idx)

    # sparsity filter via per-column prefix sums of the band support (each
    # column's count is at most N, so int32 holds it)
    with torch.profiler.record_function("detect.scan"):
        cs_flat = torch.cumsum(band_nz.to(torch.int32), -2,
                               dtype=torch.int32).reshape(B, M)
    s1 = torch.where(cand_sigidx >= 0,
                     ceil_table[cand_sigidx.clamp(min=0).long()], 1).long()
    dt = band_logp.dtype
    c1 = (_box_counts_band(cs_flat, cx, cy, s1, ceil_max, N, Dl).to(dt)
          / ((2 * s1 + 1) ** 2).to(dt))
    s2 = 2 * s1
    c2 = (_box_counts_band(cs_flat, cx, cy, s2, 2 * ceil_max, N, Dl).to(dt)
          / ((2 * s2 + 1) ** 2).to(dt))
    pass_sparse = (cx != 0) & ~((c1 < st) | (c2 < 0.6))

    # enrichment: candidate > 2 * nonzero-mean of its diagonal on the
    # sentinel-filled map (mustache.py:816-828); band column d IS diagonal d
    occupied = geom.band_validl & (band_c != 0)
    dmeans = (torch.where(occupied, band_c, 0.0).sum(-2)
              / occupied.sum(-2).to(band_c.dtype))      # NaN when empty
    cand_mean = dmeans.gather(1, cd.clamp(0, Dl - 1))
    cand_c = take(band_c, flat_idx)
    pass_enrich = cand_c > 2 * cand_mean                # NaN mean => False
    cand_pass = cand_valid & pass_sparse & pass_enrich

    # 8-neighbourhood q/scale export: dense (x+dx, y+dy) sits at band
    # (x+dx, d+dy-dx). Tested neighbours get their BH q, untested support
    # cells the q=2 marker, in-matrix cells beyond the band q=1 (log 0),
    # cells outside the matrix +inf (cannot win the component argmin)
    Kc = flat_idx.shape[1]
    offs = torch.arange(-1, 2, device=cx.device)
    nx = (cx[..., None, None] + offs[:, None]).expand(B, Kc, 3, 3)
    ny = (cy[..., None, None] + offs).expand(B, Kc, 3, 3)
    nd = ny - nx
    inside = (nx >= 0) & (nx < N) & (ny >= 0) & (ny < N)
    in_band = inside & (nd >= 0) & (nd < Dl)
    nflat = nx.clamp(0, N - 1) * Dl + nd.clamp(0, Dl - 1)
    nb_found = take(found, nflat)
    nb_q = lookup(torch.where(nb_found, take(band_logp, nflat), _INF))
    neigh_logq = torch.where(
        in_band & nb_found, nb_q,
        torch.where(in_band & take(band_nz, nflat), LOG2,
                    torch.where(inside, 0.0, _INF)))
    neigh_sigidx = torch.where(in_band, take(band_sigidx, nflat), -1)

    i32 = torch.int32
    out = {
        "n_tested": n_tested,
        "sig_count": sig_count,
        "cand_x": cx.to(i32),
        "cand_y": cy.to(i32),
        "cand_logq": cand_logq,
        "cand_sigidx": cand_sigidx.to(torch.int16),
        "cand_pass": cand_pass,
        "cand_valid": cand_valid,
        "pass_sparse": pass_sparse,
        "pass_enrich": pass_enrich,
        "neigh_logq": neigh_logq,
        "neigh_sigidx": neigh_sigidx.to(torch.int16),
    }
    for name, arr, inside_fill, outside_fill in extras:
        out["neigh_" + name] = torch.where(
            in_band, take(arr, nflat),
            torch.where(inside, inside_fill, outside_fill).to(arr.dtype))
    return out


def band_rows(win: torch.Tensor, base: int, row0: int, rows: int,
              Dl: int) -> torch.Tensor:
    """Band rows ``[row0, row0 + rows)`` ``[..., rows, Dl]`` of ``n x n``
    maps from their dense rows ``[base, ...)`` (``win`` ``[..., held,
    n]``): ``band[i, d] = map[row0 + i, row0 + i + d]``, 0 beyond the
    map (as :func:`band_of` with fill 0)."""
    n = win.shape[-1]
    i = torch.arange(row0, row0 + rows, device=win.device)[:, None]
    j = i + torch.arange(Dl, device=win.device)[None, :]
    vals = win[..., (i - base).expand(-1, Dl), j.clamp(max=n - 1)]
    return torch.where(j < n, vals, 0.0)


def _slice_support(geom: _BandGeom, band_slice: torch.Tensor, d_px: int):
    """Support masks, their counts ``[B]`` and the sentinel-filled maps of
    a batch of blocks in band space, from their normalized band slices
    ``[B, N, >= Dl]``: the shear of :func:`_preamble`'s dense outputs,
    without the dense blocks."""
    bs = torch.where(geom.band_validl, band_slice[..., :geom.Dl], 0.0)
    nzb = geom.band_validl & (bs != 0) & (geom.band_dl >= 4)
    band_c = torch.where(geom.band_dl <= 4, SENTINEL, bs)
    band_c = torch.where(geom.band_dl >= d_px + 1, SENTINEL, band_c)
    band_c = torch.where(geom.band_validl, band_c, 0.0)
    return nzb, nzb.sum(dim=(-2, -1), dtype=torch.int32), band_c


def _kernel_best(band_state, nzb, nz_count, *, scrub_nan: bool = False):
    """``(best_v, best_logp, best_sigidx)`` ``[B, N, Dl]`` of a batch of
    blocks from the kernel's band state ``(band_v, band_sig, locs,
    sums)`` (partials ``[B, P]``): log p from the best response and the
    per-plane exponential fit (detections have L > 0, so |L| == best_v
    and logp = -(v - loc)/scale). ``scrub_nan`` maps a NaN log p to 0 (p
    = 1), as the differential reference does (diff_mustache.py:386-387)."""
    band_v, band_sig, locs, sums = band_state
    inv_count = 1.0 / nz_count.clamp(min=1).to(band_v.dtype)
    scales = sums * inv_count[:, None] - locs
    sig_c = band_sig.clamp(min=0).long().reshape(band_sig.shape[0], -1)

    def per_plane(a):
        return a.gather(1, sig_c).reshape(band_sig.shape)

    logp = -(band_v - per_plane(locs)) / per_plane(scales)
    if scrub_nan:
        logp = torch.where(torch.isnan(logp), 0.0, logp)
    best_logp = torch.where(nzb & (band_sig >= 0), logp, _INF)
    return band_v, best_logp, torch.where(nzb, band_sig, -1)


def host_ints(vals, device, dtype=torch.int64) -> torch.Tensor:
    """A short host list of ints on ``device``. On the card it goes up
    from pinned memory without a wait: a plain upload from a host list
    waits for everything queued before it, which would keep the host
    from queueing the next batch while the device runs this one."""
    t = torch.tensor(vals, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def ceil_tensor(det_ceil, device) -> torch.Tensor:
    """The ladder's ``det_ceil`` (box half-width per detection plane) as
    an int64 tensor on ``device``, made once per detector: an upload from
    a host list waits for the device's queue."""
    return torch.as_tensor(det_ceil, dtype=torch.int64, device=device)


def _epilogue(geom: _BandGeom, best_logp, best_sigidx, nzb, nz_count,
              band_c, *, ceil_table, ceil_max: int, K: int, st: float,
              log_pt: float):
    """A batch's candidate tables from its band-space best state
    ``[B, N, Dl]`` (``ceil_table``: :func:`ceil_tensor`, ``ceil_max`` its
    largest entry)."""
    out = _band_candidates(
        geom, band_logp=best_logp, band_sigidx=best_sigidx, band_nz=nzb,
        band_c=band_c, ceil_table=ceil_table, ceil_max=ceil_max, st=st,
        log_pt=log_pt, K=K)
    out["nz_count"] = nz_count
    return out


def _detect_one(band_state, band_slice: torch.Tensor, *, det_ceil,
                d_px: int, K: int, st: float, log_pt: float):
    """One block's candidate table from the kernel's band state
    ``(band_v, band_sig, locs, sums)`` and its normalized band slice
    ``[N, >= Dl]`` (the band-state + band-slice branch of the JAX
    ``_detect_one``): the batched epilogue on a batch of one. The support
    mask and sentinel map come from the slice, so the dense block is never
    read here."""
    dev = band_slice.device
    geom = _BandGeom(band_slice.shape[0], d_px, dev)
    nzb, nz_count, band_c = _slice_support(geom, band_slice[None], d_px)
    _, best_logp, best_sigidx = _kernel_best(
        tuple(a[None] for a in band_state), nzb, nz_count)
    out = _epilogue(geom, best_logp, best_sigidx, nzb, nz_count, band_c,
                    ceil_table=ceil_tensor(det_ceil, dev),
                    ceil_max=int(max(det_ceil)), K=K, st=st, log_pt=log_pt)
    return {k: a[0] for k, a in out.items()}


def out_shapes(K: int, dtype=np.float32) -> dict:
    """Per-block output layout of :func:`_detect_one`: name -> (shape,
    numpy dtype); the float leaves carry the run's dtype."""
    i32, f, b, i16 = np.int32, dtype, np.bool_, np.int16
    return {
        "n_tested": ((), i32), "sig_count": ((), i32), "nz_count": ((), i32),
        "cand_x": ((K,), i32), "cand_y": ((K,), i32),
        "cand_logq": ((K,), f), "cand_sigidx": ((K,), i16),
        "cand_pass": ((K,), b), "cand_valid": ((K,), b),
        "pass_sparse": ((K,), b), "pass_enrich": ((K,), b),
        "neigh_logq": ((K, 3, 3), f), "neigh_sigidx": ((K, 3, 3), i16),
    }


def _out_spec(shapes: dict) -> dict:
    """Host-side layout for :func:`_pack_batched`: ``key -> (shape, dtype,
    buffer, offset, size)``. Float leaves come first in the packed row,
    int/bool leaves (as integer bits of the float width) after them; keys
    walk in sorted order within each part."""
    spec = {}
    nf = sum(int(np.prod(s)) for s, dt in shapes.values()
             if np.issubdtype(dt, np.floating))
    offs = {"f": 0, "i": nf}
    for k in sorted(shapes):
        shape, dtype = shapes[k]
        size = int(np.prod(shape, dtype=np.int64))
        buf = "f" if np.issubdtype(dtype, np.floating) else "i"
        spec[k] = (shape, dtype, buf, offs[buf], size)
        offs[buf] += size
    return spec


# integer type of each packed float width: int leaves ride as its bits
_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def _pack_batched(out: dict) -> torch.Tensor:
    """Pack a batched output dict into ONE [B, F + I] buffer of the float
    leaves' dtype (float32, or float64 on the float64 route): float
    leaves, then int/bool leaves cast to the integer of the same width and
    bit-viewed as the float, so a batch crosses to the host in one D2H.
    Layout matches :func:`_out_spec`."""
    fdt = next(a.dtype for a in out.values() if a.dtype.is_floating_point)
    fparts, iparts = [], []
    for k in sorted(out):
        a = out[k]
        flat = a.reshape(a.shape[0], -1)
        if a.dtype.is_floating_point:
            fparts.append(flat.to(fdt))
        else:
            iparts.append(flat.to(_INT_OF[fdt]).view(fdt))
    return torch.cat(fparts + iparts, dim=1)


def unpack_block(spec: dict, row: np.ndarray) -> dict:
    """Rebuild one block's output dict from its packed row."""
    irow = row.view(np.int32 if row.dtype == np.float32 else np.int64)
    out = {}
    for k, (shape, dtype, buf, off, size) in spec.items():
        src = row if buf == "f" else irow
        a = src[off:off + size].reshape(shape)
        out[k] = a if a.dtype == dtype else a.astype(dtype)
    return out


def resolve_route(cfg: DetectionConfig) -> str:
    """Which detection route a configuration takes, on every device (the
    JAX ``_resolve_pallas``): ``"ladder"`` (torch ops, the JAX XLA path)
    for float64, ``use_pallas="off"``, or a ladder the fused kernel cannot
    hold (:func:`fused_ladder.kernel_fits`); else ``"kernel"``, the CUDA
    kernel on the card and its plain version on the CPU. Decided from the
    configuration alone, never from a failed build or launch."""
    if cfg.precision not in ("float32", "float64"):
        raise ValueError(f"precision must be float32 or float64, got "
                         f"{cfg.precision!r}")
    if cfg.precision == "float64" or cfg.use_pallas == "off":
        return "ladder"
    spec = build_ladder(cfg.octave_values)
    if not fused_ladder.kernel_fits(spec.radius, cfg.octaves):
        return "ladder"
    return "kernel"


def thresholds(cfg: DetectionConfig) -> tuple[float, float]:
    """``(st, log pt)`` rounded to the compute dtype, as the JAX package
    passes them (``BlockDetector._scalars``)."""
    if cfg.precision == "float64":
        return float(cfg.st), math.log(cfg.pt)
    return float(np.float32(cfg.st)), float(np.float32(math.log(cfg.pt)))


@dataclasses.dataclass(frozen=True)
class BlockDetector:
    """Detector for [n, n] blocks sliced from a device-resident band."""

    cfg: DetectionConfig
    spec: LadderSpec
    n: int
    K: int
    route: str               # "kernel" or "ladder" (resolve_route)
    taps: torch.Tensor       # [S, 2R+1] ladder taps, in the compute dtype
    radii: torch.Tensor      # [S] int32 radius of each sigma, same device
    ceil_table: torch.Tensor  # ceil_tensor(spec.det_ceil), same device
    out_spec: dict           # _out_spec layout for unpack_block

    def route_state(self, cs: torch.Tensor, nz: torch.Tensor,
                    slices: torch.Tensor, valid_h, *,
                    scrub_nan: bool = False):
        """The detection state of a batch of sentinel-filled blocks ``cs``
        ``[B, n, n]`` (dense support ``nz``, band slices ``slices``) by
        the detector's route: on the kernel route the kernel's band state
        ``(band_v, band_sig, locs, sums)``, on the ladder route ``(best_v,
        best_logp, best_sigidx)``, each batched; :meth:`best_state` reads
        the batch's best state from either. A slot with ``valid_h[b] ==
        0`` is a pad: neither route computes it, and its state is
        empty."""
        spec, n = self.spec, self.n
        d_px = self.cfg.distance_px
        geom = _BandGeom(n, d_px, cs.device)
        if self.route == "kernel":
            valid = host_ints(valid_h, cs.device, torch.int32)
            return fused_ladder.fused_ladder_nms_batched(
                cs, nz.to(torch.float32), self.taps, R=spec.radius,
                n_octaves=len(spec.octave_values),
                planes_per_octave=spec.planes_per_octave, DB=geom.Dl,
                valid=valid, radii=self.radii)
        real = [b for b, ok in enumerate(valid_h) if ok]
        if len(real) == len(valid_h):
            nzb, counts, _ = _slice_support(geom, slices, d_px)
            return ladder_best(cs, nzb, counts, self.taps, spec, geom,
                               scrub_nan=scrub_nan)
        B, dev = len(valid_h), cs.device
        best = (torch.zeros((B, n, geom.Dl), dtype=cs.dtype, device=dev),
                torch.full((B, n, geom.Dl), _INF, dtype=cs.dtype, device=dev),
                torch.full((B, n, geom.Dl), -1, dtype=torch.int32,
                           device=dev))
        if real:
            idx = host_ints(real, dev)
            nzb, counts, _ = _slice_support(geom, slices[idx], d_px)
            got = ladder_best(cs[idx], nzb, counts, self.taps, spec, geom,
                              scrub_nan=scrub_nan)
            for full, part in zip(best, got):
                full[idx] = part
        return best

    def best_state(self, state, support, *, scrub_nan: bool = False):
        """The batch's ``(best_v, best_logp, best_sigidx)`` from
        :meth:`route_state`'s ``state`` and the blocks' band ``support``
        ``(nzb, nz_count, band_c)``."""
        if self.route == "kernel":
            return _kernel_best(state, support[0], support[1],
                                scrub_nan=scrub_nan)
        return state

    def _detect(self, slices: torch.Tensor, valid_h) -> dict:
        """Batch detection from the blocks' normalized band slices ``[B,
        n, >= Dl]`` on the detector's route; ``valid_h[b] == 0`` marks a
        pad slot, which neither route computes and whose outputs are
        empty. Each stage is a named profiler range (``detect.*``)."""
        d_px = self.cfg.distance_px
        rf = torch.profiler.record_function
        with rf("detect.preamble"):
            cs, nz = _preamble(dense_from_band(slices), d_px)
        with rf("detect." + self.route):
            state = self.route_state(cs, nz, slices, valid_h)
        del cs, nz
        return self._epilogues(slices, state)

    def _epilogues(self, slices: torch.Tensor, state) -> dict:
        """The batch's candidate tables from its band slices and its
        :meth:`route_state`-format state, all blocks at once."""
        d_px = self.cfg.distance_px
        geom = _BandGeom(self.n, d_px, slices.device)
        st, log_pt = thresholds(self.cfg)
        with torch.profiler.record_function("detect.epilogue"):
            support = _slice_support(geom, slices, d_px)
            _, best_logp, best_sig = self.best_state(state, support)
            return _epilogue(
                geom, best_logp, best_sig, *support,
                ceil_table=self.ceil_table,
                ceil_max=int(max(self.spec.det_ceil)), K=self.K, st=st,
                log_pt=log_pt)

    def row_state(self, win: torch.Tensor, base: int, t_lo: int,
                  t_hi: int) -> tuple:
        """One row part of a batch of dense normalized blocks: the state
        of the band rows of the fused kernel's row tiles ``[t_lo, t_hi)``
        from ``win`` ``[B, rows, n]``, the blocks' dense rows ``[base,
        base + rows)`` (at least :func:`fused_ladder.window_rows`). The
        preamble is elementwise, so it runs on the window. Returns
        ``(slices, ...)``: the part's band slices ``[B, m, Dl]`` and, on
        the kernel route, the row-window launch's ``(band_v, band_sig,
        parts)``; on the ladder route ``(best_v, best_sig, locs, sums)``
        with the part's per-plane support partials (min |L|, sum |L|).
        :meth:`join_rows` joins the parts of a batch."""
        n, d_px = self.n, self.cfg.distance_px
        spec = self.spec
        Dl = band_width(n, d_px)
        TR = fused_ladder.TILE_ROWS
        row0 = t_lo * TR
        rows = min(t_hi * TR, n) - row0
        dev = win.device
        rf = torch.profiler.record_function
        with rf("detect.preamble"):
            win = win.to(self.taps.dtype)
            gi = torch.arange(base, base + win.shape[-2], device=dev)[:, None]
            d = torch.arange(n, device=dev)[None, :] - gi
            # the blocks as fn sees them: their band, densified
            cs, nz = _preamble(torch.where((d >= 0) & (d < Dl), win, 0.0),
                               d_px, row0=base)
            slices = band_rows(win, base, row0, rows, Dl)
        with rf("detect." + self.route):
            if self.route == "kernel":
                return (slices,) + fused_ladder.fused_ladder_window(
                    cs, nz.to(torch.float32), self.taps, R=spec.radius,
                    n_octaves=len(spec.octave_values),
                    planes_per_octave=spec.planes_per_octave, DB=Dl, N=n,
                    base=base, t_lo=t_lo, t_hi=t_hi, radii=self.radii)
            geom = _BandGeom(n, d_px, dev, row0=row0, rows=rows)
            nzb, _, _ = _slice_support(geom, slices, d_px)
            return (slices,) + ladder_window(cs, nzb, self.taps, spec, n, Dl,
                                             base=base, row0=row0, rows=rows)

    def join_rows(self, parts: list) -> dict:
        """The batch's outputs (as :meth:`fn`'s) from its :meth:`row_state`
        parts in row order, all on this detector's device: rows and
        per-tile partials concatenated, the partials reduced as the
        unsplit wrapper reduces them (kernel route: the same tensor, so
        the same bits), then the unchanged epilogue on the whole block.
        On the ladder route log p comes from the best response and the
        reduced partials (``_kernel_best``: v > 0 at every detection), so
        it differs from the unsplit scan's per-plane log p only by the
        order of the partial sums."""
        slices = torch.cat([p[0] for p in parts], dim=1)
        P = len(self.spec.octave_values) * self.spec.planes_per_octave
        best_v = torch.cat([p[1] for p in parts], dim=1)
        best_sig = torch.cat([p[2] for p in parts], dim=1)
        if self.route == "kernel":
            locs, sums = fused_ladder.reduce_parts(
                torch.cat([p[3] for p in parts], dim=1), P)
            return self._epilogues(slices, (best_v, best_sig, locs, sums))
        locs = torch.stack([p[3] for p in parts]).amin(dim=0)
        sums = parts[0][4]
        for p in parts[1:]:
            sums = sums + p[4]
        geom = _BandGeom(self.n, self.cfg.distance_px, slices.device)
        nzb, count, _ = _slice_support(geom, slices, self.cfg.distance_px)
        state = _kernel_best((best_v, best_sig, locs, sums), nzb, count)
        return self._epilogues(slices, state)

    def fn_band(self, band: torch.Tensor, starts) -> dict:
        """Batch detection from the normalized chromosome band
        (band[i, d] = map[i, i+d], rows >= max(starts)+n): each start is
        sliced and densified on the device. A start of -1 is a pad slot:
        neither route computes it and its outputs are empty."""
        n = self.n
        with torch.profiler.record_function("detect.preamble"):
            slices = torch.stack([band[max(s, 0): max(s, 0) + n]
                                  for s in starts])
        return self._detect(slices, [int(s >= 0) for s in starts])

    def fn(self, blocks: torch.Tensor) -> dict:
        """Batch detection of dense normalized blocks ``[B, n, n]`` (the
        JAX ``BlockDetector.fn``, the entry of the dense runner): each
        block's band ``band[i, d] = block[i, i+d]`` (d < Dl, where every
        intra-chromosomal contact lies) goes the route of
        :meth:`fn_band`; the outputs keep the JAX key names."""
        dtype = self.taps.dtype
        Dl = band_width(self.n, self.cfg.distance_px)
        with torch.profiler.record_function("detect.preamble"):
            slices = band_of(blocks.to(dtype), Dl, 0.0)
        return self._detect(slices, [1] * blocks.shape[0])

    def fn_single(self, block: torch.Tensor) -> dict:
        """:meth:`fn` of one dense block ``[n, n]``, outputs unbatched."""
        return {k: a[0] for k, a in self.fn(block[None]).items()}

    def fn_band_packed(self, band: torch.Tensor, starts) -> torch.Tensor:
        """``fn_band`` packed into one [B, F + I] buffer (one D2H); the
        host rebuilds each block with ``unpack_block(out_spec, row)``."""
        return _pack_batched(self.fn_band(band, starts))


def build_detector(cfg: DetectionConfig, n: int, *, device,
                   max_candidates: int | None = None) -> BlockDetector:
    """Detector for [n, n] blocks on ``device`` (a torch.device), on the
    route :func:`resolve_route` picks."""
    route = resolve_route(cfg)
    spec = build_ladder(cfg.octave_values)
    # a block holds n * Dl band cells: the candidate table cannot be longer
    K = min(max_candidates or cfg.max_candidates,
            n * band_width(n, cfg.distance_px))
    dtype = np.float64 if cfg.precision == "float64" else np.float32
    return BlockDetector(cfg=cfg, spec=spec, n=n, K=K, route=route,
                         taps=ladder_tensor(spec.kernels, device, dtype),
                         radii=radii_tensor(spec.blur_sigmas, device),
                         ceil_table=ceil_tensor(spec.det_ceil, device),
                         out_spec=_out_spec(out_shapes(K, dtype)))


# ---------------------------------------------------------------------------
# host-side finish: gates + connected-component clustering
# (copied from mustache_tpu/detect.py:981-1060)
# ---------------------------------------------------------------------------

def _cluster_components(xs: list[int], ys: list[int]) -> list[list[int]]:
    """Indices of the candidates at ``(xs[i], ys[i])`` grouped by
    8-connected painted 3x3 neighborhoods, i.e. candidates within
    Chebyshev distance 3 (mustache.py:830-841), each group in index
    order and the groups in the order of their first index."""
    parent = list(range(len(xs)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    index = {(x, y): i for i, (x, y) in enumerate(zip(xs, ys))}
    for i, (x, y) in enumerate(zip(xs, ys)):
        for dx in range(-3, 4):
            for dy in range(-3, 4):
                j = index.get((x + dx, y + dy))
                if j is not None and j != i:
                    union(i, j)

    groups: dict[int, list[int]] = {}
    for i in range(len(xs)):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


# the painted 3x3 neighbourhood in the row-major order of a [3, 3] export
_PAINT = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


def emit_components(cx, cy, neigh_logq, neigh_sigidx, extras=(), *,
                    start1: int, start2: int, det_sigmas):
    """The rows of the passing candidates at ``(cx, cy)`` with their
    exported 3x3 neighbourhoods ``[K', 3, 3]``: per 8-connected component,
    its painted pixels (a later candidate's value wins a shared pixel) and
    the argmin-q pixel among them (ties: the first in row-major order),
    emitted as ``[x + start1, y + start2, q, sigma]`` with the values of
    each ``extras`` neighbourhood at that pixel. Returns ``[(row, extra
    values)]`` in the reference's order (component label order ==
    row-major order of each component's first painted pixel)."""
    xs, ys = cx.tolist(), cy.tolist()
    # per candidate, its 9 painted values (log q, sigma index, *extras)
    fields = [np.asarray(a).reshape(len(xs), 9).tolist()
              for a in (neigh_logq, neigh_sigidx, *extras)]
    values = [list(zip(*(f[i] for f in fields))) for i in range(len(xs))]
    rows = []
    for comp in _cluster_components(xs, ys):
        pixels = {}
        for i in comp:
            x, y = xs[i], ys[i]
            for (dx, dy), val in zip(_PAINT, values[i]):
                pixels[(x + dx, y + dy)] = val
        ordered = sorted(pixels.items())  # row-major, np.argwhere order
        best = min(range(len(ordered)), key=lambda k: (ordered[k][1][0], k))
        (px, py), (lq, si, *ext) = ordered[best]
        q = float(np.exp(np.float64(lq)))
        sigma = det_sigmas[si] if si >= 0 else 1.0
        rows.append((ordered[0][0], [px + start1, py + start2, q, sigma],
                     tuple(ext)))
    rows.sort(key=lambda t: t[0])
    return [(r, ext) for _, r, ext in rows]


def finish_block(out: dict, *, block_index: int, start: int, cfg: DetectionConfig,
                 spec: LadderSpec) -> list[list[float]]:
    """Host-side finish of one block: bail-out gates, clustering, and the
    per-component argmin-q emission (:func:`emit_components`). Returns
    ``[x, y, q, sigma]`` rows in the reference's order."""
    nz_count = int(out["nz_count"])
    if nz_count < cfg.min_nz:
        return []
    if nz_count < cfg.min_tested:
        return []

    passing = np.asarray(out["cand_pass"])
    if not passing.any():
        return []
    return [r for r, _ in emit_components(
        *(np.asarray(out[k])[passing] for k in
          ("cand_x", "cand_y", "neigh_logq", "neigh_sigidx")),
        start1=start, start2=start, det_sigmas=spec.det_sigmas)]


def _maybe_regrow(block_out: dict, cfg: DetectionConfig, rerun,
                  sig_count) -> dict:
    """If the candidate table overflowed (more pixels below the q threshold
    than capacity), rerun this single block with a larger capacity: the
    reference selects ALL pixels with q < pt. ``sig_count``: callable
    ``(block_out) -> int``, the block's count of significant pixels (for
    the differential block, the larger of its two maps'); ``rerun``:
    callable ``(capacity) -> block_out``, each call one
    ``pipeline.regrow`` profiler range. Sort-mode BH reports the exact
    sig_count; on overflow count-mode BH reports ``max(k*, K+1)`` with the
    exact cutoff k* (``_bh_count``), so in either mode one rerun fits. The
    loop is kept from the JAX package, whose count mode reports a lower
    bound."""
    cap = cfg.max_candidates
    while True:
        sig = sig_count(block_out)
        if sig <= cap:
            return block_out
        cap = max(1 << (sig - 1).bit_length(), 2 * cap)
        with torch.profiler.record_function("pipeline.regrow"):
            block_out = rerun(cap)
