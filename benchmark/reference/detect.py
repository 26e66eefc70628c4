"""Loop calls of one dense block, in plain PyTorch.

A transcription of the reference's ``mustache`` (mustache.py:697-850)
and ``diff_mustache`` block step (diff_mustache.py:260-569), as the
frozen oracle renders them with scipy: the blur ladder
(``gaussian_filter`` with ``mode="reflect"`` and the reference's
``truncate``), differences of Gaussians, 3x3 maxima (``maximum_filter``,
``mode="constant"``), the exponential fit and its p-values,
Benjamini-Hochberg, the sparsity and enrichment filters, and the
clustering of the survivors with each cluster's least-q pixel. The
clustering runs on the host over the few candidate pixels.

One departure, on purpose: the p-value is the exponential's survival
function ``exp(-z)``, which the reference computes as ``1 - cdf`` and so
rounds to multiples of 2**-53; the program under test computes it in log
space. ``tf32=True`` rounds each blur's operands to TensorFloat-32 and
accumulates in float32: the benchmark's low-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

SUBDIVISIONS = 10   # the reference's fixed s = 10 (mustache.py:711)


def octave_sigmas(o: float) -> list[float]:
    """The twelve blur sigmas of the octave based at ``o``."""
    return [o * 2 ** (k / SUBDIVISIONS) for k in range(SUBDIVISIONS + 2)]


def gaussian_weights(sigma: float) -> np.ndarray:
    """scipy's weights for the reference's call ``gaussian_filter(c,
    sigma, truncate=((w - 1) / 2 - 0.5) / sigma)`` with ``w = 2 *
    ceil(2 sigma) + 1``: radius ``int(truncate * sigma + 0.5)``, which
    float rounding can leave one short of ``ceil(2 sigma)``."""
    w = 2 * math.ceil(2 * sigma) + 1
    t = ((w - 1) / 2 - 0.5) / sigma
    r = int(t * float(sigma) + 0.5)
    x = np.arange(-r, r + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TensorFloat-32's 10-bit mantissa (round
    to nearest even), as the tensor cores read their operands."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _reflect_index(N: int, R: int, device) -> torch.Tensor:
    """Indices of scipy's ``mode="reflect"`` border (d c b a | a b c d |
    d c b a) for a padding of ``R`` on each side."""
    i = torch.arange(-R, N + R, device=device)
    i = torch.where(i < 0, -1 - i, i)
    return torch.where(i >= N, 2 * N - 1 - i, i)


def blur_stack(c: torch.Tensor, sigmas, *, tf32: bool = False) -> torch.Tensor:
    """``[len(sigmas), N, N]``: the block ``c`` blurred at each sigma,
    along axis 0 and then axis 1, as ``scipy.ndimage.gaussian_filter``
    does. Smaller sigmas get zero taps up to the largest radius."""
    N = c.shape[0]
    ws = [gaussian_weights(s) for s in sigmas]
    R = max((len(w) - 1) // 2 for w in ws)
    W = np.zeros((len(ws), 2 * R + 1))
    for i, w in enumerate(ws):
        r = (len(w) - 1) // 2
        W[i, R - r:R + r + 1] = w
    dt = torch.float32 if tf32 else c.dtype
    Wt = torch.tensor(W, dtype=dt, device=c.device)
    src = c.to(dt)
    if tf32:
        Wt, src = round_tf32(Wt), round_tf32(src)
    idx = _reflect_index(N, R, c.device)
    pad = src[idx]                                       # [N + 2R, N]
    out = torch.zeros((len(ws), N, N), dtype=dt, device=c.device)
    for k in range(2 * R + 1):
        out.addcmul_(pad[k:k + N].unsqueeze(0), Wt[:, k, None, None])
    pad = out[:, :, idx]                                 # [S, N, N + 2R]
    if tf32:
        pad = round_tf32(pad)
    out = torch.zeros_like(out)
    for k in range(2 * R + 1):
        out.addcmul_(pad[:, :, k:k + N], Wt[:, k, None, None])
    return out


def max3(a: torch.Tensor) -> torch.Tensor:
    """3x3 maximum of each plane of ``a`` ``[S, N, N]`` with a border of
    zeros (``maximum_filter(..., mode="constant")``, cval 0)."""
    p = F.pad(a, (1, 1, 1, 1), value=0.0)
    return F.max_pool2d(p.unsqueeze(1), 3, stride=1).squeeze(1)


def support_mask(c: torch.Tensor) -> torch.Tensor:
    """``np.logical_and(c != 0, np.triu(c, 4))``: nonzero pixels at least
    four diagonals above the main one."""
    N = c.shape[0]
    i = torch.arange(N, device=c.device)
    return (c != 0) & ((i[None, :] - i[:, None]) >= 4)


def mark_outside(c: torch.Tensor, d_px: int, intra: bool) -> torch.Tensor:
    """A copy of ``c`` with the pixels below the fifth diagonal, and for
    an intra-chromosomal block beyond ``d_px``, set to 2."""
    N = c.shape[0]
    i = torch.arange(N, device=c.device)
    k = i[None, :] - i[:, None]
    out = c.clone()
    out[k <= 4] = 2
    if intra:
        out[k >= d_px + 1] = 2
    return out


def bh_fdr(p: torch.Tensor) -> torch.Tensor:
    """Benjamini-Hochberg q-values (statsmodels ``fdr_bh``)."""
    n = p.numel()
    ps, order = torch.sort(p)
    ranks = torch.arange(1, n + 1, device=p.device, dtype=p.dtype)
    ranked = ps * n / ranks
    q = torch.flip(torch.cummin(torch.flip(ranked, [0]), 0).values, [0])
    q = torch.clamp(q, max=1.0)
    out = torch.empty_like(p)
    out[order] = q
    return out


def exp_pvalues(a: torch.Tensor) -> torch.Tensor:
    """p-values of ``a`` under ``scipy.stats.expon.fit(a)`` (loc the
    minimum, scale the mean less it), as the survival function."""
    loc = a.min()
    scale = a.mean() - loc
    return torch.exp(-(a - loc) / scale)


def _py_slice(lo: torch.Tensor, hi: torch.Tensor, N: int):
    """Bounds of Python's ``a[lo:hi]`` on an axis of length ``N``, for
    ``hi >= 1``: a negative start counts from the end."""
    lo = torch.where(lo < 0, lo + N, lo).clamp(0, N)
    hi = hi.clamp(max=N)
    return lo, torch.maximum(hi, lo)


def sparsity_keep(nz: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  scale: torch.Tensor, st: float) -> torch.Tensor:
    """The reference's sparsity filter (mustache.py:782-791): the share of
    support pixels in the box of half-width ``ceil(scale)`` at least
    ``st`` and in the box of twice that at least 0.6, boxes cut as
    Python slices cut them."""
    N = nz.shape[0]
    S = torch.zeros((N + 1, N + 1), dtype=torch.int64, device=nz.device)
    S[1:, 1:] = nz.to(torch.int64).cumsum(0).cumsum(1)

    def share(r):
        a0, a1 = _py_slice(cx - r, cx + r + 1, N)
        b0, b1 = _py_slice(cy - r, cy + r + 1, N)
        cnt = S[a1, b1] - S[a0, b1] - S[a1, b0] + S[a0, b0]
        return cnt.to(torch.float64) / ((2 * r + 1) ** 2).to(torch.float64)

    r = torch.ceil(scale.to(torch.float64)).to(torch.int64)
    return ~((share(r) < st) | (share(2 * r) < 0.6))


def diagonal_nz_means(c: torch.Tensor) -> torch.Tensor:
    """``[N]``: the mean of the nonzero entries of each diagonal ``k >= 0``
    of ``c`` (NaN where it has none)."""
    N = c.shape[0]
    pad = torch.zeros((N, 2 * N), dtype=c.dtype, device=c.device)
    pad[:, :N] = c
    diag = pad.as_strided((N, N), (2 * N + 1, 1))       # [i, k] = c[i, i+k]
    nzd = diag != 0
    s = torch.where(nzd, diag, torch.zeros((), dtype=c.dtype,
                                           device=c.device)).sum(0)
    return s / nzd.sum(0).to(c.dtype)


_RING = [(1, 0), (1, 1), (0, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (-1, 1)]


def cluster_rows(cx, cy, o_map: torch.Tensor, so: torch.Tensor,
                 start: int) -> list[tuple[int, int, float, float]]:
    """The reference's clustering (mustache.py:830-850): paint each
    surviving candidate and its eight neighbours, label the painted
    pixels 8-connected, and emit each cluster's pixel of least ``o_map``
    (the first in row-major order on a tie) with its q and scale."""
    N = o_map.shape[0]
    cx = np.asarray(cx, np.int64)
    cy = np.asarray(cy, np.int64)
    px = np.concatenate([cx] + [cx + dx for dx, _ in _RING])
    py = np.concatenate([cy] + [cy + dy for _, dy in _RING])
    W = N + 2
    keys = np.unique(px * W + py)                       # row-major order
    kx, ky = keys // W, keys % W
    inside = (kx >= 0) & (kx < N) & (ky >= 0) & (ky < N)
    o = np.full(len(keys), np.inf)
    s = np.ones(len(keys))
    if inside.any():
        ix = torch.as_tensor(kx[inside], device=o_map.device)
        iy = torch.as_tensor(ky[inside], device=o_map.device)
        o[inside] = o_map[ix, iy].to(torch.float64).cpu().numpy()
        s[inside] = so[ix, iy].to(torch.float64).cpu().numpy()
    rows, cols = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == dy == 0:
                continue
            nk = keys + dx * W + dy
            pos = np.searchsorted(keys, nk).clip(max=len(keys) - 1)
            hit = keys[pos] == nk
            rows.append(np.nonzero(hit)[0])
            cols.append(pos[hit])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    graph = coo_matrix((np.ones(len(r)), (r, c)), shape=(len(keys),) * 2)
    _, label = connected_components(graph, directed=False)
    # least o per label, the first in row-major order on a tie: keys are
    # in row-major order, so a stable sort by (label, o) puts it first
    order = np.lexsort((np.arange(len(keys)), o, label))
    first = order[np.r_[True, label[order][1:] != label[order][:-1]]]
    return [(int(kx[i]) + start, int(ky[i]) + start, float(o[i]), float(s[i]))
            for i in first]


def _ladder(c, nz, octave_values, tf32):
    """Per octave: the twelve blurs' eleven DoG planes and their 3x3
    maxima."""
    for o in octave_values:
        sig = octave_sigmas(o)
        G = blur_stack(c, sig, tf32=tf32)
        L = G[:-1] - G[1:]
        del G
        yield sig, L, max3(L)


def _candidates(o_map, so, nz, pt, st):
    """Candidates below ``pt`` that pass ``x != 0`` and the sparsity
    filter, as coordinate tensors."""
    cand = o_map < pt
    cand[0, :] = False
    cx, cy = torch.nonzero(cand, as_tuple=True)
    keep = sparsity_keep(nz, cx, cy, so[cx, cy], st)
    return cx[keep], cy[keep]


def _enriched(cm, cx, cy):
    """The enrichment filter: the pixel above twice its diagonal's mean of
    nonzero entries (NaN means fail)."""
    means = diagonal_nz_means(cm)
    return cm[cx, cy] > 2 * means[cy - cx]


def detect_block(c: torch.Tensor, octave_values, d_px: int, st: float,
                 pt: float, start: int = 0, intra: bool = True, *,
                 tf32: bool = False) -> list[tuple[int, int, float, float]]:
    """Loop calls ``(x, y, q, scale)`` of the dense block ``c`` ``[N, N]``
    (normalized values; its dtype is the computation's), offset by
    ``start``."""
    nz = support_mask(c)
    if int(nz.sum()) < 50:
        return []
    c = mark_outside(c, d_px, intra)
    p_best = torch.full_like(c, 2.0)
    sig_best = torch.ones_like(c)
    v_best = torch.zeros_like(c)
    for sig, L, M in _ladder(c, nz, octave_values, tf32):
        for j in range(1, SUBDIVISIONS):
            Lc = L[j]
            pval = torch.zeros_like(c)
            pval[nz] = exp_pvalues(Lc[nz].abs())
            will = (nz & (Lc > v_best) & (Lc == M[j])
                    & ((L[j - 1] == M[j - 1]) | (L[j + 1] == M[j + 1]))
                    & (Lc > M[j - 1]) & (Lc > M[j + 1]))
            v_best = torch.where(will, Lc, v_best)
            sig_best = torch.where(will, torch.full_like(c, sig[j + 1]),
                                   sig_best)
            p_best = torch.where(will, pval, p_best)
        del L, M
    if int(nz.sum()) < 10000:
        return []
    found = nz & (p_best != 2)
    o_map = torch.ones_like(c)
    o_map[nz] = p_best[nz]
    o_map[found] = bh_fdr(p_best[found])
    so = torch.where(nz, sig_best, torch.ones_like(c))
    del p_best, sig_best, v_best
    cx, cy = _candidates(o_map, so, nz, pt, st)
    if len(cx) == 0:
        return []
    if intra:
        passing = _enriched(c, cx, cy)
        if not bool(passing.any()):
            return []
        cx, cy = cx[passing], cy[passing]
    return cluster_rows(cx.cpu().numpy(), cy.cpu().numpy(), o_map, so, start)


def diff_detect_block(c1: torch.Tensor, c2: torch.Tensor, octave_values,
                      d_px: int, st: float, pt: float, pt2: float,
                      start: int = 0, intra: bool = True, *,
                      tf32: bool = False):
    """Differential calls of a block pair: ``(loops1, diff1, loops2,
    diff2)``, each a list of ``(x, y, q, scale)`` offset by ``start``.

    As the reference does, the difference map's fit and its p-values read
    the octave's second DoG plane throughout (diff_mustache.py:337 sets
    it once per octave; only the per-map planes roll)."""
    nz1, nz2 = support_mask(c1), support_mask(c2)
    nz = nz1 & nz2
    if int(nz1.sum()) < 50 or int(nz2.sum()) < 50:
        return [], [], [], []
    c1 = mark_outside(c1, d_px, intra)
    c2 = mark_outside(c2, d_px, intra)
    c = torch.zeros_like(c1)
    c[nz] = c1[nz] - c2[nz]
    maps = {1: (c1, nz1), 2: (c2, nz2)}
    p_best = {m: torch.full_like(c, 2.0) for m in maps}
    pair_best = {m: torch.full_like(c, 2.0) for m in maps}
    sig_best = {m: torch.ones_like(c) for m in maps}
    v_best = {m: torch.zeros_like(c) for m in maps}
    for o in octave_values:
        sig = octave_sigmas(o)
        Gd = blur_stack(c, sig[:3], tf32=tf32)
        Ld1 = Gd[1] - Gd[2]
        del Gd
        d = Ld1[nz]
        mu = d.mean()
        sd = torch.sqrt(((d - mu) ** 2).mean())
        del d
        for m, (cm, nzm) in maps.items():
            G = blur_stack(cm, sig, tf32=tf32)
            L = G[:-1] - G[1:]
            del G
            M = max3(L)
            dp_all = torch.special.ndtr((Ld1 - mu) / sd)
            dp_all = torch.where(torch.isnan(dp_all) | torch.isinf(dp_all),
                                 torch.ones_like(dp_all), dp_all)
            dp_all = torch.where(dp_all > 0.5, 1 - dp_all, dp_all) * 2
            for j in range(1, SUBDIVISIONS):
                Lc = L[j]
                pval = torch.zeros_like(c)
                pv = exp_pvalues(Lc[nzm].abs())
                pval[nzm] = torch.where(torch.isfinite(pv), pv,
                                        torch.ones_like(pv))
                will = (nzm & (Lc > v_best[m]) & (Lc == M[j])
                        & ((L[j - 1] == M[j - 1]) | (L[j + 1] == M[j + 1]))
                        & (Lc > M[j - 1]) & (Lc > M[j + 1]))
                v_best[m] = torch.where(will, Lc, v_best[m])
                sig_best[m] = torch.where(will, torch.full_like(c, sig[j + 1]),
                                          sig_best[m])
                p_best[m] = torch.where(will, pval, p_best[m])
                pair_best[m] = torch.where(will, dp_all, pair_best[m])
            del L, M, dp_all
        del Ld1
    if int(nz1.sum()) < 10000 or int(nz2.sum()) < 10000:
        return [], [], [], []
    o_map, so_map, pair_map, v_map, xy = {}, {}, {}, {}, {}
    for m, (cm, nzm) in maps.items():
        found = nzm & (p_best[m] != 2)
        om = torch.ones_like(c)
        om[nzm] = p_best[m][nzm]
        om[found] = bh_fdr(p_best[m][found])
        o_map[m] = om
        so_map[m] = torch.where(nzm, sig_best[m], torch.ones_like(c))
        pair_map[m] = torch.where(nzm, pair_best[m], torch.ones_like(c))
        v_map[m] = torch.where(nzm, v_best[m], torch.ones_like(c))
        xy[m] = _candidates(om, so_map[m], nzm, pt, st)
    if any(len(xy[m][0]) == 0 for m in maps):
        return [], [], [], []
    if intra:
        for m, (cm, _) in maps.items():
            cx, cy = xy[m]
            passing = _enriched(cm, cx, cy)
            if not bool(passing.any()):
                return [], [], [], []
            xy[m] = (cx[passing], cy[passing])
    outs = {m: cluster_rows(xy[m][0].cpu().numpy(), xy[m][1].cpu().numpy(),
                            o_map[m], so_map[m], start) for m in maps}

    def differential(m, other):
        rows = outs[m]
        if not rows:
            return []
        N = c.shape[0]
        px = np.array([r[0] - start for r in rows])
        py = np.array([r[1] - start for r in rows])
        ok = py < N
        keep = np.zeros(len(rows), bool)
        if ok.any():
            ix = torch.as_tensor(px[ok], device=c.device)
            iy = torch.as_tensor(py[ok], device=c.device)
            pair = pair_map[m][ix, iy]
            more = v_map[m][ix, iy] > v_map[other][ix, iy]
            keep[ok] = ((pair < pt2) & more).cpu().numpy()
        return [r for r, k in zip(rows, keep) if k]

    return outs[1], differential(1, 2), outs[2], differential(2, 1)
