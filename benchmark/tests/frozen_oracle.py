# Frozen copy of tests/oracle.py: the benchmark's CPU tests hold its own code to it. Do not edit.
"""Behavioral oracle for tests: numpy/scipy rendering of the reference
algorithm's exact semantics (ay-lab/mustache v1.3.3, mustache.py:595-960).

This module is TEST-ONLY. It exists so the JAX/TPU engine can be checked
against an independent implementation of the published method, built from
the survey of the reference (SURVEY.md section 3.2) using scipy's C
primitives (`gaussian_filter`, `maximum_filter`, `label`) as ground truth
for the kernels the engine re-implements. statsmodels' fdr_bh is spelled
out inline (it is closed-form) because statsmodels is not installed.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import gaussian_filter, maximum_filter, label
from scipy.stats import expon


def bh_fdr(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg q-values (statsmodels multipletests 'fdr_bh')."""
    pvals = np.asarray(pvals, dtype=np.float64)
    n = len(pvals)
    order = np.argsort(pvals)
    ranked = pvals[order] * n / np.arange(1, n + 1)
    q = np.minimum.accumulate(ranked[::-1])[::-1]
    q = np.minimum(q, 1.0)
    out = np.empty(n)
    out[order] = q
    return out


def scipy_blur(c: np.ndarray, sigma: float) -> np.ndarray:
    """The reference's exact blur call: radius clamped to ceil(2*sigma)."""
    w = 2 * math.ceil(2 * sigma) + 1
    t = ((w - 1) / 2 - 0.5) / sigma
    return gaussian_filter(c, sigma, truncate=t, order=0)


def max3(a: np.ndarray) -> np.ndarray:
    return maximum_filter(a, footprint=np.ones((3, 3)), mode="constant")


def detect_block_oracle(c: np.ndarray, octave_values, distance_in_px: int,
                        st: float, pt: float, start: int = 0,
                        intra: bool = True):
    """Loop calls for one dense block; mirrors mustache() semantics.

    Returns a list of [x+start, y+start, q, sigma] rows.
    """
    c = np.array(c, dtype=np.float64)
    n = c.shape[0]
    nz = np.logical_and(c != 0, np.triu(c, 4))
    if np.sum(nz) < 50:
        return []
    c[np.tril_indices_from(c, 4)] = 2
    if intra:
        c[np.triu_indices_from(c, k=distance_in_px + 1)] = 2

    p_best = np.ones(int(nz.sum())) * 2
    sig_best = np.ones_like(p_best)
    v_best = np.zeros_like(p_best)
    s = 10

    for o in octave_values:
        sigmas = [o * 2 ** (k / s) for k in range(s + 2)]
        G = [scipy_blur(c, sg) for sg in sigmas[:3]]
        Lp = G[0] - G[1]
        Lc = G[1] - G[2]
        mP, mC = max3(Lp), max3(Lc)
        Gc, Gn = G[1], G[2]
        for i in range(3, s + 2):
            Gc = Gn
            Gn = scipy_blur(c, sigmas[i])
            Ln = Gc - Gn
            params = expon.fit(np.abs(Lc[nz]))
            pval = 1 - expon.cdf(np.abs(Lc[nz]), *params)
            mN = max3(Ln)
            will = np.logical_and.reduce((
                Lc[nz] > v_best,
                Lc[nz] == mC[nz],
                np.logical_or(Lp[nz] == mP[nz], Ln[nz] == mN[nz]),
                Lc[nz] > mP[nz],
                Lc[nz] > mN[nz],
            ))
            v_best[will] = Lc[nz][will]
            sig_best[will] = sigmas[i - 1]
            p_best[will] = pval[will]
            Lp, Lc, mP, mC = Lc, Ln, mC, mN

    found = p_best != 2
    if len(found) < 10000:
        return []
    p_best[found] = bh_fdr(p_best[found])

    o_map = np.ones_like(c)
    o_map[nz] = p_best
    sig_count = np.sum(o_map < pt)
    x, y = np.unravel_index(np.argsort(o_map.ravel()), o_map.shape)
    so = np.ones_like(c)
    so[nz] = sig_best
    x, y = x[:sig_count], y[:sig_count]
    xy_scales = so[x, y]

    keep = x != 0
    for i in range(len(xy_scales)):
        r = math.ceil(xy_scales[i])
        c1 = np.sum(nz[x[i] - r:x[i] + r + 1, y[i] - r:y[i] + r + 1]) / ((2 * r + 1) ** 2)
        r = 2 * r
        c2 = np.sum(nz[x[i] - r:x[i] + r + 1, y[i] - r:y[i] + r + 1]) / ((2 * r + 1) ** 2)
        if c1 < st or c2 < 0.6:
            keep[i] = False
    x, y = x[keep], y[keep]
    if len(x) == 0:
        return []

    if intra:
        def diag_nzmean(k):
            d = np.diagonal(c, k)
            d = d[d != 0]
            return np.mean(d) if len(d) else np.nan
        means = np.array([diag_nzmean(int(k)) for k in (y - x)])
        with np.errstate(invalid="ignore"):
            passing = c[x, y] > 2 * means
        if len(passing) == 0 or np.sum(passing) == 0:
            return []
        x, y = x[passing], y[passing]

    lab = np.zeros((np.max(y) + 2, np.max(y) + 2), dtype=np.float32)
    lab[x, y] = o_map[x, y] + 1
    for dx, dy in ((1, 0), (1, 1), (0, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (-1, 1)):
        lab[x + dx, y + dy] = 2
    nfeat = label(lab, output=lab, structure=np.ones((3, 3)))

    out = []
    for lb in range(1, nfeat + 1):
        idx = np.argwhere(lab == lb)
        i = np.argmin(o_map[idx[:, 0], idx[:, 1]])
        _x, _y = idx[i, 0], idx[i, 1]
        out.append([_x + start, _y + start, o_map[_x, _y], so[_x, _y]])
    return out


def normalize_sparse_oracle(x, y, v, resolution, distance_in_px):
    """Reference normalize_sparse semantics (mustache.py:622-686)."""
    import warnings
    n = max(x.max(), y.max()) + 1
    weights = []
    dists = np.abs(y - x)
    if (n - distance_in_px) * resolution > 2_000_000:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            F = int(2_000_000 / resolution)
            for d in range(2 + distance_in_px):
                idx = dists == d
                vals = np.zeros(n - d)
                vals[x[idx]] = v[idx] + 0.001
                if vals.size == 0:
                    continue
                std = np.std(v[idx])
                mean = np.mean(v[idx])
                mean = 0 if math.isnan(mean) else mean
                std = 1 if math.isnan(std) else std
                kernel = np.ones(F)
                counts = np.convolve(vals != 0, kernel, mode="same")
                s1 = np.convolve(vals, kernel, mode="same")
                s2 = np.convolve(vals ** 2, kernel, mode="same")
                local_var = (s2 - s1 ** 2 / counts) / (counts - 1)
                std2 = std ** 2
                np.nan_to_num(local_var, copy=False, neginf=std2, posinf=std2, nan=std2)
                local_mean = s1 / counts
                local_mean[counts < 30] = mean
                local_var[counts < 30] = std2
                np.nan_to_num(local_mean, copy=False, neginf=mean, posinf=mean, nan=mean)
                local_std = np.sqrt(local_var)
                vals[x[idx]] -= local_mean[x[idx]]
                vals[x[idx]] /= local_std[x[idx]]
                np.nan_to_num(vals, copy=False, nan=0, posinf=0, neginf=0)
                vals = vals * (1 + math.log(1 + mean, 30))
                weights += [1 + math.log(1 + mean, 30)]
                v[idx] = vals[x[idx]]
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            np.nan_to_num(v, copy=False, neginf=0, posinf=0, nan=0)
            dpx = min(distance_in_px, n)
            for d in range(dpx):
                idx = dists == d
                std = np.std(v[idx])
                mean = np.mean(v[idx])
                mean = 0 if math.isnan(mean) else mean
                std = 1 if math.isnan(std) else std
                v[idx] = (v[idx] - mean) / std
                np.nan_to_num(v, copy=False, nan=0, posinf=0, neginf=0)
    return weights


def diff_detect_block_oracle(c1, c2, octave_values, distance_in_px, st, pt,
                             pt2, start=0, intra=True):
    """Differential loop calls for one dense block pair; mirrors
    diff_mustache() semantics (diff_mustache.py:260-569)."""
    from scipy.stats import norm

    c1 = np.array(c1, dtype=np.float64)
    c2 = np.array(c2, dtype=np.float64)
    nz1 = np.logical_and(c1 != 0, np.triu(c1, 4))
    nz2 = np.logical_and(c2 != 0, np.triu(c2, 4))
    nz = np.logical_and(nz1, nz2)
    if np.sum(nz1) < 50 or np.sum(nz2) < 50:
        return [], [], [], []
    c1[np.tril_indices_from(c1, 4)] = 2
    c2[np.tril_indices_from(c2, 4)] = 2
    if intra:
        c1[np.triu_indices_from(c1, k=distance_in_px + 1)] = 2
        c2[np.triu_indices_from(c2, k=distance_in_px + 1)] = 2
    c = np.zeros(c1.shape)
    c[nz] = c1[nz] - c2[nz]

    maps = {1: (c1, nz1), 2: (c2, nz2)}
    p_best = {m: np.ones(int(maps[m][1].sum())) * 2 for m in maps}
    pair_best = {m: np.ones_like(p_best[m]) * 2 for m in maps}
    sig_best = {m: np.ones_like(p_best[m]) for m in maps}
    v_best = {m: np.zeros_like(p_best[m]) for m in maps}
    s = 10

    for o in octave_values:
        sigmas = [o * 2 ** (k / s) for k in range(s + 2)]
        G = {0: [scipy_blur(c, sg) for sg in sigmas[:3]]}
        for m in maps:
            G[m] = [scipy_blur(maps[m][0], sg) for sg in sigmas[:3]]
        L = {k: [G[k][0] - G[k][1], G[k][1] - G[k][2]] for k in G}
        mP = {m: max3(L[m][0]) for m in maps}
        mC = {m: max3(L[m][1]) for m in maps}
        Lp = {k: L[k][0] for k in L}
        Lc = {k: L[k][1] for k in L}
        Gn = {k: G[k][2] for k in G}
        for i in range(3, s + 2):
            Gc = Gn
            Gn = {0: scipy_blur(c, sigmas[i])}
            for m in maps:
                Gn[m] = scipy_blur(maps[m][0], sigmas[i])
            Ln = {k: Gc[k] - Gn[k] for k in Gc}

            params = norm.fit(Lc[0][nz])
            for m in maps:
                cm, nzm = maps[m]
                dist_params = expon.fit(np.abs(Lc[m][nzm]))
                pval = 1 - expon.cdf(np.abs(Lc[m][nzm]), *dist_params)
                diff_pval = norm.cdf(Lc[0][nzm], loc=params[0], scale=params[1])
                np.nan_to_num(diff_pval, copy=False, posinf=1, neginf=1, nan=1)
                diff_pval[diff_pval > 0.5] = 1 - diff_pval[diff_pval > 0.5]
                diff_pval *= 2
                np.nan_to_num(pval, copy=False, posinf=1, neginf=1, nan=1)
                mN = max3(Ln[m])
                will = np.logical_and.reduce((
                    Lc[m][nzm] > v_best[m],
                    Lc[m][nzm] == mC[m][nzm],
                    np.logical_or(Lp[m][nzm] == mP[m][nzm],
                                  Ln[m][nzm] == mN[nzm]),
                    Lc[m][nzm] > mP[m][nzm],
                    Lc[m][nzm] > mN[nzm],
                ))
                v_best[m][will] = Lc[m][nzm][will]
                sig_best[m][will] = sigmas[i - 1]
                p_best[m][will] = pval[will]
                pair_best[m][will] = diff_pval[will]
                Lp[m], Lc[m], mP[m], mC[m] = Lc[m], Ln[m], mC[m], mN
            # NOTE: the difference map's Lc is intentionally NOT rolled —
            # the reference inner loop reassigns Lc1/Lc2 but never Lc
            # (diff_mustache.py:337 sets it once per octave; :413-425 roll
            # only the per-map planes), so norm.fit and the differential
            # p-values use the octave's frozen second DoG plane throughout

    if len(p_best[1]) < 10000 or len(p_best[2]) < 10000:
        return [], [], [], []
    for m in maps:
        found = p_best[m] != 2
        p_best[m][found] = bh_fdr(p_best[m][found])

    o_map, pair_map, v_map, so_map, xs, ys = {}, {}, {}, {}, {}, {}
    for m in maps:
        cm, nzm = maps[m]
        o_map[m] = np.ones_like(cm); o_map[m][nzm] = p_best[m]
        pair_map[m] = np.ones_like(cm); pair_map[m][nzm] = pair_best[m]
        v_map[m] = np.ones_like(cm); v_map[m][nzm] = v_best[m]
        so_map[m] = np.ones_like(cm); so_map[m][nzm] = sig_best[m]
        x, y = np.where(o_map[m] < pt)
        scales = so_map[m][x, y]
        keep = x != 0
        for i in range(len(scales)):
            r = math.ceil(scales[i])
            cc1 = np.sum(nzm[x[i]-r:x[i]+r+1, y[i]-r:y[i]+r+1]) / ((2*r+1)**2)
            r = 2 * r
            cc2 = np.sum(nzm[x[i]-r:x[i]+r+1, y[i]-r:y[i]+r+1]) / ((2*r+1)**2)
            if cc1 < st or cc2 < 0.6:
                keep[i] = False
        xs[m], ys[m] = x[keep], y[keep]

    if len(xs[1]) == 0 or len(xs[2]) == 0:
        return [], [], [], []

    if intra:
        for m in maps:
            cm = maps[m][0]
            def diag_nzmean(k):
                dd = np.diagonal(cm, k); dd = dd[dd != 0]
                return np.mean(dd) if len(dd) else np.nan
            means = np.array([diag_nzmean(int(k)) for k in (ys[m] - xs[m])])
            with np.errstate(invalid="ignore"):
                passing = cm[xs[m], ys[m]] > 2 * means
            if len(passing) == 0 or np.sum(passing) == 0:
                return [], [], [], []
            xs[m], ys[m] = xs[m][passing], ys[m][passing]

    outs = {}
    for m in maps:
        x, y = xs[m], ys[m]
        lab = np.zeros((np.max(y)+2, np.max(y)+2), dtype=np.float32)
        lab[x, y] = o_map[m][x, y] + 1
        for dx, dy in ((1,0),(1,1),(0,1),(-1,0),(-1,-1),(0,-1),(1,-1),(-1,1)):
            lab[x+dx, y+dy] = 2
        nfeat = label(lab, output=lab, structure=np.ones((3, 3)))
        rows = []
        for lb in range(1, nfeat + 1):
            idx = np.argwhere(lab == lb)
            i = np.argmin(o_map[m][idx[:, 0], idx[:, 1]])
            _x, _y = idx[i, 0], idx[i, 1]
            rows.append([_x + start, _y + start, o_map[m][_x, _y],
                         so_map[m][_x, _y]])
        outs[m] = rows

    diff1 = [r for r in outs[1]
             if pair_map[1][r[0]-start, r[1]-start] < pt2
             and v_map[1][r[0]-start, r[1]-start] > v_map[2][r[0]-start, r[1]-start]]
    diff2 = [r for r in outs[2]
             if pair_map[2][r[0]-start, r[1]-start] < pt2
             and v_map[2][r[0]-start, r[1]-start] > v_map[1][r[0]-start, r[1]-start]]
    return outs[1], diff1, outs[2], diff2
