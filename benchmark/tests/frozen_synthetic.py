# Frozen copy of tests/synthetic.py: the benchmark's CPU tests hold its own code to it. Do not edit.
"""Synthetic Hi-C contact-map generator for tests and benchmarks.

Produces COO upper-triangular maps with the statistical shape of real Hi-C:
counts decay with genomic distance (power law), sparsity grows with
distance, and "loops" are planted as local 2-D Gaussian enrichment bumps at
known anchor pairs. Deterministic under a seed.
"""

from __future__ import annotations

import numpy as np


def synthetic_hic(n_bins: int, d_px: int, *, seed: int = 0,
                  n_loops: int = 30, loop_strength: float = 4.0,
                  density: float = 0.97, density_decay: float = 0.02):
    """Return (x, y, v) int64/int64/float64 COO triplets, plus loop anchors.

    ``density``: fraction of band pixels that receive a nonzero count at
    distance 0 (decays with distance).
    """
    rng = np.random.default_rng(seed)
    xs, ys, vs = [], [], []
    for d in range(1, d_px + 1):
        m = n_bins - d
        if m <= 0:
            break
        p = density * (1.0 + d) ** -density_decay
        occupied = rng.random(m) < p
        idx = np.nonzero(occupied)[0]
        lam = 60.0 * (1.0 + d) ** -0.9 + 1.0
        counts = rng.poisson(lam, size=len(idx)).astype(np.float64) + 1.0
        xs.append(idx)
        ys.append(idx + d)
        vs.append(counts)
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    v = np.concatenate(vs)

    # plant loops: multiply counts near anchor pairs by a Gaussian bump.
    # membership lookup via a sorted flat-key index (a dict over tens of
    # millions of pixels is minutes on a slow host), new entries collected
    # in lists (np.append copies the whole array per call).
    anchors = []
    keys = x.astype(np.int64) * n_bins + y.astype(np.int64)
    order0 = np.argsort(keys, kind="stable")
    keys_sorted = keys[order0]
    extra_x, extra_y, extra_v = [], [], []
    new_keys = {}
    for _ in range(n_loops):
        ax = int(rng.integers(10, n_bins - 10))
        dd = int(rng.integers(max(10, d_px // 8), int(d_px * 0.9)))
        ay = ax + dd
        if ay >= n_bins - 10:
            continue
        anchors.append((ax, ay))
        for ddx in range(-3, 4):
            for ddy in range(-3, 4):
                kx, ky = ax + ddx, ay + ddy
                key = kx * n_bins + ky
                w = loop_strength * np.exp(-(ddx * ddx + ddy * ddy) / 3.0)
                pos = np.searchsorted(keys_sorted, key)
                if pos < len(keys_sorted) and keys_sorted[pos] == key:
                    v[order0[pos]] *= (1.0 + w)
                elif key in new_keys:
                    extra_v[new_keys[key]] *= (1.0 + w)
                elif 0 <= kx < n_bins and kx + 4 < ky < n_bins:
                    new_keys[key] = len(extra_v)
                    extra_x.append(kx)
                    extra_y.append(ky)
                    extra_v.append(3.0 * (1.0 + w))
    if extra_x:
        x = np.concatenate([x, np.array(extra_x)])
        y = np.concatenate([y, np.array(extra_y)])
        v = np.concatenate([v, np.array(extra_v)])
    order = np.lexsort((y, x))
    return x[order].astype(np.int64), y[order].astype(np.int64), v[order], anchors


def synthetic_inter(n1: int, n2: int, *, seed: int = 0, n_loops: int = 12,
                    loop_strength: float = 6.0, density: float = 0.5):
    """Synthetic inter-chromosomal rectangle: uniform sparse background plus
    planted Gaussian enrichment bumps at known (x, y) anchor pairs.
    Returns (x, y, v, anchors) with x on the first chromosome's bins."""
    rng = np.random.default_rng(seed)
    occ = rng.random((n1, n2)) < density
    c = np.where(occ, rng.poisson(8.0, size=(n1, n2)).astype(np.float64) + 1.0,
                 0.0)
    anchors = []
    for _ in range(n_loops):
        ax = int(rng.integers(10, n1 - 10))
        ay = int(rng.integers(10, n2 - 10))
        if any(abs(ax - a) < 8 and abs(ay - b) < 8 for a, b in anchors):
            continue
        anchors.append((ax, ay))
        for ddx in range(-3, 4):
            for ddy in range(-3, 4):
                w = loop_strength * np.exp(-(ddx * ddx + ddy * ddy) / 3.0)
                px, py = ax + ddx, ay + ddy
                c[px, py] = max(c[px, py], 8.0) * (1.0 + w)
    x, y = np.nonzero(c)
    return (x.astype(np.int64), y.astype(np.int64),
            c[x, y].astype(np.float64), anchors)
