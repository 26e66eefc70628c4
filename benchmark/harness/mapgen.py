"""The one traffic generator: synthetic contact maps, made on the device.

A chromosome of ``n_bins`` bins holds Poisson counts. The pixel ``(x,
y)``, ``d = y - x >= 1`` diagonals apart, has the mean ``A * d **
-exponent`` (contact probability falling as a power of the distance;
Lieberman-Aiden et al. 2009 measured the exponent 1.08) times the factors
of the loops that cover it; ``A`` is set so that the chromosome expects
``contacts`` contacts in all. Loops are planted at random anchor pairs as
7x7 Gaussian bumps that multiply the mean they cover by ``1 +
loop_strength * exp(-(dx^2 + dy^2) / 3)``.

The background is drawn per diagonal: ``K_d ~ Poisson((n_bins -
d) * mean_d)`` contacts on diagonal ``d``, each at a uniform row, which
gives every pixel an independent Poisson count of mean ``mean_d``. A
loop's excess over the background is a Poisson count of its own at each
pixel it covers. The draws come from one ``torch.Generator`` seeded with
the run's seed, on the device, in a few calls over the whole band. Only the
diagonals ``1..d_px`` are drawn: the reader's distance filter drops the
rest. The map is copied to host COO triplets sorted by ``(x, y)``, what a
reader hands the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def depth_scale(n_bins: int, contacts: float, exponent: float) -> float:
    """``A``: the background's mean at ``d = 1`` for which the whole
    chromosome, every diagonal ``1..n_bins - 1``, expects ``contacts``."""
    d = np.arange(1, n_bins, dtype=np.float64)
    return float(contacts / ((n_bins - d) * d ** -exponent).sum())


def loop_anchors(gen: torch.Generator, n_bins: int, d_px: int,
                 n_loops: int, device) -> list[tuple[int, int]]:
    """Up to ``n_loops`` anchor pairs ``(x, y)``: ``x`` uniform in ``[10,
    n_bins - 10)``, ``y - x`` uniform in ``[max(10, d_px // 8), 0.9
    d_px)``; a pair whose ``y`` reaches ``n_bins - 10`` is dropped."""
    ax = torch.randint(10, n_bins - 10, (n_loops,), generator=gen,
                       device=device)
    dd = torch.randint(max(10, d_px // 8), int(d_px * 0.9), (n_loops,),
                       generator=gen, device=device)
    ax, dd = ax.cpu().numpy(), dd.cpu().numpy()
    return [(int(a), int(a + d)) for a, d in zip(ax, dd)
            if a + d < n_bins - 10]


def bump_factors(anchors, n_bins: int, d_px: int, loop_strength: float):
    """Flat band indices (``x * d_px + (y - x - 1)``) and the product of
    the bumps' factors at each, for every pixel a bump covers."""
    keys, facs = [], []
    for ax, ay in anchors:
        for dx in range(-3, 4):
            for dy in range(-3, 4):
                kx, ky = ax + dx, ay + dy
                w = loop_strength * math.exp(-(dx * dx + dy * dy) / 3.0)
                if 0 <= kx < n_bins and kx < ky < n_bins and ky - kx <= d_px:
                    keys.append(kx * d_px + (ky - kx - 1))
                    facs.append(1.0 + w)
    keys = np.asarray(keys, np.int64)
    facs = np.asarray(facs, np.float64)
    uniq, inv = np.unique(keys, return_inverse=True)
    prod = np.ones(len(uniq))
    np.multiply.at(prod, inv, facs)
    return uniq, prod


def make_map(n_bins: int, d_px: int, *, seed: int, device, contacts: float,
             exponent: float, n_loops: int, loop_strength: float):
    """One map as host arrays ``(x, y, v)`` (int64, int64, float64),
    sorted by ``(x, y)``, ``x < y <= x + d_px``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a = depth_scale(n_bins, contacts, exponent)
    f64 = dict(dtype=torch.float64, device=device)
    d = torch.arange(1, min(d_px, n_bins - 1) + 1, **f64)
    per_diag = torch.poisson((n_bins - d) * a * d ** -exponent,
                             generator=gen).to(torch.int64)
    dist = torch.repeat_interleave(d.to(torch.int64), per_diag)
    del d, per_diag
    x = (torch.rand(dist.shape, generator=gen, **f64)
         * (n_bins - dist)).to(torch.int64)
    keys = [x * d_px + (dist - 1)]
    del x, dist
    anchors = loop_anchors(gen, n_bins, d_px, n_loops, device)
    if anchors:
        bk, prod = bump_factors(anchors, n_bins, d_px, loop_strength)
        bk = torch.as_tensor(bk, device=device)
        bd = (bk % d_px + 1).to(torch.float64)
        excess = a * bd ** -exponent * (torch.as_tensor(prod, **f64) - 1.0)
        keys.append(torch.repeat_interleave(
            bk, torch.poisson(excess, generator=gen).to(torch.int64)))
    key, count = torch.unique(torch.cat(keys), sorted=True,
                              return_counts=True)
    del keys
    x = key // d_px
    y = x + key % d_px + 1
    return (x.cpu().numpy(), y.cpu().numpy(),
            count.to(torch.float64).cpu().numpy())
