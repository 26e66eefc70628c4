"""Maps with Micro-C's short-range loops, made on the device.

The background is ``mapgen.make_map``'s, draw for draw: Poisson counts
about ``A * d ** -exponent`` (``mapgen.depth_scale``), drawn per diagonal
from one ``torch.Generator`` seeded with the run's seed, over the
diagonals ``1..d_px``. Only the loops differ. Micro-C resolves
promoter and enhancer loops kilobases to some hundred kilobases apart
(Hsieh et al. 2020, Mol Cell 78:539; Krietenstein et al. 2020, Mol Cell
78:554), where a map at a cited depth is nearly all nonzero, while
mapgen's loops lie ``d_px / 8`` to ``0.9 d_px`` apart (250 kb to 1.8 Mb
at 1 kb), where most pixels are empty and the sparsity filter keeps no
call. Here a loop's anchors lie ``dd`` bins apart, ``dd`` log-uniform
over ``[lo_px, hi_px]`` and rounded to a whole bin, its first anchor
``x`` uniform in ``[10, n_bins - 10 - dd)``. Each is planted as mapgen
plants its loops (``mapgen.bump_factors``): a 7x7 Gaussian bump that
multiplies the mean it covers, its excess a Poisson count of its own.
The map is copied to host COO triplets sorted by ``(x, y)``.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness import mapgen
from benchmark.reference.chromosome import Deployment


def loop_anchors(gen: torch.Generator, n_bins: int, n_loops: int,
                 lo_px: float, hi_px: float, device) -> list[tuple[int, int]]:
    """``n_loops`` anchor pairs ``(x, y)``: ``y - x`` log-uniform over
    ``[lo_px, hi_px]``, rounded to a whole bin, and ``x`` uniform in
    ``[10, n_bins - 10 - (y - x))``."""
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.rand(n_loops, generator=gen, **f64)
    w = torch.rand(n_loops, generator=gen, **f64)
    lo, hi = math.log(lo_px), math.log(hi_px)
    dd = torch.round(torch.exp(lo + u * (hi - lo))).to(torch.int64)
    x = 10 + (w * (n_bins - 20 - dd)).to(torch.int64)
    x, dd = x.cpu().numpy(), dd.cpu().numpy()
    return [(int(a), int(a + d)) for a, d in zip(x, dd)]


def make_map(n_bins: int, d_px: int, *, seed: int, device, contacts: float,
             exponent: float, n_loops: int, loop_strength: float,
             loop_px: tuple[float, float]):
    """One map as host arrays ``(x, y, v)`` (int64, int64, float64),
    sorted by ``(x, y)``, ``x < y <= x + d_px``, and its planted anchor
    pairs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a = mapgen.depth_scale(n_bins, contacts, exponent)
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
    anchors = loop_anchors(gen, n_bins, n_loops, *loop_px, device)
    if anchors:
        bk, prod = mapgen.bump_factors(anchors, n_bins, d_px, loop_strength)
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
            count.to(torch.float64).cpu().numpy(), anchors)


def make_maps(cell, seed: int, device) -> list[dict]:
    """Each map of the cell's traffic as ``{"chrom", "n_bins", "x", "y",
    "v", "anchors"}``, made from ``seed`` plus the map's ``seed_offset``,
    as ``deployment.make_maps`` makes them; the loops' separations are the
    traffic depth's ``loop_bp`` over the resolution."""
    dep = Deployment(cell.config)
    depth = cell.traffic["depth"]
    lo_bp, hi_bp = depth["loop_bp"]
    out = []
    for m in cell.traffic["maps"]:
        bp = int(m["bp"])
        share = bp / float(depth["genome_bp"])
        n_bins = -(-bp // dep.resolution)
        x, y, v, anchors = make_map(
            n_bins, dep.d_px, seed=int(seed) + int(m.get("seed_offset", 0)),
            device=device, contacts=float(depth["genome_contacts"]) * share,
            exponent=float(depth["exponent"]),
            n_loops=round(float(depth["genome_loops"]) * share),
            loop_strength=float(depth["loop_strength"]),
            loop_px=(lo_bp / dep.resolution, hi_bp / dep.resolution))
        out.append({"chrom": m["chrom"], "n_bins": n_bins, "x": x, "y": y,
                    "v": v, "anchors": anchors})
    return out
