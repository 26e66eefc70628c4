"""The reference over a whole chromosome: its block grid and ownership.

The grid (mustache.py:896-910) advances blocks of ``max(2 d_px, 2000)``
bins by the block less ``d_px``, the last one right-aligned at ``n``;
each block is densified from the contacts that lie wholly inside it
(mustache.py:919-924, zero-padded to the block size), and block ``i``
keeps a call only beyond its ownership mask (mustache.py:948-953). The
two conditions of a differential run are each normalized with their own
bin count and cut on the grid of the larger (diff_mustache.py:754-761).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.detect import detect_block, diff_detect_block
from benchmark.reference.normalize import normalize_coo


def distance_px(resolution: int, distance_bp: int) -> int:
    """The reference's ``int(math.ceil(distance_bp // resolution))``."""
    return int(math.ceil(distance_bp // resolution))


def chunk_grid(n: int, chunk: int, overlap: int):
    """Block starts and ends along the chromosome."""
    if n <= chunk:
        return [0], [n]
    start, end = [0], [chunk]
    while end[-1] < n:
        start.append(end[-1] - overlap)
        end.append(start[-1] + chunk)
    end[-1] = n
    start[-1] = end[-1] - chunk
    return start, end


def mask_sizes(start, end, overlap) -> list[int]:
    """Ownership masks: block ``i`` keeps ``(x, y)`` iff ``x`` or ``y`` is
    at least ``start[i] + mask[i]``."""
    masks = []
    for i in range(len(start)):
        if i == 0:
            masks.append(-1)
        elif i == len(start) - 1:
            masks.append(end[i - 1] - start[i])
        else:
            masks.append(overlap)
    return masks


def dense_block(x, y, v, s: int, e: int, chunk: int, dtype) -> torch.Tensor:
    """``[chunk, chunk]`` of the contacts wholly inside ``[s, e)``."""
    sel = (x >= s) & (x < e) & (y >= s) & (y < e)
    c = torch.zeros((chunk, chunk), dtype=dtype, device=v.device)
    c[x[sel] - s, y[sel] - s] = v[sel].to(dtype)
    return c


class Deployment:
    """What the reference reads of a configuration file: resolution,
    distance, thresholds and the ladder."""

    def __init__(self, cfg: dict):
        self.resolution = int(cfg["resolution"])
        self.d_px = distance_px(self.resolution, int(cfg["distance_bp"]))
        self.chunk = max(2 * self.d_px, 2000)
        self.pt = float(cfg["pt"])
        self.st = float(cfg["st"])
        self.pt2 = float(cfg.get("pt2", 0.1))
        sigma0, octaves = float(cfg["sigma0"]), int(cfg["octaves"])
        self.octave_values = [sigma0 * 2.0 ** i for i in range(octaves)]


def _coo(x, y, v, device):
    as_t = (lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt))
    return (as_t(x, torch.int64), as_t(y, torch.int64),
            as_t(v, torch.float64))


def loops(x, y, v, cfg: dict, *, device, dtype=torch.float64,
          tf32: bool = False) -> list[tuple[int, int, float, float]]:
    """Loop calls ``(bin1, bin2, q, scale)`` of one raw map."""
    dep = Deployment(cfg)
    x, y, v = _coo(x, y, v, device)
    vn = normalize_coo(x, y, v, dep.resolution, dep.d_px, dtype=dtype)
    n = int(torch.maximum(x.max(), y.max())) + 1
    start, end = chunk_grid(n, dep.chunk, dep.d_px)
    masks = mask_sizes(start, end, dep.d_px)
    rows = []
    for i, (s, e) in enumerate(zip(start, end)):
        c = dense_block(x, y, vn, s, e, dep.chunk, dtype)
        for r in detect_block(c, dep.octave_values, dep.d_px, dep.st,
                              dep.pt, start=s, tf32=tf32):
            if r[0] >= s + masks[i] or r[1] >= s + masks[i]:
                rows.append(r)
        del c
    return rows


def diff_loops(x1, y1, v1, x2, y2, v2, cfg: dict, *, device,
               dtype=torch.float64, tf32: bool = False
               ) -> list[tuple[int, int, float, float, int]]:
    """Differential calls ``(bin1, bin2, q, scale, tag)`` of two raw maps,
    tag 1 = loops of map 1, 2 = its differential loops, 3 and 4 the same
    of map 2."""
    dep = Deployment(cfg)
    maps = [_coo(x1, y1, v1, device), _coo(x2, y2, v2, device)]
    vns = [normalize_coo(x, y, v, dep.resolution, dep.d_px, dtype=dtype)
           for x, y, v in maps]
    n = max(int(torch.maximum(x.max(), y.max())) + 1 for x, y, _ in maps)
    start, end = chunk_grid(n, dep.chunk, dep.d_px)
    masks = mask_sizes(start, end, dep.d_px)
    rows = []
    for i, (s, e) in enumerate(zip(start, end)):
        c1, c2 = (dense_block(x, y, vn, s, e, dep.chunk, dtype)
                  for (x, y, _), vn in zip(maps, vns))
        groups = diff_detect_block(c1, c2, dep.octave_values, dep.d_px,
                                   dep.st, dep.pt, dep.pt2, start=s,
                                   tf32=tf32)
        for tag, group in zip((1, 2, 3, 4), groups):
            for r in group:
                if r[0] >= s + masks[i] or r[1] >= s + masks[i]:
                    rows.append((*r, tag))
        del c1, c2
    return rows
