"""The yardstick of the fused ladder kernel: the work it needs, and peaks.

Counted, not executed: two separable passes over each blur sigma's
nonzero taps (``2 r + 1``) at every cell of the band the kernel computes
(``DB`` diagonals, rows of ``min(DB, N - i)`` cells) of every real block,
one multiply-add being 2 FLOP; and 16 bytes a band cell (the dense block
and its support read once, the best value and scale written once, 4
bytes each). So a share reads the same work whatever implements the
ladder. The peaks are NVIDIA's data sheet for one H100 SXM at 700 W.
"""

from __future__ import annotations

import math

FP32_FLOPS = 67e12     # FP32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12    # HBM3, bytes/s
SUBDIVISIONS = 10


def kernel_radius(sigma: float) -> int:
    """The radius scipy uses for the reference's blur of ``sigma``."""
    w = 2 * math.ceil(2 * sigma) + 1
    t = ((w - 1) / 2 - 0.5) / sigma
    return int(t * float(sigma) + 0.5)


def ladder_taps(sigma0: float, octaves: int) -> int:
    """Nonzero taps of every blur of the ladder (12 sigmas an octave)."""
    return sum(2 * kernel_radius(o * 2 ** (k / SUBDIVISIONS)) + 1
               for o in (sigma0 * 2.0 ** i for i in range(octaves))
               for k in range(SUBDIVISIONS + 2))


def band_diagonals(N: int, d_px: int) -> int:
    """``DB``: the diagonals the kernel computes, ``d_px + 4`` rounded up
    to 128 (data and stencil halo), at most ``N``."""
    return min(-(-min(d_px + 4, N) // 128) * 128, N)


def band_cells(N: int, DB: int) -> int:
    """Cells of a block's band: ``sum over i < N of min(DB, N - i)``."""
    full = max(N - DB + 1, 0)
    return full * DB + sum(N - i for i in range(full, N))


def fused_ladder_work(N: int, DB: int, sigma0: float, octaves: int,
                      blocks: int) -> tuple[float, float]:
    """``(FLOP, bytes)`` the fused ladder needs for ``blocks`` real
    blocks of ``N`` bins with ``DB`` band diagonals."""
    cells = band_cells(N, DB) * blocks
    return 4.0 * ladder_taps(sigma0, octaves) * cells, 16.0 * cells


def bound_seconds(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flop / FP32_FLOPS, nbytes / HBM_BYTES)
