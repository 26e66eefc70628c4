"""The ladder route: the JAX package's XLA detection path in torch ops.

Torch port of ``mustache_tpu/detect.py``'s non-Pallas path (``_blur_ladder``
:99-165 and the per-plane scan of ``_detect_one`` :752-825) for the
configurations the fused kernel does not take (``detect.resolve_route``):
float64, ``use_pallas="off"``, and ladders too large for the kernel's
shared memory. Everything runs in the blocks' dtype, f32 with TF32 off or
f64.

The blurs are computed on the diagonal band only (``band[i, d] = G[i,
i+d]``, the layout everything after the blur lives in), as banded
Toeplitz matmuls, the form of ``mustache_tpu/detect.py::_blur_matmul``
restricted to the band: the vertical pass in row slabs of ``SLAB`` rows,
each slab reading only the padded columns its band rows need, then the
horizontal pass in column chunks of ``CHUNK`` band columns. The sums
differ from a convolution only in order (and in exact zero terms).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from mustache_tpu_torch.kernels.fused_ladder import (
    BLURS_PER_OCTAVE, _symmetric_pad, padded_window,
)

_INF = float("inf")
SLAB = 64      # rows per vertical-pass matmul
CHUNK = 64     # band columns per horizontal-pass matmul


def _toeplitz(taps: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``T[s, r, c] = taps[s, c - r]`` where ``0 <= c - r < W``, else 0:
    ``[S, rows, cols]``."""
    S, W = taps.shape
    off = (torch.arange(cols, device=taps.device)[None, :]
           - torch.arange(rows, device=taps.device)[:, None])
    t = taps[:, off.clamp(0, W - 1)]
    return torch.where((off >= 0) & (off < W), t, 0.0)


def band_blur(cpad: torch.Tensor, taps: torch.Tensor, N: int,
              Dl: int, rows: int | None = None,
              row0: int = 0) -> torch.Tensor:
    """Blurs of a batch of symmetric-padded blocks ``cpad`` ``[B, N+2R,
    N+2R]`` by the taps ``[S, 2R+1]``, on the band: ``[B, S, N, Dl]``,
    ``out[b, s, i, d] = G_s(b)[i, i+d]`` and 0 where ``i + d >= N``.

    A row window: ``cpad`` holds the padded block from padded row and
    column ``row0`` on (``cpad[r, c] = padded[row0 + r, row0 + c]``), and
    the output is the band rows ``[row0, row0 + rows)`` of the ``N``-row
    block. With ``row0`` a multiple of ``SLAB`` every output cell is the
    whole block's, bit for bit: the slabs are the same matmuls on the
    same data.

    Vertical pass: slab k (rows ``[kh, kh+h)``) multiplies the Toeplitz
    ``[S, h, h+2R]`` with the padded rows ``[kh, kh+h+2R)`` and columns
    ``[kh, kh+h+E-1)``, a strided view, so no slab reads a column its band
    rows do not need (E = the band columns the horizontal pass reads).
    Its rows are sheared to band coordinates. Horizontal pass: chunks of
    ``CHUNK`` band columns, each one matmul with the shared Toeplitz
    ``[S, CHUNK+2R, CHUNK]``."""
    B, Pr, Pc = cpad.shape
    S, W = taps.shape
    R = (W - 1) // 2
    rows = N - row0 if rows is None else rows
    h, k = SLAB, CHUNK
    nc = -(-Dl // k)
    E = nc * k + 2 * R                 # band columns the chunks read
    nslab = -(-rows // h)
    wq = h + E - 1                     # padded columns one slab reads
    need_r, need_c = nslab * h + 2 * R, (nslab - 1) * h + wq
    X = F.pad(cpad, (0, max(0, need_c - Pc), 0, max(0, need_r - Pr)))
    M = X.shape[-1]
    Xs = X.as_strided((B, nslab, h + 2 * R, wq),
                      (X.stride(0), h * (M + 1), M, 1))
    # one GEMM per slab for all sigmas: [S h, h+2R] @ [h+2R, wq]
    V = torch.matmul(_toeplitz(taps, h, h + 2 * R).reshape(S * h, -1), Xs)
    # shear row r by r: Vb[.., r, e] = V[.., r, r+e]
    V = F.pad(V.reshape(B, nslab, S, h * wq), (0, h))
    Vb = V.reshape(B, nslab, S, h, wq + 1)[..., :E]
    del V
    # one GEMM per sigma over every (block, slab, row, chunk)
    U = Vb.unfold(-1, k + 2 * R, k).permute(2, 0, 1, 3, 4, 5)
    del Vb
    G = torch.bmm(U.reshape(S, -1, k + 2 * R),
                  _toeplitz(taps, k, k + 2 * R).transpose(1, 2))
    del U
    G = G.reshape(S, B, nslab, h, nc * k)[..., :Dl]
    G = G.permute(1, 0, 2, 3, 4).reshape(B, S, nslab * h, Dl)[:, :, :rows]
    i = torch.arange(row0, row0 + rows, device=cpad.device)[:, None]
    d = torch.arange(Dl, device=cpad.device)[None, :]
    return torch.where(i + d < N, G, 0.0)


def max3x3_band(geom, Lb: torch.Tensor) -> torch.Tensor:
    """Dense 3x3 constant-0 maximum filter of band images ``[..., N, Dl]``
    (``geom``: the block's ``detect._BandGeom``), evaluated in band
    coordinates, separably: along the dense row (band column d+dy), then
    across rows (band row i+dx, column d-dx). Taps outside the dense
    matrix contribute the 0 pad, taps outside the band 0. Exact at the
    band columns the detection rows read (d in [1, Dl-2]); the JAX
    package's nine-term form (``_BandGeom.max3x3_band``) agrees there."""
    N = geom.N
    yl = geom.band_yl

    def shift(a, di, dd):
        # a[..., i+di, d+dd], zero-filled outside the array
        p = F.pad(a, (1, 1, 1, 1))
        n, dl = a.shape[-2:]
        return p[..., 1 + di:1 + di + n, 1 + dd:1 + dd + dl]

    row = None
    for dy in (-1, 0, 1):
        term = torch.where((yl + dy >= 0) & (yl + dy < N),
                           shift(Lb, 0, dy), 0.0)
        row = term if row is None else torch.maximum(row, term)
    m = None
    for dx in (-1, 0, 1):
        il = geom.band_il + dx
        term = torch.where((il >= 0) & (il < N), shift(row, dx, -dx), 0.0)
        m = term if m is None else torch.maximum(m, term)
    return m


def nms_will(Lp, Lc, Ln, mP, mC, mN, nz, best_v) -> torch.Tensor:
    """The scale-space NMS update (``fused_ladder.py:250-255`` of the JAX
    package): a support cell takes plane ``Lc`` where it beats the running
    best, is its own 3x3 maximum and the scale-space maximum of its
    neighbours ``Lp``/``Ln`` (``m*``: their 3x3 maxima)."""
    return (nz & (Lc > best_v) & (Lc == mC) & ((Lp == mP) | (Ln == mN))
            & (Lc > mP) & (Lc > mN))


def ring_rows(N: int, Dl: int, row0: int, rows: int, device):
    """Band-row geometry (``max3x3_band``'s ``N``, ``band_il``,
    ``band_yl``) of the rows ``[row0 - 1, row0 + rows + 1)``: a window's
    rows and its NMS ring."""
    ext = torch.arange(row0 - 1, row0 + rows + 1, device=device)[:, None]
    return SimpleNamespace(N=N, band_il=ext.expand(-1, Dl),
                           band_yl=ext + torch.arange(Dl, device=device))


def window_blur(X, taps, N: int, Dl: int, g0: int, row0: int, rows: int):
    """Band blurs ``[B, S, rows + 2, Dl]`` of the band rows ``[row0 - 1,
    row0 + rows + 1)`` (0 outside the block) from :func:`padded_window`'s
    ``X``, which starts at the slab boundary ``g0``: every cell is the
    whole block's :func:`band_blur`, bit for bit."""
    g1 = min(N, row0 + rows + 1)
    G = band_blur(X, taps, N, Dl, rows=g1 - g0, row0=g0)
    return F.pad(G[:, :, max(row0 - 1, 0) - g0:],
                 (0, 0, int(row0 == 0), int(row0 + rows == N)))


def ladder_window(cs: torch.Tensor, nzb: torch.Tensor, taps: torch.Tensor,
                  spec, N: int, Dl: int, *, base: int, row0: int,
                  rows: int):
    """The ladder route's state of the band rows ``[row0, row0 + rows)`` of
    a batch of ``N x N`` blocks, from their sentinel-filled dense rows
    ``cs`` ``[B, held, N]`` from ``base`` (the rows plus the ladder radius
    and the NMS ring) and the rows' band support ``nzb`` ``[B, rows,
    Dl]``: ``(best_v, best_sig, locs, sums)``, the running best response
    and plane of :func:`ladder_best` (bit for bit: the blurs start on a
    slab boundary, :func:`window_blur`) and each plane's support partials
    over these rows, min |L| and sum |L| ``[B, P]``. The fit and log p
    need every row's partials; ``detect.BlockDetector.join_rows`` forms
    them."""
    B = cs.shape[0]
    dt, dev = cs.dtype, cs.device
    g0 = SLAB * (max(row0 - 1, 0) // SLAB)
    X = padded_window(cs, N, spec.radius, base, g0,
                      min(N, row0 + rows + 1) - g0)
    geom = ring_rows(N, Dl, row0, rows, dev)
    nzbf = nzb.to(dt)
    best_v = torch.zeros((B, rows, Dl), dtype=dt, device=dev)
    best_sig = torch.full((B, rows, Dl), -1, dtype=torch.int32, device=dev)
    locs, sums = [], []
    ppo = spec.planes_per_octave
    for o in range(len(spec.octave_values)):
        Gb = window_blur(X, taps[o * BLURS_PER_OCTAVE:
                                 (o + 1) * BLURS_PER_OCTAVE], N, Dl, g0,
                         row0, rows)
        L = Gb[:, :-1] - Gb[:, 1:]
        del Gb
        M = max3x3_band(geom, L)[..., 1:-1, :]
        L = L[..., 1:-1, :]
        for j in range(1, L.shape[1] - 1):
            Lc = L[:, j]
            al = Lc.abs()
            locs.append(torch.where(nzb, al, _INF).amin(dim=(1, 2)))
            sums.append((al * nzbf).sum(dim=(1, 2)))
            will = nms_will(L[:, j - 1], Lc, L[:, j + 1], M[:, j - 1],
                            M[:, j], M[:, j + 1], nzb, best_v)
            best_v = torch.where(will, Lc, best_v)
            best_sig = torch.where(will, o * ppo + j - 1, best_sig)
    return best_v, best_sig, torch.stack(locs, 1), torch.stack(sums, 1)


def ladder_best(cs: torch.Tensor, nzb: torch.Tensor, nz_count: torch.Tensor,
                taps: torch.Tensor, spec, geom, *, scrub_nan: bool = False):
    """The ladder route's detection state of a batch of blocks, in the
    blocks' dtype: ``(best_v, best_logp, best_sigidx)``, each ``[B, N,
    Dl]``.

    ``cs``: sentinel-filled dense blocks ``[B, N, N]``; ``nzb``: their
    band support ``[B, N, Dl]`` and ``nz_count`` its size ``[B]``;
    ``taps``: the ladder ``[S, 2R+1]`` in the blocks' dtype; ``spec``: the
    ``LadderSpec``; ``geom``: the block's ``detect._BandGeom``. Per
    octave, the 12 blurs of every block on the band (:func:`band_blur`,
    reflect boundary by the symmetric pad), then the 9 DoG planes in
    order: each plane's exponential fit over the support (loc = min |L|,
    scale = mean |L| - loc), its log p, and the scale-space NMS update of
    the running best. ``scrub_nan`` maps a NaN log p to 0 (the
    differential path). The JAX package's XLA path
    (``mustache_tpu/detect.py:779-825``) step for step."""
    B, N, _ = cs.shape
    dt = cs.dtype
    Dl = geom.Dl
    nzbf = nzb.to(dt)
    inv_count = (1.0 / nz_count.clamp(min=1).to(dt))[:, None, None]
    best = (torch.zeros((B, N, Dl), dtype=dt, device=cs.device),
            torch.full((B, N, Dl), _INF, dtype=dt, device=cs.device),
            torch.full((B, N, Dl), -1, dtype=torch.int32, device=cs.device))
    rf = torch.profiler.record_function
    cpad = _symmetric_pad(cs, spec.radius)
    ppo = spec.planes_per_octave
    for o in range(len(spec.octave_values)):
        with rf("ladder.blur"):
            Gb = band_blur(cpad, taps[o * BLURS_PER_OCTAVE:
                                      (o + 1) * BLURS_PER_OCTAVE], N, Dl)
        with rf("ladder.scan"):
            best = _scan_octave(geom, Gb, o * ppo, nzb, nzbf, inv_count,
                                best, scrub_nan)
        del Gb
    return best


def _scan_octave(geom, Gb, plane0: int, nzb, nzbf, inv_count, best,
                 scrub_nan: bool):
    """One octave of :func:`ladder_best`'s scan over the band blurs ``Gb``
    ``[B, 12, N, Dl]``, from the running best ``(best_v, best_logp,
    best_sigidx)``; the octave's planes are ``plane0 .. plane0 + 8``."""
    best_v, best_logp, best_sig = best
    L = Gb[:, :-1] - Gb[:, 1:]                         # [B, 11, N, Dl]
    M = max3x3_band(geom, L)
    for j in range(1, L.shape[1] - 1):
        Lp, Lc, Ln = L[:, j - 1], L[:, j], L[:, j + 1]
        mP, mC, mN = M[:, j - 1], M[:, j], M[:, j + 1]
        abs_lc = Lc.abs()
        loc = torch.where(nzb, abs_lc, _INF).amin(dim=(1, 2))
        loc = loc[:, None, None]
        mean = (abs_lc * nzbf).sum(dim=(1, 2))[:, None, None] * inv_count
        logp = -(abs_lc - loc) / (mean - loc)
        if scrub_nan:
            logp = torch.where(torch.isnan(logp), 0.0, logp)
        will = nms_will(Lp, Lc, Ln, mP, mC, mN, nzb, best_v)
        best_v = torch.where(will, Lc, best_v)
        best_logp = torch.where(will, logp, best_logp)
        best_sig = torch.where(will, plane0 + j - 1, best_sig)
    return best_v, best_logp, best_sig
