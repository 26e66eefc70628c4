"""Inter-chromosomal loop detection (beyond the reference).

Torch port of ``mustache_tpu/inter.py``, whose semantics are the spec: the
reference advertises ``-ch2`` but its inter path does not run
(mustache.py:689-694, :939-942).

* **Normalization**: a global z-score over the map's entries on the host
  (:func:`normalize_inter`, mustache.py:689-694's intent).
* **Detection**: the intra core's scale-space machinery (blur ladder, 3x3
  space/scale NMS, per-plane exponential tail p-values, BH FDR, q < pt,
  sparsity filter) on the full rectangle: no diagonal band, no sentinel
  wedges, no enrichment filter.
* **Blocking**: a 2-D grid of chunk x chunk tiles with a 128-bin overlap;
  a tile owns the clusters whose argmin-q pixel lies in its interior on
  both axes (overlap midpoints), and a final coordinate dedup merges the
  rare pair that two tiles both emit next to a boundary
  (:func:`_dedup_boundary_loops`). Statistics are per tile.

The JAX package runs this path in XLA ops, no Pallas kernel
(``mustache_tpu/inter.py:46-47``), so the port runs it in torch ops on the
device, in the run's dtype (f32 with TF32 off, or f64), batched over
tiles ``[B, chunk, chunk]`` where JAX vmaps. The blurs are banded
Toeplitz matmuls (the form of ``mustache_tpu/detect.py::_blur_matmul``)
over column chunks, in row slabs above ``ROWS_ONE_SHOT`` rows, one octave
at a time; the DoG planes and their 3x3 maxima roll through the scan as
the JAX ``lax.scan`` carries them. Tiles are built on the device from
the x-sorted, deduplicated COO (one upload of the triplets; duplicate
pixels keep their last value in input order, as the JAX host densify
does). Each stage is a named profiler range (``inter.*``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mustache_tpu_torch.config import DetectionConfig, chunk_grid
from mustache_tpu_torch.detect import (
    _bh_lookup, _logq_from_sorted, _maybe_regrow, _out_spec, _pack_batched,
    emit_components, thresholds, unpack_block,
)
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.kernels.fused_ladder import (
    BLURS_PER_OCTAVE, _max3x3, _symmetric_pad,
)
from mustache_tpu_torch.ladder import _toeplitz
from mustache_tpu_torch.scalespace import LadderSpec, build_ladder, ladder_tensor
from mustache_tpu_torch.sharding import _batch_size

OVERLAP = 128        # covers the ladder radius (13), NMS (1), clustering (3)
ROWS_ONE_SHOT = 2048  # taller tiles blur in row slabs (detect.py:138-163)
SLAB = 512           # rows per slab
CHUNK = 64           # output columns per Toeplitz matmul
# bytes a tile holds at its peak, in units of chunk^2 * itemsize (the blurs
# of one octave, the rolling DoG planes and maxima, the best state, the
# tile and its support, and the blur's transients): 41.6 for a 2000^2 f32
# tile and 40.9 for a float64 one, the slope of the peak over B
# (chip_smoke.py phase 9 on an NVIDIA H100 80GB HBM3 at 700 W)
TILE_PLANES = 42
_INF = float("inf")


def normalize_inter(v: np.ndarray) -> np.ndarray:
    """Global z-score over the map's entries (mustache.py:689-694 intent);
    mutates and returns ``v``. Non-finite inputs are zeroed first (the
    reference's nan_to_num), and a zero spread leaves the map at 0."""
    np.nan_to_num(v, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
    m = float(np.mean(v)) if len(v) else 0.0
    s = float(np.std(v)) if len(v) else 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        z = (v - m) / s
    z[~np.isfinite(z)] = 0.0
    v[:] = z
    return v


def _pass_last(x: torch.Tensor, taps: torch.Tensor, n_out: int,
               depthwise: bool) -> torch.Tensor:
    """One 1-D VALID correlation along the last dim as banded Toeplitz
    matmuls over chunks of ``CHUNK`` output columns: ``out[..., s, r, j] =
    sum_t taps[s, t] * x[..., r, j + t]`` for ``j < n_out``. ``x`` is
    ``[B, M, n_out + 2R]`` (every sigma reads it; out ``[B, S, M, n_out]``)
    or, with ``depthwise``, ``[B, S, M, n_out + 2R]`` (sigma s reads plane
    s). Each intermediate is dropped as soon as the next exists (a
    caller that passes its only reference to ``x`` frees it here too)."""
    S, W = taps.shape
    k = CHUNK
    nc = -(-n_out // k)
    T = _toeplitz(taps, k, k + W - 1).transpose(1, 2)   # [S, k+2R, k]
    x = F.pad(x, (0, nc * k + W - 1 - x.shape[-1]))
    U = x.unfold(-1, k + W - 1, k)                 # [..., M, nc, k+2R]
    del x
    if depthwise:
        B, _, M = U.shape[:3]
        U = U.reshape(B, S, M * nc, k + W - 1)
        out = torch.matmul(U, T)
        del U
        return out.reshape(B, S, M, nc * k)[..., :n_out]
    B, M = U.shape[:2]
    U = U.reshape(B * M * nc, k + W - 1)
    # one GEMM for all sigmas: [B M nc, k+2R] @ [k+2R, S k]
    out = U @ T.permute(1, 0, 2).reshape(k + W - 1, S * k)
    del U
    out = out.reshape(B, M, nc, S, k).permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, M, nc * k)[..., :n_out]


def _blur_rows(cpad: torch.Tensor, taps: torch.Tensor, N1: int,
               N2: int) -> torch.Tensor:
    """Blurs of padded tiles ``cpad`` ``[B, rows + 2R, N2 + 2R]`` (rows =
    N1 output rows): the vertical pass (along axis 0), then the
    horizontal pass per sigma: ``[B, S, N1, N2]``."""
    return _pass_last(
        _pass_last(cpad.transpose(1, 2), taps, N1, depthwise=False)
        .transpose(2, 3), taps, N2, depthwise=True)


def blur_octave(cpad: torch.Tensor, taps: torch.Tensor, N1: int,
                N2: int) -> torch.Tensor:
    """The S blurs of tiles ``[B, N1, N2]`` from their symmetric pad by R
    ``cpad`` ``[B, N1 + 2R, N2 + 2R]`` and taps ``[S, 2R+1]``: ``[B, S,
    N1, N2]`` (scipy ``gaussian_filter``'s reflect boundary, as
    ``detect._blur_ladder``). Tiles of more than ``ROWS_ONE_SHOT`` rows
    go in slabs of ``SLAB`` rows, which bounds the transients."""
    R = (taps.shape[1] - 1) // 2
    if N1 <= ROWS_ONE_SHOT:
        return _blur_rows(cpad, taps, N1, N2)
    out = torch.empty((cpad.shape[0], taps.shape[0], N1, N2),
                      dtype=cpad.dtype, device=cpad.device)
    for r0 in range(0, N1, SLAB):
        h = min(SLAB, N1 - r0)
        out[:, :, r0:r0 + h] = _blur_rows(cpad[:, r0:r0 + h + 2 * R],
                                          taps, h, N2)
    return out


def _rect_box_counts(ii_flat, x, y, s, N1: int, N2: int):
    """Window sums over [x-s, x+s+1) x [y-s, y+s+1) of each tile's support,
    clamped at ALL edges (``mustache_tpu/inter.py:67-81``; the intra
    core's negative-start quirk is intra-only), from its integral image
    flattened to ``[B, (N1+1) (N2+1)]``; ``x``, ``y``, ``s`` are ``[B,
    K]``."""
    x0 = (x - s).clamp(0, N1)
    x1 = (x + s + 1).clamp(0, N1)
    y0 = (y - s).clamp(0, N2)
    y1 = (y + s + 1).clamp(0, N2)
    W = N2 + 1

    def at(a, b):
        return ii_flat.gather(1, a * W + b)
    return at(x1, y1) - at(x0, y1) - at(x1, y0) + at(x0, y0)


def inter_state(c: torch.Tensor, taps: torch.Tensor, spec: LadderSpec):
    """The detection state of tiles ``c`` ``[B, N1, N2]`` (run dtype):
    ``(nz, nz_count, best_v, best_logp, best_sigidx)``. Per octave, its 12
    blurs (:func:`blur_octave`), then the 9 DoG planes in order: each
    plane's exponential fit over the support (loc = min |L|, scale = mean
    |L| - loc), its log p, and the scale-space NMS update of the running
    best (``mustache_tpu/inter.py:84-134``)."""
    dt = c.dtype
    B, N1, N2 = c.shape
    nz = c != 0
    nz_count = nz.sum(dim=(1, 2), dtype=torch.int32)
    nzf = nz.to(dt)
    inv_count = (1.0 / nz_count.clamp(min=1).to(dt))[:, None, None]
    best_v = torch.zeros_like(c)
    best_logp = torch.full_like(c, _INF)
    best_sig = torch.full(c.shape, -1, dtype=torch.int32, device=c.device)
    rf = torch.profiler.record_function
    cpad = _symmetric_pad(c, spec.radius)
    ppo = spec.planes_per_octave
    for o in range(len(spec.octave_values)):
        with rf("inter.blur"):
            G = blur_octave(cpad, taps[o * BLURS_PER_OCTAVE:
                                       (o + 1) * BLURS_PER_OCTAVE], N1, N2)
        with rf("inter.scan"):
            Lp, Lc = G[:, 0] - G[:, 1], G[:, 1] - G[:, 2]
            mP, mC = _max3x3(Lp), _max3x3(Lc)
            for j in range(1, BLURS_PER_OCTAVE - 2):
                Ln = G[:, j + 1] - G[:, j + 2]
                mN = _max3x3(Ln)
                abs_lc = Lc.abs()
                loc = torch.where(nz, abs_lc, _INF).amin(dim=(1, 2))
                loc = loc[:, None, None]
                mean = (abs_lc * nzf).sum(dim=(1, 2))[:, None, None] \
                    * inv_count
                logp = -(abs_lc - loc) / (mean - loc)
                will = (nz & (Lc > best_v) & (Lc == mC)
                        & ((Lp == mP) | (Ln == mN)) & (Lc > mP) & (Lc > mN))
                best_v = torch.where(will, Lc, best_v)
                best_logp = torch.where(will, logp, best_logp)
                best_sig = torch.where(will, o * ppo + j - 1, best_sig)
                Lp, Lc, mP, mC = Lc, Ln, mC, mN
        del G
    return nz, nz_count, best_v, best_logp, best_sig


def inter_candidates(state, *, det_ceil, K: int, st: float,
                     log_pt: float) -> dict:
    """Each tile's candidate table from :func:`inter_state`'s ``state``
    (``mustache_tpu/inter.py:136-204``): BH by one stable sort of the flat
    keys (``lax.sort((keys, iota), num_keys=1)``), the K smallest-p
    pixels, the sparsity occupancies over the clamped window area, and the
    3x3 neighbour export (tested neighbours their BH q, untested support
    cells log 2, other in-matrix cells 0, outside +inf). Batched ``[B,
    ...]``."""
    nz, nz_count, _, best_logp, best_sig = state
    B, N1, N2 = nz.shape
    dt = best_logp.dtype
    dev = nz.device
    found = nz & (best_logp < _INF)
    n_tested = found.sum(dim=(1, 2), dtype=torch.int32)
    keys = torch.where(found, best_logp, _INF).reshape(B, -1)
    sp, sidx = torch.sort(keys, dim=1, stable=True)
    qs = _logq_from_sorted(sp, n_tested[:, None])
    sig_count = (qs < log_pt).sum(dim=1, dtype=torch.int32)
    K = min(K, N1 * N2)
    cand_logq = qs[:, :K]
    flat_idx = sidx[:, :K]
    cand_valid = cand_logq < log_pt
    cx = flat_idx // N2
    cy = flat_idx % N2

    sig_flat = torch.where(nz, best_sig, -1).reshape(B, -1)
    cand_sig = sig_flat.gather(1, flat_idx)

    ii = torch.cumsum(torch.cumsum(nz.to(torch.int32), 1, dtype=torch.int32),
                      2, dtype=torch.int32)
    ii = F.pad(ii, (1, 0, 1, 0)).reshape(B, -1)
    ceil_table = torch.as_tensor(det_ceil, dtype=torch.int64, device=dev)

    def occupancy(s):
        cnt = _rect_box_counts(ii, cx, cy, s, N1, N2).to(dt)
        # clamped window area (edge anchors have smaller windows)
        w1 = (cx + s + 1).clamp(0, N1) - (cx - s).clamp(0, N1)
        w2 = (cy + s + 1).clamp(0, N2) - (cy - s).clamp(0, N2)
        return cnt / (w1 * w2).clamp(min=1).to(dt)

    s1 = torch.where(cand_sig >= 0, ceil_table[cand_sig.clamp(min=0).long()],
                     1)
    c1 = occupancy(s1)
    c2 = occupancy(2 * s1)
    # no cx != 0 exclusion: the rectangle has no diagonal corner
    pass_sparse = ~((c1 < st) | (c2 < 0.6))
    cand_pass = cand_valid & pass_sparse

    offs = torch.arange(-1, 2, device=dev)
    nx = (cx[:, :, None, None] + offs[:, None]).expand(B, K, 3, 3)
    ny = (cy[:, :, None, None] + offs[None, :]).expand(B, K, 3, 3)
    inside = (nx >= 0) & (nx < N1) & (ny >= 0) & (ny < N2)
    nflat = (nx.clamp(0, N1 - 1) * N2 + ny.clamp(0, N2 - 1)).reshape(B, -1)

    def at(a):
        return a.reshape(B, -1).gather(1, nflat).reshape(B, K, 3, 3)
    nb_q = _bh_lookup(sp, qs, at(keys))
    zero = torch.zeros((), dtype=dt, device=dev)
    neigh_logq = torch.where(
        inside & at(found), nb_q,
        torch.where(inside & at(nz), zero + math.log(2.0),
                    torch.where(inside, zero, zero + _INF)))
    neigh_sig = torch.where(inside, at(sig_flat), -1)

    i32 = torch.int32
    return {
        "nz_count": nz_count,
        "n_tested": n_tested,
        "sig_count": sig_count,
        "cand_x": cx.to(i32),
        "cand_y": cy.to(i32),
        "cand_logq": cand_logq,
        "cand_sigidx": cand_sig.to(torch.int16),
        "cand_pass": cand_pass,
        "neigh_logq": neigh_logq,
        "neigh_sigidx": neigh_sig.to(torch.int16),
    }


def out_shapes(K: int, dtype=np.float32) -> dict:
    """Per-tile output layout of :func:`inter_candidates`: name -> (shape,
    numpy dtype)."""
    i32, f, b, i16 = np.int32, dtype, np.bool_, np.int16
    return {
        "nz_count": ((), i32), "n_tested": ((), i32), "sig_count": ((), i32),
        "cand_x": ((K,), i32), "cand_y": ((K,), i32),
        "cand_logq": ((K,), f), "cand_sigidx": ((K,), i16),
        "cand_pass": ((K,), b),
        "neigh_logq": ((K, 3, 3), f), "neigh_sigidx": ((K, 3, 3), i16),
    }


@dataclasses.dataclass(frozen=True)
class InterBlockDetector:
    """Detector for [n, n] rectangle tiles on one device."""

    cfg: DetectionConfig
    spec: LadderSpec
    n: int
    K: int
    taps: torch.Tensor       # [S, 2R+1] ladder taps, in the compute dtype
    out_spec: dict           # _out_spec layout for unpack_block

    def fn(self, tiles: torch.Tensor) -> dict:
        """Batched candidate tables of tiles ``[B, n, n]``."""
        st, log_pt = thresholds(self.cfg)
        state = inter_state(tiles, self.taps, self.spec)
        with torch.profiler.record_function("inter.bh"):
            return inter_candidates(state, det_ceil=self.spec.det_ceil,
                                    K=self.K, st=st, log_pt=log_pt)

    def fn_packed(self, tiles: torch.Tensor) -> np.ndarray:
        """:meth:`fn` packed into one ``[B, F + I]`` buffer, on the host
        after one D2H; rebuild a tile with ``unpack_block(out_spec,
        row)``."""
        out = self.fn(tiles)
        with torch.profiler.record_function("inter.bh"):
            packed = _pack_batched(out)
        return packed.cpu().numpy()


@functools.lru_cache(maxsize=16)
def _build_inter_detector_cached(octave_values: tuple, precision: str,
                                 n: int, K: int, device: torch.device):
    spec = build_ladder(octave_values)
    dtype = np.float64 if precision == "float64" else np.float32
    K = min(K, n * n)
    return spec, K, ladder_tensor(spec.kernels, device, dtype), \
        _out_spec(out_shapes(K, dtype))


def build_inter_detector(cfg: DetectionConfig, n: int, *, device,
                         max_candidates: int | None = None):
    """Detector for [n, n] tiles on ``device`` (a torch.device), keyed by
    (octave values, precision, n, K, device)."""
    spec, K, taps, out_spec = _build_inter_detector_cached(
        cfg.octave_values, cfg.precision, n,
        max_candidates or cfg.max_candidates, device)
    return InterBlockDetector(cfg=cfg, spec=spec, n=n, K=K, taps=taps,
                              out_spec=out_spec)


def finish_inter_block(out: dict, *, start1: int, start2: int,
                       cfg: DetectionConfig, spec: LadderSpec):
    """Host-side finish of one rectangle tile: gates, clustering, and the
    per-component argmin-q emission (``mustache_tpu/inter.py:267-303``,
    the semantics of ``detect.finish_block``)."""
    if int(out["nz_count"]) < cfg.min_nz:
        return []
    if int(out["nz_count"]) < cfg.min_tested:
        return []
    passing = np.asarray(out["cand_pass"])
    if not passing.any():
        return []
    return [r for r, _ in emit_components(
        *(np.asarray(out[k])[passing] for k in
          ("cand_x", "cand_y", "neigh_logq", "neigh_sigidx")),
        start1=start1, start2=start2, det_sigmas=spec.det_sigmas)]


class _TileSource:
    """The rectangle's COO on the device, x-sorted with duplicate pixels
    resolved to their last value in input order (the JAX host densify's
    last-write-wins), from which :meth:`tiles` builds dense tiles. One
    H2D of the triplets: x and y as int32 (int64 beyond 2^31 bins), v in
    the run's dtype."""

    def __init__(self, x, y, v, n1: int, n2: int, dtype, device):
        idx = np.int32 if max(n1, n2) < 2 ** 31 else np.int64
        up = [torch.from_numpy(np.ascontiguousarray(a, t)).to(device)
              for a, t in ((x, idx), (y, idx), (v, dtype))]
        self.h2d_bytes = sum(a.numel() * a.element_size() for a in up)
        xd, yd, vd = up
        # key row width: contacts beyond a given n2 must keep their own
        # key (no tile selects them, as in the JAX densify)
        w = max(n2, int(yd.max()) + 1)
        key = xd.long() * w + yd.long()
        key, order = torch.sort(key, stable=True)
        last = torch.ones_like(key, dtype=torch.bool)
        last[:-1] = key[1:] != key[:-1]
        key, order = key[last], order[last]
        self.x = key // w
        self.y = key % w
        self.v = vd[order]
        self.row_start = torch.searchsorted(
            self.x, torch.arange(n1 + 1, device=device)).cpu().numpy()
        self.dtype = vd.dtype

    def tiles(self, boxes, chunk: int) -> torch.Tensor:
        """Dense ``[len(boxes), chunk, chunk]`` tiles of the boxes ``(r0,
        r1, c0, c1)``, zero-padded at the bottom and right."""
        out = torch.zeros((len(boxes), chunk, chunk), dtype=self.dtype,
                          device=self.x.device)
        for b, (r0, r1, c0, c1) in enumerate(boxes):
            p0, p1 = int(self.row_start[r0]), int(self.row_start[r1])
            ys = self.y[p0:p1]
            sel = (ys >= c0) & (ys < c1)
            out[b].index_put_((self.x[p0:p1][sel] - r0, ys[sel] - c0),
                              self.v[p0:p1][sel])
        return out


def detect_inter_loops_coo(x, y, v, cfg: DetectionConfig, *,
                           normalize: bool = True, n1: int | None = None,
                           n2: int | None = None, chunk: int | None = None,
                           device=None, log=None):
    """Loop calls for one inter-chromosomal COO rectangle (x on the first
    chromosome's bins, y on the second's) on ``device``: the card by
    default, the CPU only when asked (``device="cpu"``); without CUDA it
    raises. Returns Loop-row lists ``[x_bin, y_bin, q, sigma]`` in the
    JAX package's order.

    Like the JAX function, ``v`` is normalized IN PLACE when it is already
    float64 (pass a copy to keep the raw counts). ``log``: optional
    callable taking one message string."""
    dev = resolve_device(device)
    if len(v) == 0:
        return []
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    v = np.asarray(v, np.float64)
    if n1 is None:
        n1 = int(x.max()) + 1
    if n2 is None:
        n2 = int(y.max()) + 1
    if normalize:
        normalize_inter(v)

    if chunk is None:
        chunk = cfg.chunk_size
    s1, e1 = chunk_grid(n1, chunk, OVERLAP)
    s2, e2 = chunk_grid(n2, chunk, OVERLAP)
    tiles = [(i, j) for i in range(len(s1)) for j in range(len(s2))]

    det = build_inter_detector(cfg, chunk, device=dev)
    dtype = np.float64 if cfg.precision == "float64" else np.float32
    B = _batch_size(cfg, len(tiles), dev, per_block=TILE_PLANES * chunk
                    * chunk * np.dtype(dtype).itemsize)
    with torch.profiler.record_function("inter.densify"):
        src = _TileSource(x, y, v, n1, n2, dtype, dev)
    if log is not None:
        log(f"inter n1={n1} n2={n2} tiles={len(tiles)} of {chunk}^2 "
            f"batch={B} device={dev} precision={cfg.precision} "
            f"h2d_bytes={src.h2d_bytes}")

    def boxes(idxs):
        return [(s1[i], e1[i], s2[j], e2[j]) for i, j in idxs]

    def owned(idx, starts, ends, n):
        """Half-open ownership interval of tile ``idx`` along one axis:
        overlap midpoints partition the axis exactly, and every owned
        pixel is >= OVERLAP/2 bins from its tile's window edges."""
        lo = 0 if idx == 0 else ends[idx - 1] - OVERLAP // 2
        hi = n if idx == len(starts) - 1 else ends[idx] - OVERLAP // 2
        return lo, hi

    def rerun_tile(tile, cap):
        """Re-detect one tile ``[1, chunk, chunk]`` with a larger
        candidate capacity."""
        grown = build_inter_detector(cfg, chunk, device=dev,
                                     max_candidates=cap)
        return unpack_block(grown.out_spec, grown.fn_packed(tile)[0])

    loops: list[list[float]] = []
    for b0 in range(0, len(tiles), B):
        idxs = tiles[b0:b0 + B]
        with torch.profiler.record_function("inter.densify"):
            blocks = src.tiles(boxes(idxs), chunk)
        packed = det.fn_packed(blocks)
        with torch.profiler.record_function("inter.finish"):
            for bi, (i, j) in enumerate(idxs):
                tile_out = _maybe_regrow(
                    unpack_block(det.out_spec, packed[bi]), cfg,
                    lambda cap, bi=bi: rerun_tile(blocks[bi:bi + 1], cap),
                    lambda o: int(o["sig_count"]))
                rows = finish_inter_block(tile_out, start1=s1[i],
                                          start2=s2[j], cfg=cfg,
                                          spec=det.spec)
                lo1, hi1 = owned(i, s1, e1, n1)
                lo2, hi2 = owned(j, s2, e2, n2)
                for r in rows:
                    # 2-D interior ownership: one tile reports a pixel
                    if lo1 <= r[0] < hi1 and lo2 <= r[1] < hi2:
                        loops.append(r)
        del blocks
    return _dedup_boundary_loops(loops)


def _dedup_boundary_loops(loops: list[list[float]]) -> list[list[float]]:
    """Post-merge coordinate dedup for tile-ownership boundary ambiguity
    (``mustache_tpu/inter.py:399-428``): merge emitted loops within
    Chebyshev distance 3 (the clustering radius), keeping the min-q
    representative; emission order of the survivors is preserved."""
    keep = [True] * len(loops)
    index: dict[tuple[int, int], int] = {}
    for i, r in enumerate(loops):
        index.setdefault((int(r[0]), int(r[1])), i)
    for i, r in enumerate(loops):
        if not keep[i]:
            continue
        x0, y0 = int(r[0]), int(r[1])
        for dx in range(-3, 4):
            for dy in range(-3, 4):
                j = index.get((x0 + dx, y0 + dy))
                if j is None or j == i or not keep[j]:
                    continue
                # drop the worse-q duplicate (ties: keep the earlier one)
                if loops[j][2] < r[2]:
                    keep[i] = False
                else:
                    keep[j] = False
            if not keep[i]:
                break
    return [r for i, r in enumerate(loops) if keep[i]]
