"""Single-block scale-space loop detection: the port's device epilogue and
host finish.

Torch port of the band-state path of ``mustache_tpu/detect.py``: the
fused kernel (``kernels/fused_ladder.py``) gives each block's best DoG
response and plane per band cell plus the per-plane exponential-fit
partials; this module recovers log p, runs Benjamini-Hochberg FDR,
candidate selection, the sparsity and enrichment filters and the 3x3
neighbour export on the device, packs each batch into one buffer for one
D2H, and finishes each block on the host (clustering and emission, copied
from ``mustache_tpu/detect.py:981-1060``).

BH runs in the JAX package's exact "sort" mode only. Its default "count"
mode exists to avoid a full sort on the TPU and misses overflow on tied
p-values (ROADMAP Queue 3 item 1); the port's parity tests hold the JAX
side in "sort" mode.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.kernels import fused_ladder
from mustache_tpu_torch.scalespace import LadderSpec, build_ladder, ladder_tensor

SENTINEL = 2.0        # fills the masked wedges; participates in the blurs
LOG2 = math.log(2.0)  # log-space image of the "untested" marker q=2
_INF = float("inf")


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


def _preamble(c: torch.Tensor, d_px: int):
    """Support mask + sentinel fill of [..., N, N] blocks
    (mustache.py:699-706, intra-chromosomal)."""
    N = c.shape[-1]
    r = torch.arange(N, device=c.device)
    diag = r[None, :] - r[:, None]                       # y - x
    nz = (c != 0) & (diag >= 4)
    c = torch.where(diag <= 4, SENTINEL, c)
    c = torch.where(diag >= d_px + 1, SENTINEL, c)
    return c, nz


class _BandGeom:
    """Band-space geometry of one [N, N] block: band[i, d] <-> dense[i,
    i+d], width Dl = band_width(N, d_px)."""

    def __init__(self, N: int, d_px: int, device):
        self.N = N
        self.Dl = Dl = band_width(N, d_px)
        self.band_dl = torch.arange(Dl, device=device)[None, :].expand(N, Dl)
        self.band_il = torch.arange(N, device=device)[:, None].expand(N, Dl)
        self.band_yl = self.band_il + self.band_dl
        self.band_validl = self.band_yl < N


def _suffix_cummin(a: torch.Tensor) -> torch.Tensor:
    """Reverse cummin over a flat vector (exact: min is associative)."""
    return torch.flip(torch.cummin(torch.flip(a, (0,)), 0).values, (0,))


def _logq_from_sorted(sp: torch.Tensor, n_tested: torch.Tensor):
    """BH log q for ascending-sorted log p (statsmodels fdr_bh:
    q_(i) = cummin_{j>=i} p_(j) * n / j, clipped at 1 = log 0)."""
    ranks = torch.arange(1, sp.shape[0] + 1, device=sp.device).to(sp.dtype)
    q = sp + torch.log(n_tested.to(sp.dtype)) - torch.log(ranks)
    return torch.clamp(_suffix_cummin(q), max=0.0)


def _bh_lookup(sp, qs, vals):
    """q-value lookup by log-p value: BH gives equal q to equal p (the
    suffix cummin flattens rank ties), so a value search is exact."""
    pos = torch.searchsorted(sp, vals).clamp(0, sp.shape[0] - 1)
    return qs[pos]


def _box_counts_band(cs_flat, x, y, s, smax: int, N: int, Dl: int):
    """Window sums of the support over [x-s, x+s+1) x [y-s, y+s+1) with
    numpy slice semantics (negative start => empty, overruns clamp;
    mustache.py:800-810), from the band's per-column inclusive prefix
    ``cs[i, d] = #{i' <= i : nz[i', i'+d]}``: the dense box decomposes by
    diagonal into at most 4*smax+1 column ranges."""
    rel = torch.arange(-2 * smax, 2 * smax + 1, device=x.device)[None, :]
    x_, y_, s_ = x[:, None], y[:, None], s[:, None]
    d = (y_ - x_) + rel                                   # [K, L]
    lo = torch.maximum(x_ - s_, y_ - s_ - d)
    hi1 = torch.minimum(x_ + s_, y_ + s_ - d) + 1         # exclusive
    lo_c = lo.clamp(0, N)
    hi_c = hi1.clamp(0, N)
    dc = d.clamp(0, Dl - 1)
    valid = (d >= 0) & (d < Dl) & (hi_c > lo_c) & (rel.abs() <= 2 * s_)
    hi_t = cs_flat[(hi_c - 1).clamp(min=0) * Dl + dc]
    lo_t = cs_flat[(lo_c - 1).clamp(min=0) * Dl + dc]
    cnt = torch.where(hi_c > 0, hi_t, 0) - torch.where(lo_c > 0, lo_t, 0)
    total = torch.where(valid, cnt, 0).sum(1)
    empty = ((x - s) < 0) | ((y - s) < 0)
    return torch.where(empty, 0, total)


def _band_candidates(geom: _BandGeom, *, band_logp, band_sigidx, band_nz,
                     band_c, ceil_table, ceil_max: int, st: float,
                     log_pt: float, K: int):
    """Fixed-capacity candidate table from band-space detection state: BH
    FDR (exact sort mode), selection, sparsity/enrichment filters and the
    exported 3x3 neighbourhoods for host clustering
    (mustache.py:774-841)."""
    N, Dl = geom.N, geom.Dl
    found = band_nz & (band_logp < _INF)
    n_tested = found.sum(dtype=torch.int32)
    kf = torch.where(found, band_logp, _INF).reshape(-1)  # +inf = untested
    # one stable sort serves BH and selection: the K smallest-p pixels
    # (row-major on ties, like the reference argsort) with their q; BH q is
    # non-decreasing along this order, so they hold every q < pt pixel
    # whenever sig_count <= K (the regrow contract)
    sp, sidx = torch.sort(kf, stable=True)
    qs = _logq_from_sorted(sp, n_tested)
    sig_count = (qs < log_pt).sum(dtype=torch.int32)
    cand_logq = qs[:K]
    flat_idx = sidx[:K]
    cand_valid = cand_logq < log_pt
    cx = flat_idx // Dl
    cd = flat_idx % Dl
    cy = cx + cd

    band_sigidx = torch.where(band_nz, band_sigidx, -1)
    cand_sigidx = band_sigidx.reshape(-1)[flat_idx]

    # sparsity filter via per-column prefix sums of the band support
    cs_flat = torch.cumsum(band_nz.to(torch.int32), 0).reshape(-1)
    s1 = torch.where(cand_sigidx >= 0,
                     ceil_table[cand_sigidx.clamp(min=0).long()], 1).long()
    c1 = (_box_counts_band(cs_flat, cx, cy, s1, ceil_max, N, Dl)
          .to(torch.float32) / ((2 * s1 + 1) ** 2).to(torch.float32))
    s2 = 2 * s1
    c2 = (_box_counts_band(cs_flat, cx, cy, s2, 2 * ceil_max, N, Dl)
          .to(torch.float32) / ((2 * s2 + 1) ** 2).to(torch.float32))
    pass_sparse = (cx != 0) & ~((c1 < st) | (c2 < 0.6))

    # enrichment: candidate > 2 * nonzero-mean of its diagonal on the
    # sentinel-filled map (mustache.py:816-828); band column d IS diagonal d
    occupied = geom.band_validl & (band_c != 0)
    dmeans = (torch.where(occupied, band_c, 0.0).sum(0)
              / occupied.sum(0).to(torch.float32))      # NaN when empty
    cand_mean = dmeans[cd.clamp(0, Dl - 1)]
    cand_c = band_c.reshape(-1)[flat_idx]
    pass_enrich = cand_c > 2 * cand_mean                # NaN mean => False
    cand_pass = cand_valid & pass_sparse & pass_enrich

    # 8-neighbourhood q/scale export: dense (x+dx, y+dy) sits at band
    # (x+dx, d+dy-dx). Tested neighbours get their BH q, untested support
    # cells the q=2 marker, in-matrix cells beyond the band q=1 (log 0),
    # cells outside the matrix +inf (cannot win the component argmin)
    Kc = flat_idx.shape[0]
    offs = torch.arange(-1, 2, device=cx.device)
    nx = (cx[:, None, None] + offs[None, :, None]).expand(Kc, 3, 3)
    ny = (cy[:, None, None] + offs[None, None, :]).expand(Kc, 3, 3)
    nd = ny - nx
    inside = (nx >= 0) & (nx < N) & (ny >= 0) & (ny < N)
    in_band = inside & (nd >= 0) & (nd < Dl)
    nxc = nx.clamp(0, N - 1)
    ndc = nd.clamp(0, Dl - 1)
    nb_found = found[nxc, ndc]
    nb_val = torch.where(nb_found, band_logp[nxc, ndc], _INF)
    nb_q = _bh_lookup(sp, qs, nb_val)
    neigh_logq = torch.where(
        in_band & nb_found, nb_q,
        torch.where(in_band & band_nz[nxc, ndc], LOG2,
                    torch.where(inside, 0.0, _INF)))
    neigh_sigidx = torch.where(in_band, band_sigidx[nxc, ndc], -1)

    i32 = torch.int32
    return {
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


def _detect_one(band_state, band_slice: torch.Tensor, *, det_ceil,
                d_px: int, K: int, st: float, log_pt: float):
    """One block's candidate table from the kernel's band state
    ``(band_v, band_sig, locs, sums)`` and its normalized band slice
    ``[N, >= Dl]`` (the band-state + band-slice branch of the JAX
    ``_detect_one``). The support mask and sentinel map come from the
    slice, so the dense block is never read here."""
    N = band_slice.shape[0]
    dev = band_slice.device
    geom = _BandGeom(N, d_px, dev)
    Dl = geom.Dl
    bs = torch.where(geom.band_validl, band_slice[:, :Dl], 0.0)
    nzb = geom.band_validl & (bs != 0) & (geom.band_dl >= 4)
    nz_count = nzb.sum(dtype=torch.int32)
    # sentinel map in band space == shear of _preamble's dense fill
    band_c = torch.where(geom.band_dl <= 4, SENTINEL, bs)
    band_c = torch.where(geom.band_dl >= d_px + 1, SENTINEL, band_c)
    band_c = torch.where(geom.band_validl, band_c, 0.0)

    # log p from the best response and the per-plane exponential fit:
    # detections have L > 0, so |L| == best_v and logp = -(v - loc)/scale
    band_v, band_sig, locs, sums = band_state
    inv_count = 1.0 / nz_count.clamp(min=1).to(torch.float32)
    scales = sums * inv_count - locs
    sig_c = band_sig.clamp(min=0).long()
    logp = -(band_v - locs[sig_c]) / scales[sig_c]
    best_logp = torch.where(nzb & (band_sig >= 0), logp, _INF)
    best_sigidx = torch.where(nzb, band_sig, -1)

    ceil_table = torch.as_tensor(det_ceil, dtype=torch.int64, device=dev)
    out = _band_candidates(
        geom, band_logp=best_logp, band_sigidx=best_sigidx, band_nz=nzb,
        band_c=band_c, ceil_table=ceil_table, ceil_max=int(max(det_ceil)),
        st=st, log_pt=log_pt, K=K)
    out["nz_count"] = nz_count
    return out


def out_shapes(K: int) -> dict:
    """Per-block output layout of :func:`_detect_one`: name -> (shape,
    numpy dtype)."""
    i32, f32, b, i16 = np.int32, np.float32, np.bool_, np.int16
    return {
        "n_tested": ((), i32), "sig_count": ((), i32), "nz_count": ((), i32),
        "cand_x": ((K,), i32), "cand_y": ((K,), i32),
        "cand_logq": ((K,), f32), "cand_sigidx": ((K,), i16),
        "cand_pass": ((K,), b), "cand_valid": ((K,), b),
        "pass_sparse": ((K,), b), "pass_enrich": ((K,), b),
        "neigh_logq": ((K, 3, 3), f32), "neigh_sigidx": ((K, 3, 3), i16),
    }


def _out_spec(shapes: dict) -> dict:
    """Host-side layout for :func:`_pack_batched`: ``key -> (shape, dtype,
    buffer, offset, size)``. Float leaves come first in the packed row,
    int/bool leaves (as int32 bits) after them; keys walk in sorted order
    within each part."""
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


def _pack_batched(out: dict) -> torch.Tensor:
    """Pack a batched output dict into ONE [B, F + I] float32 buffer:
    float leaves, then int/bool leaves cast to int32 and bit-viewed as
    float32, so a batch crosses to the host in one D2H. Layout matches
    :func:`_out_spec`."""
    fparts, iparts = [], []
    for k in sorted(out):
        a = out[k]
        flat = a.reshape(a.shape[0], -1)
        if a.dtype.is_floating_point:
            fparts.append(flat.to(torch.float32))
        else:
            iparts.append(flat.to(torch.int32).view(torch.float32))
    return torch.cat(fparts + iparts, dim=1)


def unpack_block(spec: dict, row: np.ndarray) -> dict:
    """Rebuild one block's output dict from its packed float32 row."""
    irow = row.view(np.int32)
    out = {}
    for k, (shape, dtype, buf, off, size) in spec.items():
        src = row if buf == "f" else irow
        a = src[off:off + size].reshape(shape)
        out[k] = a if a.dtype == dtype else a.astype(dtype)
    return out


def kernel_gate(cfg: DetectionConfig, device: torch.device) -> None:
    """The port's gate (the JAX ``_resolve_pallas``): f32, and on CUDA a
    ladder radius that fits the kernel's shared memory. Raises when the
    configuration cannot run; there is no other device path to fall back
    to."""
    if cfg.precision != "float32":
        raise NotImplementedError(
            f"precision={cfg.precision!r}: the port runs float32 only "
            "(float64 is ROADMAP Queue 1, normalize.py + f64 modes)")
    if device.type == "cuda":
        if cfg.use_pallas == "off":
            raise NotImplementedError(
                "use_pallas='off' on CUDA: the port's device path is the "
                "fused kernel")
        spec = build_ladder(cfg.octave_values)
        if not fused_ladder.kernel_fits(spec.radius, cfg.octaves):
            raise ValueError(
                f"ladder radius {spec.radius} ({cfg.octaves} octaves) needs "
                f"{fused_ladder.smem_bytes(spec.radius, cfg.octaves)} B of "
                f"shared memory; the kernel's limit is "
                f"{fused_ladder.SMEM_LIMIT}")


@dataclasses.dataclass(frozen=True)
class BlockDetector:
    """Detector for [n, n] blocks sliced from a device-resident band."""

    cfg: DetectionConfig
    spec: LadderSpec
    n: int
    K: int
    taps: torch.Tensor       # [S, 2R+1] f32 ladder taps on the device
    out_spec: dict           # _out_spec layout for unpack_block

    def fn_band(self, band: torch.Tensor, starts) -> dict:
        """Batch detection from the normalized chromosome band
        (band[i, d] = map[i, i+d], rows >= max(starts)+n): each start is
        sliced and densified on the device. A start of -1 is a pad slot:
        the kernel skips it and its outputs are empty."""
        cfg, spec, n = self.cfg, self.spec, self.n
        d_px = cfg.distance_px
        slices = torch.stack([band[max(s, 0): max(s, 0) + n] for s in starts])
        valid = torch.as_tensor([int(s >= 0) for s in starts],
                                dtype=torch.int32, device=band.device)
        cs, nz = _preamble(dense_from_band(slices), d_px)
        state = fused_ladder.fused_ladder_nms_batched(
            cs, nz.to(torch.float32), self.taps, R=spec.radius,
            n_octaves=len(spec.octave_values),
            planes_per_octave=spec.planes_per_octave,
            DB=band_width(n, d_px), valid=valid)
        del cs, nz
        st = float(np.float32(cfg.st))
        log_pt = float(np.float32(math.log(cfg.pt)))
        outs = [_detect_one(tuple(a[b] for a in state), slices[b],
                            det_ceil=spec.det_ceil, d_px=d_px, K=self.K,
                            st=st, log_pt=log_pt)
                for b in range(len(starts))]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def fn_band_packed(self, band: torch.Tensor, starts) -> torch.Tensor:
        """``fn_band`` packed into one [B, F + I] buffer (one D2H); the
        host rebuilds each block with ``unpack_block(out_spec, row)``."""
        return _pack_batched(self.fn_band(band, starts))


def build_detector(cfg: DetectionConfig, n: int, *, device,
                   max_candidates: int | None = None) -> BlockDetector:
    """Detector for [n, n] blocks on ``device`` (a torch.device). Raises
    for configurations the port cannot run (see :func:`kernel_gate`)."""
    kernel_gate(cfg, device)
    spec = build_ladder(cfg.octave_values)
    # a block holds n * Dl band cells: the candidate table cannot be longer
    K = min(max_candidates or cfg.max_candidates,
            n * band_width(n, cfg.distance_px))
    return BlockDetector(cfg=cfg, spec=spec, n=n, K=K,
                         taps=ladder_tensor(spec.kernels, device),
                         out_spec=_out_spec(out_shapes(K)))


# ---------------------------------------------------------------------------
# host-side finish: gates + connected-component clustering
# (copied from mustache_tpu/detect.py:981-1060)
# ---------------------------------------------------------------------------

def _cluster_components(cands: list[dict]) -> list[list[dict]]:
    """Group candidates whose painted 3x3 neighborhoods are 8-connected,
    i.e. candidates within Chebyshev distance 3 (mustache.py:830-841)."""
    parent = list(range(len(cands)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    index: dict[tuple[int, int], int] = {}
    for i, cd in enumerate(cands):
        index[(cd["x"], cd["y"])] = i
    for i, cd in enumerate(cands):
        for dx in range(-3, 4):
            for dy in range(-3, 4):
                j = index.get((cd["x"] + dx, cd["y"] + dy))
                if j is not None and j != i:
                    union(i, j)

    groups: dict[int, list[dict]] = {}
    for i, cd in enumerate(cands):
        groups.setdefault(find(i), []).append(cd)
    return list(groups.values())


def finish_block(out: dict, *, block_index: int, start: int, cfg: DetectionConfig,
                 spec: LadderSpec) -> list[list[float]]:
    """Host-side finish of one block: bail-out gates, clustering, and the
    per-component argmin-q emission. Returns ``[x, y, q, sigma]`` rows in
    the same order the reference produces (component label order ==
    row-major order of each component's first painted pixel).
    """
    nz_count = int(out["nz_count"])
    if nz_count < cfg.min_nz:
        return []
    if nz_count < cfg.min_tested:
        return []

    passing = np.asarray(out["cand_pass"])
    if not passing.any():
        return []
    cx = np.asarray(out["cand_x"])[passing]
    cy = np.asarray(out["cand_y"])[passing]
    nlq = np.asarray(out["neigh_logq"])[passing]
    nsi = np.asarray(out["neigh_sigidx"])[passing]

    cands = [
        {"x": int(cx[i]), "y": int(cy[i]), "nlq": nlq[i], "nsi": nsi[i]}
        for i in range(len(cx))
    ]

    det_sigmas = spec.det_sigmas
    rows: list[tuple[tuple[int, int], list[float]]] = []
    for comp in _cluster_components(cands):
        # painted pixel set with the q/scale value at each pixel
        pixels: dict[tuple[int, int], tuple[float, int]] = {}
        for cd in comp:
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    px, py = cd["x"] + dx, cd["y"] + dy
                    lq = float(cd["nlq"][dx + 1, dy + 1])
                    si = int(cd["nsi"][dx + 1, dy + 1])
                    pixels[(px, py)] = (lq, si)
        ordered = sorted(pixels.items())  # row-major, np.argwhere order
        best = min(range(len(ordered)), key=lambda i: (ordered[i][1][0], i))
        (px, py), (lq, si) = ordered[best]
        q = float(np.exp(np.float64(lq)))
        sigma = det_sigmas[si] if si >= 0 else 1.0
        first_pixel = ordered[0][0]
        rows.append((first_pixel, [px + start, py + start, q, sigma]))

    rows.sort(key=lambda t: t[0])
    return [r for _, r in rows]
