"""Differential loop detection (two conditions) on the card.

Torch port of ``mustache_tpu/diff.py`` without its sharded runners
(``diff_mustache`` semantics, diff_mustache.py:260-569). Both conditions'
normalized bands live on the device; each batch of blocks is sliced and
densified from both, and the two conditions' blocks go through the
single-map detector's route (``detect.resolve_route``) as ONE stacked
``[2B]`` batch: condition 1's blocks in slots ``0..B-1``, condition 2's
in ``B..2B-1`` (``mustache_tpu/diff.py:337-357``). On the kernel route
that is one launch of the fused ladder/DoG/NMS kernel; on the ladder
route (float64, ``use_pallas="off"``, oversized ladders) the JAX XLA
path's per-map ladders in torch ops, in the block's dtype. A pad slot
(start -1) is skipped in both halves, so pad slots may sit mid-batch; the
state is split by slot, never by validity.

The difference map ``cs1 - cs2`` on the joint support needs only blur
planes 1 and 2 of each octave: the reference fits its folded-normal
differential p ONCE per octave and never rolls that plane
(diff_mustache.py:337). Those 4 blurs per block run on the band only, as
banded matmuls in the block's dtype (``ladder.band_blur``), then the
per-octave two-sided p is taken over the joint support
(``mustache_tpu/diff.py:384-412``). Per map, log p comes from the route's
state with NaN scrubbed to p = 1, each detection is paired with the
differential p of its octave, and the candidate tables export ``pair``,
``v1`` and ``v2`` over every 3x3 neighbourhood
(``mustache_tpu/diff.py:173-263``). Normalize follows the single-map rule
(``pipeline.py``): on the device for the float32 default, on the host for
float64 and ``exact_normalize``, skipped for ``normalize=False``. The
host finish (``mustache_tpu/diff.py:485-566``) emits through
``detect.emit_components``; the regrow and the block loop
(``mustache_tpu/diff.py:607-624, 653-855``) are the single-map path's
(``pipeline.detect_blocks``).

A ``sharding.MeshRunner`` splits each batch over its mesh's entries, as
for the single-map path; pad slots are not launched, so the last batch
of a chromosome is not padded to the batch size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mustache_tpu_torch.config import DetectionConfig, clamp_distance_filter
from mustache_tpu_torch.detect import (
    SENTINEL, BlockDetector, _BandGeom, _band_candidates, _out_spec,
    _pack_batched, _preamble, _slice_support, band_of, build_detector,
    dense_from_band, emit_components, host_ints,
    out_shapes as single_out_shapes, thresholds,
)
from mustache_tpu_torch.kernels.fused_ladder import _symmetric_pad
from mustache_tpu_torch.ladder import band_blur
from mustache_tpu_torch.pipeline import detect_blocks
from mustache_tpu_torch.scalespace import LadderSpec

_INF = float("inf")


def diff_planes(spec: LadderSpec) -> list[int]:
    """Ladder rows of the difference map's blurs: planes 1 and 2 of each
    octave (``mustache_tpu/diff.py:84-85``)."""
    bpo = spec.planes_per_octave + 3
    return [o * bpo + k for o in range(len(spec.octave_values))
            for k in (1, 2)]


def diff_p_band(cs1, cs2, nz1, nz2, taps_sel, *, R: int, Dl: int, valid):
    """Frozen per-octave differential p of each block, ``[B, n_oct, N,
    Dl]`` in band layout (``mustache_tpu/diff.py:384-412``).

    ``cs1``/``cs2``: sentinel-filled blocks ``[B, N, N]`` (f32, or f64
    on the float64 route); ``nz1``/``nz2``: their supports (taken before
    the sentinel fill); ``taps_sel``: the difference map's taps ``[2
    n_oct, 2R+1]`` in the blocks' dtype (:func:`diff_planes`); ``valid``:
    per-slot flags, host ints. The difference ``cs1 - cs2`` on the joint
    support is blurred on the band (``ladder.band_blur``), planes ``2o``
    and ``2o+1`` give octave o's DoG plane, and its
    two-sided normal tail is taken with the mean and variance on the
    joint support; a NaN p (zero variance) is 1. Pad slots are left at 0
    (their outputs are never read)."""
    B, N, _ = cs1.shape
    n_oct = taps_sel.shape[0] // 2
    out = torch.zeros((B, n_oct, N, Dl), dtype=cs1.dtype, device=cs1.device)
    real = [b for b in range(B) if valid[b]]
    if not real:
        return out
    idx = host_ints(real, cs1.device)
    nzd = nz1[idx] & nz2[idx]
    cds = torch.where(nzd, cs1[idx] - cs2[idx], 0.0)
    gb = band_blur(_symmetric_pad(cds, R), taps_sel, N, Dl)
    nzdb = band_of(nzd, Dl, False)
    nzdbf = nzdb.to(cs1.dtype)
    inv = 1.0 / nzd.sum(dim=(1, 2), dtype=torch.int32).clamp(min=1).to(
        cs1.dtype)
    for o in range(n_oct):
        L = gb[:, 2 * o] - gb[:, 2 * o + 1]              # [b, N, Dl]
        mu = (L * nzdbf).sum(dim=(1, 2)) * inv
        var = torch.where(nzdb, (L - mu[:, None, None]) ** 2,
                          0.0).sum(dim=(1, 2)) * inv
        phi = torch.special.ndtr((L - mu[:, None, None])
                                 / torch.sqrt(var)[:, None, None])
        phi = torch.where(torch.isnan(phi), 1.0, phi)
        out[idx, o] = torch.where(phi > 0.5, 1.0 - phi, phi) * 2.0
    return out


def _diff_detect_one(best, support, diff_p, *, ceil_table, ceil_max: int,
                     planes_per_octave: int, d_px: int, K: int, st: float,
                     log_pt: float):
    """A batch's two candidate tables per block (the JAX
    ``_diff_detect_one`` from its states on, vmapped over the batch), from
    the stacked ``[2B]`` detection state ``best`` ``(best_v, best_logp,
    best_sigidx)`` (either route, NaN log p already scrubbed to 0; slots
    ``0..B-1`` condition 1, ``B..2B-1`` condition 2), their band
    ``support`` ``(nzb, nz_count, band_c)`` and each block's differential
    p ``[B, n_oct, N, Dl]``. Both conditions' tables come from one
    ``[2B]`` call of ``_band_candidates``; each condition exports its own
    pair p and both maps' best responses. Keys carry a ``1``/``2``
    suffix, plus ``nz1_count`` and ``nz2_count``."""
    B = diff_p.shape[0]
    geom = _BandGeom(diff_p.shape[-2], d_px, diff_p.device)
    best_v, best_logp, best_sig = best
    nzb, nz_count, band_c = support
    # best DoG responses on each map's own support, 1 elsewhere
    # (diff_mustache.py:446-449), exported on both maps' neighbourhoods
    band_v = torch.where(nzb, best_v, 1.0)
    v1, v2 = band_v[:B].repeat(2, 1, 1), band_v[B:].repeat(2, 1, 1)
    # differential p of the detection's octave, 2 where undetected
    octv = (best_sig.clamp(min=0) // planes_per_octave).long()
    pair = torch.gather(diff_p.repeat(2, 1, 1, 1), 1, octv[:, None])[:, 0]
    best_pair = torch.where(best_sig >= 0, pair, SENTINEL)
    table = _band_candidates(
        geom, band_logp=best_logp, band_sigidx=best_sig, band_nz=nzb,
        band_c=band_c, ceil_table=ceil_table, ceil_max=ceil_max, st=st,
        log_pt=log_pt, K=K,
        extras=(("pair", torch.where(nzb, best_pair, 1.0), 1.0, _INF),
                ("v1", v1, 1.0, 1.0), ("v2", v2, 1.0, 1.0)))
    out = {"nz1_count": nz_count[:B], "nz2_count": nz_count[B:]}
    for m, half in (("1", slice(0, B)), ("2", slice(B, 2 * B))):
        out.update({k + m: v[half] for k, v in table.items()})
    return out


def out_shapes(K: int, dtype=np.float32) -> dict:
    """Per-block output layout of :func:`_diff_detect_one`: name ->
    (shape, numpy dtype); the float leaves carry the run's dtype."""
    per_map = {k: v for k, v in single_out_shapes(K, dtype).items()
               if k != "nz_count"}
    per_map.update({f"neigh_{e}": ((K, 3, 3), dtype)
                    for e in ("pair", "v1", "v2")})
    shapes = {"nz1_count": ((), np.int32), "nz2_count": ((), np.int32)}
    for m in "12":
        shapes.update({k + m: v for k, v in per_map.items()})
    return shapes


@dataclasses.dataclass(frozen=True)
class DiffBlockDetector:
    """Differential detector for [n, n] blocks sliced from two
    device-resident bands, on the route of its single-map detector
    ``base``."""

    base: BlockDetector
    out_spec: dict           # _out_spec layout for unpack_block

    cfg = property(lambda self: self.base.cfg)
    spec = property(lambda self: self.base.spec)
    n = property(lambda self: self.base.n)
    K = property(lambda self: self.base.K)
    route = property(lambda self: self.base.route)
    taps = property(lambda self: self.base.taps)
    radii = property(lambda self: self.base.radii)

    def fn_band(self, band1: torch.Tensor, band2: torch.Tensor,
                starts) -> dict:
        """Batch detection from both conditions' normalized bands (same
        shape; rows >= max(starts)+n). A start of -1 is a pad slot: the
        route skips it in both halves and its outputs are empty."""
        cfg, spec, n = self.cfg, self.spec, self.n
        d_px = cfg.distance_px
        B = len(starts)
        valid_h = [int(s >= 0) for s in starts]
        geom = _BandGeom(n, d_px, band1.device)
        # each stage is a named profiler range: chip_smoke.py reads the
        # device time under each from a trace
        rf = torch.profiler.record_function
        with rf("diff.preamble"):
            slices = torch.stack([band[max(s, 0): max(s, 0) + n]
                                  for band in (band1, band2) for s in starts])
            cs, nz = _preamble(dense_from_band(slices), d_px)
        # both conditions' blocks as one batch: slots [0, B) are condition
        # 1, [B, 2B) condition 2 (one kernel launch on the kernel route)
        with rf("diff.fused_ladder" if self.route == "kernel"
                else "diff.ladder"):
            state = self.base.route_state(cs, nz, slices, valid_h * 2,
                                          scrub_nan=True)
        with rf("diff.planes"):
            dp = diff_p_band(cs[:B], cs[B:], nz[:B], nz[B:],
                             self.taps[diff_planes(spec)], R=spec.radius,
                             Dl=geom.Dl, valid=valid_h)
        del cs, nz
        st, log_pt = thresholds(cfg)
        with rf("diff.epilogue"):
            support = _slice_support(geom, slices, d_px)
            best = self.base.best_state(state, support, scrub_nan=True)
            return _diff_detect_one(
                best, support, dp, ceil_table=self.base.ceil_table,
                ceil_max=int(max(spec.det_ceil)),
                planes_per_octave=spec.planes_per_octave, d_px=d_px,
                K=self.K, st=st, log_pt=log_pt)

    def fn_band_packed(self, band1: torch.Tensor, band2: torch.Tensor,
                       starts) -> torch.Tensor:
        """``fn_band`` packed into one [B, F + I] buffer (one D2H); the
        host rebuilds each block with ``unpack_block(out_spec, row)``."""
        return _pack_batched(self.fn_band(band1, band2, starts))


def build_diff_detector(cfg: DetectionConfig, n: int, *, device,
                        max_candidates: int | None = None) -> DiffBlockDetector:
    """Differential detector for [n, n] blocks on ``device``: the
    single-map detector's route, ladder and capacity with the diff
    layout."""
    d = build_detector(cfg, n, device=device, max_candidates=max_candidates)
    dtype = np.float64 if cfg.precision == "float64" else np.float32
    return DiffBlockDetector(base=d,
                             out_spec=_out_spec(out_shapes(d.K, dtype)))


# ---------------------------------------------------------------------------
# host finish (mustache_tpu/diff.py:485-566)
# ---------------------------------------------------------------------------

def _finish_map(out, tag, *, start, spec):
    """Cluster one condition's surviving candidates; returns ``(passing,
    rows)`` with ``rows`` as :func:`detect.emit_components` gives them,
    the pair/v1/v2 values needed for the differential call beside each,
    or None where this map's bail-outs fire."""
    passing = (np.asarray(out[f"cand_valid{tag}"])
               & np.asarray(out[f"pass_sparse{tag}"]))
    if not passing.any():
        return None, None
    with_enrich = passing & np.asarray(out[f"pass_enrich{tag}"])
    if not with_enrich.any():
        return passing, None
    cx, cy, nlq, nsi, *extras = (
        np.asarray(out[k + tag])[with_enrich] for k in
        ("cand_x", "cand_y", "neigh_logq", "neigh_sigidx", "neigh_pair",
         "neigh_v1", "neigh_v2"))
    return passing, emit_components(cx, cy, nlq, nsi, extras, start1=start,
                                    start2=start, det_sigmas=spec.det_sigmas)


def finish_diff_block(out: dict, *, start: int, cfg: DetectionConfig,
                      spec: LadderSpec):
    """Returns (loops1, diff_loops1, loops2, diff_loops2) row lists."""
    empty = ([], [], [], [])
    # the reference's two bail-outs (nz<50 at diff_mustache.py:262-267 and
    # the >=10000-support FDR gate at :428-436) collapse into the stricter
    # one: min_tested >= min_nz always
    if int(out["nz1_count"]) < cfg.min_tested or \
            int(out["nz2_count"]) < cfg.min_tested:
        return empty

    pass1, rows1 = _finish_map(out, "1", start=start, spec=spec)
    pass2, rows2 = _finish_map(out, "2", start=start, spec=spec)
    # joint bail-outs (diff_mustache.py:507-508, :519, :526)
    if pass1 is None or pass2 is None:
        return empty
    if rows1 is None or rows2 is None:
        return empty

    def split(rows, own):
        loops, diff_loops = [], []
        for row, (pair, nv1, nv2) in rows:
            loops.append(row)
            own_v, other_v = (nv1, nv2) if own == 1 else (nv2, nv1)
            if pair < cfg.pt2 and own_v > other_v:
                diff_loops.append(row)
        return loops, diff_loops

    loops1, diff1 = split(rows1, 1)
    loops2, diff2 = split(rows2, 2)
    return loops1, diff1, loops2, diff2


# ---------------------------------------------------------------------------
# per-chromosome orchestration
# ---------------------------------------------------------------------------

def diff_block_bytes(route: str, n: int, Dl: int, itemsize: int) -> int:
    """Device bytes one block of a differential batch holds at its peak,
    the batch rule's unit (``pipeline.block_bytes``' twin)."""
    if route == "kernel":
        # 28 * n^2 + 80 * n * Dl bytes: the stacked preamble (both
        # conditions' widened slices, sentinel copies, supports), then the
        # difference planes, which run on every real block of the batch
        # at once (the dense difference, its padded copies, the
        # vertical-pass slabs and the band blurs).
        # tools/diff_batch_memory.py measured 191.7 MB a block at n=2000,
        # Dl=512 (127.0 MB of it the planes) and 1079.0 MB at n=4000,
        # Dl=2048 (769.5 MB), on an NVIDIA H100 80GB HBM3 at 700 W. The
        # epilogue runs on the whole batch: two tables' state a block,
        # counted at 128 * n * Dl bytes more (the single-map rule's 64 * n
        # * Dl per table).
        return 28 * n * n + 208 * n * Dl
    # the JAX package's XLA cap for the triple ladder: ~135 n^2 live
    # elements of the compute dtype per block (mustache_tpu/diff.py:594-597)
    return 135 * n * n * itemsize


def detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, cfg: DetectionConfig, *,
                          normalize: bool = True,
                          exact_normalize: bool = False, runner=None,
                          device=None, log=None):
    """Differential loop calls for one chromosome, both conditions, on
    ``device``: the card by default; ``device="cpu"`` runs the kernel
    route's plain PyTorch version. ``normalize`` and ``exact_normalize``
    as in ``pipeline.detect_loops_coo``; ``runner``: a
    ``sharding.MeshRunner`` as there (``device`` is then not read), each
    entry holding both conditions' bands (replicate) or a slab pair
    (rowshard), each normalized with its OWN bin count (the window
    clipping at the diagonal tails depends on it,
    ``mustache_tpu/diff.py:754-761``). The inputs are not modified.
    ``log``: optional callable taking one message string.

    Returns a list of ``(bin1, bin2, q, scale, tag)`` in block order with
    tag 1=loop1, 2=diffloop1, 3=loop2, 4=diffloop2
    (diff_mustache.py:704-715).

    The call is one ``diff.call`` profiler range holding the stages'
    ranges as ``pipeline.detect_loops_coo``'s (the same block loop,
    ``pipeline.detect_blocks``), with ``diff.finish`` in place of
    ``pipeline.finish``."""
    def finish(out, i, start, spec):
        groups = finish_diff_block(out, start=start, cfg=cfg, spec=spec)
        return [r + [tag] for tag, group in zip((1, 2, 3, 4), groups)
                for r in group]

    with torch.profiler.record_function("diff.call"):
        return detect_blocks(
            [(x1, y1, v1), (x2, y2, v2)], cfg, build=build_diff_detector,
            bytes_per_block=diff_block_bytes, finish=finish,
            emit=lambda r: (int(r[0]), int(r[1]), float(r[2]), float(r[3]),
                            r[4]),
            finish_range="diff.finish",
            sig_count=lambda o: max(int(o["sig_count1"]),
                                    int(o["sig_count2"])),
            describe=lambda Bl, sent: (
                f"(stacked {2 * Bl} slots per entry) "
                + " ".join(f"cond{m} {d}" for m, d in zip((1, 2), sent))),
            normalize=normalize, exact_normalize=exact_normalize,
            runner=runner, device=device, log=log)


def find_diff_loops(x1, y1, v1, x2, y2, v2, *, resolution: int = 5000,
                    distance_bp: int = 2_000_000, pt: float = 0.2,
                    pt2: float = 0.1, st: float = 0.88, sigma0: float = 1.6,
                    octaves: int = 2, precision: str = "float32",
                    normalize: bool = True, device=None):
    """One-call differential API (twin of :func:`find_loops`): two COO
    contact maps in, ``(bin1, bin2, q, scale, tag)`` rows out, on
    ``device`` (the card unless ``device="cpu"``). The caller's arrays are
    copied and left untouched."""
    cfg = DetectionConfig(
        resolution=resolution,
        distance_bp=clamp_distance_filter(distance_bp, resolution,
                                          diff=True),
        pt=pt, pt2=pt2, st=st, sigma0=sigma0, octaves=octaves,
        precision=precision,
    )
    return detect_diff_loops_coo(
        *(np.array(a) for a in (x1, y1, v1, x2, y2, v2)), cfg,
        normalize=normalize, device=device)
