"""Per-chromosome orchestration: band fill -> one H2D -> normalize ->
batches of blocks (slice, densify, detection route, epilogue, one packed
D2H) -> host finish -> overlap dedup.

Torch port of ``mustache_tpu/pipeline.py::detect_loops_coo``. The block
grid, overlap sizes and ownership masks are the reference's
(mustache.py:896-960), so per-block statistics reproduce the reference's
numbers.

Normalize, by the JAX package's rule: the float32 default fills the RAW
band on the host in the narrowest lossless encoding (uint8, uint16 or
nibble-packed uint4, plus an exception list; the native fill of
``io/native``, streamed in two slabs for large bands) and normalizes it
on the device (``bandnorm.py``). float64 and ``exact_normalize=True``
normalize on the host (``normalize.py``) into a band of the compute
dtype, which goes up once; ``normalize=False`` uploads the raw band in
the compute dtype. The detection route follows from the configuration
(``detect.resolve_route``) and is named in the plan line.

The differential entry (``diff.py``) runs the same block loop
(:func:`detect_blocks`) on its two conditions' bands.

Every run goes through a ``sharding.MeshRunner``: an unsharded run is a
one-entry mesh of its device, a sharded one splits each batch of blocks
over the mesh's entries (``sharding.py``), each holding the band
(replicate) or its slab of it (rowshard).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from mustache_tpu_torch.bandnorm import (
    bucket_rows, normalize_band_device, pad_exceptions,
)
from mustache_tpu_torch.config import DetectionConfig, block_mask_sizes, chunk_grid
from mustache_tpu_torch.detect import (
    _maybe_regrow, band_width, build_detector, finish_block, resolve_route,
    unpack_block,
)
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.io import native
from mustache_tpu_torch.normalize import normalize_sparse
from mustache_tpu_torch.sharding import (
    MeshRunner, RowShardPlan, make_mesh, upload_band,
)


@dataclasses.dataclass(frozen=True)
class Loop:
    """One loop call in bin coordinates."""

    bin1: int
    bin2: int
    q: float
    scale: float

    def to_row(self, chrom, chrom2, res: int) -> str:
        return (
            f"{chrom}\t{self.bin1 * res}\t{(self.bin1 + 1) * res}\t"
            f"{chrom2}\t{self.bin2 * res}\t{(self.bin2 + 1) * res}\t"
            f"{self.q}\t{self.scale}\n"
        )


def fill_raw_band(x, y, v, band_shape) -> np.ndarray:
    """Scatter-fill the RAW chromosome band ``band[x, y-x] = v`` as f32
    with the native fill: the compact fill's band where its census finds
    no narrower encoding (``mustache_tpu/pipeline.py:55-77``)."""
    with torch.profiler.record_function("upload.fill"):
        band = np.zeros(band_shape, np.float32)
        native.fill_band(x, y, v, band)
    return band


# uint4 packing pays the u4 count of the host census and a larger
# exception scatter (the JAX package a pack pass too); the JAX package
# found its link bytes worth that only from 8 M band cells
# (``mustache_tpu/pipeline.py:80-83``). Kept as is: the H100 numbers are
# in PERF.md, the threshold is not retuned for the card.
_U4_MIN_BYTES = 8_000_000
EXC_BYTES = 12      # one exception record: i32 row + i32 col + f32 value

# bytes the float32 band upload (``pipeline.upload``) has handed to the
# card since the process started: each call's ``BandUpload.nbytes``, the
# band's slabs and its exception records
H2D_BYTES = 0


def fill_raw_band_compact(x, y, v, band_shape, counts=None):
    """Raw-band fill in the narrowest LOSSLESS transfer encoding
    (``mustache_tpu/pipeline.py:86-172``).

    Counts are almost all small integers with a thin tail of misfits, so
    the band goes as uint8 or uint16 plus a (row, col, f32 value)
    exception list that the device scatters over the widened band, or,
    from ``_U4_MIN_BYTES`` band cells where it beats u8 by 0.7x, as
    nibble-packed uint8 [rows, Dl // 2] with values 16..255 moved to the
    exception list. Float-heavy data keeps the f32 band. ``counts``: the
    ``native.classify_values`` census when the caller has it.

    Without ``counts``, one pass over a COO sorted by row fills the u8
    band and takes the census (``native.fill_band_u8_census``). Where the
    census then picks another encoding than u8 unpacked, or the COO is
    not sorted by row (then the census, as the JAX package takes it, and
    the full scan), the band is filled again in an ``upload.refill``
    range.

    Returns ``(band, exceptions, packed4)``; ``exceptions`` is None or an
    unpadded (rows, cols, values) triple. Requires unique (x, y) pairs
    (the ingest-path invariant)."""
    rows, Dl = band_shape
    if not len(v):
        return fill_raw_band(x, y, v, band_shape), None, False
    if counts is None:
        with torch.profiler.record_function("upload.fill"):
            band = np.zeros(band_shape, np.uint8)
            got = native.fill_band_u8_census(x, y, v, band)
        if got is not None and _encoding(rows, Dl, *got[1]) == "u8":
            exc = got[0]
            return band, (exc if len(exc[0]) else None), False
        # another encoding, or a COO not sorted by row (the full scan)
        with torch.profiler.record_function("upload.refill"):
            return _fill_by_census(x, y, v, band_shape,
                                   None if got is None else got[1],
                                   scan=got is None)
    return _fill_by_census(x, y, v, band_shape, counts)


def _encoding(rows: int, Dl: int, ne8: int, ne16: int) -> str:
    """The band's encoding by the census: ``f32``, ``u16``, ``u8``, or
    ``u8|u4`` where u8 wins and the band is large enough for the 4-bit
    census to decide between u8 and nibble-packed u4."""
    bytes8 = rows * Dl + ne8 * EXC_BYTES
    bytes16 = 2 * rows * Dl + ne16 * EXC_BYTES
    if min(bytes8, bytes16) >= 4 * rows * Dl:
        return "f32"
    if bytes8 > bytes16:
        return "u16"
    # 4-bit census only when u8 wins (its misfits are a superset) and the
    # band is large enough for the halved bytes to pay
    if Dl % 2 == 0 and rows * Dl >= _U4_MIN_BYTES:
        return "u8|u4"
    return "u8"


def _packs4(rows: int, Dl: int, ne8: int, ne4: int) -> bool:
    """Whether a band whose census picked ``u8|u4`` goes nibble-packed:
    u4 beats u8 by 0.7x in bytes sent."""
    return (rows * Dl // 2 + ne4 * EXC_BYTES
            < 0.7 * (rows * Dl + ne8 * EXC_BYTES))


def _fill_by_census(x, y, v, band_shape, counts, scan=False):
    """:func:`fill_raw_band_compact` by the census: ``counts`` (the u8 and
    u16 counts, or ``native.classify_values``' three), or
    ``native.classify_values`` taken here when None or when ``u8|u4``
    needs the u4 count; ``scan``: the COO is known not to be sorted by
    row (:func:`_compact_fill`). A u4 band is filled straight into its
    nibble-packed ``[rows, Dl // 2]`` buffer."""
    rf = torch.profiler.record_function
    rows, Dl = band_shape
    if counts is None:
        with rf("upload.census"):
            counts = native.classify_values(v)
    ne8, ne16 = counts[:2]
    encoding = _encoding(rows, Dl, ne8, ne16)
    if encoding == "f32":
        return fill_raw_band(x, y, v, band_shape), None, False
    packed4 = False
    if encoding == "u8|u4":
        if len(counts) < 3:
            with rf("upload.census"):
                counts = native.classify_values(v)
        packed4 = _packs4(rows, Dl, ne8, counts[2])
    with rf("upload.fill"):
        if packed4:
            band = np.empty((rows, Dl // 2), np.uint8)
            exc = _compact_fill(native.fill_band_compact, x, y, v, band,
                                counts[2] + 16, scan=scan, packed4=True)
        else:
            dtype, ne = ((np.uint16, ne16) if encoding == "u16"
                         else (np.uint8, ne8))
            band = np.zeros(band_shape, dtype)
            exc = _compact_fill(native.fill_band_compact, x, y, v, band,
                                ne + 16, scan=scan)
    return band, (exc if len(exc[0]) else None), packed4


def _compact_fill(fill, *args, scan=False, **kw):
    """A native compact fill (``native.fill_band_compact`` or its row
    window) by row ranges, or with ``scan`` by the full scan; where the
    walk finds the COO not sorted by row, the full scan fills it again in
    an ``upload.refill`` range."""
    if scan:
        return fill(*args, scan=True, **kw)
    exc = fill(*args, **kw)
    if exc is None:
        with torch.profiler.record_function("upload.refill"):
            exc = fill(*args, scan=True, **kw)
    return exc


@dataclasses.dataclass
class BandUpload:
    """A raw band on the device as it went up: ``band`` ([rows, Dl], or
    [rows, Dl // 2] nibble-packed when ``packed4``), the unpadded host
    exception triple or None, and the number of H2D slabs."""

    band: torch.Tensor
    exceptions: tuple | None
    packed4: bool
    slabs: int

    @property
    def encoding(self) -> str:
        if self.packed4:
            return "u4"
        return {torch.uint8: "u8", torch.uint16: "u16",
                torch.float32: "f32"}[self.band.dtype]

    @property
    def n_exceptions(self) -> int:
        return 0 if self.exceptions is None else len(self.exceptions[0])

    @property
    def nbytes(self) -> int:
        """Bytes sent host to device: the band and the exception records."""
        return (self.band.numel() * self.band.element_size()
                + EXC_BYTES * self.n_exceptions)

    def describe(self) -> str:
        return (f"band={self.encoding} bytes={self.nbytes} "
                f"exceptions={self.n_exceptions} slabs={self.slabs}")


def stream_band_to_device(x, y, v, band_shape, device) -> BandUpload:
    """Slab-streamed compact band upload (``mustache_tpu/pipeline.py:
    175-253``): for a large u8/u4 band, fill row slab k+1 on the host
    while slab k's pinned, non-blocking H2D is in flight. The slabs land
    in one preallocated device band, so nothing is concatenated. Other
    bands take the one-shot :func:`fill_raw_band_compact` and one H2D.
    Its stages are profiler ranges: ``upload.census`` (the value census:
    one pass for the u8, u16 and u4 counts; the one-shot fill takes the
    first two in its fill's pass), ``upload.fill`` (the host band's fill,
    a u4 band straight into its nibble-packed slabs, and the exceptions),
    ``upload.refill`` (a second fill: :func:`fill_raw_band_compact`,
    :func:`_compact_fill`) and ``upload.stage`` (pinning and the H2D
    enqueue)."""
    rf = torch.profiler.record_function
    rows, Dl = band_shape
    streamable = (len(v) >= (1 << 20) and rows >= 4096
                  and rows * Dl >= 8_000_000)
    counts = None
    if streamable:
        with rf("upload.census"):
            counts = native.classify_values(v)
        encoding = _encoding(rows, Dl, *counts[:2])
        # only the u8/u4 encodings stream (u16/f32 data goes one-shot,
        # with the same encoding fill_raw_band_compact would pick)
        streamable = encoding in ("u8", "u8|u4")
    if not streamable:
        band, exc, p4 = fill_raw_band_compact(x, y, v, band_shape, counts)
        return BandUpload(upload_band(band, device), exc, p4, 1)

    ne8, _, ne4 = counts
    p4 = encoding == "u8|u4" and _packs4(rows, Dl, ne8, ne4)
    pin = device.type == "cuda"
    width, cap = (Dl // 2, ne4 + 16) if p4 else (Dl, ne8 + 16)
    band_dev = torch.empty((rows, width), dtype=torch.uint8, device=device)
    # 2 slabs: each range fill reads every entry's x (its rows' entries
    # walked, the others' for their order), so more slabs cost host time
    # faster than they add overlap
    n_slabs = 2
    per = -(-rows // n_slabs)
    staged, excs = [], []
    for g0 in range(0, rows, per):
        g1 = min(g0 + per, rows)
        with rf("upload.fill"):
            # the u4 fill zeroes its own rows: a pinned slab from the
            # allocator's cache, already faulted in, needs no clearing pass
            slab = (torch.empty if p4 else torch.zeros)(
                (g1 - g0, width), dtype=torch.uint8, pin_memory=pin)
            excs.append(_compact_fill(native.fill_band_compact_range, x, y,
                                      v, slab.numpy(), g0, g1, cap,
                                      packed4=p4))
        # async on CUDA: the next slab fills while this one is in flight
        with rf("upload.stage"):
            band_dev[g0:g1].copy_(slab, non_blocking=pin)
        staged.append(slab)
    with rf("upload.fill"):
        exc = tuple(np.concatenate([e[i] for e in excs]) for i in range(3))
    return BandUpload(band_dev, exc if len(exc[0]) else None, p4,
                      len(staged))


def block_bytes(route: str, n: int, Dl: int, itemsize: int) -> int:
    """Device bytes one block of a batch holds at its peak, the batch
    rule's unit (``sharding._batch_size``)."""
    if route == "kernel":
        # about 16 * n^2 bytes (the f32 dense block and its sentinel copy,
        # the f32 support mask, the bool mask) plus about 64 * n * Dl
        # bytes of band-sized epilogue state (count mode's f64 ranks,
        # int64 scatter indices and int32 histogram, or sort mode's keys
        # and int64 indices; ~20 [n, Dl] maps): 780 MB at 1 kb
        return 16 * n * n + 64 * n * Dl
    # the JAX package's XLA per-block size: ~45 n^2 live elements of the
    # compute dtype through the ladder (mustache_tpu/pipeline.py:274-278)
    return 45 * n * n * itemsize


def fill_host_band(x, y, v, cfg: DetectionConfig, band_shape, n: int, *,
                   normalize: bool, exact: bool) -> np.ndarray:
    """The band of the host-normalize modes, in the compute dtype
    (``mustache_tpu/pipeline.py:400-412``): normalized by
    ``normalize_sparse`` with ``exact`` (its native pass fills an f32
    band directly; an f64 band is filled by scatter), or the raw values
    when ``normalize`` is False. ``v`` is not modified."""
    dtype = np.float64 if cfg.precision == "float64" else np.float32
    band = np.zeros(band_shape, dtype)
    if normalize:
        v = np.array(v, dtype=np.float64)   # normalize_sparse works in place
        work = np.float64 if (exact or dtype == np.float64) else np.float32
        fuse = band if dtype == np.float32 else None
        normalize_sparse(x, y, v, cfg.resolution, cfg.distance_px,
                         exact=exact, work_dtype=work, band_out=fuse, n=n)
        if fuse is not None:
            return band
    if dtype == np.float32:
        native.fill_band(x, y, v, band)
    else:
        native.fill_band_plain(x, y, v, band)
    return band


def normalized_bands(x, y, v, cfg: DetectionConfig, band_shape, n: int,
                     runner: MeshRunner, *, normalize: bool, exact: bool,
                     plan: RowShardPlan | None = None):
    """ONE host fill of a chromosome's band, normalized by the JAX
    package's rule (``mustache_tpu/pipeline.py:360-420``) and placed on
    every entry of ``runner``'s mesh. The float32 normalize uploads the
    compact raw band once (one or two H2D slabs) to the first entry, the
    others get device copies of it, and each entry normalizes its own
    copy (``bandnorm.py``), so every entry holds the same values as an
    unsharded run. float64, ``exact`` and ``normalize=False`` fill the
    band of the compute dtype on the host (:func:`fill_host_band`) and
    upload it to each entry. With a row-shard ``plan``, the host
    normalizes (at f32 work dtype for the float32 default) and each entry
    receives only its slab. Returns ``(one band per entry, the plan
    line's account of what went up)``."""
    global H2D_BYTES
    mode = ("exact" if exact else "fast") if normalize else "off"
    rf = torch.profiler.record_function
    if plan is None and normalize and not exact and cfg.precision == "float32":
        with rf("pipeline.upload"):
            upload = stream_band_to_device(x, y, v, band_shape,
                                           runner.devices[0])
            H2D_BYTES += upload.nbytes
            with rf("upload.stage"):
                exc = (None if upload.exceptions is None
                       else pad_exceptions(upload.exceptions, band_shape[0]))
                raws = runner.place_band(upload.band)
        with rf("pipeline.normalize"):
            bands = [normalize_band_device(raw, n, cfg.resolution,
                                           cfg.distance_px, exceptions=exc,
                                           packed4=upload.packed4)[0]
                     for raw in raws]
        return bands, upload.describe()
    host = fill_host_band(x, y, v, cfg, band_shape, n, normalize=normalize,
                          exact=exact)
    sent = f"band={host.dtype.name} bytes={host.nbytes} host_normalize={mode}"
    if plan is not None:
        return (runner.place_band_rowshard(host, plan),
                f"{sent} slab_rows={plan.slab_rows}")
    return runner.place_band(host), sent


def local_runner(device) -> MeshRunner:
    """The runner of an unsharded run: a one-entry mesh of ``device`` (the
    card unless ``device="cpu"``; raises without CUDA)."""
    return MeshRunner(make_mesh(devices=[resolve_device(device)]))


def describe_runner(runner: MeshRunner) -> str:
    """The plan line's account of the devices: ``device=cpu`` for one
    entry, else the mesh's entries and placement."""
    devs = ",".join(str(d) for d in runner.devices)
    if runner.nb == 1 and runner.band_placement == "replicate":
        return f"device={devs}"
    return f"mesh={runner.nb} placement={runner.band_placement} device={devs}"


def detect_loops_coo(x, y, v, cfg: DetectionConfig, *, normalize: bool = True,
                     exact_normalize: bool = False, runner=None,
                     device=None, log=None) -> list[Loop]:
    """Loop calls for one intra-chromosomal COO map (bin coordinates) on
    ``device``: the card by default; ``device="cpu"`` runs the kernel
    route's plain PyTorch version. ``runner``: a ``sharding.MeshRunner``
    that splits the blocks over its mesh's devices (``device`` is then not
    read); its replicate placement gives the unsharded run's rows, its
    row-shard placement normalizes on the host. ``normalize=False``
    detects on the raw values; ``exact_normalize`` takes the reference's
    summation order in the host normalize. ``x``, ``y``, ``v`` are not
    modified. ``log``: optional callable taking one message string.

    The call is one ``pipeline.call`` profiler range; its stages are
    ranges inside it (:func:`detect_blocks`): ``pipeline.prepare`` (twice:
    up to the band, and the batch size after it), ``pipeline.upload``,
    ``pipeline.normalize``, ``mesh.launch`` and ``mesh.collect`` per
    batch, ``pipeline.finish`` per block (with a ``pipeline.regrow`` per
    rerun)."""
    def finish(out, i, start, spec):
        return finish_block(out, block_index=i, start=start, cfg=cfg,
                            spec=spec)

    with torch.profiler.record_function("pipeline.call"):
        return detect_blocks(
            [(x, y, v)], cfg, build=build_detector,
            bytes_per_block=block_bytes, finish=finish,
            emit=lambda r: Loop(int(r[0]), int(r[1]), float(r[2]),
                                float(r[3])),
            finish_range="pipeline.finish",
            sig_count=lambda o: int(o["sig_count"]),
            describe=lambda Bl, sent: sent[0],
            normalize=normalize, exact_normalize=exact_normalize,
            runner=runner, device=device, log=log)


def detect_blocks(coos, cfg: DetectionConfig, *, build, bytes_per_block,
                  finish, emit, finish_range: str, sig_count, describe,
                  normalize: bool, exact_normalize: bool, runner, device,
                  log):
    """The block loop of one chromosome given as one COO map or as several
    (the conditions of the differential call), on the chunk grid of the
    largest bin count ``n``: each map's band is normalized with its own
    bin count and placed on every entry of ``runner`` (or of the local
    runner of ``device``); the blocks go over the mesh in batches sized
    by ``bytes_per_block(route, chunk, Dl, itemsize)``, each entry running
    ``build(cfg, chunk, device=, max_candidates=)``'s ``fn_band_packed``
    on its bands; the host finishes each block as the next batch runs.

    Per block, in a ``finish_range`` profiler range: the regrow
    (:func:`_maybe_regrow` with ``sig_count``), then ``finish(out, block
    index, start, spec)``'s rows ``[x, y, ...]``; those the block owns
    (past its overlap mask) go out as ``emit(row)``, in block order.
    ``describe(batch per entry, what each map sent up)``: the tail of the
    plan line given to ``log``."""
    rf = torch.profiler.record_function
    with rf("pipeline.prepare"):
        route = resolve_route(cfg)
        if runner is None:
            runner = local_runner(device)
        if any(len(c[2]) == 0 for c in coos):
            return []
        coos = [(np.ascontiguousarray(x, dtype=np.int64),
                 np.ascontiguousarray(y, dtype=np.int64),
                 np.ascontiguousarray(v, dtype=np.float64))
                for x, y, v in coos]

        d_px = cfg.distance_px
        ns = [int(max(x.max(), y.max())) + 1 for x, y, _ in coos]
        n = max(ns)
        # blocks are ALWAYS chunk x chunk: when n <= chunk the reference
        # still densifies into a chunk x chunk zero-padded matrix
        # (mustache.py:923)
        width = cfg.chunk_size
        start, end = chunk_grid(n, width, d_px)
        masks = block_mask_sizes(start, end, d_px)
        nblocks = len(start)
        detectors = runner.per_device(lambda d: build(cfg, width, device=d))

        # rows ride the JAX package's bucket ladder (pad rows are inert)
        band_shape = (bucket_rows(max(n, width)), band_width(width, d_px))
        plan = (runner.plan_rowshard(start, width)
                if runner.band_placement == "rowshard" else None)
    placed, sent = zip(*(
        normalized_bands(x, y, v, cfg, band_shape, n_own, runner,
                         normalize=normalize, exact=exact_normalize,
                         plan=plan)
        for (x, y, v), n_own in zip(coos, ns)))
    bands = list(zip(*placed))          # per entry, its band of each map

    with rf("pipeline.prepare"):
        per_block = bytes_per_block(route, width, band_shape[1],
                                    bands[0][0].element_size())
        Bl = runner.local_batch(cfg, nblocks, per_block)
        if log is not None:
            log(f"n={n} blocks={nblocks} of {width}^2 "
                f"batch={runner.nb * Bl} {describe_runner(runner)} "
                f"route={route} precision={cfg.precision} "
                f"{describe(Bl, sent)}")

    def rerun_block(k, s, cap):
        """Re-detect the block at local start ``s`` of entry k with a
        larger candidate capacity, on that entry's bands or slabs."""
        det = build(cfg, width, device=runner.devices[k], max_candidates=cap)
        row = det.fn_band_packed(*bands[k], [s]).cpu().numpy()[0]
        return unpack_block(det.out_spec, row)

    launches = (plan.launches(Bl) if plan is not None
                else runner.replicated_launches(start, Bl))
    out_spec, spec = detectors[0].out_spec, detectors[0].spec
    # rows tagged by block index: entries return their blocks
    # entry-major, so block order is restored by a stable sort at the end;
    # the next batch runs on the device while this loop finishes a batch
    tagged = []
    for i, k, s, row in runner.pipelined(detectors, bands, launches):
        with rf(finish_range):
            block_out = _maybe_regrow(
                unpack_block(out_spec, row), cfg,
                lambda cap, k=k, s=s: rerun_block(k, s, cap), sig_count)
            # the block owns the rows past its overlap mask
            own_from = start[i] + masks[i]
            for r in finish(block_out, i, start[i], spec):
                if r[0] >= own_from or r[1] >= own_from:
                    tagged.append((i, emit(r)))
    tagged.sort(key=lambda t: t[0])
    return [row for _, row in tagged]


def write_loops(path: str, per_chrom: Iterable[tuple[str, str, int, Sequence[Loop]]]):
    """Write the reference-format TSV (mustache.py:1082-1103)."""
    with open(path, "w") as fh:
        fh.write(
            "BIN1_CHR\tBIN1_START\tBIN1_END\tBIN2_CHROMOSOME\t"
            "BIN2_START\tBIN2_END\tFDR\tDETECTION_SCALE\n"
        )
        for chrom, chrom2, res, loops in per_chrom:
            for lp in loops:
                fh.write(lp.to_row(chrom, chrom2, res))


# Public convenience API ----------------------------------------------------

def find_loops(x, y, v, *, resolution: int = 5000, distance_bp: int = 2_000_000,
               pt: float = 0.2, st: float = 0.88, sigma0: float = 1.6,
               octaves: int = 2, precision: str = "float32",
               normalize: bool = True, device=None) -> list[Loop]:
    """One-call API: COO contact map in, loop calls out, on ``device``
    (the card unless ``device="cpu"``). The caller's arrays are left
    untouched."""
    from mustache_tpu_torch.config import clamp_distance_filter

    cfg = DetectionConfig(
        resolution=resolution,
        distance_bp=clamp_distance_filter(distance_bp, resolution),
        pt=pt, st=st, sigma0=sigma0, octaves=octaves, precision=precision,
    )
    return detect_loops_coo(x, y, np.asarray(v, dtype=np.float64), cfg,
                            normalize=normalize, device=device)
