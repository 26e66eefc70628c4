"""Per-chromosome orchestration: raw band fill -> one H2D -> device
normalize -> batches of blocks (slice, densify, fused kernel, epilogue,
one packed D2H) -> host finish -> overlap dedup.

Torch port of the device-normalize branch of
``mustache_tpu/pipeline.py::detect_loops_coo``. The block grid, overlap
sizes and ownership masks are the reference's (mustache.py:896-960), so
per-block statistics reproduce the reference's numbers.

The band goes up in the narrowest lossless encoding (uint8, uint16 or
nibble-packed uint4, plus an exception list), filled by the native host
fill (``io/native``) and, for large bands, streamed in two slabs.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP Queue 1):
``precision="float64"`` and ``exact_normalize`` (host normalize,
``normalize.py``) and ``runner`` (sharding).
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
    band_width, build_detector, check_precision, finish_block, unpack_block,
)
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.io import native


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
    """Scatter-fill the RAW chromosome band ``band[x, y-x] = v`` with the
    native fill: a uint16 band when every value is an integer count below
    2^16 (widened losslessly on the device, bandnorm.widen_band), else an
    f32 band (``mustache_tpu/pipeline.py:55-77``)."""
    if native.values_fit_u16(v):
        band = np.zeros(band_shape, np.uint16)
        native.fill_band_u16(x, y, v, band)
    else:
        band = np.zeros(band_shape, np.float32)
        native.fill_band(x, y, v, band)
    return band


def upload_band(band: np.ndarray, device: torch.device) -> torch.Tensor:
    """One H2D of the host band, staged through pinned memory on CUDA."""
    t = torch.from_numpy(band)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# uint4 packing pays a host census and pack plus a larger exception
# scatter; the JAX package found its link bytes worth that only from 8 M
# band cells (``mustache_tpu/pipeline.py:80-83``). Kept as is: the H100
# numbers are in PERF.md, the threshold is not retuned for the card.
_U4_MIN_BYTES = 8_000_000
EXC_BYTES = 12      # one exception record: i32 row + i32 col + f32 value


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

    Returns ``(band, exceptions, packed4)``; ``exceptions`` is None or an
    unpadded (rows, cols, values) triple. Requires unique (x, y) pairs
    (the ingest-path invariant)."""
    rows, Dl = band_shape
    if not len(v):
        return fill_raw_band(x, y, v, band_shape), None, False
    ne8, ne16 = native.classify_values(v) if counts is None else counts
    bytes8 = rows * Dl + ne8 * EXC_BYTES
    bytes16 = 2 * rows * Dl + ne16 * EXC_BYTES
    if min(bytes8, bytes16) >= 4 * rows * Dl:
        return fill_raw_band(x, y, v, band_shape), None, False
    # 4-bit census only when u8 wins (its misfits are a superset) and the
    # band is large enough for the halved bytes to pay
    ne4 = bytes4 = None
    if (Dl % 2 == 0 and bytes8 <= bytes16 and rows * Dl >= _U4_MIN_BYTES):
        ne4 = native.classify_values4(v)
        bytes4 = rows * Dl // 2 + ne4 * EXC_BYTES
    dtype, ne = (np.uint8, ne8) if bytes8 <= bytes16 else (np.uint16, ne16)
    band = np.zeros(band_shape, dtype)
    exc = native.fill_band_compact(x, y, v, band, ne + 16)
    if bytes4 is not None and bytes4 < 0.7 * bytes8:
        band, big = native.pack_band4(band, ne4 + 16)
        exc = tuple(np.concatenate([a, b]) for a, b in zip(exc, big))
        return band, (exc if len(exc[0]) else None), True
    return band, (exc if len(exc[0]) else None), False


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
    bands take the one-shot :func:`fill_raw_band_compact` and one H2D."""
    rows, Dl = band_shape
    streamable = (len(v) >= (1 << 20) and rows >= 4096
                  and rows * Dl >= 8_000_000)
    counts = native.classify_values(v) if len(v) else None
    if streamable:
        ne8, ne16 = counts
        bytes8 = rows * Dl + ne8 * EXC_BYTES
        # only the u8/u4 encodings stream (u16/f32 data goes one-shot,
        # with the same encoding fill_raw_band_compact would pick)
        streamable = (bytes8 <= 2 * rows * Dl + ne16 * EXC_BYTES
                      and bytes8 < 4 * rows * Dl)
    if not streamable:
        band, exc, p4 = fill_raw_band_compact(x, y, v, band_shape, counts)
        return BandUpload(upload_band(band, device), exc, p4, 1)

    ne4 = native.classify_values4(v) if Dl % 2 == 0 else None
    p4 = ne4 is not None and rows * Dl // 2 + ne4 * EXC_BYTES < 0.7 * bytes8
    pin = device.type == "cuda"
    width = Dl // 2 if p4 else Dl
    band_dev = torch.empty((rows, width), dtype=torch.uint8, device=device)
    # 2 slabs: each range fill scans the whole COO, so more slabs cost
    # host time faster than they add overlap
    n_slabs = 2
    per = -(-rows // n_slabs)
    staged, excs = [], []
    for g0 in range(0, rows, per):
        g1 = min(g0 + per, rows)
        slab = torch.zeros((g1 - g0, Dl), dtype=torch.uint8,
                           pin_memory=pin and not p4)
        exc = native.fill_band_compact_range(x, y, v, slab.numpy(), g0, g1,
                                             ne8 + 16)
        if p4:
            packed = torch.empty((g1 - g0, width), dtype=torch.uint8,
                                 pin_memory=pin)
            _, big = native.pack_band4(slab.numpy(), ne4 + 16,
                                       out=packed.numpy())
            big = (big[0] + np.int32(g0), big[1], big[2])
            exc = tuple(np.concatenate([a, b]) for a, b in zip(exc, big))
            slab = packed
        excs.append(exc)
        # async on CUDA: the next slab fills while this one is in flight
        band_dev[g0:g1].copy_(slab, non_blocking=pin)
        staged.append(slab)
    exc = tuple(np.concatenate([e[i] for e in excs]) for i in range(3))
    return BandUpload(band_dev, exc if len(exc[0]) else None, p4,
                      len(staged))


def _batch_size(cfg: DetectionConfig, n: int, Dl: int, nblocks: int,
                device: torch.device) -> int:
    """Blocks per batch. On CUDA, from free device memory: a block holds
    about 16 * n^2 bytes at its peak (the f32 dense block and its
    sentinel copy, the f32 support mask, the bool mask) plus about
    64 * n * Dl bytes of band-sized epilogue state (the sort's keys and
    int64 indices, ~20 [n, Dl] maps); half of the free memory is given to
    a batch, at most 16 blocks. On the CPU, 2 (as the JAX package)."""
    if cfg.block_batch:
        return cfg.block_batch
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        per_block = 16 * n * n + 64 * n * Dl
        cap = max(1, min(16, int(0.5 * free // per_block)))
    else:
        cap = 2
    return min(cap, nblocks)


def detect_loops_coo(x, y, v, cfg: DetectionConfig, *,
                     exact_normalize: bool = False, runner=None,
                     device=None, log=None) -> list[Loop]:
    """Loop calls for one intra-chromosomal COO map (bin coordinates) on
    ``device``: the card by default ("cuda[:i]" runs the fused kernel);
    ``device="cpu"`` runs its plain PyTorch version. Unported modes raise
    ``NotImplementedError`` before the device is resolved, so on any host.
    ``x``, ``y``, ``v`` are not modified. ``log``: optional callable
    taking one message string."""
    if exact_normalize:
        raise NotImplementedError(
            "exact_normalize: host normalize not ported yet (ROADMAP Queue "
            "1, normalize.py + f64/exact modes)")
    if runner is not None:
        raise NotImplementedError(
            "runner: sharded runs not ported yet (ROADMAP Queue 1, "
            "sharding.py)")
    check_precision(cfg)
    dev = resolve_device(device)
    if len(v) == 0:
        return []
    x = np.ascontiguousarray(x, dtype=np.int64)
    y = np.ascontiguousarray(y, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.float64)

    d_px = cfg.distance_px
    n = int(max(x.max(), y.max())) + 1
    # blocks are ALWAYS chunk x chunk: when n <= chunk the reference still
    # densifies into a chunk x chunk zero-padded matrix (mustache.py:923)
    width = cfg.chunk_size
    detector = build_detector(cfg, width, device=dev)   # raises if unsupported

    # ONE host fill and ONE (possibly two-slab) H2D per chromosome: the
    # diagonal band in its compact encoding; rows ride the JAX package's
    # bucket ladder (pad rows are inert)
    band_shape = (bucket_rows(max(n, width)), band_width(width, d_px))
    upload = stream_band_to_device(x, y, v, band_shape, dev)
    exc = (None if upload.exceptions is None
           else pad_exceptions(upload.exceptions, band_shape[0]))
    band, _ = normalize_band_device(upload.band, n, cfg.resolution, d_px,
                                    exceptions=exc, packed4=upload.packed4)

    start, end = chunk_grid(n, width, d_px)
    masks = block_mask_sizes(start, end, d_px)
    nblocks = len(start)
    B = _batch_size(cfg, width, band_shape[1], nblocks, dev)
    if log is not None:
        log(f"n={n} blocks={nblocks} of {width}^2 batch={B} device={dev} "
            f"{upload.describe()}")

    def run(det, idxs) -> np.ndarray:
        # one packed D2H per batch
        return det.fn_band_packed(band, [start[i] for i in idxs]).cpu().numpy()

    def rerun_block(i, cap):
        """Re-detect block i with a larger candidate capacity."""
        det = build_detector(cfg, width, device=dev, max_candidates=cap)
        return unpack_block(det.out_spec, run(det, [i])[0])

    loops: list[Loop] = []
    for b0 in range(0, nblocks, B):
        idxs = list(range(b0, min(b0 + B, nblocks)))
        packed = run(detector, idxs)
        for bi, i in enumerate(idxs):
            block_out = _maybe_regrow(
                unpack_block(detector.out_spec, packed[bi]), cfg,
                lambda cap, i=i: rerun_block(i, cap))
            rows = finish_block(block_out, block_index=i, start=start[i],
                                cfg=cfg, spec=detector.spec)
            mask = masks[i]
            for r in rows:
                if r[0] >= start[i] + mask or r[1] >= start[i] + mask:
                    loops.append(Loop(int(r[0]), int(r[1]), float(r[2]),
                                      float(r[3])))
    return loops


def _maybe_regrow(block_out: dict, cfg: DetectionConfig, rerun) -> dict:
    """If the candidate table overflowed (more pixels below the q threshold
    than capacity), rerun this single block with a larger capacity.
    ``rerun``: callable ``(capacity) -> block_out``. Sort-mode BH reports
    the exact sig_count, so one rerun fits; the loop is kept from the JAX
    package, whose count mode reports a lower bound."""
    cap = cfg.max_candidates
    while True:
        sig = int(block_out["sig_count"])
        if sig <= cap:
            return block_out
        cap = max(1 << (sig - 1).bit_length(), 2 * cap)
        block_out = rerun(cap)


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
               device=None) -> list[Loop]:
    """One-call API: COO contact map in, loop calls out, on ``device``
    (the card unless ``device="cpu"``)."""
    from mustache_tpu_torch.config import clamp_distance_filter

    cfg = DetectionConfig(
        resolution=resolution,
        distance_bp=clamp_distance_filter(distance_bp, resolution),
        pt=pt, st=st, sigma0=sigma0, octaves=octaves, precision=precision,
    )
    return detect_loops_coo(x, y, np.asarray(v, dtype=np.float64), cfg,
                            device=device)
