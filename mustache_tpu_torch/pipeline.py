"""Per-chromosome orchestration: raw band fill -> one H2D -> device
normalize -> batches of blocks (slice, densify, fused kernel, epilogue,
one packed D2H) -> host finish -> overlap dedup.

Torch port of the device-normalize branch of
``mustache_tpu/pipeline.py::detect_loops_coo``. The block grid, overlap
sizes and ownership masks are the reference's (mustache.py:896-960), so
per-block statistics reproduce the reference's numbers.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP Queue 1):
``precision="float64"`` and ``exact_normalize`` (host normalize,
``normalize.py``), ``runner`` (sharding), and the u8/u4 streamed band
upload (``fill_raw_band_compact`` / ``stream_band_to_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from mustache_tpu_torch.bandnorm import bucket_rows, normalize_band_device
from mustache_tpu_torch.config import DetectionConfig, block_mask_sizes, chunk_grid
from mustache_tpu_torch.detect import band_width, build_detector, finish_block, unpack_block
from mustache_tpu_torch.device import resolve_device


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
    """Scatter-fill the RAW chromosome band ``band[x, y-x] = v``.

    Integer counts < 2^16 (every unbiased text/.hic/.cool workload) fill a
    uint16 band (half the H2D bytes of f32), widened to f32 on the device
    (bandnorm.widen_band), which is lossless for such values; anything
    else keeps an f32 band. The numpy twin of the JAX package's native
    fill (``mustache_tpu/pipeline.py:55-77``)."""
    fit = (v.size > 0 and float(v.min()) >= 0.0 and float(v.max()) < 65536.0
           and not np.any(v != np.floor(v)))
    band = np.zeros(band_shape, np.uint16 if fit else np.float32)
    d = y - x
    sel = (d >= 0) & (d < band.shape[1])
    band[x[sel], d[sel]] = v[sel]
    return band


def upload_band(band: np.ndarray, device: torch.device) -> torch.Tensor:
    """One H2D of the host band, staged through pinned memory on CUDA."""
    t = torch.from_numpy(band)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


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
                     device="cpu", log=None) -> list[Loop]:
    """Loop calls for one intra-chromosomal COO map (bin coordinates) on
    ``device`` ("cpu" or "cuda[:i]"; CUDA runs the fused kernel, the CPU
    its plain PyTorch version). ``x``, ``y``, ``v`` are not modified.
    ``log``: optional callable taking one message string."""
    if exact_normalize:
        raise NotImplementedError(
            "exact_normalize: host normalize not ported yet (ROADMAP Queue "
            "1, normalize.py + f64/exact modes)")
    if runner is not None:
        raise NotImplementedError(
            "runner: sharded runs not ported yet (ROADMAP Queue 1, "
            "sharding.py)")
    dev = resolve_device(device)
    if len(v) == 0:
        return []
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    v = np.asarray(v, dtype=np.float64)

    d_px = cfg.distance_px
    n = int(max(x.max(), y.max())) + 1
    # blocks are ALWAYS chunk x chunk: when n <= chunk the reference still
    # densifies into a chunk x chunk zero-padded matrix (mustache.py:923)
    width = cfg.chunk_size
    detector = build_detector(cfg, width, device=dev)   # raises if unsupported

    # ONE host fill and ONE H2D per chromosome: the diagonal band; rows
    # ride the JAX package's bucket ladder (pad rows are inert)
    band_shape = (bucket_rows(max(n, width)), band_width(width, d_px))
    band = upload_band(fill_raw_band(x, y, v, band_shape), dev)
    band, _ = normalize_band_device(band, n, cfg.resolution, d_px)

    start, end = chunk_grid(n, width, d_px)
    masks = block_mask_sizes(start, end, d_px)
    nblocks = len(start)
    B = _batch_size(cfg, width, band_shape[1], nblocks, dev)
    if log is not None:
        log(f"n={n} blocks={nblocks} of {width}^2 batch={B} device={dev}")

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
               device="cpu") -> list[Loop]:
    """One-call API: COO contact map in, loop calls out, on ``device``."""
    from mustache_tpu_torch.config import clamp_distance_filter

    cfg = DetectionConfig(
        resolution=resolution,
        distance_bp=clamp_distance_filter(distance_bp, resolution),
        pt=pt, st=st, sigma0=sigma0, octaves=octaves, precision=precision,
    )
    return detect_loops_coo(x, y, np.asarray(v, dtype=np.float64), cfg,
                            device=device)
