#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the fused ladder/DoG/NMS kernel from csrc/ with nvcc (and the
   native band fill and host normalize with g++, in parallel) and print
   ptxas's report for it (registers, shared memory, spills);
3. kernel vs its plain PyTorch version on the card, on sentinel-filled
   synthetic blocks at both main-path block shapes (N=2000/DB=512 at 5 kb,
   N=4000/DB=2048 at 1 kb), and at the 5 kb shape with a 3-octave ladder
   (radii up to 28: the kernel's path for sigmas of more than 32 taps)
   and a 4-octave one (radius 55, 174,144 B of shared memory, the largest
   sigma0-1.6 ladder the slab mode holds), and the streamed mode's
   ladders (R <= 127): the 5 kb shape at sigma0 1.6 with 5 octaves
   (R=110) and at sigma0 3.0 with 4 (R=103), and the 1 kb shape with 5
   octaves; B=4 with a pad slot in the
   middle: band_sig
   equal on the support (a mismatch must be an f32 near-tie and sit on no
   significant candidate), band_v / locs / sums within rtol 2e-4, the pad
   slot empty, a second launch bit-identical; kernel, plain version and
   cuDNN's two-pass blur of the same blocks (blur only: no PyTorch call
   computes the fused function) timed with CUDA events; the kernel held
   against its FP32 bound from the FLOP the algorithm needs; the 2- and
   4-octave shapes also launched in the streamed mode, bit-identical to
   the slab mode (also on their blocks cut to N - 2, where the streamed
   mode copies the slab with cp.async alone), and timed; each shape's
   CTAs per SM and resident clusters (the CUDA occupancy API,
   ``cudaOccupancyMaxActiveClusters``), and the FMAs its passes execute
   per FMA the cells need, counted from the kernel's geometry;
4. end to end: the bench headline workload (synthetic chr21 at 5 kb,
   6 blocks of 2000^2) through ``detect_loops_coo`` with no device given
   (the card by default) and ``write_loops``; the kernel must have
   launched, and the loop rows must equal the JAX package's CPU golden
   (tests/data/torch_port_chr21_5kb_golden.tsv, tools/make_torch_golden.py):
   anchors and scales exact, q within rtol 2e-4, the only allowed
   difference a row whose q is within rtol 2e-4 of pt;
5. the CLI on the card, from files: the chr21 workload written as a text
   contact file and as a v8 ``.hic`` (tests/hic_writer.py), each run twice
   through ``mustache_tpu_torch.cli.main`` with no platform flag; the rows
   must equal the golden as in phase 4, the kernel must have launched, and
   the band must have gone up as u8 through the native fill. Also the host
   band fill (numpy against native) and the H2D of the f32 and u8 bands,
   timed, and the device time of one CLI run from the trace that
   ``--engine-profile-dir`` writes;
6. the 1 kb slice end to end (bench.py's 1 kb workload: 12,000 bins,
   d_px 2000, blocks of 4000^2): the streamed compact upload (two slabs,
   u8 or u4), whose widened band with the exceptions scattered must equal
   the f32 band of the same COO bit for bit; ``detect_loops_coo`` with no
   device (walls, loops, peak device memory, held to the 1 kb golden when
   tests/data/torch_port_1kb_golden.tsv exists); and the CLI on the same
   contacts from a text file, whose TSV must equal the direct call's;
7. differential calling on the bench diff workload (chr21 5 kb at seeds
   2021 and 2022, pt2 0.1): the kernel against its plain version on a
   stacked [2B] batch of both conditions' blocks with a pad slot per
   condition (slots 2 and 5), with phase 3's checks; the main path's
   12-slot stacked launch and the difference planes timed;
   ``detect_diff_loops_coo`` with no device (kernel launched, walls cold
   and warm, peak device memory, device ms per stage from a profiled run)
   against the diff golden (tests/data/torch_port_chr21_5kb_diff_golden.tsv,
   ``tools/make_torch_golden.py --slice diff5kb``): per tag as phase 4,
   and a differential row may sit on one side only where the port's own
   call at its representative pixel is an f32 near-tie (pair within rtol
   2e-3 of pt2, or v1 and v2 within rtol 2e-4); and the diff CLI with no
   platform flag from two v8 ``.hic`` files, whose four files must equal
   the direct call's rows;
8. the ladder route and the host normalize (``detect.resolve_route``,
   ``ladder.py``, ``normalize.py``): ``detect_loops_coo`` at float64 on
   the chr21 workload against the JAX package's float64 golden
   (tests/data/torch_port_chr21_5kb_f64_golden.tsv,
   ``tools/make_torch_golden.py --slice f64_5kb``): rows in order, every
   field but q exact, q within rtol 1e-9; route ``ladder`` and no fused
   kernel launch; walls, peak device memory, the host normalize's time
   and the device time by stage (preamble, blur, scan, epilogue) from a
   profiled run; the CLI with ``--engine-precision float64`` from phase
   5's text file, held to the same golden, and from its ``.hic`` (which
   stores float32 counts), rows exact and q within rtol 2e-4;
   ``detect_diff_loops_coo`` at
   float64 on the two-condition workload against the float64 diff golden
   (``--slice diff_f64_5kb``) per tag; ``exact_normalize=True`` at
   float32 (host band, one fused kernel launch): the 290 golden rows, q
   held under phase 4's rule to the JAX exact-normalize golden
   (``--slice exact_5kb``); ``use_pallas="off"`` (the f32 ladder route)
   against the 290-row golden under phase 4's rule, timed against the
   kernel route, and the two routes'
   detection state of the 6 blocks under CUDA events; and sigma0 1.6
   with 6 octaves (radius 220, beyond the JAX package's fused gate and
   the kernel's) on the ladder route, held to the fused kernel's plain
   version on the card under phase 4's rule;
9. inter-chromosomal calling and the native ``.hic`` decoder
   (``inter.py``, ``io/native/hic_decode.cpp``): a whole chr21 x chr22
   pair at 5 kb (``synthetic_inter(9342, 10164, seed=2121, n_loops=300)``,
   ~47 M contacts, a 5 x 6 grid of 2000^2 tiles) through
   ``detect_inter_loops_coo`` with no device, against the JAX package's
   CPU golden (tests/data/torch_port_inter_5kb_golden.tsv,
   ``tools/make_torch_golden.py --slice inter_5kb``): rows in order,
   anchors and scales exact, q within rtol 2e-4; no fused kernel launch;
   walls cold and warm, peak device memory, H2D bytes, device ms by
   ``inter.*`` range; the float64 run as the judge of both f32 paths; the
   per-tile peak memory at B=1 and 3 (the batch rule's slope); the
   device-built tiles against the JAX-style host densify; the CLI with
   ``-ch c1 -ch2 c2`` from a v8 ``.hic`` (2000 x 1500 bins) against the
   direct call on the same contacts; and the native decoder against the
   Python one on phase 5's and this phase's files (equal arrays, both
   timed), reporting whether zlib.h was found;
10. sharding (``sharding.py``, ``dryrun.py``): ``dryrun_multichip`` on
   every card and on a mesh of four entries of ``cuda:0`` (production
   geometry included); chr21 at 5 kb through the replicate and row-shard
   placements on meshes of one and four entries of ``cuda:0``: replicate
   rows identical to phase 4's, row-shard rows held under phase 4's rule
   to the JAX row-sharded golden
   (tests/data/torch_port_chr21_5kb_rowshard_golden.tsv,
   ``tools/make_torch_golden.py --slice rowshard_5kb``), with their q
   distance from phase 4's rows, the slab and replicated bytes, the fused
   launches per entry and the warm walls against phase 4's; phase 7's
   workload on four entries (replicate: phase 7's rows; row-shard: tags,
   anchors and scales exact, q within rtol 5e-3); and the CLI on a v8
   ``.hic`` of three 5 kb chromosomes (phase 5's map at seeds 2021-2023)
   as two processes on the first card over gloo (``--engine-nprocs 2``):
   the TSV byte-equal to the single-process run's, and with one
   chromosome's ingest failing, exit codes [0, 1] and the other two in
   the TSV. The mesh's row axis: the dense runner on meshes of 4 x 1,
   2 x 2, 1 x 4 and 1 x 3 entries of ``cuda:0`` over the JAX sharding
   test's 8 blocks (256^2) and chr21 5 kb's six 2000^2 blocks, every
   output bit-identical to ``n_row = 1``, fused launches and dense bytes
   held per entry; row windows of 2, 3 and 4 parts joined equal to the
   whole-block launch bit for bit, one window exact against its plain
   version and timed against the whole-block launch; float64 (the ladder
   route) on 2 x 2 within rtol 1e-9; the dryrun's ``n_row = 2`` part
   (on four entries);
11. ``.cool`` / ``.mcool`` without h5py (``io/h5.py``): the committed
   fixtures in cooler's layout (tests/data/torch_port_cooler_layout.*,
   gzip 6 + shuffle, chunked, an enum, variable-length attributes, two
   resolutions) read equal to the JAX reader's digests
   (tests/data/torch_port_cool_expected.json, ``tools/make_torch_golden.py
   --slice cool_card``); chr21 5 kb written as ``.mcool`` by
   ``tools/write_cool.py`` through the CLI, held to the 290-row golden as
   in phase 5, its ingest against phase 5's ``.hic`` ingest; a small
   inter pair from ``.cool`` equal to the same pair from ``.hic``; h5py
   never imported;
12. the kernel's streamed mode on every caller, at sigma0 1.6 with 5
   octaves (R=110), each against the ladder route (``use_pallas="off"``)
   on the same call: chr21 5 kb through ``detect_loops_coo`` and the CLI
   from phase 5's ``.hic`` with ``-oc 5`` (one fused launch each, route
   ``kernel``; rows held under phase 4's rule to the JAX golden,
   tests/data/torch_port_chr21_5kb_oct5_golden.tsv, ``tools/
   make_torch_golden.py --slice oct5_5kb``; walls cold and warm of both
   routes), the 1 kb slice (rows held to the ladder route's, peak device
   memory of both), the differential workload (one stacked launch, rows
   held to the ladder route's under phase 7's rule; the stacked batches
   held to the plain version and timed as in phase 7) and the row window
   (four parts joined bit-identical to the whole-block launch, part 2 of
   4 exact against its plain version and timed as in phase 10; the
   dense runner on 1 x 4 entries of ``cuda:0`` equal to ``n_row = 1``);
13. BH modes and the batched epilogue (``detect._BH_MODE``; phases 4-12
   run the default, count mode): the tie block (50 of 100 tested tied at
   p = 0.02, pt = 0.05, capacity 35) through ``_band_candidates`` on the
   card in count mode must report overflow and regrow to sort mode's 50
   rejections; chr21 5 kb, the 1 kb slice and the two-condition diff in
   both modes in one process: one batch's candidate tables bit-identical
   between the modes (counts, valid slots, pass flags, significant
   neighbours), rows equal between the modes and to the goldens (as in
   phases 4, 6 and 7), one fused launch a run, warm walls in turns, and
   from one profiled run per mode the device ms by range (the epilogue's
   among them), the kernel launches and copies per chromosome, beside the
   card's name and power limit; chr21 5 kb in batches of 2 (three
   batches, pipelined) and of 1 gives the rows of one batch;
14. whole chromosomes at 1 kb (blocks of 4000^2, a band 2048 wide): chr21
   (``synthetic_hic(46710, 2000, seed=1011, n_loops=580, ...)``, 23 blocks)
   and chr1 (``synthetic_hic(248956, 2000, seed=1001, n_loops=3100, ...,
   density=0.9, density_decay=0.25)``, 124 blocks; made in a second
   process while chr21 runs). For each: the host band fill and the
   streamed upload timed; the normalize stage alone, its peak device
   memory at most 4 f32 bands and below the whole call's, timed with CUDA
   events (on chr21 held to the whole-band normalize by ``torch.equal``,
   or the largest difference printed); ``detect_loops_coo`` cold, three
   times warm and in turns (auto batches, ``block_batch=1`` twice, auto),
   one fused launch a batch, every run's rows identical; rows held under
   phase 4's rule to the JAX golden (tests/data/torch_port_chr21_1kb_golden.
   tsv and, where committed, ..._chr1_1kb_golden.tsv, ``tools/
   make_torch_golden.py --slice chr21_1kb``); the planted anchors found;
   one profiled warm run (device ms by stage, the f64 cumsums' share of
   the normalize, kernel ms per launch, host finish ms, device busy
   share); chr21 through the CLI from an ``.mcool`` of float64 counts
   (``tools/write_cool.py``), its TSV equal to the direct call's and the
   golden, with the CLI's ingest / detect split; chr1's first batch (B as
   the rule picks) through the kernel against its plain version under
   phase 3's checks, both timed.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

RTOL = 2e-4           # f32 tolerance of the JAX package's own parity tests
PT, ST = 0.1, 0.8     # bench headline thresholds (bench.py)
NEAR_TIE = 1e-5       # relative f64 margin below which f32 may decide
                      # either way (~100 f32 ulps)
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "torch_port_chr21_5kb_golden.tsv")
GOLDEN_1KB = os.path.join(ROOT, "tests", "data", "torch_port_1kb_golden.tsv")
GOLDEN_DIFF = os.path.join(ROOT, "tests", "data",
                           "torch_port_chr21_5kb_diff_golden.tsv")
GOLDEN_F64 = os.path.join(ROOT, "tests", "data",
                          "torch_port_chr21_5kb_f64_golden.tsv")
GOLDEN_EXACT = os.path.join(ROOT, "tests", "data",
                            "torch_port_chr21_5kb_exact_golden.tsv")
GOLDEN_DIFF_F64 = os.path.join(ROOT, "tests", "data",
                               "torch_port_chr21_5kb_diff_f64_golden.tsv")
GOLDEN_INTER = os.path.join(ROOT, "tests", "data",
                            "torch_port_inter_5kb_golden.tsv")
GOLDEN_OCT5 = os.path.join(ROOT, "tests", "data",
                           "torch_port_chr21_5kb_oct5_golden.tsv")
# the chr21 5 kb workload (bench.py::build_workload) and the 1 kb slice
# (bench.py::build_workload_1kb): synthetic_hic args and kwargs
CHR21 = ((9629, 400), dict(seed=2021, n_loops=300, loop_strength=3.0))
# the bench diff leg's second condition (bench.py: seeds 2021 and 2022)
CHR21_COND2 = ((9629, 400), dict(seed=2022, n_loops=300, loop_strength=3.0))
PT2 = 0.1             # bench diff leg's differential threshold
# phase 7's stacked batch: B=3 per condition, the third a pad slot, so
# kernel slots 2 and 5 are pads
DIFF_STARTS = [0, 3200, -1]
# phase 9: chr21 x chr22 at 5 kb (46,709,983 and 50,818,468 bp) and the
# settings of tests/test_inter.py::test_cli_inter_end_to_end
CHR21_X_22 = ((9342, 10164), dict(seed=2121, n_loops=300))
INTER_PT, INTER_ST = 0.1, 0.5
SLICE_1KB = ((12000, 2000), dict(seed=1011, n_loops=150, loop_strength=3.0,
                                 density=0.95))
FP32_FLOPS = 67e12    # H100 SXM FP32 peak outside the tensor cores (700 W)
HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
# (label, N, d_px, resolution, n_bins, starts, ladder octaves); slot 2 is
# the pad slot
OCT5 = (1.6, 3.2, 6.4, 12.8, 25.6)     # sigma0 1.6, -oc 5: R=110
SHAPES = [("5kb", 2000, 400, 5000, 5000, [0, 1000, 0, 3000], (1.6, 3.2)),
          ("1kb", 4000, 2000, 1000, 8000, [0, 2000, 0, 4000], (1.6, 3.2)),
          ("5kb-3oct", 2000, 400, 5000, 5000, [0, 1000, 0, 3000],
           (1.6, 3.2, 6.4)),
          ("5kb-4oct", 2000, 400, 5000, 5000, [0, 1000, 0, 3000],
           (1.6, 3.2, 6.4, 12.8)),
          ("5kb-oct5", 2000, 400, 5000, 5000, [0, 1000, 0, 3000], OCT5),
          ("5kb-s3oct4", 2000, 400, 5000, 5000, [0, 1000, 0, 3000],
           (3.0, 6.0, 12.0, 24.0)),
          ("1kb-oct5", 4000, 2000, 1000, 8000, [0, 2000, 0, 4000], OCT5)]
VALID = [1, 1, 0, 1]
# shapes whose ladder takes the slab mode, also launched in the streamed
# mode: the two modes must give the same bits
BOTH_MODES = ("5kb", "5kb-4oct")


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def compact_normalized_band(x, y, v, shape, dev, n_bins, res, d_px):
    """The band of ``shape`` on ``dev`` as the pipeline's float32 default
    makes it: the compact raw fill, one H2D, the device normalize."""
    from mustache_tpu_torch.bandnorm import (
        normalize_band_device, pad_exceptions,
    )
    from mustache_tpu_torch.pipeline import fill_raw_band_compact
    from mustache_tpu_torch.sharding import upload_band

    band, exc, p4 = fill_raw_band_compact(x, y, v, shape)
    exc = None if exc is None else pad_exceptions(exc, shape[0])
    return normalize_band_device(upload_band(band, dev), n_bins, res, d_px,
                                 exceptions=exc, packed4=p4)[0]


def diff_bands(x1, y1, v1, x2, y2, v2, cfg, runner):
    """Both conditions' normalized bands on ``runner``'s one entry as the
    differential entry places them (``pipeline.detect_blocks``): one band
    shape, each band normalized with its own bin count. Returns ``(band1,
    band2, n)`` with ``n`` the larger bin count."""
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.pipeline import normalized_bands

    maps = ((x1, y1, v1), (x2, y2, v2))
    ns = [int(max(np.max(x), np.max(y))) + 1 for x, y, _ in maps]
    n, width = max(ns), cfg.chunk_size
    shape = (bucket_rows(max(n, width)), band_width(width, cfg.distance_px))
    (b1,), (b2,) = (normalized_bands(x, y, v, cfg, shape, n_own, runner,
                                     normalize=True, exact=False)[0]
                    for (x, y, v), n_own in zip(maps, ns))
    return b1, b2, n


def synthetic_blocks(dev, N, d_px, res, n_bins, starts, seed):
    """Sentinel-filled blocks [B, N, N] and their support, built the way the
    pipeline builds them (raw band -> device normalize -> slice -> densify
    -> sentinel fill), plus the band slices."""
    from synthetic import synthetic_hic
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.detect import _preamble, band_width, dense_from_band

    x, y, v, _ = synthetic_hic(n_bins, d_px, seed=seed, n_loops=60,
                               loop_strength=3.0, density=0.95)
    shape = (bucket_rows(n_bins), band_width(N, d_px))
    band = compact_normalized_band(x, y, v, shape, dev, n_bins, res, d_px)
    slices = torch.stack([band[max(s, 0): max(s, 0) + N] for s in starts])
    cs, nz = _preamble(dense_from_band(slices), d_px)
    return cs, nz.to(torch.float32), slices


def band_support(nzf, DB):
    """Support in band layout [B, N, DB] (cells with j = i + d >= N are
    off-support)."""
    B, N, _ = nzf.shape
    i = torch.arange(N, device=nzf.device)[:, None]
    j = i + torch.arange(DB, device=nzf.device)[None, :]
    return (nzf[:, i, j.clamp(max=N - 1)] > 0.5) & (j < N)


def near_tie(cs_blk: np.ndarray, i: int, j: int, spec) -> float:
    """Smallest relative margin, in float64, among the comparisons the NMS
    makes at dense cell (i, j): each DoG plane's centre against its 3x3
    neighbours and the two adjacent planes, and against every other
    plane's centre (the running best). A mismatch between two f32
    implementations is legitimate only where this margin is within f32
    rounding."""
    N = cs_blk.shape[0]
    R = spec.radius
    idx_r = np.arange(i - 1 - R, i + 2 + R)
    idx_c = np.arange(j - 1 - R, j + 2 + R)

    def refl(a):
        a = np.where(a < 0, -1 - a, a)
        return np.clip(np.where(a >= N, 2 * N - 1 - a, a), 0, N - 1)

    win = cs_blk[np.ix_(refl(idx_r), refl(idx_c))].astype(np.float64)
    inside = np.outer((np.arange(i - 1, i + 2) >= 0) & (np.arange(i - 1, i + 2) < N),
                      (np.arange(j - 1, j + 2) >= 0) & (np.arange(j - 1, j + 2) < N))
    T = 2 * R + 1
    G = []
    for k in spec.kernels:                       # f64 taps
        rows = np.stack([win[r:r + T].T @ k for r in range(3)])    # [3, 3+2R]
        g = np.stack([rows[:, c:c + T] @ k for c in range(3)], 1)  # [3, 3]
        G.append(np.where(inside, g, 0.0))
    G = np.asarray(G)
    margins, scale = [], 1e-30
    centres = []
    for o in range(len(spec.octave_values)):
        L = G[o * 12:(o + 1) * 12 - 1] - G[o * 12 + 1:(o + 1) * 12]
        scale = max(scale, np.abs(L).max())
        for p in range(1, 10):
            c = L[p, 1, 1]
            centres.append(c)
            for q in (p - 1, p, p + 1):
                nb = np.delete(L[q].ravel(), 4) if q == p else L[q].ravel()
                margins.extend(np.abs(c - nb))
                if q != p:
                    margins.extend(np.abs(L[q, 1, 1] - np.delete(L[q].ravel(), 4)))
    centres = np.asarray(centres)
    margins.extend(np.abs(centres[:, None] - centres[None, :])[
        ~np.eye(len(centres), dtype=bool)])
    return float(np.min(margins) / scale)


def kernel_bound(spec, N, DB, n_real, rows=None):
    """FLOP the algorithm needs, bytes it must move, and the least time
    the card could take for them: two separable passes over each sigma's
    nonzero taps (2r + 1) at every band cell (sum over rows of min(DB,
    N - i)) of every real slot, one FMA = 2 FLOP; cs and nzf read once
    and band_v and band_sig written once over the band, 4 bytes each.
    ``rows``: a row window's band rows (default: all N)."""
    from mustache_tpu_torch.scalespace import kernel_radius

    taps = sum(2 * kernel_radius(s) + 1 for s in spec.blur_sigmas)
    cells = sum(min(DB, N - i) for i in (range(N) if rows is None
                                         else rows)) * n_real
    flop = 2 * 2 * taps * cells
    nbytes = 16 * cells
    t_ops, t_bytes = flop / FP32_FLOPS, nbytes / HBM_BYTES
    return (flop, nbytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def executed_fmas(spec, N, DB, n_real, mode, cluster):
    """FMAs the kernel's two passes execute on the whole-block launch,
    counted from its geometry (csrc/fused_ladder.cu), every tile with
    cells taken to have support (so an upper bound): per sigma of radius
    r, the horizontal pass 80 columns x 32 rows x (2r + 1) taps per tile;
    the vertical pass 66 + 2r columns x 32 rows per tile ("slab"), or 64
    m + 2 + 2r columns per cluster of ``cluster`` tiles of which m have
    cells ("stream")."""
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.scalespace import kernel_radius

    taps = [2 * kernel_radius(s) + 1 for s in spec.blur_sigmas]
    tpr = fl.tiles_per_row(DB)
    vert = horiz = 0
    for ti in range(fl.row_tiles(N)):
        r0 = ti * fl.TILE_ROWS
        with_cells = min(tpr, -(-(N - r0) // fl.TILE_COLS))
        horiz += with_cells * 80 * 32 * sum(taps)
        if mode == "slab":
            vert += with_cells * 32 * sum((65 + t) * t for t in taps)
            continue
        for k0 in range(0, with_cells, cluster):
            m = min(cluster, with_cells - k0)
            vert += 32 * sum((64 * m + 1 + t) * t for t in taps)
    return n_real * (vert + horiz)


def blur_only(cs, taps, spec, valid):
    """cuDNN's two-pass blur of every real block, all octaves (allow_tf32
    off): the yardstick for the blur part alone."""
    from mustache_tpu_torch.kernels.fused_ladder import (
        BLURS_PER_OCTAVE, _blur_octave, _symmetric_pad,
    )
    N = cs.shape[-1]
    for b in range(cs.shape[0]):
        if valid[b]:
            cpad = _symmetric_pad(cs[b], spec.radius)
            for o in range(len(spec.octave_values)):
                _blur_octave(cpad, taps[o * BLURS_PER_OCTAVE:
                                        (o + 1) * BLURS_PER_OCTAVE], N)


def hold_to_plain(tag, label, cs, nzf, slices, valid_list, spec, taps,
                  radii, d_px, DB):
    """The kernel against its plain version on one batch: two launches
    bit-identical, pad slots empty, band_sig equal on the support (a
    mismatch must be an f32 near-tie and sit on no significant candidate),
    the significant candidates of every real slot equal, band_v / locs /
    sums within RTOL. Returns (max abs err of band_v, of locs, max rel err
    of sums, significant candidates, the launch's keyword arguments)."""
    from mustache_tpu_torch.detect import _detect_one
    from mustache_tpu_torch.kernels import fused_ladder as fl

    N = cs.shape[-1]
    valid = torch.tensor(valid_list, dtype=torch.int32, device=cs.device)
    kw = dict(R=spec.radius, n_octaves=len(spec.octave_values),
              planes_per_octave=spec.planes_per_octave, DB=DB, valid=valid)
    got = fl.fused_ladder_nms_batched(cs, nzf, taps, radii=radii, **kw)
    again = fl.fused_ladder_nms_batched(cs, nzf, taps, radii=radii, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{label}: two launches differ")
    del again
    want = fl.fused_ladder_nms_reference(cs, nzf, taps, **kw)
    torch.cuda.synchronize()
    gv, gs, gl, gsum = got
    wv, ws, wl, wsum = want

    # pad slots: empty state, zero partials
    for b, ok in enumerate(valid_list):
        if not ok and not ((gv[b] == 0).all() and (gs[b] == -1).all()
                           and (gl[b] == 0).all() and (gsum[b] == 0).all()):
            fail(f"{label}: pad slot {b} not empty")
    sup = band_support(nzf * valid[:, None, None], DB)
    mism = (gs != ws) & sup
    n_mis = int(mism.sum())
    say(f"[{tag}] {label} N={N} DB={DB} R={spec.radius} B={len(valid_list)}: "
        f"support cells {int(sup.sum())}, detections {int((ws >= 0).sum())}, "
        f"band_sig mismatches {n_mis}")
    if int(((gs != ws) & ~sup).sum()):
        fail(f"{label}: band_sig differs off the support")

    # candidates with q < pt from both states must agree; no mismatch
    # may sit on one
    K = 8192
    st = float(np.float32(ST))
    lp = float(np.float32(math.log(PT)))
    n_sig = 0
    for b in [b for b, ok in enumerate(valid_list) if ok]:
        outs = [_detect_one(tuple(a[b] for a in state), slices[b],
                            det_ceil=spec.det_ceil, d_px=d_px, K=K,
                            st=st, log_pt=lp)
                for state in (got, want)]
        sets = []
        for o in outs:
            if int(o["sig_count"]) > K:
                fail(f"{label}: sig_count {int(o['sig_count'])} > {K}")
            ok = o["cand_valid"].cpu().numpy()
            xs, ys = o["cand_x"].cpu().numpy(), o["cand_y"].cpu().numpy()
            sg = o["cand_sigidx"].cpu().numpy()
            q = o["cand_logq"].cpu().numpy()
            sets.append({(int(a), int(c), int(s)): float(lq) for a, c, s,
                         lq, k in zip(xs, ys, sg, q, ok) if k})
        if set(sets[0]) != set(sets[1]):
            fail(f"{label} slot {b}: significant candidates differ")
        for key, lq in sets[1].items():
            if not math.isclose(sets[0][key], lq, rel_tol=RTOL,
                                abs_tol=1e-4):
                fail(f"{label} slot {b}: log q {sets[0][key]} vs {lq}")
        n_sig += len(sets[1])
        cells = {(x, y) for x, y, _ in sets[1]}
        mb = mism[b].nonzero().cpu().numpy()
        cs_b = cs[b].cpu().numpy() if len(mb) else None
        for i, d in mb[:200]:
            if (int(i), int(i + d)) in cells:
                fail(f"{label} slot {b}: mismatch on a significant "
                     f"candidate at ({i}, {i + d})")
            m = near_tie(cs_b, int(i), int(i + d), spec)
            if m > NEAR_TIE:
                fail(f"{label} slot {b}: mismatch at ({i}, {i + d}) is "
                     f"no near-tie (margin {m:.3g})")
        if len(mb) > 200:
            fail(f"{label} slot {b}: {len(mb)} band_sig mismatches")

    for name, a, w in (("band_v", gv, wv), ("locs", gl, wl),
                       ("sums", gsum, wsum)):
        if not torch.allclose(a, w, rtol=RTOL, atol=1e-6):
            fail(f"{label}: {name} max abs err "
                 f"{float((a - w).abs().max())}")
    err = float((gv - wv).abs().max())
    locs_err = float((gl - wl).abs().max())
    sums_rel = float(((gsum - wsum).abs()
                      / wsum.abs().clamp(min=1e-30)).max())
    return err, locs_err, sums_rel, n_sig, kw


@contextlib.contextmanager
def streamed_mode():
    """The fused kernel in its streamed mode whatever the ladder, for the
    check that the two modes give the same bits; never a path of the
    program."""
    from mustache_tpu_torch.kernels import fused_ladder as fl

    saved = fl.ladder_mode
    fl.ladder_mode = lambda R, n_octaves: "stream"
    try:
        yield
    finally:
        fl.ladder_mode = saved


def phase_kernel_vs_plain(dev):
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.scalespace import (
        build_ladder, ladder_tensor, radii_tensor,
    )

    report = {}
    for label, N, d_px, res, n_bins, starts, octaves in SHAPES:
        spec = build_ladder(octaves)
        taps = ladder_tensor(spec.kernels, dev)
        radii = radii_tensor(spec.blur_sigmas, dev)
        DB = band_width(N, d_px)
        cs, nzf, slices = synthetic_blocks(dev, N, d_px, res, n_bins, starts,
                                           seed=7)
        R, n_oct = spec.radius, len(octaves)
        mode = fl.ladder_mode(R, n_oct)
        cluster = fl.CLUSTER if mode == "stream" else 1
        ctas, clusters = fl.occupancy(R, n_oct, dev)
        say(f"[3] {label}: octaves {octaves}, R={R}, mode {mode}, "
            f"{fl.smem_bytes(R, n_oct)} B of shared memory a CTA, cluster "
            f"{cluster}, {ctas} CTAs per SM, {clusters} clusters resident "
            f"(cudaOccupancyMaxActiveClusters)")
        err, locs_err, sums_rel, n_sig, kw = hold_to_plain(
            "3", label, cs, nzf, slices, VALID, spec, taps, radii, d_px, DB)
        ms = cuda_ms(lambda: fl.fused_ladder_nms_batched(
            cs, nzf, taps, radii=radii, **kw), reps=10)
        stream_ms = None
        if label in BOTH_MODES:
            want = fl.fused_ladder_nms_batched(cs, nzf, taps, radii=radii,
                                               **kw)
            with streamed_mode():
                got = fl.fused_ladder_nms_batched(cs, nzf, taps,
                                                  radii=radii, **kw)
                torch.cuda.synchronize()
                stream_ms = cuda_ms(lambda: fl.fused_ladder_nms_batched(
                    cs, nzf, taps, radii=radii, **kw), reps=10)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"{label}: the streamed mode differs from the slab "
                     f"mode")
            # the blocks cut to N - 2 rows and columns (N % 4 != 0): the
            # streamed mode's slab copies all take the cp.async path
            cut = [t[:, :N - 2, :N - 2].contiguous() for t in (cs, nzf)]
            want = fl.fused_ladder_nms_batched(*cut, taps, radii=radii, **kw)
            with streamed_mode():
                got = fl.fused_ladder_nms_batched(*cut, taps, radii=radii,
                                                  **kw)
                torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"{label}: the streamed mode differs from the slab "
                     f"mode at N = {N - 2}")
            del got, want, cut
            say(f"[3] {label}: streamed mode "
                f"({fl.smem_bytes(R, n_oct, 'stream')} B, cluster "
                f"{fl.CLUSTER}) bit-identical to "
                f"the slab mode, also at N = {N - 2}; {stream_ms:.4f} ms "
                f"against the slab mode's {ms:.4f} ms")
        plain_ms = cuda_ms(
            lambda: fl.fused_ladder_nms_reference(cs, nzf, taps, **kw), reps=2)
        blur_ms = cuda_ms(lambda: blur_only(cs, taps, spec, VALID), reps=3)
        flop, nbytes, bound_ms, bound_by = kernel_bound(
            spec, N, DB, sum(VALID))
        fma_ratio = executed_fmas(spec, N, DB, sum(VALID), mode,
                                  cluster) / (flop / 2)
        say(f"[3] {label}: counted from the kernel's geometry, not "
            f"measured: its passes execute at most {fma_ratio:.3f} times "
            f"the FMAs the band cells need (every tile with cells counted "
            f"as having support)")
        say(f"[3] {label}: significant candidates {n_sig} equal; band_v max "
            f"abs err {err:.3g}, locs {locs_err:.3g}, sums rel "
            f"{sums_rel:.3g}; two launches bit-identical")
        say(f"[3] {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"cuDNN blur only {blur_ms:.3f} ms (B=4, one pad slot); "
            f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
            f"{bound_ms:.4f} ms ({bound_by}), share of bound "
            f"{bound_ms / ms:.3f}, {flop / ms / 1e9:.2f} TFLOP/s")
        report[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             blur_ms=blur_ms, bound_ms=bound_ms,
                             bound_by=bound_by, share=bound_ms / ms,
                             mode=mode, stream_ms=stream_ms,
                             ctas_per_sm=ctas, max_clusters=clusters)
        del cs, nzf, slices
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def read_tsv(path):
    with open(path) as fh:
        header = fh.readline()
        rows = [ln.rstrip("\n").split("\t") for ln in fh if ln.strip()]
    return header, rows


def compare_to_golden(rows, golden, allow=None, tag="4"):
    """Rows equal in order: anchors and scale strings exact, q within
    RTOL; a row present on one side only must have q within RTOL of pt,
    or pass ``allow(row)`` where the caller gives one."""
    def strip(rs, other):
        keys = {tuple(r[:6]) for r in other}
        kept = []
        for r in rs:
            if tuple(r[:6]) not in keys:
                if math.isclose(float(r[6]), PT, rel_tol=RTOL):
                    say(f"[{tag}] near-pt row on one side only: {r}")
                elif allow is not None and allow(r):
                    say(f"[{tag}] near-tie row on one side only: {r}")
                else:
                    fail(f"row {r[:6]} q={r[6]} only on one side")
                continue
            kept.append(r)
        return kept

    a, b = strip(rows, golden), strip(golden, rows)
    if len(a) != len(b):
        fail(f"{len(a)} vs {len(b)} common rows")
    worst = 0.0
    for r, g in zip(a, b):
        if r[:6] != g[:6] or r[7] != g[7]:
            fail(f"row {r} != golden {g}")
        qr, qg = float(r[6]), float(g[6])
        if not (math.isfinite(qr) and 0 < qr < PT):
            fail(f"q out of range in {r}")
        worst = max(worst, abs(qr - qg) / qg)
        if worst > RTOL:
            fail(f"q {qr} vs golden {qg}")
    return len(a), worst


def workload(spec):
    from synthetic import synthetic_hic

    args, kw = spec
    x, y, v, _ = synthetic_hic(*args, **kw)
    return x, y, v


def phase_end_to_end():
    from mustache_tpu_torch import DetectionConfig, detect_loops_coo, write_loops
    from mustache_tpu_torch.kernels import fused_ladder as fl

    x, y, v = workload(CHR21)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                          st=ST, precision="float32")

    logs = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops = detect_loops_coo(x, y, v, cfg, log=logs.append)  # the card
        torch.cuda.synchronize()
        return loops, time.perf_counter() - t0

    fl.LAUNCHES = 0
    loops, cold = run()
    launches = fl.LAUNCHES
    say(f"[4] {logs[0]}")
    if "device=cuda" not in logs[0]:
        fail("detect_loops_coo without a device did not run on the card")
    if launches <= 0:
        fail("the main path did not launch the fused kernel")
    warm = []
    for _ in range(3):
        again, dt = run()
        warm.append(dt)
        if again != loops:
            fail("warm rerun gave other loops")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "loops.tsv")
        write_loops(out, [("chr21", "chr21", cfg.resolution, loops)])
        header, rows = read_tsv(out)
    gheader, golden = read_tsv(GOLDEN)
    if header != gheader or not rows:
        fail("bad TSV header or no loops")
    n_common, worst = compare_to_golden(rows, golden)
    say(f"[4] chr21 5kb: {len(rows)} loops ({len(golden)} golden, "
        f"{n_common} common rows equal, q max rel err {worst:.3g}); kernel "
        f"launches {launches}; wall cold {cold:.3f} s, warm "
        f"{' '.join(f'{w:.3f}' for w in warm)} s (median "
        f"{sorted(warm)[1]:.3f})")
    return launches, loops, sorted(warm)[1]


# ---------------------------------------------------------------------------
# phases 5 and 6
# ---------------------------------------------------------------------------

def write_text_contacts(path, x, y, v, res, chrom):
    """5-column text contact file (chrom mid1 chrom mid2 count), counts
    written with repr so they read back exactly; written in chunks."""
    with open(path, "w") as fh:
        step = 1 << 20
        for i in range(0, len(v), step):
            sl = slice(i, i + step)
            fh.write("".join(
                f"{chrom}\t{a}\t{chrom}\t{b}\t{c!r}\n" for a, b, c in zip(
                    (x[sl] * res).tolist(), (y[sl] * res).tolist(),
                    v[sl].tolist())))


def write_hic_contacts(path, x, y, v, res, chrom, n_bins):
    """Version 8 ``.hic`` of one chromosome (float32 counts) with a KR
    vector of ones, so the CLI's default normalization leaves v as is."""
    from hic_writer import write_hic

    write_hic(path, [(chrom, n_bins * res)], res, {chrom: (x, y, v)},
              version=8, norms={("KR", chrom): np.ones(n_bins)})


def run_cli(argv, cli_main=None):
    """``mustache_tpu_torch.cli.main(argv)`` (or ``cli_main``) with the JSON
    event log captured: (exit code, events, wall seconds)."""
    if cli_main is None:
        from mustache_tpu_torch.cli import main as cli_main

    err = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv + ["--engine-json-log"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [json.loads(ln) for ln in err.getvalue().splitlines()
              if ln.startswith("{")]
    return rc, events, wall


def event(events, kind):
    found = [e for e in events if e["event"] == kind]
    if len(found) != 1:
        fail(f"expected one {kind!r} event, got {len(found)}")
    return found[0]


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn`` (which ends in a synchronize where it
    touches the card) over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def upload_ms(band, exc, dev) -> float:
    """ms of one band upload (pinned staging + H2D) plus its padded
    exception list, until the card has it."""
    from mustache_tpu_torch.bandnorm import pad_exceptions
    from mustache_tpu_torch.sharding import upload_band

    def go():
        upload_band(band, dev)
        if exc is not None:
            [torch.as_tensor(e, device=dev)
             for e in pad_exceptions(exc, band.shape[0])]
        torch.cuda.synchronize()
    return host_ms(go, reps=5)


def trace_device_time(trace_dir):
    """Device time in the torch.profiler trace(s) under ``trace_dir``:
    (ms by category -- kernel, memcpy, memset --, the 8 kernels with the
    most time as (name, ms, calls))."""
    by_cat, by_name = {}, {}
    for name in os.listdir(trace_dir):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(trace_dir, name)) as fh:
            trace = json.load(fh)
        for ev in trace.get("traceEvents", []):
            cat = ev.get("cat", "")
            if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
                continue
            ms = ev.get("dur", 0) / 1e3
            by_cat[cat] = by_cat.get(cat, 0.0) + ms
            if cat == "kernel":
                t, n = by_name.get(ev["name"], (0.0, 0))
                by_name[ev["name"]] = (t + ms, n + 1)
    top = sorted(((k, t, n) for k, (t, n) in by_name.items()),
                 key=lambda r: -r[1])[:8]
    return by_cat, top


def check_band_equal(got, want, label):
    """Fail unless two device bands are equal bit for bit."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: band {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if diff:
        fail(f"{label}: {diff} band cells differ from the f32 band")


def phase_fill_and_h2d(dev, x, y, v, shape, label):
    """Host band fill and H2D at one workload: the numpy f32 fill (the
    port's first fill) and the numpy twins of the compact fill against the
    native compact fill; the f32 band's upload against the compact
    band's."""
    from mustache_tpu_torch.io import native
    from mustache_tpu_torch.pipeline import fill_raw_band_compact

    def numpy_f32():
        band = np.zeros(shape, np.float32)
        native.fill_band_plain(x, y, v, band)
        return band

    def numpy_compact():
        ne8, _ = native.classify_values_plain(v)
        band = np.zeros(shape, np.uint8)
        return band, native.fill_band_compact_plain(x, y, v, band), ne8

    f32 = numpy_f32()
    band, exc, p4 = fill_raw_band_compact(x, y, v, shape)
    enc = "u4" if p4 else {np.uint8: "u8", np.uint16: "u16"}.get(
        band.dtype.type, "f32")
    n_exc = 0 if exc is None else len(exc[0])
    rep = {
        "fill_numpy_f32_ms": host_ms(numpy_f32, reps=5),
        "fill_numpy_compact_ms": host_ms(numpy_compact, reps=5),
        "fill_native_compact_ms": host_ms(
            lambda: fill_raw_band_compact(x, y, v, shape), reps=5),
        "h2d_f32_bytes": f32.nbytes,
        "h2d_f32_ms": upload_ms(f32, None, dev),
        "encoding": enc,
        "h2d_compact_bytes": band.nbytes + 12 * n_exc,
        "h2d_compact_ms": upload_ms(band, exc, dev),
        "exceptions": n_exc,
    }
    say(f"[{label}] host band fill {shape}: numpy f32 "
        f"{rep['fill_numpy_f32_ms']:.2f} ms, numpy compact twin "
        f"{rep['fill_numpy_compact_ms']:.2f} ms, native compact "
        f"{rep['fill_native_compact_ms']:.2f} ms ({enc}, {n_exc} "
        f"exceptions); H2D f32 {rep['h2d_f32_bytes']} B in "
        f"{rep['h2d_f32_ms']:.3f} ms, {enc} {rep['h2d_compact_bytes']} B in "
        f"{rep['h2d_compact_ms']:.3f} ms")
    return rep


def phase_cli_files(dev, workdir):
    """Phase 5; the contact files it writes stay in ``workdir`` for phase
    8."""
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.io import native
    from mustache_tpu_torch.kernels import fused_ladder as fl

    (n_bins, d_px), _ = CHR21
    x, y, v = workload(CHR21)
    rep = phase_fill_and_h2d(dev, x, y, v, (bucket_rows(n_bins),
                                            band_width(2000, d_px)), "5")
    _, golden = read_tsv(GOLDEN)
    with contextlib.nullcontext(workdir) as tmp:
        paths = {"text": os.path.join(tmp, "chr21.txt"),
                 "hic": os.path.join(tmp, "chr21.hic")}
        t0 = time.perf_counter()
        write_text_contacts(paths["text"], x, y, v, 5000, "chr21")
        t1 = time.perf_counter()
        write_hic_contacts(paths["hic"], x, y, v, 5000, "chr21", n_bins)
        say(f"[5] wrote {len(v)} contacts as text in {t1 - t0:.1f} s and as "
            f".hic v8 in {time.perf_counter() - t1:.1f} s")
        out = os.path.join(tmp, "loops.tsv")
        for label, path in paths.items():
            walls, ingests, detects = [], [], []
            for _ in range(2):
                fl.LAUNCHES = 0
                native.FILLS = 0
                native.DECODES = 0
                rc, events, wall = run_cli(
                    ["-f", path, "-ch", "chr21", "-r", "5kb", "-o", out,
                     "-pt", str(PT), "-st", str(ST)])
                launches, fills = fl.LAUNCHES, native.FILLS
                if label == "hic" and native.DECODES <= 0:
                    fail("CLI on hic: blocks not decoded by the native "
                         "decoder")
                if rc != 0:
                    fail(f"CLI on {label} exited {rc}")
                plan = event(events, "detect_plan")["detail"]
                if "device=cuda" not in plan:
                    fail(f"CLI on {label} did not run on the card: {plan}")
                if "band=u8" not in plan or fills <= 0:
                    fail(f"CLI on {label}: band not sent as u8 by the native "
                         f"fill ({plan}; native fills {fills})")
                if launches <= 0:
                    fail(f"CLI on {label} did not launch the fused kernel")
                header, rows = read_tsv(out)
                n_common, worst = compare_to_golden(rows, golden)
                walls.append(wall)
                ingests.append(event(events, "ingest")["seconds"])
                detects.append(event(events, "detect")["seconds"])
            say(f"[5] CLI {label}: {plan}; {len(rows)} rows, {n_common} equal "
                f"to the golden (q max rel err {worst:.3g}); kernel launches "
                f"{launches}, native fills {fills}; wall {walls[0]:.3f} / "
                f"{walls[1]:.3f} s, ingest {ingests[0]:.3f} / "
                f"{ingests[1]:.3f} s, detect {detects[0]:.3f} / "
                f"{detects[1]:.3f} s")
            rep[f"cli_{label}_wall_s"] = walls[1]
            rep[f"cli_{label}_ingest_s"] = ingests[1]
            rep[f"cli_{label}_detect_s"] = detects[1]
            rep[f"cli_{label}_launches"] = launches

        # one more .hic run with --engine-profile-dir: the device time of
        # the CLI's detect phase, from the trace the flag writes
        prof_dir = os.path.join(tmp, "trace5")
        rc, events, wall = run_cli(
            ["-f", paths["hic"], "-ch", "chr21", "-r", "5kb", "-o", out,
             "-pt", str(PT), "-st", str(ST), "--engine-profile-dir",
             prof_dir])
        if rc != 0:
            fail(f"CLI with --engine-profile-dir exited {rc}")
        by_cat, top = trace_device_time(prof_dir)
        detect_s = event(events, "detect")["seconds"]
        busy = sum(by_cat.values())
        say(f"[5] profiled CLI (.hic): wall {wall:.3f} s, detect "
            f"{detect_s:.3f} s; device time in the trace "
            + (", ".join(f"{k} {v:.2f} ms" for k, v in sorted(by_cat.items()))
               if by_cat else "not measured (no device events)")
            + f"; busy share of detect {busy / 1e3 / detect_s:.3f}")
        for name, ms, calls in top:
            say(f"[5]   {ms:8.3f} ms {calls:5d}x {name[:90]}")
        rep["profile_device_ms"] = by_cat
        rep["profile_detect_s"] = detect_s
    return rep


def phase_1kb(dev):
    from mustache_tpu_torch import DetectionConfig, detect_loops_coo, write_loops
    from mustache_tpu_torch.bandnorm import (
        bucket_rows, pad_exceptions, widen_with_exceptions,
    )
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.io import native
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.pipeline import stream_band_to_device
    from mustache_tpu_torch.sharding import upload_band

    (n_bins, d_px), _ = SLICE_1KB
    t0 = time.perf_counter()
    x, y, v = workload(SLICE_1KB)
    say(f"[6] 1 kb slice: {len(v)} contacts over {n_bins} bins, made in "
        f"{time.perf_counter() - t0:.1f} s")
    shape = (bucket_rows(max(n_bins, 2 * d_px)), band_width(2 * d_px, d_px))
    rep = phase_fill_and_h2d(dev, x, y, v, shape, "6")

    def stream():
        up = stream_band_to_device(x, y, v, shape, dev)
        torch.cuda.synchronize()
        return up
    up = stream()
    if up.slabs != 2 or up.encoding not in ("u8", "u4"):
        fail(f"1 kb band did not stream as u8/u4: {up.describe()}")
    rep["stream_ms"] = host_ms(stream, reps=5)
    rep["stream_encoding"] = up.encoding
    rep["stream_bytes"] = up.nbytes
    f32 = np.zeros(shape, np.float32)
    native.fill_band(x, y, v, f32)
    pad = (None if up.exceptions is None
           else pad_exceptions(up.exceptions, shape[0]))
    check_band_equal(widen_with_exceptions(up.band, pad, up.packed4),
                     upload_band(f32, dev), "1 kb streamed band")
    say(f"[6] streamed upload: {up.describe()}, {rep['stream_ms']:.2f} ms "
        f"(census, fill, pack and H2D); widened band equals the f32 band "
        f"({f32.nbytes} B) bit for bit")
    del up, f32
    torch.cuda.empty_cache()

    cfg = DetectionConfig(resolution=1000, distance_bp=d_px * 1000, pt=PT,
                          st=ST)
    logs = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops = detect_loops_coo(x, y, v, cfg, log=logs.append)  # the card
        torch.cuda.synchronize()
        return loops, time.perf_counter() - t0

    fl.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    loops, cold = run()
    launches = fl.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if "device=cuda" not in logs[0] or launches <= 0:
        fail(f"1 kb detect_loops_coo did not run the kernel on the card: "
             f"{logs[0]}, launches {launches}")
    warm = []
    for _ in range(2):
        again, dt = run()
        warm.append(dt)
        if again != loops:
            fail("1 kb warm rerun gave other loops")
    with tempfile.TemporaryDirectory() as tmp:
        direct = os.path.join(tmp, "direct.tsv")
        write_loops(direct, [("chr1", "chr1", 1000, loops)])
        _, rows = read_tsv(direct)
        if not rows:
            fail("no loops at 1 kb")
        golden_note = "no 1 kb golden in the tree"
        if os.path.exists(GOLDEN_1KB):
            n_common, worst = compare_to_golden(rows, read_tsv(GOLDEN_1KB)[1])
            golden_note = (f"{n_common} rows equal to the 1 kb golden (q max "
                           f"rel err {worst:.3g})")
        say(f"[6] {logs[0]}")
        say(f"[6] detect_loops_coo 1 kb: {len(loops)} loops, {golden_note}; "
            f"kernel launches {launches}; wall cold {cold:.3f} s, warm "
            f"{warm[0]:.3f} / {warm[1]:.3f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB")

        txt = os.path.join(tmp, "chr1_1kb.txt")
        t0 = time.perf_counter()
        write_text_contacts(txt, x, y, v, 1000, "chr1")
        t_write = time.perf_counter() - t0
        fl.LAUNCHES = 0
        out = os.path.join(tmp, "cli.tsv")
        rc, events, wall = run_cli(["-f", txt, "-ch", "chr1", "-r", "1kb",
                                    "-o", out, "-pt", str(PT), "-st",
                                    str(ST)])
        cli_launches = fl.LAUNCHES
        if rc != 0 or cli_launches <= 0:
            fail(f"1 kb CLI exited {rc}, kernel launches {cli_launches}")
        if read_tsv(out) != read_tsv(direct):
            fail("1 kb CLI TSV differs from detect_loops_coo's")
        ingest = event(events, "ingest")["seconds"]
        detect = event(events, "detect")["seconds"]
        say(f"[6] CLI 1 kb from text ({t_write:.1f} s to write): TSV equals "
            f"the direct call's; {event(events, 'detect_plan')['detail']}; "
            f"wall {wall:.3f} s, ingest {ingest:.3f} s, detect {detect:.3f} s,"
            f" kernel launches {cli_launches}")
    rep.update(detect_1kb_warm_s=min(warm), detect_1kb_cold_s=cold,
               loops_1kb=len(loops), launches_1kb=launches,
               peak_mem_1kb_gib=peak / 2**30, cli_1kb_wall_s=wall,
               cli_1kb_ingest_s=ingest, cli_1kb_detect_s=detect)
    return rep


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

def diff_tsv_rows(rows, chrom, res):
    """Differential rows ``(bin1, bin2, q, scale, tag)`` as TSV fields, the
    way the diff golden and the diff CLI's files write them (plus the
    tag)."""
    return [[chrom, str(b1 * res), str((b1 + 1) * res), chrom, str(b2 * res),
             str((b2 + 1) * res), f"{q}", f"{scale}", str(tag)]
            for b1, b2, q, scale, tag in rows]


def compare_diff_to_golden(rows, golden, tie):
    """Per tag, rows equal in order as :func:`compare_to_golden` holds
    them. A differential row (tag 2 or 4) may sit on one side only where
    ``tie(row)`` says the port's own differential call was a near-tie.
    Returns (common rows, q max rel err)."""
    n_common, worst = 0, 0.0
    for t in "1234":
        a = [r for r in rows if r[8] == t]
        g = [r for r in golden if r[8] == t]
        n, w = compare_to_golden(a, g, allow=tie if t in "24" else None,
                                 tag="7")
        n_common += n
        worst = max(worst, w)
    return n_common, worst


def diff_near_tie(pair, nv1, nv2) -> bool:
    """A differential call ``pair < pt2 and own_v > other_v`` that f32 may
    decide either way: pair within rtol 2e-3 of pt2 (the JAX package's own
    ``neigh_pair`` tolerance) or the two responses within rtol 2e-4."""
    return (abs(pair - PT2) <= 2e-3 * PT2
            or abs(nv1 - nv2) <= RTOL * max(abs(nv1), abs(nv2)))


def make_diff_tie(det, band1, band2, starts, res):
    """``tie(row)`` for :func:`compare_diff_to_golden`: re-detects the
    blocks that hold a one-sided differential row (TSV fields, tag in the
    last) through ``det`` on the two bands, and says whether the port's own
    call at the row's representative pixel was a :func:`diff_near_tie`."""
    from mustache_tpu_torch.detect import unpack_block
    from mustache_tpu_torch.diff import _finish_map

    N = det.n

    def tie(r):
        b1, b2 = int(r[1]) // res, int(r[4]) // res
        m = "1" if r[8] in "12" else "2"
        for s in starts:
            if not (s <= b1 < s + N and s <= b2 < s + N):
                continue
            out = unpack_block(det.out_spec, det.fn_band_packed(
                band1, band2, [s]).cpu().numpy()[0])
            for row, (pair, nv1, nv2) in _finish_map(
                    out, m, start=s, spec=det.spec)[1] or []:
                if row[:2] == [b1, b2]:
                    say(f"[7] row {r[:6]} tag {r[8]}: port pair {pair!r}, "
                        f"v1 {nv1!r}, v2 {nv2!r}")
                    if diff_near_tie(pair, nv1, nv2):
                        return True
        return False
    return tie


def stacked_blocks(band1, band2, starts, N, d_px):
    """The stacked [2B] batch DiffBlockDetector.fn_band builds: condition
    1's blocks, then condition 2's, sentinel-filled, with their support
    and band slices."""
    from mustache_tpu_torch.detect import _preamble, dense_from_band

    slices = torch.stack([b[max(s, 0): max(s, 0) + N]
                          for b in (band1, band2) for s in starts])
    cs, nz = _preamble(dense_from_band(slices), d_px)
    return cs, nz.to(torch.float32), slices


def trace_range_time(trace_dir, names):
    """Device ms of the kernels launched inside each named profiler range
    (``record_function``), from the Chrome trace(s) under ``trace_dir``:
    a kernel belongs to the range whose CPU span holds its launch (the
    runtime call with the kernel's correlation id). Each kernel counts
    once; idle gaps inside a range count for nothing."""
    spans, launches, kernels = [], {}, []
    for name in os.listdir(trace_dir):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(trace_dir, name)) as fh:
            trace = json.load(fh)
        for ev in trace.get("traceEvents", []):
            cat = ev.get("cat", "")
            corr = ev.get("args", {}).get("correlation")
            if cat == "user_annotation" and ev.get("name") in names:
                spans.append((ev["name"], ev["ts"], ev["ts"] + ev["dur"]))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ev["ts"]
            elif cat == "kernel" and corr is not None:
                kernels.append((corr, ev.get("dur", 0) / 1e3))
    out = {k: 0.0 for k in names}
    for corr, ms in kernels:
        t = launches.get(corr)
        for name, t0, t1 in spans:
            if t is not None and t0 <= t <= t1:
                out[name] += ms
                break
    return out


def profile_ranges(fn, names):
    """One profiled run of ``fn``: device ms of the kernels launched in
    each named profiler range, the run's kernel ms and its top kernels,
    all from the Chrome trace (:func:`trace_range_time`,
    :func:`trace_device_time`); None and [] where the trace holds no
    device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        by_cat, top = trace_device_time(tmp)
        ranges = trace_range_time(tmp, names)
    kernel_ms = by_cat.get("kernel", 0.0)
    if kernel_ms <= 0:
        return None, None, []
    return ranges, kernel_ms, top


def stacked_report(tag, det, band1, band2, start, d_px):
    """The diff path's fused launches on the card: the stacked batch with
    a pad slot per condition (``DIFF_STARTS``: slots 2 and 5) held to the
    plain version under phase 3's rule, then the main path's launch of
    every block of both conditions (2B slots) timed beside its plain
    version, cuDNN's blur of the same blocks and its FP32 bound, and the
    difference planes timed."""
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.diff import diff_p_band, diff_planes
    from mustache_tpu_torch.kernels import fused_ladder as fl

    spec, N = det.spec, det.n
    DB = band_width(N, d_px)
    dev = band1.device
    cs, nzf, slices = stacked_blocks(band1, band2, DIFF_STARTS, N, d_px)
    err, locs_err, sums_rel, n_sig, _ = hold_to_plain(
        tag, "diff stacked", cs, nzf, slices,
        [int(s >= 0) for s in DIFF_STARTS] * 2, spec, det.taps, det.radii,
        d_px, DB)
    say(f"[{tag}] stacked [2B] batch, pads at slots 2 and 5: significant "
        f"candidates {n_sig} equal; band_v max abs err {err:.3g}, locs "
        f"{locs_err:.3g}, sums rel {sums_rel:.3g}")
    del cs, nzf, slices

    # the main path's launch: every block of both conditions, 2B slots
    B = len(start)
    cs, nzf, slices = stacked_blocks(band1, band2, start, N, d_px)
    kw = dict(R=spec.radius, n_octaves=len(spec.octave_values),
              planes_per_octave=spec.planes_per_octave, DB=DB,
              valid=torch.ones(2 * B, dtype=torch.int32, device=dev))
    ms = cuda_ms(lambda: fl.fused_ladder_nms_batched(
        cs, nzf, det.taps, radii=det.radii, **kw), reps=10)
    plain_ms = cuda_ms(
        lambda: fl.fused_ladder_nms_reference(cs, nzf, det.taps, **kw), reps=1)
    blur_ms = cuda_ms(lambda: blur_only(cs, det.taps, spec, [1] * (2 * B)),
                      reps=2)
    flop, _, bound_ms, bound_by = kernel_bound(spec, N, DB, 2 * B)
    nz = nzf > 0.5
    planes_ms = cuda_ms(lambda: diff_p_band(
        cs[:B], cs[B:], nz[:B], nz[B:], det.taps[diff_planes(spec)],
        R=spec.radius, Dl=DB, valid=[1] * B), reps=3)
    say(f"[{tag}] stacked launch of the main path ({2 * B} slots): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, cuDNN blur only "
        f"{blur_ms:.3f} ms; {flop / 1e9:.3f} GFLOP -> "
        f"bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}; "
        f"difference planes (4 blurs + p, {B} blocks) {planes_ms:.3f} ms")
    del cs, nzf, slices, nz
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, blur_ms=blur_ms,
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                planes_ms=planes_ms)


def phase_diff(dev):
    from mustache_tpu_torch import DetectionConfig, detect_diff_loops_coo
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.diff import build_diff_detector
    from mustache_tpu_torch.diff_cli import SUFFIXES, main as diff_main
    from mustache_tpu_torch.pipeline import local_runner
    from mustache_tpu_torch.kernels import fused_ladder as fl

    t_phase = time.perf_counter()
    (n_bins, _), _ = CHR21
    x1, y1, v1 = workload(CHR21)
    x2, y2, v2 = workload(CHR21_COND2)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                          st=ST, pt2=PT2)
    d_px, N = cfg.distance_px, cfg.chunk_size
    band1, band2, n = diff_bands(x1, y1, v1, x2, y2, v2, cfg,
                                 local_runner(dev))
    det = build_diff_detector(cfg, N, device=dev)
    start, _ = chunk_grid(n, N, d_px)

    k = stacked_report("7", det, band1, band2, start, d_px)

    # detect_diff_loops_coo with no device: the card, against the golden
    logs = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, cfg,
                                     log=logs.append)      # the card
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    fl.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    rows, cold = run()
    launches = fl.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if "device=cuda" not in logs[0] or launches <= 0:
        fail(f"detect_diff_loops_coo did not run the kernel on the card: "
             f"{logs[0]}, launches {launches}")
    warm = []
    for _ in range(3):
        again, dt = run()
        warm.append(dt)
        if again != rows:
            fail("diff warm rerun gave other rows")
    names = ("diff.preamble", "diff.fused_ladder", "diff.planes",
             "diff.epilogue")
    ranges, busy, top = profile_ranges(run, names)

    tie = make_diff_tie(det, band1, band2, start, cfg.resolution)
    got = diff_tsv_rows(rows, "chr21", cfg.resolution)
    _, golden = read_tsv(GOLDEN_DIFF)
    n_common, worst = compare_diff_to_golden(got, golden, tie)
    counts = {t: sum(r[8] == t for r in got) for t in "1234"}
    say(f"[7] {logs[0]}")
    say(f"[7] detect_diff_loops_coo chr21 5 kb, two conditions: {len(got)} "
        f"rows (tags 1-4: {counts['1']}, {counts['2']}, {counts['3']}, "
        f"{counts['4']}; golden {len(golden)}), {n_common} equal to the "
        f"golden (q max rel err {worst:.3g}); kernel launches {launches}; "
        f"wall cold {cold:.3f} s, warm "
        f"{' '.join(f'{w:.3f}' for w in warm)} s (median "
        f"{sorted(warm)[1]:.3f}); peak device memory {peak / 2**30:.2f} GiB")
    if ranges is None:
        say("[7] profiled run: not measured (no device time in the trace)")
    else:
        say(f"[7] profiled run: {busy:.2f} ms of kernels; "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in ranges.items()))
        for name, kms, calls in top:
            say(f"[7]   {kms:8.3f} ms {calls:5d}x {name[:90]}")

    # the diff CLI with no platform flag, from two .hic files
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"cond{m}.hic") for m in (1, 2)]
        t0 = time.perf_counter()
        for path, (x, y, v) in zip(paths, ((x1, y1, v1), (x2, y2, v2))):
            write_hic_contacts(path, x, y, v, 5000, "chr21", n_bins)
        t_write = time.perf_counter() - t0
        prefix = os.path.join(tmp, "diff")
        fl.LAUNCHES = 0
        rc, events, wall = run_cli(
            ["-f1", paths[0], "-f2", paths[1], "-ch", "chr21", "-r", "5kb",
             "-o", prefix, "-pt", str(PT), "-st", str(ST), "-pt2", str(PT2)],
            diff_main)
        cli_launches = fl.LAUNCHES
        if rc != 0 or cli_launches <= 0:
            fail(f"diff CLI exited {rc}, kernel launches {cli_launches}")
        plan = event(events, "detect_plan")["detail"]
        if "device=cuda" not in plan:
            fail(f"diff CLI did not run on the card: {plan}")
        for t, sfx in SUFFIXES.items():
            header, file_rows = read_tsv(prefix + sfx)
            want = [r[:8] for r in got if r[8] == str(t)]
            if not header.startswith("BIN1_CHR") or file_rows != want:
                fail(f"diff CLI {sfx}: {len(file_rows)} rows differ from "
                     f"the direct call's {len(want)}")
        ingest = event(events, "ingest")["seconds"]
        detect = event(events, "detect")["seconds"]
    say(f"[7] diff CLI from two .hic ({t_write:.1f} s to write): four files "
        f"equal the direct call's rows; {plan}; wall {wall:.3f} s, ingest "
        f"{ingest:.3f} s, detect {detect:.3f} s, kernel launches "
        f"{cli_launches}; phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches_diff=launches, ms_diff_stacked=k["ms"],
                plain_ms_diff_stacked=k["plain_ms"],
                bound_ms_diff_stacked=k["bound_ms"],
                blur_ms_diff_stacked=k["blur_ms"],
                max_abs_err_diff=k["max_abs_err"],
                diff_planes_ms=k["planes_ms"], diff_cold_s=cold,
                diff_warm_s=sorted(warm)[1], diff_peak_mem_gib=peak / 2**30,
                diff_profile_ms=ranges, diff_profile_kernel_ms=busy,
                diff_rows=len(got), cli_diff_wall_s=wall,
                cli_diff_ingest_s=ingest, cli_diff_detect_s=detect,
                cli_diff_launches=cli_launches), rows


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

F64_RTOL = 1e-9       # float64 against the JAX package's float64 golden


def compare_exact(rows, golden, label, ncols=8, rtol=F64_RTOL):
    """Rows equal in order, every field but q exact, q within ``rtol``;
    returns the q max rel err."""
    if len(rows) != len(golden):
        fail(f"{label}: {len(rows)} rows, golden {len(golden)}")
    worst = 0.0
    for r, g in zip(rows, golden):
        if r[:6] != g[:6] or r[7:ncols] != g[7:ncols]:
            fail(f"{label}: row {r} != golden {g}")
        qr, qg = float(r[6]), float(g[6])
        worst = max(worst, abs(qr - qg) / qg)
    if worst > rtol:
        fail(f"{label}: q max rel err {worst:.3g} > {rtol}")
    return worst


def loops_tsv_rows(loops, chrom, res):
    """Loop objects as the TSV fields write_loops gives them."""
    return [[chrom, str(lp.bin1 * res), str((lp.bin1 + 1) * res), chrom,
             str(lp.bin2 * res), str((lp.bin2 + 1) * res), f"{lp.q}",
             f"{lp.scale}"] for lp in loops]


def timed_runs(fn, n_warm=3):
    """(result, cold wall, warm walls, peak device memory) of ``fn``, the
    card synchronized around each call; the later results must equal the
    first."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(n_warm):
        t0 = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again != first:
            fail("a warm rerun gave other rows")
    return first, cold, warm, torch.cuda.max_memory_allocated()


@contextlib.contextmanager
def plain_kernel_route():
    """Every configuration on the kernel route, and the kernel route on the
    fused kernel's plain version: the check that holds the ladder route to
    the plain version, never a path of the program."""
    import mustache_tpu_torch.detect as D
    from mustache_tpu_torch.kernels import fused_ladder as fl

    saved = D.resolve_route, fl.fused_ladder_nms_batched

    def plain(cs, nzf, kernels, *, radii=None, **kw):
        return fl.fused_ladder_nms_reference(cs, nzf, kernels, **kw)

    D.resolve_route = lambda cfg: "kernel"
    fl.fused_ladder_nms_batched = plain
    try:
        yield
    finally:
        D.resolve_route, fl.fused_ladder_nms_batched = saved


def phase_ladder_route(dev, workdir):
    """Phase 8: the ladder route and the host normalize on the card."""
    from mustache_tpu_torch import (
        DetectionConfig, detect_diff_loops_coo, detect_loops_coo,
    )
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.detect import (
        _BandGeom, _preamble, _slice_support, band_width, build_detector,
        dense_from_band,
    )
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.ladder import ladder_best
    from mustache_tpu_torch.pipeline import fill_host_band

    rep = {}
    t_phase = time.perf_counter()
    (n_bins, d_px), _ = CHR21
    x, y, v = workload(CHR21)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                          st=ST)
    f64 = cfg.with_(precision="float64")
    _, golden = read_tsv(GOLDEN)
    _, golden64 = read_tsv(GOLDEN_F64)

    # (a) float64 through detect_loops_coo on the card, against the JAX
    # package's float64 golden; the fused kernel must not launch
    logs = []
    fl.LAUNCHES = 0
    loops, cold, warm, peak = timed_runs(
        lambda: detect_loops_coo(x, y, v, f64, log=logs.append))
    if fl.LAUNCHES:
        fail(f"float64 launched the fused kernel {fl.LAUNCHES} times")
    if "device=cuda" not in logs[0] or "route=ladder" not in logs[0]:
        fail(f"float64 did not take the ladder route on the card: {logs[0]}")
    err64 = compare_exact(loops_tsv_rows(loops, "chr21", 5000), golden64,
                          "float64 chr21")
    host_norm_ms = host_ms(lambda: fill_host_band(
        x, y, v, f64, (bucket_rows(n_bins), band_width(2000, d_px)), n_bins,
        normalize=True, exact=False), reps=3)
    names = ("detect.preamble", "ladder.blur", "ladder.scan",
             "detect.epilogue")
    ranges, busy, top = profile_ranges(
        lambda: detect_loops_coo(x, y, v, f64), names)
    say(f"[8] {logs[0]}")
    say(f"[8] float64 chr21 5 kb: {len(loops)} rows equal to the JAX "
        f"float64 golden ({len(golden64)}; q max rel err {err64:.3g}); "
        f"fused kernel launches 0; wall cold {cold:.3f} s, warm "
        f"{' '.join(f'{w:.3f}' for w in warm)} s; peak device memory "
        f"{peak / 2**30:.2f} GiB; host normalize (native, f64 band) "
        f"{host_norm_ms:.1f} ms")
    if ranges is None:
        say("[8] profiled float64 run: not measured (no device time)")
    else:
        say(f"[8] profiled float64 run: {busy:.2f} ms of kernels; "
            + ", ".join(f"{k} {val:.2f} ms" for k, val in ranges.items()))
        for name, kms, calls in top:
            say(f"[8]   {kms:8.3f} ms {calls:5d}x {name[:90]}")
    rep.update(f64_rows=len(loops), f64_q_max_rel_err=err64,
               f64_cold_s=cold, f64_warm_s=sorted(warm)[1],
               f64_peak_mem_gib=peak / 2**30, f64_host_normalize_ms=host_norm_ms,
               f64_profile_ms=ranges, f64_profile_kernel_ms=busy)

    # (b) the CLI at float64 from phase 5's files: the text file holds the
    # counts exactly (repr) and is held to the float64 golden; the v8
    # .hic stores them as float32, so its rows (anchors, scales, order)
    # are exact and q agrees to the float32 rounding of the input
    out = os.path.join(workdir, "loops64.tsv")
    for label, path, rtol in (("text", "chr21.txt", F64_RTOL),
                              ("hic", "chr21.hic", RTOL)):
        fl.LAUNCHES = 0
        rc, events, wall = run_cli(
            ["-f", os.path.join(workdir, path), "-ch", "chr21", "-r", "5kb",
             "-o", out, "-pt", str(PT), "-st", str(ST),
             "--engine-precision", "float64"])
        plan = event(events, "detect_plan")["detail"]
        if rc != 0 or fl.LAUNCHES or "route=ladder" not in plan \
                or "device=cuda" not in plan:
            fail(f"float64 CLI ({label}): rc {rc}, launches {fl.LAUNCHES}, "
                 f"plan {plan}")
        err_cli = compare_exact(read_tsv(out)[1], golden64,
                                f"float64 CLI ({label})", rtol=rtol)
        say(f"[8] CLI --engine-precision float64 from {label}: {plan}; rows "
            f"equal to the float64 golden (q max rel err {err_cli:.3g}, "
            f"held to {rtol:g}); wall {wall:.3f} s, ingest "
            f"{event(events, 'ingest')['seconds']:.3f} s, detect "
            f"{event(events, 'detect')['seconds']:.3f} s")
        rep[f"f64_cli_{label}_wall_s"] = wall
        rep[f"f64_cli_{label}_detect_s"] = event(events, "detect")["seconds"]

    # (c) float64 differential calling against the JAX float64 diff golden
    x2, y2, v2 = workload(CHR21_COND2)
    dlogs = []
    fl.LAUNCHES = 0
    rows, dcold, dwarm, dpeak = timed_runs(
        lambda: detect_diff_loops_coo(x, y, v, x2, y2, v2,
                                      f64.with_(pt2=PT2), log=dlogs.append),
        n_warm=1)
    if fl.LAUNCHES or "route=ladder" not in dlogs[0]:
        fail(f"float64 diff: launches {fl.LAUNCHES}, plan {dlogs[0]}")
    got = diff_tsv_rows(rows, "chr21", 5000)
    _, gdiff = read_tsv(GOLDEN_DIFF_F64)
    errd = 0.0
    for t in "1234":
        errd = max(errd, compare_exact([r for r in got if r[8] == t],
                                       [r for r in gdiff if r[8] == t],
                                       f"float64 diff tag {t}", ncols=9))
    say(f"[8] {dlogs[0]}")
    say(f"[8] float64 diff chr21 5 kb: {len(got)} rows equal to the JAX "
        f"float64 diff golden per tag (q max rel err {errd:.3g}); wall "
        f"cold {dcold:.3f} s, warm {dwarm[0]:.3f} s; peak device memory "
        f"{dpeak / 2**30:.2f} GiB")
    rep.update(f64_diff_rows=len(got), f64_diff_cold_s=dcold,
               f64_diff_warm_s=dwarm[0], f64_diff_peak_mem_gib=dpeak / 2**30)

    # (d) exact_normalize at float32: host band, the fused kernel once.
    # Its rows are the 290 of the default golden; its q follows the exact
    # normalize, so it is held to the JAX package's exact-normalize golden
    elogs = []
    fl.LAUNCHES = 0
    eloops = detect_loops_coo(x, y, v, cfg, exact_normalize=True,
                              log=elogs.append)
    torch.cuda.synchronize()
    e_launches = fl.LAUNCHES
    if e_launches != 1 or "route=kernel" not in elogs[0] \
            or "host_normalize=exact" not in elogs[0]:
        fail(f"exact_normalize: launches {e_launches}, plan {elogs[0]}")
    erows = loops_tsv_rows(eloops, "chr21", 5000)
    if [r[:6] + r[7:] for r in erows] != [r[:6] + r[7:] for r in golden]:
        fail("exact_normalize: rows differ from the 290-row golden")
    _, golden_exact = read_tsv(GOLDEN_EXACT)
    n_e, err_e = compare_to_golden(erows, golden_exact, tag="8")
    worst_default = max(abs(float(r[6]) - float(g[6])) / float(g[6])
                        for r, g in zip(erows, golden))
    say(f"[8] exact_normalize float32: {elogs[0]}; the 290 golden rows; "
        f"{n_e} equal to the JAX exact-normalize golden (q max rel err "
        f"{err_e:.3g}; {worst_default:.3g} from the default-mode golden); "
        f"fused kernel launches {e_launches}")
    rep.update(exact_launches=e_launches, exact_q_err=err_e,
               exact_q_err_vs_default=worst_default)

    # (e) float32 on the ladder route (use_pallas="off") against the
    # golden, and its time against the kernel route's
    off = cfg.with_(use_pallas="off")
    ologs = []
    fl.LAUNCHES = 0
    oloops, ocold, owarm, opeak = timed_runs(
        lambda: detect_loops_coo(x, y, v, off, log=ologs.append))
    if fl.LAUNCHES or "route=ladder" not in ologs[0]:
        fail(f"use_pallas=off: launches {fl.LAUNCHES}, plan {ologs[0]}")
    n_o, err_o = compare_to_golden(
        loops_tsv_rows(oloops, "chr21", 5000), golden, tag="8")
    _, _, kwarm, _ = timed_runs(lambda: detect_loops_coo(x, y, v, cfg))
    # the two routes' detection state of the same 6 blocks, CUDA events
    det = build_detector(cfg, 2000, device=dev)
    shape = (bucket_rows(n_bins), band_width(2000, d_px))
    band = fill_host_band(x, y, v, cfg, shape, n_bins, normalize=True,
                          exact=False)
    band = torch.as_tensor(band, device=dev)
    from mustache_tpu_torch.config import chunk_grid
    starts, _ = chunk_grid(n_bins, 2000, d_px)
    slices = torch.stack([band[s:s + 2000] for s in starts])
    geom = _BandGeom(2000, d_px, dev)
    nzb, counts, _ = _slice_support(geom, slices, d_px)
    cs, nz = _preamble(dense_from_band(slices), d_px)
    nzf = nz.to(torch.float32)
    spec = det.spec
    kw = dict(R=spec.radius, n_octaves=len(spec.octave_values),
              planes_per_octave=spec.planes_per_octave, DB=geom.Dl)
    kernel_ms = cuda_ms(lambda: fl.fused_ladder_nms_batched(
        cs, nzf, det.taps, radii=det.radii, **kw), reps=10)
    ladder_ms = cuda_ms(lambda: ladder_best(cs, nzb, counts, det.taps, spec,
                                            geom), reps=5)
    taps64 = det.taps.double()
    ladder64_ms = cuda_ms(lambda: ladder_best(
        cs.double(), nzb, counts, taps64, spec, geom), reps=3)
    say(f"[8] use_pallas=off float32: {ologs[0]}; {n_o} rows equal to the "
        f"golden (q max rel err {err_o:.3g}); fused kernel launches 0; "
        f"wall cold {ocold:.3f} s, warm median {sorted(owarm)[1]:.3f} s "
        f"against the kernel route's {sorted(kwarm)[1]:.3f} s; peak device "
        f"memory {opeak / 2**30:.2f} GiB")
    say(f"[8] detection state of the 6 blocks (N=2000, DB={geom.Dl}): fused "
        f"kernel {kernel_ms:.4f} ms, ladder route f32 {ladder_ms:.3f} ms, "
        f"ladder route f64 {ladder64_ms:.3f} ms (CUDA events)")
    rep.update(off_rows=len(oloops), off_warm_s=sorted(owarm)[1],
               kernel_route_warm_s=sorted(kwarm)[1],
               state_kernel_ms=kernel_ms, state_ladder_f32_ms=ladder_ms,
               state_ladder_f64_ms=ladder64_ms)
    del band, slices, nzb, cs, nz, nzf
    torch.cuda.empty_cache()

    # (f) an oversized ladder (sigma0 1.6, 6 octaves: R=220, beyond the
    # JAX package's fused gate) on the ladder route, held to the fused
    # kernel's plain version on the card
    big = cfg.with_(octaves=6)
    R6 = build_detector(big, 2000, device=dev).spec.radius
    blogs = []
    fl.LAUNCHES = 0
    t0 = time.perf_counter()
    bloops = detect_loops_coo(x, y, v, big, log=blogs.append)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    if fl.LAUNCHES or "route=ladder" not in blogs[0]:
        fail(f"6 octaves: launches {fl.LAUNCHES}, plan {blogs[0]}")
    with plain_kernel_route():
        plain_loops = detect_loops_coo(x, y, v, big)
    n_b, err_b = compare_to_golden(
        loops_tsv_rows(bloops, "chr21", 5000),
        loops_tsv_rows(plain_loops, "chr21", 5000), tag="8")
    say(f"[8] sigma0 1.6, 6 octaves (R={R6} > {fl.MAX_RADIUS}, beyond "
        f"the kernel's gate): {blogs[0]}; "
        f"{len(bloops)} rows, {n_b} equal to the plain version's "
        f"({len(plain_loops)}; q max rel err {err_b:.3g}); wall "
        f"{t_big:.3f} s; phase 8 took {time.perf_counter() - t_phase:.1f} s")
    rep.update(oct6_rows=len(bloops), oct6_wall_s=t_big)
    return rep


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

def inter_tsv_rows(rows, c1, c2, res):
    """Inter rows ``[x, y, q, sigma]`` as the TSV fields the CLI writes."""
    from mustache_tpu_torch.pipeline import Loop

    return [Loop(int(r[0]), int(r[1]), float(r[2]), float(r[3]))
            .to_row(c1, c2, res).rstrip("\n").split("\t") for r in rows]


def compare_inter(rows, golden, tag="9"):
    """Rows in order, anchors and scale strings exact, q within RTOL (at
    these q, 1e-27 to 1e-18, that is |log q| within 2e-4: about each f32
    path's distance from float64, which the caller's judge reports); a
    row present on one side only must have q within RTOL of pt. Returns
    (common rows, q max rel err, log q max abs err)."""
    def strip(rs, other):
        keys = {tuple(r[:6]) for r in other}
        kept = []
        for r in rs:
            if tuple(r[:6]) not in keys:
                if not math.isclose(float(r[6]), INTER_PT, rel_tol=RTOL):
                    fail(f"[{tag}] row {r[:6]} q={r[6]} only on one side")
                say(f"[{tag}] near-pt row on one side only: {r}")
                continue
            kept.append(r)
        return kept

    a, b = strip(rows, golden), strip(golden, rows)
    if [r[:6] + r[7:] for r in a] != [r[:6] + r[7:] for r in b]:
        fail(f"[{tag}] rows differ from the golden in anchors, scale or "
             f"order")
    q_err, lq_err = 0.0, 0.0
    for r, g in zip(a, b):
        qr, qg = float(r[6]), float(g[6])
        if abs(qr - qg) > RTOL * qg:
            fail(f"[{tag}] q {qr} vs golden {qg} in {r[:6]}")
        q_err = max(q_err, abs(qr - qg) / qg)
        lq_err = max(lq_err, abs(math.log(qr) - math.log(qg)))
    return len(a), q_err, lq_err


def anchor_census(rows, anchors, cuts1, cuts2) -> dict:
    """How the rows meet the planted anchors: anchors with a row within 2
    bins, anchors with none (and how many of those lie within 3 bins of
    a tile-ownership cut, ``cuts1`` on x and ``cuts2`` on y), rows near
    no anchor, and pairs of rows within 3 bins of each other (a cluster
    two tiles both emitted)."""
    def near(a, b, d):
        return abs(a[0] - b[0]) <= d and abs(a[1] - b[1]) <= d

    def at_cut(a):
        return (min((abs(a[0] - c) for c in cuts1), default=99) <= 3
                or min((abs(a[1] - c) for c in cuts2), default=99) <= 3)
    missed = [a for a in anchors if not any(near(r, a, 2) for r in rows)]
    return {"anchors": len(anchors),
            "recovered": len(anchors) - len(missed),
            "missed": len(missed),
            "missed_at_a_cut": sum(at_cut(a) for a in missed),
            "rows_near_no_anchor": sum(
                not any(near(r, a, 2) for a in anchors) for r in rows),
            "row_pairs_within_3": sum(
                near(rows[i], rows[j], 3) for i in range(len(rows))
                for j in range(i + 1, len(rows)))}


def host_densify_ms(x, y, v, starts1, ends1, starts2, ends2, chunk, dev):
    """The JAX package's tile path (``mustache_tpu/inter.py:339-352``):
    stable x-sort, then every tile densified on the host in numpy and sent
    up; ms until the card holds them all."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    vs = v[order].astype(np.float32)
    row_start = np.searchsorted(xs, np.arange(ends1[-1] + 1))
    tiles = []
    for i in range(len(starts1)):
        p0, p1 = row_start[starts1[i]], row_start[ends1[i]]
        for j in range(len(starts2)):
            cc = np.zeros((chunk, chunk), np.float32)
            sel = (ys[p0:p1] >= starts2[j]) & (ys[p0:p1] < ends2[j])
            cc[xs[p0:p1][sel] - starts1[i], ys[p0:p1][sel] - starts2[j]] = \
                vs[p0:p1][sel]
            tiles.append(torch.from_numpy(cc).to(dev))
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), len(tiles) * chunk * chunk * 4


def tile_peak_bytes(det, src, boxes, chunk):
    """Peak device bytes above the baseline of one ``det.fn`` on the
    tiles ``boxes``."""
    tiles = src.tiles(boxes, chunk)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det.fn(tiles)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del tiles
    torch.cuda.empty_cache()
    return peak


def phase_inter(dev, workdir):
    """Phase 9: inter-chromosomal calling and the native .hic decoder."""
    from mustache_tpu_torch import DetectionConfig
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.inter import (
        OVERLAP, TILE_PLANES, _TileSource, build_inter_detector,
        detect_inter_loops_coo, normalize_inter,
    )
    from mustache_tpu_torch.io import native
    from mustache_tpu_torch.io.hic import HicFile, read_hic_file
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from synthetic import synthetic_hic, synthetic_inter

    rep = {}
    t_phase = time.perf_counter()
    (n1, n2), kw = CHR21_X_22
    x, y, v, anchors = synthetic_inter(n1, n2, **kw)
    say(f"[9] chr21 x chr22 5 kb: {len(v)} contacts over {n1} x {n2} bins, "
        f"made in {time.perf_counter() - t_phase:.1f} s")
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000,
                          pt=INTER_PT, st=INTER_ST)
    chunk = cfg.chunk_size
    s1, e1 = chunk_grid(n1, chunk, OVERLAP)
    s2, e2 = chunk_grid(n2, chunk, OVERLAP)

    # (a) detect_inter_loops_coo with no device: cold, then 3 warm runs,
    # each on its own copy of v (the call normalizes a float64 v in place)
    copies = [v.copy() for _ in range(4)]
    logs = []
    fl.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, results = [], []
    for vc in copies:
        t0 = time.perf_counter()
        results.append(detect_inter_loops_coo(x, y, vc, cfg, n1=n1, n2=n2,
                                              log=logs.append))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = fl.LAUNCHES
    del copies
    if launches:
        fail(f"the inter path launched the fused kernel {launches} times")
    if "device=cuda" not in logs[0]:
        fail(f"detect_inter_loops_coo without a device did not run on the "
             f"card: {logs[0]}")
    if any(r != results[0] for r in results[1:]):
        fail("a warm inter rerun gave other rows")
    rows = inter_tsv_rows(results[0], "chr21", "chr22", 5000)
    _, golden = read_tsv(GOLDEN_INTER)
    n_common, q_err, lq_err = compare_inter(rows, golden)
    plan = logs[0]
    B = int(plan.split("batch=")[1].split()[0])
    ntiles = len(s1) * len(s2)
    h2d = int(plan.split("h2d_bytes=")[1].split()[0])
    warm = sorted(walls[1:])
    say(f"[9] {plan}")
    say(f"[9] detect_inter_loops_coo: {len(rows)} rows, {n_common} equal to "
        f"the JAX golden ({len(golden)}; q max rel err {q_err:.3g}, log q "
        f"max abs err {lq_err:.3g}); tiles {ntiles}, B {B}, launches "
        f"{-(-ntiles // B)}; fused kernel launches 0; wall cold "
        f"{walls[0]:.3f} s, warm {' '.join(f'{w:.3f}' for w in walls[1:])} "
        f"s (median {warm[1]:.3f}); peak device memory "
        f"{peak / 2**30:.2f} GiB; H2D {h2d} B")
    boundary = anchor_census(results[0], anchors,
                             [e - OVERLAP // 2 for e in e1[:-1]],
                             [e - OVERLAP // 2 for e in e2[:-1]])
    say(f"[9] planted anchors and tile ownership: {boundary}")
    rep.update(inter_rows=len(rows), inter_q_max_rel_err=q_err,
               inter_logq_max_abs_err=lq_err, inter_tiles=ntiles,
               inter_batch=B, inter_launches=-(-ntiles // B),
               inter_cold_s=walls[0], inter_warm_s=warm[1],
               inter_peak_gib=peak / 2**30, inter_h2d_bytes=h2d,
               fused_launches_inter=launches, inter_anchors=boundary)

    # (b) device time by range, from one profiled run
    names = ("inter.densify", "inter.blur", "inter.scan", "inter.bh",
             "inter.finish")
    ranges, busy, top = profile_ranges(
        lambda: detect_inter_loops_coo(x, y, v.copy(), cfg, n1=n1, n2=n2),
        names)
    if ranges is None:
        say("[9] profiled inter run: not measured (no device time)")
    else:
        say(f"[9] profiled inter run: {busy:.2f} ms of kernels; "
            + ", ".join(f"{k} {val:.2f} ms" for k, val in ranges.items()))
        for name, kms, calls in top:
            say(f"[9]   {kms:8.3f} ms {calls:5d}x {name[:90]}")
    rep.update(inter_profile_ms=ranges, inter_profile_kernel_ms=busy)

    # (c) float64, the judge of both f32 paths (rows by anchor)
    t0 = time.perf_counter()
    rows64 = inter_tsv_rows(detect_inter_loops_coo(
        x, y, v.copy(), cfg.with_(precision="float64"), n1=n1, n2=n2),
        "chr21", "chr22", 5000)
    t64 = time.perf_counter() - t0
    lq64 = {tuple(r[:6]): math.log(float(r[6])) for r in rows64}
    judge = {}
    for label, rs in (("port f32", rows), ("JAX f32", golden)):
        common = [r for r in rs if tuple(r[:6]) in lq64]
        judge[label] = (len(rs) - len(common), max(
            abs(math.log(float(r[6])) - lq64[tuple(r[:6])]) for r in common))
    say(f"[9] float64 judge ({len(rows64)} rows, {t64:.3f} s): log q max abs "
        "err " + ", ".join(f"{k} {e:.3g} ({n} rows not in the f64 set)"
                           for k, (n, e) in judge.items()))
    if any(e > 1e-3 for _, e in judge.values()):
        fail("an f32 path sits more than 1e-3 from float64 in log q")
    rep.update(inter_f64_s=t64, inter_f32_vs_f64=judge["port f32"][1],
               inter_jax_f32_vs_f64=judge["JAX f32"][1])

    # (d) tile build: the device path (one COO upload, x-sort and dedup,
    # scatter per tile) against the JAX host densify, and the per-tile
    # peak memory behind the batch rule
    vc = v.copy()
    t0 = time.perf_counter()
    vn = normalize_inter(vc)
    norm_ms = 1e3 * (time.perf_counter() - t0)
    boxes = [(s1[i], e1[i], s2[j], e2[j]) for i in range(len(s1))
             for j in range(len(s2))]

    def device_tiles():
        src = _TileSource(x, y, vn, n1, n2, np.float32, dev)
        for b0 in range(0, len(boxes), B):
            src.tiles(boxes[b0:b0 + B], chunk)
        torch.cuda.synchronize()
        return src
    src = device_tiles()
    dev_ms = host_ms(device_tiles, reps=3)
    host_tile_ms, host_bytes = host_densify_ms(x, y, vn, s1, e1, s2, e2,
                                               chunk, dev)
    torch.cuda.empty_cache()
    say(f"[9] host normalize_inter {norm_ms:.1f} ms; tiles: device-built "
        f"from the COO {dev_ms:.1f} ms ({h2d} B up), host densify as JAX + "
        f"H2D {host_tile_ms:.1f} ms ({host_bytes} B up)")
    det = build_inter_detector(cfg, chunk, device=dev)
    p1 = tile_peak_bytes(det, src, boxes[:1], chunk)
    p3 = tile_peak_bytes(det, src, boxes[:3], chunk)
    slope = (p3 - p1) / 2
    det64 = build_inter_detector(cfg.with_(precision="float64"), chunk,
                                 device=dev)
    src64 = _TileSource(x, y, vn, n1, n2, np.float64, dev)
    q1 = tile_peak_bytes(det64, src64, boxes[:1], chunk)
    q2 = tile_peak_bytes(det64, src64, boxes[:2], chunk)
    del src, src64
    torch.cuda.empty_cache()
    say(f"[9] per-tile peak (n={chunk}): f32 B=1 {p1 / 1e6:.1f} MB, B=3 "
        f"{p3 / 1e6:.1f} MB, slope {slope / 1e6:.1f} MB a tile = "
        f"{slope / (4 * chunk * chunk):.1f} planes; f64 B=1 {q1 / 1e6:.1f} "
        f"MB, B=2 {q2 / 1e6:.1f} MB, slope {(q2 - q1) / 1e6:.1f} MB = "
        f"{(q2 - q1) / (8 * chunk * chunk):.1f} planes (rule: "
        f"{TILE_PLANES} planes)")
    rep.update(inter_normalize_ms=norm_ms, inter_tiles_device_ms=dev_ms,
               inter_tiles_host_ms=host_tile_ms,
               inter_tile_slope_planes=slope / (4 * chunk * chunk),
               inter_tile_slope_planes_f64=(q2 - q1) / (8 * chunk * chunk))
    del x, y, v, vn

    # (e) the inter CLI from a .hic: two chromosomes (2000 x 1500 bins of
    # inter contacts, a small intra map), against the direct call on the
    # contacts the reader gives
    xi, yi, vi, _ = synthetic_inter(2000, 1500, seed=2122, n_loops=40)
    xa, ya, va, _ = synthetic_hic(2000, 60, seed=2123)
    path = os.path.join(workdir, "inter.hic")
    t0 = time.perf_counter()
    write_hic_pairs(path, 2000, 1500, (xa, ya, va), (xi, yi, vi))
    t_write = time.perf_counter() - t0
    out = os.path.join(workdir, "inter.tsv")
    fl.LAUNCHES = 0
    native.DECODES = 0
    rc, events, wall = run_cli(["-f", path, "-ch", "c1", "-ch2", "c2", "-r",
                                "5kb", "-o", out, "-pt", str(INTER_PT),
                                "-st", str(INTER_ST)])
    cplan = event(events, "detect_plan")["detail"]
    if rc != 0 or "device=cuda" not in cplan or fl.LAUNCHES \
            or native.DECODES <= 0:
        fail(f"inter CLI: rc {rc}, plan {cplan}, fused launches "
             f"{fl.LAUNCHES}, native decodes {native.DECODES}")
    cx, cy, cv = read_hic_file(path, False, False, cfg.distance_bp, "c1",
                               "c2", 5000)
    direct = inter_tsv_rows(detect_inter_loops_coo(cx, cy, cv, cfg), "c1",
                            "c2", 5000)
    cli_rows = read_tsv(out)[1]
    if cli_rows != direct or not direct:
        fail(f"inter CLI rows ({len(cli_rows)}) differ from the direct "
             f"call's ({len(direct)})")
    ingest = event(events, "ingest")["seconds"]
    detect = event(events, "detect")["seconds"]
    say(f"[9] CLI -ch c1 -ch2 c2 from .hic v8 ({len(vi)} inter contacts, "
        f"written in {t_write:.1f} s): {cplan}; {len(direct)} rows equal to "
        f"the direct call's; wall {wall:.3f} s, ingest {ingest:.3f} s, "
        f"detect {detect:.3f} s")
    rep.update(inter_cli_wall_s=wall, inter_cli_ingest_s=ingest,
               inter_cli_detect_s=detect)

    # (f) the native decoder against the Python one, on phase 5's
    # intra file and this phase's inter rectangle: equal arrays, timed
    for label, hpath, c1, c2 in (
            ("phase 5 chr21", os.path.join(workdir, "chr21.hic"), "chr21",
             "chr21"),
            ("phase 9 c1 x c2", path, "c1", "c2")):
        hic = HicFile(hpath)
        try:
            blocks = hic._matrix_zoom(hic.chrom_by_name(c1).index,
                                      hic.chrom_by_name(c2).index, "BP",
                                      5000).blocks
            got = hic._decode_blocks(blocks)
            want = hic._decode_blocks_plain(blocks)
            if any(a.dtype != b.dtype or not np.array_equal(a, b)
                   for a, b in zip(got, want)):
                fail(f"native .hic decode differs from Python's on {label}")
            nat = host_ms(lambda: hic._decode_blocks(blocks), reps=3)
            plain = host_ms(lambda: hic._decode_blocks_plain(blocks), reps=3)
        finally:
            hic.close()
        say(f"[9] .hic decode {label} ({len(blocks)} blocks, {len(got[0])} "
            f"records): native {nat:.1f} ms, Python {plain:.1f} ms, equal "
            f"arrays")
        rep[f"decode_{c1}_native_ms"] = nat
        rep[f"decode_{c1}_python_ms"] = plain

    # the intra .hic ingest (the CLI's reader entry point) with the native
    # decoder and with the Python one, in turns
    hpath = os.path.join(workdir, "chr21.hic")

    def ingest_intra():
        read_hic_file(hpath, False, False, 2_000_000, "chr21", "chr21", 5000)
    native_s = host_ms(ingest_intra, reps=3) / 1e3
    with python_decoder():
        python_s = host_ms(ingest_intra, reps=3) / 1e3
    say(f"[9] intra .hic ingest (read_hic_file, chr21 5 kb): native decoder "
        f"{native_s:.3f} s, Python decoder {python_s:.3f} s; phase 9 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    rep.update(ingest_intra_native_s=native_s, ingest_intra_python_s=python_s)
    return rep


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

GOLDEN_ROWSHARD = os.path.join(ROOT, "tests", "data",
                               "torch_port_chr21_5kb_rowshard_golden.tsv")
RTOL_ROWSHARD = 5e-3  # the JAX dryrun's rowshard q rtol (host vs device
                      # normalize)
# phase 10's CLI file: three 5 kb chromosomes, phase 5's chr21 map at
# seeds 2021-2023
CLI3 = [(f"c{i}", ((9629, 400), dict(seed=2021 + i, n_loops=300,
                                     loop_strength=3.0))) for i in range(3)]
PROC_TIMEOUT = 300    # seconds a CLI process of phase 10 may take


def q_distance(got, base, key, q):
    """Rows in the same order with the same ``key`` (else a failure); the
    largest relative distance of their q."""
    if [key(r) for r in got] != [key(r) for r in base]:
        fail(f"{len(got)} rows differ from the {len(base)} unsharded rows "
             f"in anchors, scales or tags")
    if not base:
        return 0.0
    return max(abs(q(a) - q(b)) / q(b) for a, b in zip(got, base))


def mesh_run(fn, runner):
    """``fn()`` once cold with the kernel's and the runner's launch counts
    set to 0 just before (read just after), then twice warm (the same
    rows): ``(rows, launches per entry, kernel launches, cold wall, warm
    median wall)``."""
    from mustache_tpu_torch.kernels import fused_ladder as fl

    fl.LAUNCHES = 0
    runner.launches = [0] * len(runner.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    per_entry, launches = list(runner.launches), fl.LAUNCHES
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again != rows:
            fail("a warm sharded rerun gave other rows")
    if launches <= 0 or sum(per_entry) != launches:
        fail(f"sharded run: kernel launches {launches}, per entry "
             f"{per_entry}")
    return rows, per_entry, launches, cold, min(warm)


def two_process_cli(hic, out, extra_env=None):
    """The CLI from ``hic`` as two processes on the first card
    (``--engine-nprocs 2``, a gloo group on 127.0.0.1): ``(exit codes,
    walls, each process's output tail)``. Both processes are stopped
    before this returns."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES",
                                          "0").split(",")[0]
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    env.update(extra_env or {})
    argv = [sys.executable, "-m", "mustache_tpu_torch", "-f", hic, "-r",
            "5kb", "-o", out, "-pt", str(PT), "-st", str(ST),
            "--engine-json-log", "--engine-coordinator",
            f"127.0.0.1:{port}", "--engine-nprocs", "2"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--engine-procid", str(i)], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for i in range(2)]
    rcs, walls, outs = [], [], []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=PROC_TIMEOUT)
            rcs.append(p.returncode)
            walls.append(time.perf_counter() - t0)
            outs.append(o.decode(errors="replace")[-3000:])
    except subprocess.TimeoutExpired:
        fail(f"a CLI process of the two did not end in {PROC_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, walls, outs


def phase_sharding(dev, workdir, loops4, warm4, rows7):
    """Phase 10: the sharded runners, the dryrun and the two-process CLI
    on the card; ``loops4``/``warm4``: phase 4's rows and warm wall,
    ``rows7``: phase 7's differential rows."""
    from hic_writer import write_hic
    from mustache_tpu_torch import (
        DetectionConfig, detect_diff_loops_coo, detect_loops_coo,
    )
    from mustache_tpu_torch.dryrun import dryrun_multichip
    from mustache_tpu_torch.sharding import make_mesh, make_runner

    t_phase = time.perf_counter()
    rep = {}
    # (a) the dryrun on every card, and on four entries of the first
    for label, n, devices in (("cards", torch.cuda.device_count(), None),
                              ("cuda:0 x4", 4, ["cuda:0"] * 4)):
        t0 = time.perf_counter()
        r = dryrun_multichip(n, devices)
        say(f"[10] dryrun_multichip on {label}: dense runner on "
            f"{r['dense_mesh']} bit-identical to fn, fused launches per "
            f"entry {r['dense_launches_row' + str(r['dense_mesh']['row'])]}; "
            f"mesh {r['mesh']}, pipeline "
            f"{r['pipeline_rows']} rows and diff {r['diff_rows']} rows "
            f"replicated == unsharded (q bit-identical), production "
            f"{r['production_rows']} rows; rowshard q max rel distance: "
            f"diff {r['diff_rowshard_q_dist']:.3g}, production "
            f"{r['production_rowshard_q_dist']:.3g}; "
            f"{time.perf_counter() - t0:.1f} s")
        rep[f"dryrun_{n}"] = r

    # (b) chr21 5 kb through both placements on 1 and 4 entries of cuda:0
    x, y, v = workload(CHR21)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                          st=ST, precision="float32")
    _, golden_rs = read_tsv(GOLDEN_ROWSHARD)
    key = lambda lp: (lp.bin1, lp.bin2, lp.scale)   # noqa: E731
    walls = {"unsharded": warm4}
    for placement in ("replicate", "rowshard"):
        for k in (1, 4):
            label = f"{placement}_{k}"
            runner = make_runner(make_mesh(devices=["cuda:0"] * k),
                                 placement)
            rows, per_entry, launches, cold, warm = mesh_run(
                lambda: detect_loops_coo(x, y, v, cfg, runner=runner),
                runner)
            walls[label] = warm
            rep[f"launches_{label}"] = per_entry
            if placement == "replicate":
                if rows != loops4:
                    fail(f"{label}: rows differ from phase 4's")
                check = "rows identical to phase 4's"
            else:
                n_common, worst = compare_to_golden(
                    loops_tsv_rows(rows, "chr21", 5000), golden_rs,
                    tag="10")
                dist = q_distance(rows, loops4, key, lambda lp: lp.q)
                check = (f"{n_common} rows equal to the JAX rowshard golden "
                         f"(q max rel err {worst:.3g}); q max rel distance "
                         f"from phase 4's rows {dist:.3g}")
                ev = runner.last_band_event
                check += (f"; slab {ev['per_chip_mb']} MB per entry, "
                          f"{ev['total_mb']} MB in all, replicated "
                          f"{ev['replicated_mb']} MB")
                rep[f"rowshard_{k}_band_mb"] = ev
                rep[f"rowshard_{k}_q_dist_phase4"] = dist
            say(f"[10] chr21 5 kb {placement} on {k} x cuda:0: {len(rows)} "
                f"rows, {check}; fused launches per entry {per_entry}; "
                f"wall cold {cold:.3f} s, warm {warm:.3f} s")
    say("[10] chr21 5 kb warm walls: " + ", ".join(
        f"{k} {w:.3f} s" for k, w in walls.items()))
    rep["walls_s"] = walls

    # (c) the differential workload on four entries, both placements
    x1, y1, v1 = x, y, v
    x2, y2, v2 = workload(CHR21_COND2)
    dcfg = cfg.with_(pt2=PT2)
    dkey = lambda r: (r[0], r[1], r[3], r[4])       # noqa: E731
    for placement in ("replicate", "rowshard"):
        runner = make_runner(make_mesh(devices=["cuda:0"] * 4), placement)
        rows, per_entry, launches, cold, warm = mesh_run(
            lambda: detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, dcfg,
                                          runner=runner), runner)
        dist = q_distance(rows, rows7, dkey, lambda r: r[2])
        if placement == "replicate" and dist != 0.0:
            fail(f"diff replicate: q differs from phase 7's ({dist:.3g})")
        if dist > RTOL_ROWSHARD:
            fail(f"diff rowshard: q max rel distance {dist:.3g} from "
                 f"phase 7's rows")
        rep[f"launches_diff_{placement}_4"] = per_entry
        walls[f"diff_{placement}_4"] = warm
        say(f"[10] diff {placement} on 4 x cuda:0: {len(rows)} rows, tags, "
            f"anchors and scales equal to phase 7's, q max rel distance "
            f"{dist:.3g}; fused launches per entry {per_entry}; wall cold "
            f"{cold:.3f} s, warm {warm:.3f} s")

    # (d) the CLI as two processes on the first card
    hic = os.path.join(workdir, "three.hic")
    t0 = time.perf_counter()
    maps = {name: workload(spec) for name, spec in CLI3}
    write_hic(hic, [(name, spec[0][0] * 5000) for name, spec in CLI3], 5000,
              maps, version=8,
              norms={("KR", name): np.ones(spec[0][0]) for name, spec in CLI3})
    say(f"[10] wrote three 5 kb chromosomes as .hic v8 in "
        f"{time.perf_counter() - t0:.1f} s")
    single = os.path.join(workdir, "single.tsv")
    rc, _, wall1 = run_cli(["-f", hic, "-r", "5kb", "-o", single, "-pt",
                            str(PT), "-st", str(ST)])
    if rc != 0:
        fail(f"single-process CLI on the three chromosomes exited {rc}")
    multi = os.path.join(workdir, "multi.tsv")
    rcs, pwalls, outs = two_process_cli(hic, multi)
    if rcs != [0, 0]:
        fail(f"two-process CLI exited {rcs}: {outs}")
    with open(single, "rb") as a, open(multi, "rb") as b:
        if a.read() != b.read():
            fail("two-process TSV differs from the single-process TSV")
    faulted = os.path.join(workdir, "fault.tsv")
    frcs, fwalls, fouts = two_process_cli(
        hic, faulted, {"MTPU_FAULT_INJECT": "ingest:100:c1"})
    if frcs != [0, 1]:
        fail(f"two-process CLI with c1 failing exited {frcs}: {fouts}")
    _, frows = read_tsv(faulted)
    if {r[0] for r in frows} != {"c0", "c2"}:
        fail(f"faulted two-process TSV holds {sorted({r[0] for r in frows})}")
    say(f"[10] CLI as two processes on the first card: TSV byte-equal to "
        f"the single-process one ({wall1:.3f} s in process); walls per "
        f"process {pwalls[0]:.3f} / {pwalls[1]:.3f} s; with c1 failing on "
        f"process 1: exit codes {frcs}, the TSV holds c0 and c2, walls "
        f"{fwalls[0]:.3f} / {fwalls[1]:.3f} s; phase 10 (a-d) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    rep.update(cli_single_wall_s=wall1, cli_two_process_walls_s=pwalls,
               cli_fault_walls_s=fwalls, cli_fault_rcs=frcs)
    rep.update(phase_row_axis(dev))
    say(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return rep


ROW_MESHES = [(4, 1), (2, 2), (1, 4), (1, 3)]   # (n_block, n_row) of cuda:0


def row_axis_blocks():
    """The 8 blocks of tests/test_sharding.py::test_sharded_equals_
    unsharded: 256^2, raw contacts of synthetic_hic(256, 64, seed 40-47,
    n_loops=4)."""
    from synthetic import synthetic_hic

    blocks = np.zeros((8, 256, 256), dtype=np.float32)
    for b in range(8):
        x, y, v, _ = synthetic_hic(256, 64, seed=40 + b, n_loops=4)
        blocks[b][x, y] = v
    return blocks


def chr21_dense_blocks(dev):
    """chr21 5 kb's six 2000^2 blocks, densified (on the host) from its
    band as the pipeline normalizes it on the device."""
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.detect import band_width, dense_from_band

    (n_bins, d_px), _ = CHR21
    x, y, v = workload(CHR21)
    starts, _ = chunk_grid(n_bins, 2000, d_px)
    shape = (bucket_rows(n_bins), band_width(2000, d_px))
    band = compact_normalized_band(x, y, v, shape, dev, n_bins, 5000, d_px)
    slices = torch.stack([band[s:s + 2000] for s in starts])
    return dense_from_band(slices).cpu().numpy()


def joined_windows(cs, nzf, det, kw, n, n_row):
    """The band state of ``n``-row blocks from ``n_row`` row-window
    launches, one per part of ``fused_ladder.row_cuts``, joined in
    order."""
    from mustache_tpu_torch.kernels import fused_ladder as fl

    cuts = fl.row_cuts(n, n_row)
    parts = []
    for lo, hi in zip(cuts, cuts[1:]):
        w0, w1 = fl.window_rows(n, lo, hi, det.spec.radius)
        parts.append(fl.fused_ladder_window(
            cs[:, w0:w1].contiguous(), nzf[:, w0:w1].contiguous(), det.taps,
            radii=det.radii, N=n, base=w0, t_lo=lo, t_hi=hi, **kw))
    return [torch.cat([p[i] for p in parts], 1) for i in range(3)]


def window_report(tag, cs, nzf, det, kw, n):
    """One row window, part 2 of 4 of the blocks ``cs``/``nzf`` ``[B, n,
    n]``, on the card: exact against its plain version (band_sig and
    band_v equal, locs equal, sums within RTOL), timed against the
    whole-block launch and the plain version, with its FP32 bound."""
    from mustache_tpu_torch.kernels import fused_ladder as fl

    spec, DB = det.spec, kw["DB"]
    cuts = fl.row_cuts(n, 4)
    lo, hi = cuts[1], cuts[2]
    w0, w1 = fl.window_rows(n, lo, hi, spec.radius)
    win = dict(N=n, base=w0, t_lo=lo, t_hi=hi)
    wcs, wnz = cs[:, w0:w1].contiguous(), nzf[:, w0:w1].contiguous()
    got = fl.fused_ladder_window(wcs, wnz, det.taps, radii=det.radii,
                                 **kw, **win)
    plain = fl.fused_ladder_nms_reference(wcs, wnz, det.taps, **kw, **win)
    torch.cuda.synchronize()
    locs, sums = fl.reduce_parts(
        got[2], kw["n_octaves"] * kw["planes_per_octave"])
    err = float((got[0] - plain[0]).abs().max())
    sig_diff = int((got[1] != plain[1]).sum())
    locs_err = float((locs - plain[2]).abs().max())
    sums_rel = float(((sums - plain[3]).abs()
                      / plain[3].abs().clamp(min=1e-30)).max())
    if sig_diff or err > 0 or locs_err > 0 or sums_rel > RTOL:
        fail(f"row window [{lo}, {hi}) against its plain version: band_sig "
             f"differs at {sig_diff} cells, band_v max abs err {err}, locs "
             f"{locs_err}, sums rel {sums_rel}")
    del got, plain
    ms_win = cuda_ms(lambda: fl.fused_ladder_window(
        wcs, wnz, det.taps, radii=det.radii, **kw, **win), reps=10)
    ms_full = cuda_ms(lambda: fl.fused_ladder_window(
        cs, nzf, det.taps, radii=det.radii, **kw), reps=10)
    plain_ms = cuda_ms(lambda: fl.fused_ladder_nms_reference(
        wcs, wnz, det.taps, **kw, **win), reps=2)
    rows = range(lo * fl.TILE_ROWS, min(hi * fl.TILE_ROWS, n))
    flop, _, bound_ms, bound_by = kernel_bound(spec, n, DB, cs.shape[0],
                                               rows=rows)
    say(f"[{tag}] row window [{lo * fl.TILE_ROWS}, {rows[-1] + 1}) of "
        f"{cs.shape[0]} {n}^2 blocks (held rows [{w0}, {w1}), part 2 of 4, "
        f"R={spec.radius}): band_sig equal, band_v max abs err {err:.3g}, "
        f"locs {locs_err:.3g}, sums rel {sums_rel:.3g} against its plain "
        f"version; kernel {ms_win:.4f} ms against the whole-block launch's "
        f"{ms_full:.4f} ms; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}, {flop / 1e9:.3f} GFLOP)")
    return dict(max_abs_err_row_window=err, ms_row_window=ms_win,
                ms_full_block_b6=ms_full, plain_ms_row_window=plain_ms,
                bound_ms_row_window=bound_ms, bound_by_row_window=bound_by)


def phase_row_axis(dev):
    """Phase 10 (e): the mesh's row axis. The dense runner on meshes of
    ``cuda:0`` entries (``ROW_MESHES``) against ``n_row = 1`` (the
    unsplit ``fn``), outputs bit-identical, on the JAX test's 8 blocks and
    chr21's six 2000^2 blocks; the joined row-window state against the
    whole-block launch, bit-identical; one row window against its plain
    version; the row-window launch timed against the whole-block launch;
    float64 (ladder route) on 2 x 2 within rtol 1e-9."""
    from mustache_tpu_torch import DetectionConfig
    from mustache_tpu_torch.detect import _preamble, band_width, build_detector
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.sharding import make_mesh, make_runner

    t0 = time.perf_counter()
    rep = {}
    inputs = {"jax_blocks_256": (row_axis_blocks(), 64, 256),
              "chr21_2000": (chr21_dense_blocks(dev), 400, 2000)}
    for name, (blocks, d_px, n) in inputs.items():
        cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                              pt=PT, st=ST, precision="float32")
        det = build_detector(cfg, n, device=dev)
        base = {k: a.cpu().numpy() for k, a in det.fn(
            torch.from_numpy(blocks).to(dev)).items()}
        for n_block, n_row in ROW_MESHES:
            runner = make_runner(make_mesh(n_block, n_row,
                                           devices=["cuda:0"] * (n_block
                                                                 * n_row)))
            dets = runner.per_device(lambda d: build_detector(cfg, n,
                                                              device=d))
            fl.LAUNCHES = 0
            runner.launches = [0] * len(runner.launches)
            out = runner(dets, blocks)
            torch.cuda.synchronize()
            launches, total = list(runner.launches), fl.LAUNCHES
            for k, want in base.items():
                if not np.array_equal(out[k], want,
                                      equal_nan=want.dtype.kind == "f"):
                    fail(f"row axis {name} {n_block}x{n_row}: {k} differs "
                         f"from n_row = 1")
            if total <= 0 or sum(launches) != total or min(launches) <= 0:
                fail(f"row axis {name} {n_block}x{n_row}: fused launches "
                     f"{total}, per entry {launches}")
            block_mb = -(-len(blocks) // n_block) * blocks[0].nbytes / 1e6
            held = ([round(h / 1e6, 3) for h in runner.last_held]
                    if n_row > 1 else [block_mb] * n_block)
            say(f"[10] row axis {name} on {n_block}x{n_row} cuda:0: outputs "
                f"bit-identical to n_row = 1; fused launches per entry "
                f"{launches}; dense MB held per entry {held} against "
                f"{block_mb:.2f} MB of its group's blocks")
            rep[f"launches_row_{name}_{n_block}x{n_row}"] = launches
            rep[f"held_mb_row_{name}_{n_block}x{n_row}"] = held

    # the joined row-window state against the whole-block launch, one row
    # window against its plain version, and the launches timed: chr21's
    # six blocks in one batch
    blocks, d_px, n = inputs["chr21_2000"]
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000, pt=PT,
                          st=ST, precision="float32")
    det = build_detector(cfg, n, device=dev)
    spec, DB = det.spec, band_width(n, d_px)
    cs, nz = _preamble(torch.from_numpy(blocks).to(dev), d_px)
    nzf = nz.to(torch.float32)
    del nz
    kw = dict(R=spec.radius, n_octaves=len(spec.octave_values),
              planes_per_octave=spec.planes_per_octave, DB=DB)
    full = fl.fused_ladder_window(cs, nzf, det.taps, radii=det.radii, **kw)
    for n_row in (2, 3, 4):
        if not all(torch.equal(a, b) for a, b in zip(
                joined_windows(cs, nzf, det, kw, n, n_row), full)):
            fail(f"row windows of {n_row} parts do not join to the "
                 f"whole-block launch")
    say(f"[10] joined row windows of 2, 3 and 4 parts == the whole-block "
        f"launch of chr21's six 2000^2 blocks (bit-identical)")
    rep.update(window_report("10", cs, nzf, det, kw, n))
    del cs, nzf, full
    torch.cuda.empty_cache()

    # float64: the ladder route on 2 x 2 within rtol 1e-9 of n_row = 1
    blocks = inputs["jax_blocks_256"][0]
    cfg = DetectionConfig(resolution=5000, distance_bp=64 * 5000, pt=PT,
                          st=ST, precision="float64", max_candidates=256)
    want = {k: a.cpu().numpy() for k, a in build_detector(
        cfg, 256, device=dev).fn(torch.from_numpy(blocks).to(dev)).items()}
    runner = make_runner(make_mesh(2, 2, devices=["cuda:0"] * 4))
    got = runner(runner.per_device(lambda d: build_detector(cfg, 256,
                                                            device=d)),
                 blocks)
    worst = 0.0
    for k, w in want.items():
        if k in ("cand_logq", "neigh_logq"):
            fin = np.isfinite(w) & (w != 0)
            if not np.array_equal(np.isfinite(got[k]), np.isfinite(w)):
                fail(f"float64 row axis: {k} finite cells differ")
            worst = max(worst, float(np.max(np.abs(got[k][fin] - w[fin])
                                            / np.abs(w[fin]))))
        elif not np.array_equal(got[k], w):
            fail(f"float64 row axis 2x2: {k} differs from n_row = 1")
    if worst > 1e-9:
        fail(f"float64 row axis 2x2: log q max rel distance {worst:.3g}")
    say(f"[10] row axis at float64 (ladder route) on 2x2 cuda:0: every "
        f"output equal to n_row = 1 but log q, max rel distance "
        f"{worst:.3g} (bound 1e-9); fused launches {runner.launches}; "
        f"row axis took {time.perf_counter() - t0:.1f} s")
    rep["f64_row_axis_logq_rel"] = worst
    return rep


def phase_cool(dev, workdir, files):
    """Phase 11: ``.cool`` / ``.mcool`` on the card, which has no h5py.
    The committed fixtures in cooler's layout read equal to the JAX
    reader's digests; chr21 5 kb written as ``.mcool`` by
    ``tools/write_cool.py`` through the CLI against the 290-row golden;
    a small inter pair from ``.cool`` against the same pair from
    ``.hic``. ``files``: phase 5's report (its ``.hic`` ingest)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import write_cool
    from mustache_tpu_torch.io import cool as tcool
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from synthetic import synthetic_inter

    t_phase = time.perf_counter()
    rep = {}
    with open(COOL_EXPECTED) as fh:
        want = {k: v for k, v in json.load(fh).items()
                if not k.startswith("_")}
    t0 = time.perf_counter()
    got = cool_digests(tcool, *COOL_FIXTURES)
    if got != want:
        bad = sorted(k for k in want if got.get(k) != want[k])
        fail(f"cooler-layout fixtures read other triplets: {bad}")
    say(f"[11] cooler-layout fixtures (gzip 6 + shuffle, chunked, enum, "
        f"variable-length attributes, .mcool of two resolutions): "
        f"{len(want)} reads equal to the JAX reader's digests in "
        f"{time.perf_counter() - t0:.3f} s")

    # chr21 5 kb as .mcool through the CLI
    (n_bins, _), _ = CHR21
    x, y, v = workload(CHR21)
    mcool = os.path.join(workdir, "chr21.mcool")
    t0 = time.perf_counter()
    write_cool.write_mcool(mcool, {5000: ([("chr21", n_bins * 5000)],
                                          {"chr21": (x, y, v)}, None)},
                           count_dtype=np.float64)
    t_write = time.perf_counter() - t0
    _, golden = read_tsv(GOLDEN)
    out = os.path.join(workdir, "cool_loops.tsv")
    walls, ingests = [], []
    for _ in range(2):
        fl.LAUNCHES = 0
        rc, events, wall = run_cli(["-f", mcool, "-ch", "chr21", "-r", "5kb",
                                    "-o", out, "-pt", str(PT), "-st",
                                    str(ST)])
        if rc != 0:
            fail(f"CLI on .mcool exited {rc}")
        plan = event(events, "detect_plan")["detail"]
        if "device=cuda" not in plan or fl.LAUNCHES <= 0:
            fail(f"CLI on .mcool: {plan}, kernel launches {fl.LAUNCHES}")
        _, rows = read_tsv(out)
        n_common, worst = compare_to_golden(rows, golden, tag="11")
        walls.append(wall)
        ingests.append(event(events, "ingest")["seconds"])
        rep["cli_mcool_launches"] = fl.LAUNCHES
    say(f"[11] chr21 5 kb as .mcool ({os.path.getsize(mcool) / 1e6:.1f} MB, "
        f"written in {t_write:.1f} s): CLI {len(rows)} rows, {n_common} "
        f"equal to the golden (q max rel err {worst:.3g}); wall "
        f"{walls[0]:.3f} / {walls[1]:.3f} s, ingest from .mcool "
        f"{ingests[0]:.3f} / {ingests[1]:.3f} s against phase 5's .hic "
        f"ingest {files['cli_hic_ingest_s']:.3f} s")
    rep.update(cli_mcool_wall_s=walls[1], cli_mcool_ingest_s=ingests[1],
               cli_mcool_rows=len(rows))

    # a small inter pair from .cool against the same contacts from .hic
    n1, n2 = 1000, 800

    def stored(x, y, v):
        # one count per pixel, f32-exact: the .hic writer stores float32
        _, first = np.unique(x * (n1 + n2) + y, return_index=True)
        return x[first], y[first], v[first].astype(np.float32).astype(
            np.float64)

    xi, yi, vi = stored(*synthetic_inter(n1, n2, seed=2121, n_loops=20)[:3])
    intra = stored(*workload(((n1, 200), dict(seed=2121, n_loops=20))))
    cool = os.path.join(workdir, "pair.cool")
    hic = os.path.join(workdir, "pair.hic")
    write_cool.write_cool(cool, [("c1", n1 * 5000), ("c2", n2 * 5000)], 5000,
                          {"c1": intra, ("c1", "c2"): (xi, yi, vi)},
                          count_dtype=np.float64)
    write_hic_pairs(hic, n1, n2, intra, (xi, yi, vi))
    outs = {}
    for label, path in (("cool", cool), ("hic", hic)):
        outs[label] = os.path.join(workdir, f"pair_{label}.tsv")
        rc, events, _ = run_cli(["-f", path, "-ch", "c1", "-ch2", "c2", "-r",
                                 "5kb", "-o", outs[label], "-pt",
                                 str(INTER_PT), "-st", str(INTER_ST)])
        if rc != 0:
            fail(f"inter CLI from .{label} exited {rc}")
    _, rows_c = read_tsv(outs["cool"])
    _, rows_h = read_tsv(outs["hic"])
    if not rows_c or rows_c != rows_h:
        fail(f"inter pair: {len(rows_c)} rows from .cool, {len(rows_h)} "
             f"from .hic, not equal")
    if "h5py" in sys.modules:
        fail("h5py was imported")
    say(f"[11] inter pair c1 x c2 ({n1} x {n2} bins) from .cool: "
        f"{len(rows_c)} rows, equal to the .hic run's; h5py not imported; "
        f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    rep["inter_cool_rows"] = len(rows_c)
    return rep


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

def counted(fn):
    """``fn`` wrapped to record the fused launches of each call (the count
    set to 0 just before it, read just after), and the list of counts."""
    from mustache_tpu_torch.kernels import fused_ladder as fl

    counts = []

    def run():
        fl.LAUNCHES = 0
        out = fn()
        counts.append(fl.LAUNCHES)
        return out
    return run, counts


def phase_oct5(dev, workdir):
    """Phase 12: sigma0 1.6 at ``-oc 5`` (R=110, the kernel's streamed
    mode) through every caller of the fused kernel, each against the
    ladder route (``use_pallas="off"``) on the same call: chr21 5 kb
    through ``detect_loops_coo`` and the CLI from phase 5's ``.hic`` (one
    launch each, route ``kernel``, rows held to the JAX golden under phase
    4's rule), the 1 kb slice (rows held to the ladder route's, peak
    memory of both), the differential workload (one stacked launch, rows
    held to the ladder route's under phase 7's rule; the stacked launch
    held and timed, :func:`stacked_report`) and the row window (four
    parts joined equal to the whole-block launch, one held and timed,
    :func:`window_report`; the dense runner on 1 x 4 entries of
    ``cuda:0`` equal to ``n_row = 1``)."""
    from mustache_tpu_torch import (
        DetectionConfig, detect_diff_loops_coo, detect_loops_coo,
    )
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.detect import (
        _preamble, band_width, build_detector,
    )
    from mustache_tpu_torch.diff import build_diff_detector
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.pipeline import local_runner
    from mustache_tpu_torch.sharding import make_mesh, make_runner

    rep = {}
    t_phase = time.perf_counter()
    x, y, v = workload(CHR21)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                          st=ST, octaves=5)
    spec = build_detector(cfg, 2000, device=dev).spec
    R = spec.radius
    say(f"[12] sigma0 1.6, 5 octaves: R={R}, kernel mode "
        f"{fl.ladder_mode(R, 5)}, {fl.smem_bytes(R, 5)} B a CTA, clusters "
        f"of {fl.CLUSTER}")
    _, golden = read_tsv(GOLDEN_OCT5)

    # (a) detect_loops_coo: the kernel route against the golden, and the
    # ladder route on the same call
    walls = {}
    for route, c in (("kernel", cfg),
                     ("ladder", cfg.with_(use_pallas="off"))):
        logs = []
        run, counts = counted(lambda: detect_loops_coo(x, y, v, c,
                                                       log=logs.append))
        loops, cold, warm, peak = timed_runs(run)
        want = 1 if route == "kernel" else 0
        if (f"route={route}" not in logs[0] or "device=cuda" not in logs[0]
                or any(n != want for n in counts)):
            fail(f"-oc 5 {route} route: launches {counts}, plan {logs[0]}")
        n_c, worst = compare_to_golden(loops_tsv_rows(loops, "chr21", 5000),
                                       golden, tag="12")
        walls[route] = (cold, sorted(warm)[1])
        say(f"[12] chr21 5 kb -oc 5, {route} route: {logs[0]}; {len(loops)} "
            f"rows, {n_c} equal to the JAX golden ({len(golden)}; q max rel "
            f"err {worst:.3g}); fused launches per call {counts}; wall cold "
            f"{cold:.3f} s, warm {' '.join(f'{w:.3f}' for w in warm)} s; "
            f"peak device memory {peak / 2**30:.2f} GiB")
        rep[f"oct5_{route}_cold_s"], rep[f"oct5_{route}_warm_s"] = walls[route]
        rep[f"oct5_{route}_q_err"] = worst
    rep["launches_oct5"] = 1

    # (b) the CLI from phase 5's .hic at -oc 5
    out = os.path.join(workdir, "oct5.tsv")
    fl.LAUNCHES = 0
    rc, events, wall = run_cli(
        ["-f", os.path.join(workdir, "chr21.hic"), "-ch", "chr21", "-r",
         "5kb", "-o", out, "-pt", str(PT), "-st", str(ST), "-oc", "5"])
    cli_launches = fl.LAUNCHES
    plan = event(events, "detect_plan")["detail"] if rc == 0 else ""
    if rc != 0 or cli_launches != 1 or "route=kernel" not in plan:
        fail(f"CLI -oc 5 exited {rc}, launches {cli_launches}, plan {plan}")
    n_c, worst = compare_to_golden(read_tsv(out)[1], golden, tag="12")
    say(f"[12] CLI -oc 5 from .hic: {plan}; {n_c} rows equal to the golden "
        f"(q max rel err {worst:.3g}); fused launches {cli_launches}; wall "
        f"{wall:.3f} s, detect {event(events, 'detect')['seconds']:.3f} s")
    rep["launches_cli_oct5"] = cli_launches

    # (c) the 1 kb slice at -oc 5: the kernel route's rows against the
    # ladder route's
    (_, d_px), _ = SLICE_1KB
    x1, y1, v1 = workload(SLICE_1KB)
    cfg1 = DetectionConfig(resolution=1000, distance_bp=d_px * 1000, pt=PT,
                           st=ST, octaves=5)
    got = {}
    for route, c in (("kernel", cfg1),
                     ("ladder", cfg1.with_(use_pallas="off"))):
        logs = []
        run, counts = counted(lambda: detect_loops_coo(x1, y1, v1, c,
                                                       log=logs.append))
        loops, cold, warm, peak = timed_runs(run, n_warm=1)
        if (f"route={route}" not in logs[0]
                or (route == "kernel") != (min(counts) > 0)):
            fail(f"1 kb -oc 5 {route} route: launches {counts}, plan "
                 f"{logs[0]}")
        got[route] = loops_tsv_rows(loops, "chr1", 1000)
        say(f"[12] 1 kb -oc 5, {route} route: {logs[0]}; {len(loops)} rows; "
            f"fused launches per call {counts}; wall cold {cold:.3f} s, warm "
            f"{warm[0]:.3f} s; peak device memory {peak / 2**30:.2f} GiB")
        rep[f"oct5_1kb_{route}_warm_s"] = warm[0]
        rep[f"oct5_1kb_{route}_peak_gib"] = peak / 2**30
        rep[f"launches_1kb_oct5_{route}"] = counts[0]
    if not got["kernel"]:
        fail("no loops at 1 kb -oc 5")
    n_c, worst = compare_to_golden(got["kernel"], got["ladder"], tag="12")
    say(f"[12] 1 kb -oc 5: {n_c} kernel-route rows equal to the ladder "
        f"route's (q max rel err {worst:.3g})")
    del x1, y1, v1
    torch.cuda.empty_cache()

    # (d) differential calling at -oc 5: one stacked launch, rows held to
    # the ladder route's under phase 7's rule
    x2, y2, v2 = workload(CHR21_COND2)
    dcfg = cfg.with_(pt2=PT2)
    drows = {}
    for route, c in (("kernel", dcfg), ("ladder", dcfg.with_(
            use_pallas="off"))):
        logs = []
        run, counts = counted(lambda: detect_diff_loops_coo(
            x, y, v, x2, y2, v2, c, log=logs.append))
        rows, cold, warm, peak = timed_runs(run, n_warm=1)
        want = 1 if route == "kernel" else 0
        if f"route={route}" not in logs[0] or any(n != want for n in counts):
            fail(f"diff -oc 5 {route} route: launches {counts}, plan "
                 f"{logs[0]}")
        drows[route] = diff_tsv_rows(rows, "chr21", 5000)
        say(f"[12] diff -oc 5, {route} route: {len(rows)} rows; fused "
            f"launches per call {counts}; wall cold {cold:.3f} s, warm "
            f"{warm[0]:.3f} s; peak device memory {peak / 2**30:.2f} GiB")
        rep[f"oct5_diff_{route}_warm_s"] = warm[0]
    rep["launches_diff_oct5"] = 1
    band1, band2, n = diff_bands(x, y, v, x2, y2, v2, dcfg,
                                 local_runner(dev))
    start, _ = chunk_grid(n, dcfg.chunk_size, dcfg.distance_px)
    ddet = build_diff_detector(dcfg, dcfg.chunk_size, device=dev)
    tie = make_diff_tie(ddet, band1, band2, start, dcfg.resolution)
    n_c, worst = compare_diff_to_golden(drows["kernel"], drows["ladder"], tie)
    say(f"[12] diff -oc 5: {n_c} kernel-route rows equal to the ladder "
        f"route's per tag (q max rel err {worst:.3g})")
    k = stacked_report("12", ddet, band1, band2, start, dcfg.distance_px)
    rep.update({f"{key}_diff_oct5": val for key, val in k.items()})
    del band1, band2

    # (e) the row window: four parts joined against the whole-block
    # launch, and the dense runner on 1 x 4 entries of cuda:0
    blocks = chr21_dense_blocks(dev)
    det = build_detector(cfg, 2000, device=dev)
    cs, nz = _preamble(torch.from_numpy(blocks).to(dev), 400)
    nzf = nz.to(torch.float32)
    del nz
    kw = dict(R=R, n_octaves=5, planes_per_octave=spec.planes_per_octave,
              DB=band_width(2000, 400))
    full = fl.fused_ladder_window(cs, nzf, det.taps, radii=det.radii, **kw)
    fl.LAUNCHES = 0
    joined = joined_windows(cs, nzf, det, kw, 2000, 4)
    window_launches = fl.LAUNCHES
    if not all(torch.equal(a, b) for a, b in zip(joined, full)):
        fail("-oc 5: row windows of 4 parts do not join to the whole-block "
             "launch")
    say(f"[12] row windows -oc 5: 4 parts ({window_launches} launches) "
        f"joined == the whole-block launch of chr21's six 2000^2 blocks "
        f"(bit-identical)")
    win = window_report("12", cs, nzf, det, kw, 2000)
    rep.update({f"{k}_oct5": val for k, val in win.items()})
    del cs, nzf, full, joined
    torch.cuda.empty_cache()
    base = {k: a.cpu().numpy() for k, a in det.fn(
        torch.from_numpy(blocks).to(dev)).items()}
    runner = make_runner(make_mesh(1, 4, devices=["cuda:0"] * 4))
    dets = runner.per_device(lambda d: build_detector(cfg, 2000, device=d))
    fl.LAUNCHES = 0
    out = runner(dets, blocks)
    torch.cuda.synchronize()
    for k, want in base.items():
        if not np.array_equal(out[k], want,
                              equal_nan=want.dtype.kind == "f"):
            fail(f"-oc 5 row axis 1x4: {k} differs from n_row = 1")
    if min(runner.launches) <= 0 or sum(runner.launches) != fl.LAUNCHES:
        fail(f"-oc 5 row axis 1x4: launches {runner.launches}, counted "
             f"{fl.LAUNCHES}")
    say(f"[12] the dense runner on 1x4 cuda:0 at -oc 5 equals n_row = 1, "
        f"fused launches per entry {runner.launches}; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    rep["launches_row_window_oct5"] = list(runner.launches)
    return rep


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

COOL_EXPECTED = os.path.join(ROOT, "tests", "data",
                             "torch_port_cool_expected.json")
COOL_FIXTURES = [os.path.join(ROOT, "tests", "data",
                              f"torch_port_cooler_layout.{ext}")
                 for ext in ("cool", "mcool")]
COOL_PAIRS = [("chr1", "chr1"), ("chr2", "chr2"), ("chr1", "chr2"),
              ("chr2", "chr1")]


def cool_digests(mod, cool, mcool) -> dict:
    """What the ``.cool`` reader module ``mod`` reads from the two fixture
    files: ``"<file> <c1> <c2> <balance>" -> [pixels, dtypes, sha256 of x,
    y and v]`` for intra and inter fetches (300 kb), balanced through the
    CLI's entry points and raw through ``CoolFile``, and each file's
    chromosome list."""
    import hashlib

    out = {}
    for label, path, res in (("cool", cool, None), ("mcool", mcool, 5000)):
        clr = mod.CoolFile(path, resolution=res)
        for c1, c2 in COOL_PAIRS:
            raw = (clr.fetch_band(c1, 300_000, balance=False) if c1 == c2
                   else clr.fetch_rect(c1, c2, balance=False))
            bal = (mod.read_cooler(path, 300_000, c1, c2, True)[:3]
                   if res is None else
                   mod.read_mcooler(path, 300_000, c1, c2, res, True))
            for tag, t in (("raw", raw), ("balanced", bal)):
                out[f"{label} {c1} {c2} {tag}"] = (
                    [len(t[0]), " ".join(str(a.dtype) for a in t)]
                    + [hashlib.sha256(np.ascontiguousarray(a).tobytes())
                       .hexdigest() for a in t])
        clr.close()
        out[f"{label} chromosomes"] = mod.cool_chrom_list(path, res)
    return out


@contextlib.contextmanager
def python_decoder():
    """``HicFile._decode_blocks`` on its Python twin: the yardstick the
    native decoder is timed against, never a path of the program."""
    from mustache_tpu_torch.io.hic import HicFile

    saved = HicFile._decode_blocks
    HicFile._decode_blocks = HicFile._decode_blocks_plain
    try:
        yield
    finally:
        HicFile._decode_blocks = saved


def write_hic_pairs(path, n1, n2, intra, inter):
    """Version 8 ``.hic`` of chromosomes c1 (n1 bins, the intra map) and
    c2 (n2 bins) with their c1 x c2 contacts, KR vectors of ones."""
    from hic_writer import write_hic

    write_hic(path, [("c1", n1 * 5000), ("c2", n2 * 5000)], 5000,
              {"c1": intra, ("c1", "c2"): inter}, version=8,
              norms={("KR", "c1"): np.ones(n1), ("KR", "c2"): np.ones(n2)})


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

BH_MODES = ("count", "sort")
# the BH tie case: 50 of 100 tested tied at p = 0.02, pt = 0.05, capacity
# 35, where the JAX package's one-pass overflow test sees nothing
TIE = dict(n=100, tied=50, p=0.02, pt=0.05, K=35)


def bh_reject(p, pt):
    """Indices a numpy BH (statsmodels ``fdr_bh``'s form) rejects."""
    order = np.argsort(p, kind="stable")
    ranked = p[order] * len(p) / np.arange(1, len(p) + 1)
    q = np.minimum.accumulate(ranked[::-1])[::-1]
    return set(order[q < pt].tolist())


def phase_tie_block(dev):
    """The tie block through ``_band_candidates`` on the card in count
    mode: overflow must be reported with sig_count >= 50, and the regrow
    (``detect._maybe_regrow``) must end at sort mode's 50 rejections,
    which a numpy BH also gives."""
    from mustache_tpu_torch import DetectionConfig
    from mustache_tpu_torch import detect as td
    from mustache_tpu_torch.detect import _maybe_regrow

    rng = np.random.default_rng(13)
    p = np.concatenate([np.full(TIE["tied"], TIE["p"]),
                        rng.uniform(0.5, 1.0, TIE["n"] - TIE["tied"])])
    rng.shuffle(p)
    N, d_px = 16, 8
    geom = td._BandGeom(N, d_px, dev)
    cells = torch.nonzero(geom.band_validl.reshape(-1))[:TIE["n"], 0]
    logp = torch.full((N * geom.Dl,), math.inf, device=dev)
    logp[cells] = torch.from_numpy(np.log(p).astype(np.float32)).to(dev)
    nz = torch.zeros(N * geom.Dl, dtype=torch.bool, device=dev)
    nz[cells] = True
    shape = (1, N, geom.Dl)
    log_pt = float(np.float32(math.log(TIE["pt"])))
    caps = []

    def tables(K, mode):
        td._BH_MODE = mode
        caps.append(K)
        out = td._band_candidates(
            geom, band_logp=logp.reshape(shape), band_nz=nz.reshape(shape),
            band_sigidx=torch.zeros(shape, dtype=torch.int32, device=dev),
            band_c=torch.ones(shape, device=dev),
            ceil_table=torch.ones(18, dtype=torch.int64, device=dev),
            ceil_max=1, st=0.0, log_pt=log_pt, K=K)
        if out["cand_x"].device != dev:
            fail("the tie block's tables left the card")
        return {k: a[0].cpu().numpy() for k, a in out.items()}

    def rejected(out):
        ok = out["cand_valid"]
        flat = (out["cand_x"][ok] * geom.Dl + out["cand_y"][ok]
                - out["cand_x"][ok])
        where = {int(c): i for i, c in enumerate(cells.cpu().tolist())}
        return {where[int(f)] for f in flat}

    first = tables(TIE["K"], "count")
    final = _maybe_regrow(first, DetectionConfig(max_candidates=TIE["K"]),
                          lambda cap: tables(cap, "count"),
                          lambda o: int(o["sig_count"]))
    sort = tables(128, "sort")
    want = bh_reject(p, TIE["pt"])
    if int(first["sig_count"]) < TIE["tied"]:
        fail(f"count mode missed the tie block's overflow: sig_count "
             f"{int(first['sig_count'])} at K={TIE['K']}")
    if not (rejected(final) == rejected(sort) == want
            and len(want) == TIE["tied"]):
        fail(f"tie block: {len(rejected(final))} rejections after the "
             f"regrow, sort mode {len(rejected(sort))}, numpy BH "
             f"{len(want)}")
    say(f"[13] tie block on the card ({TIE['tied']} of {TIE['n']} tested at "
        f"p={TIE['p']}, pt={TIE['pt']}, K={TIE['K']}): count mode reported "
        f"sig_count {int(first['sig_count'])}, regrew at capacities "
        f"{caps[1:-1]} to {len(rejected(final))} rejections, equal to sort "
        f"mode's and to a numpy BH's")
    return int(first["sig_count"])


def compare_tables(got, ref, label, suffixes=("",)):
    """Fail unless two batches' candidate tables agree where the BH modes
    must: counts, the valid mask, every valid slot's position, scale, q
    and pass flags bit for bit, and the significant neighbours' q."""
    for m in suffixes:
        ok = ref["cand_valid" + m]
        for k in ("n_tested", "sig_count", "cand_valid"):
            if not torch.equal(got[k + m], ref[k + m]):
                fail(f"{label}: {k + m} differs between the BH modes")
        for k in ("cand_x", "cand_y", "cand_sigidx", "cand_logq",
                  "pass_sparse", "pass_enrich", "cand_pass",
                  "neigh_sigidx"):
            if not torch.equal(got[k + m][ok], ref[k + m][ok]):
                fail(f"{label}: valid {k + m} differs between the BH modes")
        lq_g, lq_r = got["neigh_logq" + m][ok], ref["neigh_logq" + m][ok]
        sig = lq_r < math.log(PT)
        if not (torch.equal(lq_g < math.log(PT), sig)
                and torch.equal(lq_g[sig], lq_r[sig])):
            fail(f"{label}: significant neighbours differ between the BH "
                 f"modes")
        if int(ok.sum()) == 0:
            fail(f"{label}: no significant candidate to compare")
    return int(sum(ref["cand_valid" + m].sum() for m in suffixes))


def range_top(trace_dir, name, k=6):
    """The ``k`` kernels with the most device time among those launched
    inside the profiler range ``name`` (by launch correlation, as
    :func:`trace_range_time`): ``(kernel name, ms, calls)``."""
    spans, launches, kernels = [], {}, []
    for fname in os.listdir(trace_dir):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(trace_dir, fname)) as fh:
            trace = json.load(fh)
        for ev in trace.get("traceEvents", []):
            cat = ev.get("cat", "")
            corr = ev.get("args", {}).get("correlation")
            if cat == "user_annotation" and ev.get("name") == name:
                spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ev["ts"]
            elif cat == "kernel" and corr is not None:
                kernels.append((corr, ev["name"], ev.get("dur", 0) / 1e3))
    by_name = {}
    for corr, kname, ms in kernels:
        t = launches.get(corr)
        if t is not None and any(t0 <= t <= t1 for t0, t1 in spans):
            tot, n = by_name.get(kname, (0.0, 0))
            by_name[kname] = (tot + ms, n + 1)
    return sorted(((n, t, c) for n, (t, c) in by_name.items()),
                  key=lambda r: -r[1])[:k]


def profile_launches(fn, names):
    """One profiled run of ``fn``: device ms of the kernels launched in
    each named range (:func:`trace_range_time`), the top kernels of the
    last range (:func:`range_top`), the run's kernel ms and its counts of
    kernel launches and of copies and sets; ``None`` where the trace holds
    no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        ranges = trace_range_time(tmp, names)
        top = range_top(tmp, names[-1])
        by_cat, _ = trace_device_time(tmp)
        with open(path) as fh:
            cats = [ev.get("cat", "") for ev in
                    json.load(fh).get("traceEvents", [])]
    if by_cat.get("kernel", 0.0) <= 0:
        return None
    return dict(ranges=ranges, top=top, kernel_ms=by_cat["kernel"],
                kernels=cats.count("kernel"),
                copies=cats.count("gpu_memcpy") + cats.count("gpu_memset"))


def phase_bh_modes(dev):
    """Phase 13: both BH modes and the batched epilogue on chr21 5 kb, the
    1 kb slice and the two-condition diff, in one process."""
    from mustache_tpu_torch import (
        DetectionConfig, detect_diff_loops_coo, detect_loops_coo,
    )
    from mustache_tpu_torch import detect as td
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.diff import build_diff_detector
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.pipeline import local_runner, normalized_bands

    t_phase = time.perf_counter()
    default = td._BH_MODE
    if default != "count":
        fail(f"the default BH mode is {default!r}, not count")
    rep = {"tie_sig_count": phase_tie_block(dev)}

    (n5, _), _ = CHR21
    (n1, d1), _ = SLICE_1KB
    cfg5 = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=PT,
                           st=ST)
    cfg1 = DetectionConfig(resolution=1000, distance_bp=d1 * 1000, pt=PT,
                           st=ST)
    cfgd = cfg5.with_(pt2=PT2)
    m5, m1 = workload(CHR21), workload(SLICE_1KB)
    md = m5 + workload(CHR21_COND2)
    _, golden5 = read_tsv(GOLDEN)
    _, golden1 = read_tsv(GOLDEN_1KB)
    _, goldend = read_tsv(GOLDEN_DIFF)
    runner = local_runner(dev)

    # the valid tables of each workload's first batch, both modes
    for label, (x, y, v), cfg in (("chr21 5 kb", m5, cfg5),
                                  ("1 kb", m1, cfg1)):
        n = int(max(x.max(), y.max())) + 1
        width, d_px = cfg.chunk_size, cfg.distance_px
        shape = (bucket_rows(max(n, width)), td.band_width(width, d_px))
        (band,), _ = normalized_bands(x, y, v, cfg, shape, n, runner,
                                      normalize=True, exact=False)
        starts = chunk_grid(n, width, d_px)[0]
        det = td.build_detector(cfg, width, device=dev)
        outs = {}
        for mode in BH_MODES:
            td._BH_MODE = mode
            outs[mode] = det.fn_band(band, starts)
        n_valid = compare_tables(outs["count"], outs["sort"], label)
        say(f"[13] {label}: {len(starts)} blocks in one batch, {n_valid} "
            f"valid candidates, the tables bit-identical between the modes")
        del band, outs
    b1, b2, n = diff_bands(*md, cfgd, runner)
    ddet = build_diff_detector(cfgd, cfgd.chunk_size, device=dev)
    dstarts = chunk_grid(n, cfgd.chunk_size, cfgd.distance_px)[0]
    outs = {}
    for mode in BH_MODES:
        td._BH_MODE = mode
        outs[mode] = ddet.fn_band(b1, b2, dstarts)
    n_valid = compare_tables(outs["count"], outs["sort"], "diff", ("1", "2"))
    say(f"[13] diff: {len(dstarts)} blocks a condition in one batch, "
        f"{n_valid} valid candidates, both conditions' tables bit-identical "
        f"between the modes")
    del outs
    tie = make_diff_tie(ddet, b1, b2, dstarts, cfgd.resolution)
    del b1, b2
    torch.cuda.empty_cache()

    # each workload through its entry point in both modes: rows against
    # the golden and against the other mode, warm walls in turns, one
    # profiled run each
    logs = []
    calls = {
        "5kb": (lambda c: detect_loops_coo(*m5, c, log=logs.append), cfg5,
                "detect"),
        "1kb": (lambda c: detect_loops_coo(*m1, c, log=logs.append), cfg1,
                "detect"),
        "diff": (lambda c: detect_diff_loops_coo(*md, c, log=logs.append),
                 cfgd, "diff"),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    count_rows = {}
    for label, (call, cfg, prefix) in calls.items():
        names = tuple(f"{prefix}.{s}" for s in (
            ("preamble", "kernel", "epilogue") if prefix == "detect"
            else ("preamble", "fused_ladder", "planes", "epilogue")))
        rows, walls, prof = {}, {m: [] for m in BH_MODES}, {}
        for mode in BH_MODES:                          # warm both
            td._BH_MODE = mode
            fl.LAUNCHES = 0
            rows[mode] = call(cfg)
            plan = dict(kv.split("=", 1) for kv in logs[-1].split()
                        if kv.split("=")[0] in ("blocks", "batch"))
            batches = -(-int(plan["blocks"]) // int(plan["batch"]))
            if fl.LAUNCHES != batches:
                fail(f"{label} {mode}: {fl.LAUNCHES} fused launches for "
                     f"{batches} batches ({logs[-1]})")
        if rows["count"] != rows["sort"]:
            fail(f"{label}: rows differ between the BH modes")
        count_rows[label] = rows["count"]
        if prefix == "diff":
            compare_diff_to_golden(diff_tsv_rows(rows["count"], "chr21",
                                                 cfg.resolution), goldend,
                                   tie)
        else:
            chrom, golden = (("chr21", golden5) if label == "5kb"
                             else ("chr1", golden1))
            compare_to_golden(loops_tsv_rows(rows["count"], chrom,
                                             cfg.resolution), golden,
                              tag="13")
        for _ in range(3):                             # in turns
            for mode in BH_MODES:
                td._BH_MODE = mode
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = call(cfg)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                if again != rows[mode]:
                    fail(f"{label} {mode}: a warm rerun gave other rows")
        for mode in BH_MODES:
            td._BH_MODE = mode
            prof[mode] = profile_launches(lambda: call(cfg), names)
        for mode in BH_MODES:
            pm = prof[mode]
            med = sorted(walls[mode])[1]
            rep[f"{label}_{mode}"] = dict(
                warm_s=walls[mode], warm_median_s=med, profile=pm)
            if pm is None:
                dev_note = "device time not measured (no device events)"
            else:
                dev_note = (
                    f"{pm['kernel_ms']:.2f} ms of kernels, "
                    + ", ".join(f"{k} {v:.2f} ms"
                                for k, v in pm["ranges"].items())
                    + f"; {pm['kernels']} kernel launches and "
                    f"{pm['copies']} copies/sets per chromosome")
            say(f"[13] {label} BH {mode}: {len(rows[mode])} rows (equal "
                f"to the golden and to the other mode's); warm "
                f"{' '.join(f'{w:.4f}' for w in walls[mode])} s (median "
                f"{med:.4f}); {dev_note}; {smi}")
            for kname, kms, n in (pm or {}).get("top", []):
                say(f"[13]   {names[-1]}: {kms:8.3f} ms {n:4d}x "
                    f"{kname[:90]}")

    # chr21 5 kb in batches of 2 (3 batches, pipelined) and of 1
    td._BH_MODE = default
    for bb in (2, 1):
        cfg = cfg5.with_(block_batch=bb)
        logs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = detect_loops_coo(*m5, cfg, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if f"batch={bb} " not in logs[0]:
            fail(f"block_batch={bb} did not run in batches of {bb}: "
                 f"{logs[0]}")
        if got != count_rows["5kb"]:
            fail(f"chr21 5 kb in batches of {bb} gave other rows")
        rep[f"5kb_batches_of_{bb}_s"] = wall
        say(f"[13] chr21 5 kb in batches of {bb} (pipelined): the rows of "
            f"one batch; wall {wall:.4f} s; {logs[0]}")
    say(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s; {smi}")
    return rep


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------

# whole chromosomes at 1 kb: the 1 kb slice's parameters over all of hg38
# chr21 (46,709,983 bp), and hg38 chr1 (248,956,422 bp) at a density of
# 0.9 falling as (1 + d)^-0.25 (0.76 next to the diagonal, 0.13 at 2 Mb:
# sparse away from the diagonal, as a Micro-C map at 1 kb is; 88.7 M
# contacts where the slice's density would give 413 M)
CHR21_1KB = ((46710, 2000), dict(seed=1011, n_loops=580, loop_strength=3.0,
                                 density=0.95))
CHR1_1KB = ((248956, 2000), dict(seed=1001, n_loops=3100, loop_strength=3.0,
                                 density=0.9, density_decay=0.25))
GOLDEN_CHR21_1KB = os.path.join(ROOT, "tests", "data",
                                "torch_port_chr21_1kb_golden.tsv")
GOLDEN_CHR1_1KB = os.path.join(ROOT, "tests", "data",
                               "torch_port_chr1_1kb_golden.tsv")
WHOLE_RANGES = ("pipeline.upload", "pipeline.normalize", "detect.preamble",
                "detect.kernel", "detect.epilogue", "pipeline.finish")
NORM_PEAK_BANDS = 4   # the normalize stage's peak, in f32 bands, at most
NEAR_BINS = 2         # a call "finds" a planted anchor within this many bins


def whole_chrom_cfg(spec):
    from mustache_tpu_torch import DetectionConfig

    (_, d_px), _ = spec
    return DetectionConfig(resolution=1000, distance_bp=d_px * 1000, pt=PT,
                           st=ST)


def whole_chrom_geometry(spec, n=None):
    """``(blocks, band shape)`` of a whole-chromosome workload at ``n``
    bins (default: the chromosome's), from the port's own geometry."""
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.detect import band_width

    (n_bins, _), _ = spec
    n = n_bins if n is None else n
    cfg = whole_chrom_cfg(spec)
    width, d_px = cfg.chunk_size, cfg.distance_px
    return (len(chunk_grid(n, width, d_px)[0]),
            (bucket_rows(max(n, width)), band_width(width, d_px)))


def plan_batches(plan: str):
    """``(blocks, batch, batches)`` from a ``detect_plan`` line."""
    kv = dict(t.split("=", 1) for t in plan.split() if "=" in t)
    blocks, batch = int(kv["blocks"]), int(kv["batch"])
    return blocks, batch, -(-blocks // batch)


def planted_shares(loops, anchors, tol=NEAR_BINS):
    """(share of planted anchors with a call within ``tol`` bins on both
    axes, share of calls within ``tol`` bins of a planted anchor)."""
    a = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    c = np.array([(lp.bin1, lp.bin2) for lp in loops],
                 dtype=np.int64).reshape(-1, 2)
    if not len(a) or not len(c):
        return 0.0, 0.0
    near = ((np.abs(a[:, None, 0] - c[None, :, 0]) <= tol)
            & (np.abs(a[:, None, 1] - c[None, :, 1]) <= tol))
    return float(near.any(1).mean()), float(near.any(0).mean())


def start_workload_process(spec, path):
    """A second Python process that makes ``spec``'s map and saves it as
    ``path`` (``.npz``: x, y, v, anchors), so one chromosome's map is
    made while the card works on another. The caller waits for it
    (:func:`load_workload_process`)."""
    code = ("import json, sys; import numpy as np; "
            "sys.path.insert(0, sys.argv[1]); "
            "from synthetic import synthetic_hic; "
            "a, kw = json.loads(sys.argv[2]); "
            "x, y, v, anchors = synthetic_hic(*a, **kw); "
            "np.savez(sys.argv[3], x=x, y=y, v=v, "
            "anchors=np.array(anchors, dtype=np.int64).reshape(-1, 2))")
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.join(ROOT, "tests"), json.dumps(spec),
                             path])


def load_workload_process(proc, path, timeout=900):
    """The map :func:`start_workload_process` saved, once its process
    ends (killed if it outlives ``timeout`` seconds); the file is
    removed."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        fail(f"the workload process exited {rc}")
    with np.load(path) as z:
        out = z["x"], z["y"], z["v"], z["anchors"]
    os.remove(path)
    return out


def whole_band_normalize(band_raw, n, resolution, distance_in_px,
                         exceptions=None, packed4=False):
    """The device normalize as one whole-band pass, the port's form
    before its row slabs: every window sum from f64 cumsums of the whole
    band (three band-sized f64 arrays and their shifted copies at once).
    Phase 14 and tests/test_torch_whole_chrom.py hold
    ``bandnorm.normalize_band_device`` to it bit for bit."""
    from mustache_tpu_torch.bandnorm import _norm_regime, widen_with_exceptions

    band = widen_with_exceptions(band_raw, exceptions, packed4)
    rows, Dl = band.shape
    regime = _norm_regime(rows, Dl, n, resolution, distance_in_px)
    occ = band != 0
    cnt_g = occ.to(band.dtype).sum(0)
    mean_g = band.sum(0) / cnt_g
    mean_g = torch.where(torch.isfinite(mean_g), mean_g, 0.0)
    var = torch.where(occ, (band - mean_g[None, :]) ** 2, 0.0).sum(0) / cnt_g
    std_g = torch.sqrt(var)
    std_g = torch.where(torch.isfinite(std_g), std_g, 1.0)
    weights = 1.0 + torch.log1p(mean_g) / math.log(30.0)
    dcol = torch.arange(Dl, device=band.device)[None, :]
    if regime[0] == "global":
        z = (band - mean_g[None, :]) / std_g[None, :]
        z = torch.where(torch.isfinite(z), z, 0.0)
        return (torch.where(occ & (dcol < regime[1]), z, band),
                band.new_zeros((0,)))
    _, F, Dv, short_cols = regime

    def cumsum0(a):
        cs = torch.cumsum(a, dim=0, dtype=torch.float64)
        return torch.cat([torch.zeros_like(cs[:1]), cs], 0)

    if short_cols:
        lend = np.clip(n - np.arange(Dl), 0, rows)
        offd = np.where(lend < F, (np.maximum(lend, 1) - 1) // 2,
                        (F - 1) // 2)
        i = np.arange(rows)[:, None]
        hi_idx, lo_idx = (torch.as_tensor(a, dtype=torch.int64,
                                          device=band.device) for a in (
            np.clip(i + offd[None, :] + 1, 0, lend[None, :]),
            np.clip(i + offd[None, :] - F + 1, 0, lend[None, :])))

        def win(a):
            cs = cumsum0(a)
            return (torch.gather(cs, 0, hi_idx)
                    - torch.gather(cs, 0, lo_idx)).to(a.dtype)
    else:
        off = (F - 1) // 2

        def win(a):
            cs = cumsum0(a)
            hi = torch.cat([cs, cs[-1:].expand(off, Dl)], 0)[
                off + 1: off + 1 + rows]
            sh = off - F + 1
            lo = torch.cat([cs.new_zeros((-sh, Dl)), cs[: rows + sh]], 0)
            return (hi - lo).to(a.dtype)

    bandp = torch.where(occ, band + 0.001, 0.0)
    mcol = mean_g + 0.001
    bc = torch.where(occ, bandp - mcol[None, :], 0.0)
    cnt, s1c, s2c = win(occ.to(band.dtype)), win(bc), win(bc * bc)
    lm = mcol[None, :] + s1c / cnt
    lv = (s2c - s1c * s1c / cnt) / (cnt - 1)
    gs2 = (std_g * std_g)[None, :].expand_as(lv)
    gm = mean_g[None, :].expand_as(lm)
    lv = torch.where(torch.isfinite(lv), lv, gs2)
    low = cnt < 30
    lm = torch.where(low, gm, lm)
    lv = torch.where(low, gs2, lv)
    lm = torch.where(torch.isfinite(lm), lm, gm)
    z = (bandp - lm) / torch.sqrt(lv)
    z = torch.where(torch.isfinite(z), z, 0.0)
    z = z * weights[None, :]
    return torch.where(occ & (dcol < Dv), z, band), weights[:Dv]


def whole_trace_report(path):
    """One pass over a profiled whole-chromosome run's Chrome trace:
    device ms of the kernels, copies and sets launched in each of
    ``WHOLE_RANGES`` (by launch correlation, as :func:`trace_range_time`),
    the f64 cumsums' ms among the normalize's (kernels named ``*scan*``),
    the fused kernel's ms and launches, the host ms of each range's CPU
    spans, and the device ms by category (kernel, memcpy, memset)."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans, launches, kernels = [], {}, []
    by_cat = {}
    host = {k: 0.0 for k in WHOLE_RANGES}
    for ev in events:
        cat = ev.get("cat", "")
        corr = ev.get("args", {}).get("correlation")
        if cat == "user_annotation" and ev.get("name") in host:
            spans.append((ev["name"], ev["ts"], ev["ts"] + ev["dur"]))
            host[ev["name"]] += ev["dur"] / 1e3
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ev["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms = ev.get("dur", 0) / 1e3
            by_cat[cat] = by_cat.get(cat, 0.0) + ms
            if corr is not None:
                kernels.append((corr, ev["name"], ms))
    dev = {k: 0.0 for k in WHOLE_RANGES}
    scan_ms = fused_ms = 0.0
    fused_n = 0
    for corr, name, ms in kernels:
        if "fused_ladder" in name:
            fused_ms += ms
            fused_n += 1
        t = launches.get(corr)
        for rname, t0, t1 in spans:
            if t is not None and t0 <= t <= t1:
                dev[rname] += ms
                if rname == "pipeline.normalize" and "scan" in name:
                    scan_ms += ms
                break
    return dict(device_ms=dev, host_ms=host, scan_ms=scan_ms,
                fused_ms=fused_ms, fused_launches=fused_n, by_cat=by_cat)


def profile_whole(fn):
    """One profiled run of ``fn``: its wall and :func:`whole_trace_report`
    of its trace; None where the trace holds no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        rep = whole_trace_report(path)
    if rep["by_cat"].get("kernel", 0.0) <= 0:
        return None
    rep["wall_s"] = wall
    rep["busy_share"] = sum(rep["by_cat"].values()) / 1e3 / wall
    return rep


def whole_bound_ms(spec, blocks):
    """The kernel's bound (:func:`kernel_bound`) over all of a whole
    chromosome's blocks at the default ladder, in ms."""
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.scalespace import build_ladder

    cfg = whole_chrom_cfg(spec)
    N = cfg.chunk_size
    return kernel_bound(build_ladder(cfg.octave_values), N,
                        band_width(N, cfg.distance_px), blocks)[2]


def hold_batch_to_plain(label, band, starts, cfg, dev):
    """The fused kernel against its plain version on the main path's
    batch: the chromosome's first blocks at the batch the rule picked
    (``starts``), cut from its normalized band as the detector cuts them,
    under phase 3's checks; both timed with CUDA events. Returns the
    report's numbers."""
    from mustache_tpu_torch.detect import _preamble, band_width, dense_from_band
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.scalespace import (
        build_ladder, ladder_tensor, radii_tensor,
    )

    N, d_px = cfg.chunk_size, cfg.distance_px
    DB = band_width(N, d_px)
    spec = build_ladder(cfg.octave_values)
    taps = ladder_tensor(spec.kernels, dev)
    radii = radii_tensor(spec.blur_sigmas, dev)
    slices = torch.stack([band[s: s + N] for s in starts])
    cs, nz = _preamble(dense_from_band(slices), d_px)
    nzf = nz.to(torch.float32)
    del nz
    B = len(starts)
    err, locs_err, sums_rel, n_sig, kw = hold_to_plain(
        "14", label, cs, nzf, slices, [1] * B, spec, taps, radii, d_px, DB)
    ms = cuda_ms(lambda: fl.fused_ladder_nms_batched(
        cs, nzf, taps, radii=radii, **kw), reps=5)
    plain_ms = cuda_ms(
        lambda: fl.fused_ladder_nms_reference(cs, nzf, taps, **kw), reps=1)
    flop, nbytes, bound_ms, bound_by = kernel_bound(spec, N, DB, B)
    say(f"[14] {label}: the kernel on the main path's first batch (B={B}, "
        f"N={N}, DB={DB}) against its plain version: {n_sig} significant "
        f"candidates equal, band_v max abs err {err:.3g}, locs "
        f"{locs_err:.3g}, sums rel {sums_rel:.3g}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms; {flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB "
        f"-> bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}")
    del cs, nzf, slices
    torch.cuda.empty_cache()
    return dict(B=B, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms)


def whole_chrom_run(label, spec, coo, anchors, dev, smi, *, golden=None,
                    workdir=None, check_whole_norm=False, hold_batch=False):
    """Phase 14 on one chromosome: the host band fill and streamed upload
    timed; the normalize stage alone (its peak device memory at most
    ``NORM_PEAK_BANDS`` f32 bands, its CUDA-event ms; with
    ``check_whole_norm`` equal by ``torch.equal`` to
    :func:`whole_band_normalize`); ``detect_loops_coo`` cold (one fused
    launch a batch, the call's peak above the normalize's, rows held to
    ``golden`` under phase 4's rule where given), three times warm, and
    in turns auto, ``block_batch=1``, ``block_batch=1``, auto (every run's
    rows identical to the cold run's); one profiled warm run (device ms
    by stage, the cumsums' share of the normalize, host finish, busy
    share); the planted anchors found; with ``workdir``, the CLI from an
    ``.mcool`` of the map held to ``golden``; with ``hold_batch``, the
    kernel against its plain version on the first batch."""
    from mustache_tpu_torch import detect_loops_coo
    from mustache_tpu_torch.bandnorm import normalize_band_device, pad_exceptions
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.pipeline import (
        fill_raw_band_compact, local_runner, normalized_bands,
        stream_band_to_device,
    )

    x, y, v = coo
    cfg = whole_chrom_cfg(spec)
    n = int(max(x.max(), y.max())) + 1
    blocks, shape = whole_chrom_geometry(spec, n)
    band_bytes = 4 * shape[0] * shape[1]
    rep = dict(contacts=len(v), n=n, blocks=blocks, band_rows=shape[0],
               band_cols=shape[1], band_f32_bytes=band_bytes)

    # the host fill alone, then the streamed upload (fill + H2D overlapped)
    t0 = time.perf_counter()
    fill_raw_band_compact(x, y, v, shape)
    rep["fill_ms"] = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    up = stream_band_to_device(x, y, v, shape, dev)
    torch.cuda.synchronize()
    rep["stream_ms"] = 1e3 * (time.perf_counter() - t0)
    pad = (None if up.exceptions is None
           else pad_exceptions(up.exceptions, shape[0]))

    def peak_of(fn):
        """``fn()``'s result and the device bytes it held at its peak
        beyond what was allocated before it (the raw band, for the
        normalize)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() - (
            up.band.numel() if up is not None else 0)
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    # the normalize stage alone: peak memory (the raw band included) and
    # CUDA-event ms of a second call (the first allocates the stage's
    # memory with cudaMalloc)
    def normalize(fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)

        def go():
            e0.record()
            out = fn(up.band, n, cfg.resolution, cfg.distance_px,
                     exceptions=pad, packed4=up.packed4)[0]
            e1.record()
            return out
        out, peak = peak_of(go)
        del out
        out = go()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1), peak

    norm, rep["normalize_ms"], rep["normalize_peak"] = normalize(
        normalize_band_device)
    ratio = rep["normalize_peak"] / band_bytes
    say(f"[14] {label}: {len(v)} contacts, n={n}, {blocks} blocks, band "
        f"{shape[0]} x {shape[1]} ({band_bytes / 1e9:.2f} GB as f32); host "
        f"fill {rep['fill_ms']:.1f} ms, streamed upload {up.describe()} "
        f"{rep['stream_ms']:.1f} ms; normalize {rep['normalize_ms']:.2f} ms, "
        f"peak {rep['normalize_peak'] / 2**30:.2f} GiB = {ratio:.2f} f32 "
        f"bands (raw band included)")
    if ratio > NORM_PEAK_BANDS:
        fail(f"{label}: the normalize stage peaked at {ratio:.2f} f32 bands "
             f"(at most {NORM_PEAK_BANDS})")
    if check_whole_norm:
        ref, rep["whole_normalize_ms"], rep["whole_normalize_peak"] = \
            normalize(whole_band_normalize)
        rep["normalize_equal"] = torch.equal(norm, ref)
        diff = (0.0 if rep["normalize_equal"]
                else float((norm - ref).abs().nan_to_num(0.0).max()))
        rep["normalize_max_diff"] = diff
        say(f"[14] {label}: the slabbed normalize "
            + ("equals the whole-band one (torch.equal)"
               if rep["normalize_equal"] else
               f"is NOT bit-identical to the whole-band one: largest "
               f"difference {diff:.3g}")
            + f"; whole-band {rep['whole_normalize_ms']:.2f} ms, peak "
            f"{rep['whole_normalize_peak'] / 2**30:.2f} GiB")
        del ref
    del norm, up, pad
    up = None
    torch.cuda.empty_cache()

    logs = []

    def call(bb=0):
        c = cfg.with_(block_batch=bb) if bb else cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops = detect_loops_coo(x, y, v, c, log=logs.append)  # the card
        torch.cuda.synchronize()
        return loops, time.perf_counter() - t0

    fl.LAUNCHES = 0
    (loops, cold), rep["call_peak"] = peak_of(call)
    launches = fl.LAUNCHES
    plan = logs[-1]
    _, batch, batches = plan_batches(plan)
    say(f"[14] {label}: {plan}")
    if "device=cuda" not in plan or "route=kernel" not in plan:
        fail(f"{label}: detect_loops_coo did not take the kernel route on "
             f"the card: {plan}")
    if launches != batches:
        fail(f"{label}: {launches} fused launches for {batches} batches")
    if rep["normalize_peak"] >= rep["call_peak"]:
        fail(f"{label}: the normalize stage set the call's peak "
             f"({rep['normalize_peak']} of {rep['call_peak']} B)")
    rows = loops_tsv_rows(loops, label, cfg.resolution)
    golden_note = "no golden in the tree"
    if golden is not None:
        want = read_tsv(golden)[1]
        n_common, worst = compare_to_golden(rows, want, tag="14")
        golden_note = (f"{n_common} rows equal to the JAX golden (q max rel "
                       f"err {worst:.3g})")
    if not loops and (golden is None or want):
        fail(f"{label}: no loops")
    if not loops:
        say(f"[14] {label}: no loops, as in the JAX golden: the sparsity "
            f"filter (c2 >= 0.6 over the box of half-width 2 s1) rejects "
            f"every significant candidate of this sparse map")
    rep.update(batch=batch, batches=batches, launches=launches,
               loops=len(loops), cold_s=cold)

    warm = []
    for _ in range(3):
        again, dt = call()
        warm.append(dt)
        if again != loops:
            fail(f"{label}: a warm rerun gave other rows")
    walls = {"auto": [], "serial": []}
    for mode in ("auto", "serial", "serial", "auto"):
        again, dt = call(1 if mode == "serial" else 0)
        walls[mode].append(dt)
        if again != loops:
            fail(f"{label}: the {mode} run gave other rows than one in "
                 f"batches of {batch}")
    if f"batch=1 " not in logs[-2]:
        fail(f"{label}: block_batch=1 did not run in batches of 1")
    rep.update(warm_s=warm, turns_auto_s=walls["auto"],
               turns_serial_s=walls["serial"])
    found, real = planted_shares(loops, anchors)
    rep.update(anchors_found=found, calls_at_anchors=real)
    say(f"[14] {label}: {len(loops)} loops, {golden_note}; {launches} fused "
        f"launches = {batches} batches of {batch}; in batches of 1 the same "
        f"rows bit for bit; planted anchors with a call within {NEAR_BINS} "
        f"bins {found:.3f}, calls within {NEAR_BINS} bins of one "
        f"{real:.3f}; peak device memory {rep['call_peak'] / 2**30:.2f} GiB "
        f"(normalize stage {rep['normalize_peak'] / 2**30:.2f}); wall cold "
        f"{cold:.3f} s, warm {' '.join(f'{w:.3f}' for w in warm)} s; turns "
        f"auto {walls['auto'][0]:.3f}, serial {walls['serial'][0]:.3f}, "
        f"serial {walls['serial'][1]:.3f}, auto {walls['auto'][1]:.3f} s; "
        f"{smi}")

    prof = profile_whole(call)
    rep["profile"] = prof
    if prof is None:
        say(f"[14] {label}: device time not measured (no device events in "
            f"the trace)")
    else:
        d, h = prof["device_ms"], prof["host_ms"]
        norm_ms = d["pipeline.normalize"]
        rep["ms_per_launch"] = prof["fused_ms"] / max(prof["fused_launches"],
                                                       1)
        say(f"[14] {label}: profiled warm run {prof['wall_s']:.3f} s, "
            f"device busy share {prof['busy_share']:.3f} ("
            + ", ".join(f"{k} {t:.1f} ms" for k, t in
                        sorted(prof["by_cat"].items()))
            + f"); device ms by stage: normalize {norm_ms:.2f} (f64 cumsums "
            f"{prof['scan_ms']:.2f}, share "
            f"{prof['scan_ms'] / max(norm_ms, 1e-9):.3f}), preamble "
            f"{d['detect.preamble']:.2f}, kernel {d['detect.kernel']:.2f} "
            f"({prof['fused_launches']} launches, "
            f"{rep['ms_per_launch']:.3f} ms each), epilogue "
            f"{d['detect.epilogue']:.2f}, upload copies "
            f"{d['pipeline.upload']:.2f}, "
            f"regrows in the finish {d['pipeline.finish']:.2f}; host ms: "
            f"upload {h['pipeline.upload']:.1f}, normalize "
            f"{h['pipeline.normalize']:.1f}, finish "
            f"{h['pipeline.finish']:.1f} over {blocks} blocks")

    if workdir is not None:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import write_cool

        (n_bins, _), _ = spec
        mcool = os.path.join(workdir, f"{label}_1kb.mcool")
        t0 = time.perf_counter()
        write_cool.write_mcool(
            mcool, {1000: ([(label, n_bins * 1000)], {label: (x, y, v)},
                           None)}, count_dtype=np.float64)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(mcool)
        out = os.path.join(workdir, f"{label}_1kb.tsv")
        fl.LAUNCHES = 0
        rc, events, wall = run_cli(["-f", mcool, "-ch", label, "-r", "1kb",
                                    "-o", out, "-pt", str(PT), "-st",
                                    str(ST)])
        os.remove(mcool)
        cli_plan = event(events, "detect_plan")["detail"] if rc == 0 else ""
        if rc != 0 or "device=cuda" not in cli_plan:
            fail(f"{label}: CLI from .mcool exited {rc}: {cli_plan}")
        if fl.LAUNCHES != plan_batches(cli_plan)[2]:
            fail(f"{label}: CLI {fl.LAUNCHES} fused launches for "
                 f"{plan_batches(cli_plan)[2]} batches")
        header, cli_rows = read_tsv(out)
        if cli_rows != rows:
            fail(f"{label}: CLI rows differ from detect_loops_coo's")
        cli_note = "equal to detect_loops_coo's"
        if golden is not None:
            n_common, worst = compare_to_golden(cli_rows, read_tsv(golden)[1],
                                                tag="14")
            cli_note += (f", {n_common} equal to the golden (q max rel err "
                         f"{worst:.3g})")
        ingest = event(events, "ingest")["seconds"]
        detect = event(events, "detect")["seconds"]
        rep.update(cli_wall_s=wall, cli_ingest_s=ingest, cli_detect_s=detect,
                   cli_launches=fl.LAUNCHES, mcool_bytes=size,
                   mcool_write_s=t_write)
        say(f"[14] {label}: CLI from .mcool ({size / 1e9:.2f} GB, float64 "
            f"counts, written in {t_write:.1f} s): {len(cli_rows)} rows "
            f"{cli_note}; {fl.LAUNCHES} fused launches; wall {wall:.3f} s = ingest "
            f"{ingest:.3f} s + detect {detect:.3f} s (the CLI's own log)")

    if hold_batch:
        (band,), _ = normalized_bands(x, y, v, cfg, shape, n,
                                      local_runner(dev), normalize=True,
                                      exact=False)
        start = chunk_grid(n, cfg.chunk_size, cfg.distance_px)[0]
        rep["first_batch"] = hold_batch_to_plain(label, band, start[:batch],
                                                 cfg, dev)
        del band
    torch.cuda.empty_cache()
    return rep


def phase_whole_chroms(dev):
    """Phase 14: the main path on whole chromosomes at 1 kb. chr1's map is
    made in a second process while chr21 runs."""
    from synthetic import synthetic_hic

    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.empty_cache()
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        path1 = os.path.join(tmp, "chr1_1kb.npz")
        proc = start_workload_process(CHR1_1KB, path1)
        try:
            (args, kw) = CHR21_1KB
            t0 = time.perf_counter()
            x, y, v, anchors = synthetic_hic(*args, **kw)
            say(f"[14] chr21 1 kb: {len(v)} contacts, {len(anchors)} planted "
                f"anchors, made in {time.perf_counter() - t0:.1f} s")
            rep["chr21"] = whole_chrom_run(
                "chr21", CHR21_1KB, (x, y, v), anchors, dev, smi,
                golden=GOLDEN_CHR21_1KB, workdir=tmp, check_whole_norm=True)
            del x, y, v
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        t0 = time.perf_counter()
        x, y, v, anchors = load_workload_process(proc, path1)
        say(f"[14] chr1 1 kb: {len(v)} contacts, {len(anchors)} planted "
            f"anchors, made in a second process (waited "
            f"{time.perf_counter() - t0:.1f} s for it after chr21)")
        rep["chr1"] = whole_chrom_run(
            "chr1", CHR1_1KB, (x, y, v), anchors, dev, smi,
            golden=GOLDEN_CHR1_1KB if os.path.exists(GOLDEN_CHR1_1KB)
            else None, hold_batch=True)
    say(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s; {smi}")
    return rep


def build_all():
    """Build the fused kernel (nvcc), the native band fill, host normalize,
    .hic decoder and HDF5 chunk decoder (g++) at the same time
    (``warmup.warm``), then load them."""
    from mustache_tpu_torch import warmup
    from mustache_tpu_torch.io import native
    from mustache_tpu_torch.kernels import build

    t0 = time.perf_counter()
    seconds = warmup.warm(torch.device("cuda"))
    say(f"[2] built {', '.join(sorted(seconds))} in "
        f"{time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(seconds.items()))
        + f") in {build.build_dir()}; the .hic decoder's zlib: "
        + ("entry points declared by hand (no zlib.h)"
           if native.hic_zlib_declared() else "zlib.h"))
    for ln in build.build_log("fused_ladder").splitlines():
        if "registers" in ln or "spill" in ln or "entry function" in ln:
            say(f"[2] {ln.strip()}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from mustache_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    build_all()

    report = phase_kernel_vs_plain(dev)
    launches, loops4, warm4 = phase_end_to_end()
    with tempfile.TemporaryDirectory() as workdir:
        files = phase_cli_files(dev, workdir)
        slice_1kb = phase_1kb(dev)
        diff, rows7 = phase_diff(dev)
        ladder = phase_ladder_route(dev, workdir)
        inter = phase_inter(dev, workdir)
        sharding = phase_sharding(dev, workdir, loops4, warm4, rows7)
        cool = phase_cool(dev, workdir, files)
        oct5 = phase_oct5(dev, workdir)
    bh = phase_bh_modes(dev)
    whole = phase_whole_chroms(dev)
    say(json.dumps({"phase5_5kb": files, "phase6_1kb": slice_1kb,
                    "phase7_diff": diff, "phase8_ladder": ladder,
                    "phase9_inter": inter, "phase10_sharding": sharding,
                    "phase11_cool": cool, "phase12_oct5": oct5,
                    "phase13_bh": bh, "phase14_whole": whole}))

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    r5, r1, r3 = report["5kb"], report["1kb"], report["5kb-3oct"]
    r4 = report["5kb-4oct"]
    say(json.dumps({"kernels": [{
        "name": "fused_ladder_nms",
        "route": "cuda",
        "source": "mustache_tpu_torch/kernels/csrc/fused_ladder.cu",
        "replaces": "mustache_tpu/kernels/fused_ladder.py:104",
        "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in report.values()]
                           + [whole["chr1"]["first_batch"]["max_abs_err"],
                              diff["max_abs_err_diff"],
                              sharding["max_abs_err_row_window"],
                              oct5["max_abs_err_diff_oct5"],
                              oct5["max_abs_err_row_window_oct5"]]),
        "ms": r5["ms"],
        "plain_ms": r5["plain_ms"],
        "bound_ms": r5["bound_ms"],
        "bound_by": r5["bound_by"],
        "library_ms": None,
        "share": r5["share"],
        "cudnn_blur_only_ms": r5["blur_ms"],
        "ms_1kb": r1["ms"],
        "plain_ms_1kb": r1["plain_ms"],
        "bound_ms_1kb": r1["bound_ms"],
        "share_1kb": r1["share"],
        "cudnn_blur_only_ms_1kb": r1["blur_ms"],
        "ms_3oct": r3["ms"],
        "plain_ms_3oct": r3["plain_ms"],
        "share_3oct": r3["share"],
        "ms_4oct": r4["ms"],
        "plain_ms_4oct": r4["plain_ms"],
        "bound_ms_4oct": r4["bound_ms"],
        "share_4oct": r4["share"],
        "launches_exact_normalize": ladder["exact_launches"],
        "launches_cli_text": files["cli_text_launches"],
        "launches_cli_hic": files["cli_hic_launches"],
        "launches_1kb": slice_1kb["launches_1kb"],
        "launches_diff": diff["launches_diff"],
        "ms_diff_stacked": diff["ms_diff_stacked"],
        "plain_ms_diff_stacked": diff["plain_ms_diff_stacked"],
        "bound_ms_diff_stacked": diff["bound_ms_diff_stacked"],
        "launches_cli_diff": diff["cli_diff_launches"],
        "launches_inter": inter["fused_launches_inter"],
        "launches_per_entry_sharded": {
            k[len("launches_"):]: v for k, v in sharding.items()
            if k.startswith("launches_")},
        "ms_row_window": sharding["ms_row_window"],
        "ms_full_block_b6": sharding["ms_full_block_b6"],
        "plain_ms_row_window": sharding["plain_ms_row_window"],
        "bound_ms_row_window": sharding["bound_ms_row_window"],
        "bound_by_row_window": sharding["bound_by_row_window"],
        "launches_cli_mcool": cool["cli_mcool_launches"],
        **{f"{key}_{tag}": report[label][key]
           for label, tag in (("5kb-oct5", "oct5"),
                              ("5kb-s3oct4", "s3oct4"),
                              ("1kb-oct5", "1kb_oct5"))
           for key in ("ms", "plain_ms", "bound_ms", "share")},
        "cudnn_blur_only_ms_oct5": report["5kb-oct5"]["blur_ms"],
        "cudnn_blur_only_ms_s3oct4": report["5kb-s3oct4"]["blur_ms"],
        "cudnn_blur_only_ms_1kb_oct5": report["1kb-oct5"]["blur_ms"],
        "ms_stream_mode_5kb": report["5kb"]["stream_ms"],
        "ms_stream_mode_4oct": r4["stream_ms"],
        "launches_oct5": oct5["launches_oct5"],
        "launches_cli_oct5": oct5["launches_cli_oct5"],
        "launches_1kb_oct5": oct5["launches_1kb_oct5_kernel"],
        "launches_diff_oct5": oct5["launches_diff_oct5"],
        **{f"{key}_diff_oct5": oct5[f"{key}_diff_oct5"]
           for key in ("ms", "plain_ms", "bound_ms", "share")},
        "cudnn_blur_only_ms_diff_oct5": oct5["blur_ms_diff_oct5"],
        "launches_row_window_oct5": oct5["launches_row_window_oct5"],
        **{f"{key}_row_window_oct5": oct5[f"{key}_row_window_oct5"]
           for key in ("ms", "plain_ms", "bound_ms")},
        "ms_full_block_b6_oct5": oct5["ms_full_block_b6_oct5"],
        "launches_oct6": 0,
        **{f"{key}_chr1_1kb_b{whole['chr1']['batch']}":
           whole["chr1"]["first_batch"][key]
           for key in ("ms", "plain_ms", "bound_ms", "share")},
        **{f"launches_{c}_1kb": whole[c]["launches"] for c in whole},
        **{f"batches_{c}_1kb": whole[c]["batches"] for c in whole},
        **{f"ms_per_launch_{c}_1kb": whole[c].get("ms_per_launch")
           for c in whole},
        **{f"bound_ms_per_launch_{c}_1kb": whole_bound_ms(
            CHR1_1KB if c == "chr1" else CHR21_1KB, whole[c]["blocks"])
           / whole[c]["batches"] for c in whole},
        "launches_cli_mcool_chr21_1kb": whole["chr21"]["cli_launches"],
        "ctas_per_sm": {k: r["ctas_per_sm"] for k, r in report.items()},
        "max_active_clusters": {k: r["max_clusters"]
                                for k, r in report.items()},
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
