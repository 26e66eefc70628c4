#!/usr/bin/env python3
"""Device memory a block of the differential batch holds, on the card.

Runs ``DiffBlockDetector.fn_band_packed`` (the whole batch: preamble,
the route's detection state of the stacked [2B] slots, the difference
planes of every real block at once, the epilogue) and ``diff_p_band``
alone (the difference planes) at several batch sizes B, and prints the
peak device bytes each allocates above what was resident before it
(both conditions' bands, the detector, and for the planes the stacked
blocks), with the per-block slope and the intercept of a straight-line
fit over B. Shapes: chr21 at 5 kb (N=2000, the bench diff leg, seeds
2021 and 2022) and the bench 1 kb slice's map at 1 kb (N=4000; its
second condition is the first with each count scaled by a seeded
log-normal factor). ``diff.detect_diff_loops_coo`` sizes its batch from
these slopes. Needs a CUDA card; imports nothing of JAX.

    python tools/diff_batch_memory.py [--precision float32|float64] [--shapes 5kb 1kb]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

# (label, resolution, synthetic_hic args and kwargs, batch sizes)
SHAPES = {
    "5kb": (5000, ((9629, 400), dict(seed=2021, n_loops=300,
                                     loop_strength=3.0)), (1, 2, 4, 8)),
    "1kb": (1000, ((12000, 2000), dict(seed=1011, n_loops=150,
                                       loop_strength=3.0, density=0.95)),
            (1, 2, 4)),
}


def peak_above(fn) -> int:
    """Peak bytes ``fn`` allocates above what is allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak)


def fit(Bs, peaks):
    """Least-squares slope and intercept of peaks over B."""
    slope, icpt = np.polyfit(np.asarray(Bs, float), np.asarray(peaks, float),
                             1)
    return float(slope), float(icpt)


def measure(label, precision):
    from synthetic import synthetic_hic

    from mustache_tpu_torch import DetectionConfig
    from mustache_tpu_torch.config import chunk_grid
    from mustache_tpu_torch.detect import _preamble, dense_from_band
    from chip_smoke import diff_bands
    from mustache_tpu_torch.diff import (
        build_diff_detector, diff_p_band, diff_planes,
    )
    from mustache_tpu_torch.pipeline import local_runner

    res, (args, kw), Bs = SHAPES[label]
    x1, y1, v1, _ = synthetic_hic(*args, **kw)
    if label == "5kb":
        x2, y2, v2, _ = synthetic_hic(*args, **{**kw, "seed": 2022})
    else:
        rng = np.random.default_rng(1012)
        x2, y2 = x1, y1
        v2 = v1 * rng.lognormal(0.0, 0.3, len(v1))
    dev = torch.device("cuda")
    cfg = DetectionConfig(resolution=res, distance_bp=2_000_000, pt=0.1,
                          st=0.8, pt2=0.1, precision=precision)
    N, d_px = cfg.chunk_size, cfg.distance_px
    band1, band2, n = diff_bands(x1, y1, v1, x2, y2, v2, cfg,
                                 local_runner(dev))
    det = build_diff_detector(cfg, N, device=dev)
    start, _ = chunk_grid(n, N, d_px)
    taps = det.taps[diff_planes(det.spec)]
    det.fn_band_packed(band1, band2, start[:1])          # warm-up
    whole, planes = [], []
    for B in Bs:
        starts = [start[i % len(start)] for i in range(B)]
        whole.append(peak_above(
            lambda: det.fn_band_packed(band1, band2, starts)))
        slices = torch.stack([b[s: s + N] for b in (band1, band2)
                              for s in starts])
        cs, nz = _preamble(dense_from_band(slices), d_px)
        del slices
        planes.append(peak_above(lambda: diff_p_band(
            cs[:B], cs[B:], nz[:B], nz[B:], taps, R=det.spec.radius,
            Dl=band1.shape[1], valid=[1] * B)))
        del cs, nz
    ws, wi = fit(Bs, whole)
    ps, pi = fit(Bs, planes)
    return {"shape": label, "precision": precision, "n": N,
            "Dl": int(band1.shape[1]), "B": list(Bs),
            "whole_peak_bytes": whole, "planes_peak_bytes": planes,
            "whole_per_block_bytes": ws, "whole_intercept_bytes": wi,
            "planes_per_block_bytes": ps, "planes_intercept_bytes": pi,
            "whole_per_block_over_n2": ws / N ** 2,
            "planes_per_block_over_n2": ps / N ** 2}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--shapes", nargs="+", default=["5kb", "1kb"],
                    choices=sorted(SHAPES))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("a CUDA card is required")
    for label in a.shapes:
        print(json.dumps(measure(label, a.precision)), flush=True)


if __name__ == "__main__":
    main()
