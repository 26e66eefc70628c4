"""Time the native band fill's pieces on a benchmark map.

Makes one chromosome of the benchmark's traffic (``benchmark/traffic/
<traffic>.json``, the first map, by ``benchmark/harness/mapgen.py`` on
``--device``), then times on the host, as medians of ``--reps`` calls:
the value census (``native.classify_values``), the u8 compact fill
(``native.fill_band_compact``) at each thread count of ``--threads``,
the one-pass fill with its census (``native.fill_band_u8_census``,
where the checkout has it) at the same counts, and the one-shot upload's
host fill (``pipeline.fill_raw_band_compact``). Prints one JSON line.

    python tools/band_fill_sweep.py [--device cuda] [--seed 2147483901]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402


def median_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return round(statistics.median(ts), 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default="chr21_hg19_5kb")
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--bp", type=int, default=None,
                    help="cut the chromosome to this length (a small trial)")
    a = ap.parse_args(argv)

    from benchmark.harness import mapgen
    from mustache_tpu_torch import pipeline
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.detect import band_width
    from mustache_tpu_torch.io import native

    cfg = json.loads((ROOT / "benchmark/configs/hic_5kb.json").read_text())
    traffic = json.loads(
        (ROOT / f"benchmark/traffic/{a.traffic}.json").read_text())
    depth, m = traffic["depth"], traffic["maps"][0]
    res = int(cfg["resolution"])
    d_px = int(cfg["distance_bp"]) // res
    bp = a.bp or int(m["bp"])
    share = bp / float(depth["genome_bp"])
    x, y, v = mapgen.make_map(
        -(-bp // res), d_px, seed=a.seed, device=a.device,
        contacts=float(depth["genome_contacts"]) * share,
        exponent=float(depth["exponent"]),
        n_loops=round(float(depth["genome_loops"]) * share),
        loop_strength=float(depth["loop_strength"]))
    width = 2000
    n = int(max(x.max(), y.max())) + 1
    shape = (bucket_rows(max(n, width)), band_width(width, d_px))
    ne8, ne16, _ = native.classify_values(v)
    band = np.zeros(shape, np.uint8)

    def fill(k):
        band[:] = 0
        native.fill_band_compact(x, y, v, band, ne8 + 16, n_threads=k)

    out = {"affinity": len(os.sched_getaffinity(0)),
           "entries": len(v), "band": list(shape), "ne8": ne8, "ne16": ne16,
           "census_ms": median_ms(lambda: native.classify_values(v), a.reps),
           "x_max_ms": median_ms(lambda: x.max(), a.reps),
           "zero_band_ms": median_ms(lambda: band.fill(0), a.reps),
           "fill_ms": {k: median_ms(lambda k=k: fill(k), a.reps)
                       for k in a.threads}}
    if hasattr(native, "fill_band_u8_census"):
        def one_pass(k):
            band[:] = 0
            assert native.fill_band_u8_census(x, y, v, band,
                                              n_threads=k) is not None
        out["one_pass_ms"] = {k: median_ms(lambda k=k: one_pass(k), a.reps)
                              for k in a.threads}
    out["fill_raw_band_compact_ms"] = median_ms(
        lambda: pipeline.fill_raw_band_compact(x, y, v, shape), a.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
