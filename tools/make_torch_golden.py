#!/usr/bin/env python3
"""Write the golden loop calls that chip_smoke.py holds the PyTorch/CUDA
port to.

Runs the JAX package's ``detect_loops_coo`` on the CPU (float32, default
modes) and writes the reference-format TSV:

* ``5kb`` (default): the bench headline workload, a synthetic chr21 at
  5 kb (``synthetic_hic(9629, 400, seed=2021, n_loops=300,
  loop_strength=3.0)``, as ``bench.py::build_workload``; 6 blocks of
  2000^2), to ``tests/data/torch_port_chr21_5kb_golden.tsv``;
* ``1kb``: the bench 1 kb slice (``synthetic_hic(12000, 2000, seed=1011,
  n_loops=150, loop_strength=3.0, density=0.95)``, as
  ``bench.py::build_workload_1kb``; blocks of 4000^2) with the JAX BH in
  exact sort mode (the port's only mode), to
  ``tests/data/torch_port_1kb_golden.tsv``;
* ``diff5kb``: the bench differential workload (``bench.py`` diff leg:
  the chr21 5 kb map at seeds 2021 and 2022 as the two conditions,
  ``pt=0.1, st=0.8, pt2=0.1``) through the JAX ``detect_diff_loops_coo``
  in sort-mode BH, to ``tests/data/torch_port_chr21_5kb_diff_golden.tsv``:
  the reference-format columns plus ``TAG`` (1 loop1, 2 diffloop1, 3
  loop2, 4 diffloop2), rows in the engine's block order.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--slice 1kb|diff5kb] [--out PATH]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# the golden is a CPU result by definition; set before jax is imported
os.environ["JAX_PLATFORMS"] = "cpu"

# slice -> (synthetic_hic args, kwargs, resolution, chromosome, BH mode)
SLICES = {
    "5kb": ((9629, 400), dict(seed=2021, n_loops=300, loop_strength=3.0),
            5000, "chr21", None),
    "1kb": ((12000, 2000), dict(seed=1011, n_loops=150, loop_strength=3.0,
                                density=0.95), 1000, "chr1", "sort"),
    "diff5kb": ((9629, 400), dict(seed=2021, n_loops=300, loop_strength=3.0),
                5000, "chr21", "sort"),
}
DIFF_SEED2 = 2022      # the diff leg's second condition (bench.py)
OUT = {"5kb": os.path.join(ROOT, "tests", "data",
                           "torch_port_chr21_5kb_golden.tsv"),
       "1kb": os.path.join(ROOT, "tests", "data",
                           "torch_port_1kb_golden.tsv"),
       "diff5kb": os.path.join(ROOT, "tests", "data",
                               "torch_port_chr21_5kb_diff_golden.tsv")}
DIFF_HEADER = ("BIN1_CHR\tBIN1_START\tBIN1_END\tBIN2_CHROMOSOME\t"
               "BIN2_START\tBIN2_END\tFDR\tDETECTION_SCALE\tTAG\n")


def write_diff_rows(path, chrom, res, rows):
    """Differential rows ``(bin1, bin2, q, scale, tag)`` as the diff CLI
    writes each of its four files, plus the tag column, in one TSV."""
    with open(path, "w") as fh:
        fh.write(DIFF_HEADER)
        for b1, b2, q, scale, tag in rows:
            fh.write(f"{chrom}\t{b1 * res}\t{(b1 + 1) * res}\t{chrom}\t"
                     f"{b2 * res}\t{(b2 + 1) * res}\t{q}\t{scale}\t{tag}\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice", choices=sorted(SLICES), default="5kb")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or OUT[args.slice]

    import jax

    import mustache_tpu.detect as jdetect
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.pipeline import detect_loops_coo, write_loops
    from synthetic import synthetic_hic

    shape, kw, res, chrom, bh_mode = SLICES[args.slice]
    if bh_mode:
        jdetect._BH_MODE = bh_mode
    x, y, v, _ = synthetic_hic(*shape, **kw)
    cfg = DetectionConfig(resolution=res, distance_bp=2_000_000, pt=0.1,
                          st=0.8, pt2=0.1, precision="float32")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    if args.slice == "diff5kb":
        from mustache_tpu.diff import detect_diff_loops_coo

        x2, y2, v2, _ = synthetic_hic(*shape, **dict(kw, seed=DIFF_SEED2))
        loops = detect_diff_loops_coo(x, y, v, x2, y2, v2, cfg)
        write_diff_rows(out, chrom, cfg.resolution, loops)
    else:
        loops = detect_loops_coo(x, y, v, cfg)
        write_loops(out, [(chrom, chrom, cfg.resolution, loops)])
    print(f"{len(loops)} rows -> {out} ({time.time() - t0:.1f} s, "
          f"jax {jax.__version__} on {jax.default_backend()}, BH "
          f"{jdetect._BH_MODE})")


if __name__ == "__main__":
    main()
