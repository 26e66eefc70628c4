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
  ``tests/data/torch_port_1kb_golden.tsv``.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--slice 1kb] [--out PATH]
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
}
OUT = {"5kb": os.path.join(ROOT, "tests", "data",
                           "torch_port_chr21_5kb_golden.tsv"),
       "1kb": os.path.join(ROOT, "tests", "data",
                           "torch_port_1kb_golden.tsv")}


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
                          st=0.8, precision="float32")
    t0 = time.time()
    loops = detect_loops_coo(x, y, v, cfg)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    write_loops(out, [(chrom, chrom, cfg.resolution, loops)])
    print(f"{len(loops)} loops -> {out} ({time.time() - t0:.1f} s, "
          f"jax {jax.__version__} on {jax.default_backend()}, BH "
          f"{jdetect._BH_MODE})")


if __name__ == "__main__":
    main()
