#!/usr/bin/env python3
"""Write the golden loop calls that chip_smoke.py holds the PyTorch/CUDA
port to.

Runs the JAX package's ``detect_loops_coo`` on the CPU (float32, default
modes) over the bench headline workload, a synthetic chr21 at 5 kb
(``synthetic_hic(9629, 400, seed=2021, n_loops=300, loop_strength=3.0)``,
as ``bench.py::build_workload``; 6 blocks of 2000^2), and writes the
reference-format TSV to ``tests/data/torch_port_chr21_5kb_golden.tsv``.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--out PATH]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# the golden is a CPU result by definition; set before jax is imported
os.environ["JAX_PLATFORMS"] = "cpu"

CHR21_BINS = 9629
D_PX = 400
OUT = os.path.join(ROOT, "tests", "data", "torch_port_chr21_5kb_golden.tsv")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    import jax

    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.pipeline import detect_loops_coo, write_loops
    from synthetic import synthetic_hic

    x, y, v, _ = synthetic_hic(CHR21_BINS, D_PX, seed=2021, n_loops=300,
                               loop_strength=3.0)
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=0.1,
                          st=0.8, precision="float32")
    t0 = time.time()
    loops = detect_loops_coo(x, y, v, cfg)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    write_loops(args.out, [("chr21", "chr21", cfg.resolution, loops)])
    print(f"{len(loops)} loops -> {args.out} ({time.time() - t0:.1f} s, "
          f"jax {jax.__version__} on {jax.default_backend()})")


if __name__ == "__main__":
    main()
