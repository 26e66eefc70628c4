#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its files are found by name (``benchmark/README.md``). The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` a ``breakdown``,
and last the compared numbers beside their limits under ``checks``); the
same numbers are the last lines of standard error. Without the cards the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, leads the import path
sys.path[0] = ROOT

# every build and kernel cache of the program inside the checkout, at a
# fixed path: only a checkout's first run compiles
os.environ["MUSTACHE_TPU_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "mustache_tpu_torch", "kernels", "_build")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cell

    try:
        return cell.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=T_START)
    except cell.NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
