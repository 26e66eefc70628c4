#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103

For each of ``--seeds``: the cell's inputs from that seed, one warm call
and one call of the program's entry (the timed path at the timed size),
and the compared numbers of that call against the float64 reference
(``side: program``: the lower readings). For each of
``--control-seeds``: the same numbers for the control, the reference
computed in TF32 (every blur's operands rounded to TensorFloat-32,
float32 sums, the rest in float32) put in the program's place (``side:
control``: the upper readings). One JSON line each; the benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["MUSTACHE_TPU_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "mustache_tpu_torch", "kernels", "_build")


def readings(name: str, seeds, control_seeds, device="cuda", root=None,
             out=sys.stdout):
    """Print and return the readings of the cell ``name``."""
    import torch

    from benchmark.harness import compare, manifest

    cell = manifest.find_cell(name, root or manifest.ROOT)
    kind = manifest.kind_module(cell.kind)
    lines = []
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            work = kind.setup(cell, seed, device)
            if side == "program":
                work.call()
                got = work.call()
            else:
                got = work.reference(device, torch.float32, True)
            if device != "cpu":
                torch.cuda.empty_cache()
            ref = work.reference(device, torch.float64, False)
            work.close()
            line = {"cell": name, "side": side, "seed": seed,
                    **compare.compare(got, ref),
                    "seconds": time.perf_counter() - t0}
            out.write(json.dumps(line) + "\n")
            out.flush()
            lines.append(line)
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    readings(args.workload, args.seeds, args.control_seeds)


if __name__ == "__main__":
    main()
