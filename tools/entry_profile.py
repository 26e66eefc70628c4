#!/usr/bin/env python3
"""Warm walls and device profile of the port's entry points, on the card.

Runs chr21 at 5 kb, the bench 1 kb slice (``detect_loops_coo``) and the
two-condition chr21 (``detect_diff_loops_coo``) of ``chip_smoke.py``
through the ``mustache_tpu_torch`` of CHECKOUT: one run to warm up, five
timed warm runs (host clock around synchronized calls; rows equal on
every run), and one run under ``torch.profiler`` from which it reads the
kernel ms, the ms of the kernels launched inside the epilogue range
(``detect.epilogue`` / ``diff.epilogue``, by launch correlation), the
kernel launches and the copies and sets. Prints the card's name and power
limit, then one line ``AB {json}``. Needs a CUDA card; imports nothing
of JAX.

    python tools/entry_profile.py CHECKOUT LABEL [--whole --maps DIR]

To hold a change against its parent on one card, unpack the parent into
a git-ignored directory (``git archive``) and run, in one call, parent,
change, change, parent, each in its own process. ``--whole`` adds ``chip_smoke.py`` phase 14's
whole chromosomes at 1 kb (chr21 and chr1; the workloads of this
script's own checkout) with each call's peak device memory; their maps
are made once and kept in ``--maps`` (``.npz``) for the later processes.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def profile(fn, range_name):
    """Kernel ms, epilogue-range ms, kernel launches and copies/sets of
    one profiled run of ``fn``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") == range_name]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def in_range(e):
        t = launched.get(e.get("args", {}).get("correlation"))
        return t is not None and any(t0 <= t <= t1 for t0, t1 in spans)

    return dict(
        kernel_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
        epilogue_ms=sum(e.get("dur", 0) for e in kernels if in_range(e))
        / 1e3,
        kernels=len(kernels),
        copies=sum(e.get("cat") in ("gpu_memcpy", "gpu_memset")
                   for e in events))


def whole_calls(maps_dir):
    """chip_smoke.py phase 14's whole chromosomes at 1 kb as
    ``{name: (call, config)}``, their maps loaded from ``maps_dir`` or
    made there first."""
    import importlib.util

    import numpy as np

    # this script's chip_smoke.py (the checkout's may predate phase 14);
    # its configurations come from the checkout's package, imported first
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("phase14_specs", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from mustache_tpu_torch import detect_loops_coo
    from synthetic import synthetic_hic

    os.makedirs(maps_dir, exist_ok=True)
    calls = {}
    for name, work in (("chr21_1kb", chip_smoke.CHR21_1KB),
                       ("chr1_1kb", chip_smoke.CHR1_1KB)):
        path = os.path.join(maps_dir, name + ".npz")
        if not os.path.exists(path):
            x, y, v, _ = synthetic_hic(*work[0], **work[1])
            np.savez(path, x=x, y=y, v=v)
        with np.load(path) as z:
            coo = z["x"], z["y"], z["v"]
        cfg = chip_smoke.whole_chrom_cfg(work)
        calls[name] = ((lambda coo=coo, cfg=cfg: detect_loops_coo(*coo,
                                                                  cfg)), cfg)
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout")
    ap.add_argument("label")
    ap.add_argument("--whole", action="store_true")
    ap.add_argument("--maps", default=None)
    args = ap.parse_args()
    if args.whole and not args.maps:
        ap.error("--whole needs --maps")
    root = os.path.abspath(args.checkout)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    import torch
    from synthetic import synthetic_hic
    from mustache_tpu_torch import (
        DetectionConfig, detect_diff_loops_coo, detect_loops_coo, warmup,
    )

    package = sys.modules["mustache_tpu_torch"].__file__
    if not os.path.abspath(package).startswith(root + os.sep):
        sys.exit(f"imported {package}, not the package of {root}")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    warmup.warm(torch.device("cuda"))

    chr21 = dict(seed=2021, n_loops=300, loop_strength=3.0)
    m5 = synthetic_hic(9629, 400, **chr21)[:3]
    m5b = synthetic_hic(9629, 400, **{**chr21, "seed": 2022})[:3]
    m1 = synthetic_hic(12000, 2000, seed=1011, n_loops=150,
                       loop_strength=3.0, density=0.95)[:3]
    cfg5 = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=0.1,
                           st=0.8)
    cfg1 = DetectionConfig(resolution=1000, distance_bp=2_000_000, pt=0.1,
                           st=0.8)
    calls = {
        "5kb": (lambda: detect_loops_coo(*m5, cfg5), "detect.epilogue"),
        "1kb": (lambda: detect_loops_coo(*m1, cfg1), "detect.epilogue"),
        "diff": (lambda: detect_diff_loops_coo(*m5, *m5b,
                                               cfg5.with_(pt2=0.1)),
                 "diff.epilogue"),
    }
    if args.whole:
        for name, (fn, cfg) in whole_calls(args.maps).items():
            calls[name] = (fn, "detect.epilogue")
    out = {"label": args.label, "device": torch.cuda.get_device_name(0)}
    for name, (fn, range_name) in calls.items():
        rows = fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if again != rows:
                sys.exit(f"{name}: a warm rerun gave other rows")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[name] = dict(rows=len(rows), walls=walls,
                         median=sorted(walls)[2], peak_bytes=peak,
                         **profile(fn, range_name))
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
