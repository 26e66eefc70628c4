"""Build the port's native libraries ahead of the first run.

Torch port of ``mustache_tpu/warmup.py``. The JAX package compiles one
XLA graph per (rows, band, batch) shape and warms its persistent cache
shape by shape; nothing in the port compiles per shape. Its first-use
costs are the builds of its native code into the build cache
(``kernels/build.py::build_dir``), all started together here:

* ``fused_ladder`` (nvcc, ``kernels/csrc/fused_ladder.cu``), on the card
  only;
* ``band_fill``, ``normalize``, ``hic_decode``, ``h5_chunks`` and
  ``cool_select`` (g++, ``io/native``).

Usage::

    python -m mustache_tpu_torch.warmup -r 5kb
    python -m mustache_tpu_torch.warmup -r 1kb --diff
    python -m mustache_tpu_torch.warmup -r 5kb --sizes-file my.chrom.sizes
    python -m mustache_tpu_torch.warmup -r 5kb --engine-platform cpu

``-r``, ``--sizes-file`` and ``--diff`` are the JAX tool's; here they
only describe the run being prepared, since every shape runs the same
libraries.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

def libraries(device) -> dict:
    """name -> (source, bind) of every native library a run on ``device``
    (a torch.device) loads; the CUDA kernel only on the card."""
    from mustache_tpu_torch.io import native
    from mustache_tpu_torch.kernels import fused_ladder

    libs = {"band_fill": (native.SRC, native.bind),
            "normalize": (native.NORM_SRC, native.bind_normalize),
            "hic_decode": (native.HIC_SRC, native.bind_hic),
            "h5_chunks": (native.H5_SRC, native.bind_h5),
            "cool_select": (native.COOL_SRC, native.bind_cool)}
    if device.type == "cuda":
        libs["fused_ladder"] = (None, fused_ladder.bind)
    return libs


def warm(device, log=None) -> dict:
    """Build (or find in the build cache) and load every native library a
    run on ``device`` needs, the builds in parallel. Returns name ->
    seconds until that build finished (a cached library takes ~0)."""
    from mustache_tpu_torch.kernels import build

    log = log or (lambda msg: None)
    libs = libraries(device)
    t0 = time.perf_counter()

    def one(name):
        src, _ = libs[name]
        build.build(name, src)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        jobs = {name: pool.submit(one, name) for name in libs}
        seconds = {name: job.result() for name, job in jobs.items()}
    for name, (src, bind) in libs.items():
        build.load(name, bind, src)
        log(f"{name}: {seconds[name]:.2f} s "
            f"({build.library_path(name, src).name})")
    return seconds


def main(argv=None):
    import argparse

    from mustache_tpu_torch.cli import PLATFORMS
    from mustache_tpu_torch.config import parse_bp
    from mustache_tpu_torch.device import resolve_device
    from mustache_tpu_torch.kernels import build

    ap = argparse.ArgumentParser(
        prog="mustache_tpu_torch.warmup",
        description="Build the port's native libraries into the build "
                    "cache before the first run.")
    ap.add_argument("-r", "--resolution", required=True,
                    help="resolution (e.g. 5kb, 1000)")
    ap.add_argument("--sizes-file", default=None,
                    help="2-column <name> <length_bp> file; default: hg38")
    ap.add_argument("--diff", action="store_true",
                    help="the run is differential (same libraries)")
    ap.add_argument("--engine-platform", dest="platform", default="",
                    choices=sorted(PLATFORMS),
                    help="empty or 'cuda' builds for the card (nvcc and "
                         "g++); 'cpu' builds the g++ libraries only")
    args = ap.parse_args(argv)

    res = parse_bp(args.resolution)
    if not res:
        ap.error("unparsable -r")
    genome = "hg38"
    if args.sizes_file:
        with open(args.sizes_file) as fh:
            n = sum(len(line.split()) >= 2 for line in fh)
        genome = f"{n} chromosomes of {args.sizes_file}"
    dev = resolve_device(PLATFORMS[args.platform])
    print(f"[warmup] {genome} at {res} bp"
          f"{', differential' if args.diff else ''} on {dev}: nothing "
          f"compiles per shape in the port; building its native libraries "
          f"into {build.build_dir()}", flush=True)
    t0 = time.perf_counter()
    seconds = warm(dev, log=lambda m: print(f"[warmup] {m}", flush=True))
    print(f"[warmup] {len(seconds)} libraries ready in "
          f"{time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
