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
  loop2, 4 diffloop2), rows in the engine's block order;
* ``f64_5kb`` and ``diff_f64_5kb``: the ``5kb`` and ``diff5kb``
  workloads at ``precision="float64"`` (the JAX package's XLA path and
  host normalize, sort-mode BH), to
  ``tests/data/torch_port_chr21_5kb_f64_golden.tsv`` and
  ``tests/data/torch_port_chr21_5kb_diff_f64_golden.tsv``;
* ``exact_5kb``: the ``5kb`` workload at float32 with
  ``exact_normalize=True`` (the host normalize in the reference's
  summation order, then the float32 XLA path; sort-mode BH), to
  ``tests/data/torch_port_chr21_5kb_exact_golden.tsv``;
* ``inter_5kb``: a whole chromosome pair at 5 kb, chr21 x chr22
  (``synthetic_inter(9342, 10164, seed=2121, n_loops=300)``, density
  0.5: 46,709,983 and 50,818,468 bp, about 47 M contacts) through the
  JAX ``inter.detect_inter_loops_coo`` at ``pt=0.1, st=0.5``, default
  sigma0 and octaves, 2 Mb (tiles of 2000^2, a 5 x 6 grid), to
  ``tests/data/torch_port_inter_5kb_golden.tsv``;
* ``cpu_f64``: the small float64 cases of ``tests/torch_port_cases.py``
  (pipelines, differential calls and both CLIs, sort-mode BH), to
  ``tests/data/torch_port_cpu_f64_golden.json``.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--slice NAME] [--out PATH]
"""

import argparse
import json
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
    "f64_5kb": ((9629, 400), dict(seed=2021, n_loops=300, loop_strength=3.0),
                5000, "chr21", "sort"),
    "diff_f64_5kb": ((9629, 400), dict(seed=2021, n_loops=300,
                                       loop_strength=3.0),
                     5000, "chr21", "sort"),
    "exact_5kb": ((9629, 400), dict(seed=2021, n_loops=300,
                                    loop_strength=3.0),
                  5000, "chr21", "sort"),
    "inter_5kb": ((9342, 10164), dict(seed=2121, n_loops=300), 5000,
                  ("chr21", "chr22"), None),
    "cpu_f64": (None, None, 5000, None, "sort"),
}
DIFF_SEED2 = 2022      # the diff leg's second condition (bench.py)
OUT = {"5kb": os.path.join(ROOT, "tests", "data",
                           "torch_port_chr21_5kb_golden.tsv"),
       "1kb": os.path.join(ROOT, "tests", "data",
                           "torch_port_1kb_golden.tsv"),
       "diff5kb": os.path.join(ROOT, "tests", "data",
                               "torch_port_chr21_5kb_diff_golden.tsv"),
       "f64_5kb": os.path.join(ROOT, "tests", "data",
                               "torch_port_chr21_5kb_f64_golden.tsv"),
       "diff_f64_5kb": os.path.join(ROOT, "tests", "data",
                                    "torch_port_chr21_5kb_diff_f64_golden.tsv"),
       "exact_5kb": os.path.join(ROOT, "tests", "data",
                                 "torch_port_chr21_5kb_exact_golden.tsv"),
       "inter_5kb": os.path.join(ROOT, "tests", "data",
                                 "torch_port_inter_5kb_golden.tsv"),
       "cpu_f64": os.path.join(ROOT, "tests", "data",
                               "torch_port_cpu_f64_golden.json")}
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


def _rows(loops):
    """Loop rows as JSON lists: [bin1, bin2, q, scale(, tag)]."""
    return [[int(lp.bin1), int(lp.bin2), float(lp.q), float(lp.scale)]
            if hasattr(lp, "bin1") else
            [int(lp[0]), int(lp[1]), float(lp[2]), float(lp[3]), int(lp[4])]
            for lp in loops]


def cpu_f64_golden(out):
    """Run the JAX package on every case of tests/torch_port_cases.py and
    write their rows (and the CLIs' output files) to one JSON file."""
    import tempfile

    import torch_port_cases as C
    from mustache_tpu.cli import main as cli_main
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.diff import detect_diff_loops_coo, find_diff_loops
    from mustache_tpu.diff_cli import main as diff_cli_main
    from mustache_tpu.pipeline import detect_loops_coo, find_loops

    gold = {}
    for name, (_, _, ckw, kw) in C.SINGLE.items():
        t0 = time.time()
        x, y, v = C.single_map(name)
        gold[name] = _rows(detect_loops_coo(
            x, y, v.copy(), DetectionConfig(**C.cfg_kwargs(ckw)), **kw))
        print(f"{name}: {len(gold[name])} rows ({time.time() - t0:.1f} s)")
    for name, (_, _, _, ckw, kw) in C.DIFF.items():
        t0 = time.time()
        x1, y1, v1, x2, y2, v2 = C.diff_maps(name)
        gold[name] = _rows(detect_diff_loops_coo(
            x1, y1, v1.copy(), x2, y2, v2.copy(),
            DetectionConfig(**C.cfg_kwargs(ckw)), **kw))
        print(f"{name}: {len(gold[name])} rows ({time.time() - t0:.1f} s)")
    gold["find_fast"] = _rows(find_loops(*C.single_map("find_fast"),
                                         **C.FIND_KW))
    gold["find_diff_raw"] = _rows(find_diff_loops(
        *C.diff_maps("find_diff_raw"), **C.FIND_DIFF_KW))
    print(f"find_fast: {len(gold['find_fast'])} rows, find_diff_raw: "
          f"{len(gold['find_diff_raw'])} rows")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        txt = C.write_text(os.path.join(tmp, "two.txt"), C.CLI_CHROMS)
        ref = os.path.join(tmp, "cli.tsv")
        assert cli_main(["-f", txt, "-o", ref] + C.CLI_FLAGS
                        + ["--engine-platform", "cpu"]) == 0
        gold["cli_f64"] = open(ref).read()
        print(f"cli_f64 ({time.time() - t0:.1f} s)")
        t0 = time.time()
        paths = [C.write_text(os.path.join(tmp, f"{c}.txt"), chroms)
                 for c, chroms in C.DIFF_CLI_CONDS.items()]
        ref = os.path.join(tmp, "diff")
        assert diff_cli_main(["-f1", paths[0], "-f2", paths[1], "-o", ref]
                             + C.DIFF_CLI_FLAGS
                             + ["--engine-platform", "cpu",
                                "--engine-mesh", "off"]) == 0
        gold["diff_cli_f64"] = {
            sfx: open(ref + sfx).read()
            for sfx in (".loop1", ".diffloop1", ".loop2", ".diffloop2")}
        print(f"diff_cli_f64 ({time.time() - t0:.1f} s)")
    with open(out, "w") as fh:
        fh.write("{\n" + ",\n".join(
            f"{json.dumps(k)}: {json.dumps(v)}" for k, v in gold.items())
            + "\n}\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice", choices=sorted(SLICES), default="5kb")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or OUT[args.slice]
    if "f64" in args.slice:
        # float64 arrays stay float64 in JAX only with x64 on (the JAX
        # package's tests turn it on in tests/conftest.py)
        os.environ["JAX_ENABLE_X64"] = "true"

    import jax

    import mustache_tpu.detect as jdetect
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.pipeline import detect_loops_coo, write_loops
    from synthetic import synthetic_hic

    shape, kw, res, chrom, bh_mode = SLICES[args.slice]
    if bh_mode:
        jdetect._BH_MODE = bh_mode
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    if args.slice == "cpu_f64":
        cpu_f64_golden(out)
        print(f"-> {out} ({time.time() - t0:.1f} s, jax {jax.__version__} "
              f"on {jax.default_backend()}, BH {jdetect._BH_MODE})")
        return
    if args.slice == "inter_5kb":
        from mustache_tpu.inter import detect_inter_loops_coo
        from mustache_tpu.pipeline import Loop
        from synthetic import synthetic_inter

        x, y, v, _ = synthetic_inter(*shape, **kw)
        cfg = DetectionConfig(resolution=res, distance_bp=2_000_000, pt=0.1,
                              st=0.5)
        rows = detect_inter_loops_coo(x, y, v, cfg, n1=shape[0], n2=shape[1])
        loops = [Loop(int(r[0]), int(r[1]), float(r[2]), float(r[3]))
                 for r in rows]
        write_loops(out, [(*chrom, cfg.resolution, loops)])
        print(f"{len(loops)} rows -> {out} ({time.time() - t0:.1f} s, "
              f"jax {jax.__version__} on {jax.default_backend()})")
        return
    x, y, v, _ = synthetic_hic(*shape, **kw)
    cfg = DetectionConfig(
        resolution=res, distance_bp=2_000_000, pt=0.1, st=0.8, pt2=0.1,
        precision="float64" if "f64" in args.slice else "float32")
    if args.slice in ("diff5kb", "diff_f64_5kb"):
        from mustache_tpu.diff import detect_diff_loops_coo

        x2, y2, v2, _ = synthetic_hic(*shape, **dict(kw, seed=DIFF_SEED2))
        loops = detect_diff_loops_coo(x, y, v, x2, y2, v2, cfg)
        write_diff_rows(out, chrom, cfg.resolution, loops)
    else:
        loops = detect_loops_coo(x, y, v, cfg,
                                 exact_normalize=args.slice == "exact_5kb")
        write_loops(out, [(chrom, chrom, cfg.resolution, loops)])
    print(f"{len(loops)} rows -> {out} ({time.time() - t0:.1f} s, "
          f"jax {jax.__version__} on {jax.default_backend()}, BH "
          f"{jdetect._BH_MODE})")


if __name__ == "__main__":
    main()
