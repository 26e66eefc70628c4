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
  exact sort mode (both of the port's BH modes give its rows), to
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
* ``oct5_5kb``: the ``5kb`` workload at float32 with ``octaves=5``
  (sigma0 1.6: the ladder's radius is 110, inside the JAX fused
  kernel's gate; on the CPU the JAX package runs its XLA path),
  sort-mode BH, to ``tests/data/torch_port_chr21_5kb_oct5_golden.tsv``;
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
  ``tests/data/torch_port_cpu_f64_golden.json``;
* ``cpu_f32``: the small float32 cases of ``tests/torch_port_cases.py``
  (``F32_*``: both CLIs from text and ``.hic``, the differential slice,
  the inter-chromosomal grid at float32 and float64, a two-block map
  through the row-sharded runner on 4 devices), run as the JAX
  package's tests run it (x64 on, 8 virtual CPU devices, sort-mode BH),
  to ``tests/data/torch_port_cpu_f32_golden.json``, which also records
  this command and the JAX version;
* ``rowshard_5kb``: the ``5kb`` workload through the JAX row-sharded
  runner (``make_runner(mesh, "rowshard")`` on a 4-device CPU mesh: the
  host normalize, each device's slab), sort-mode BH, to
  ``tests/data/torch_port_chr21_5kb_rowshard_golden.tsv``;
* ``cool_card``: two small files in cooler's layout written by h5py
  (``tests/torch_port_cases.py::write_cool_card_fixtures``: a ``.cool``
  and a ``.mcool`` of two resolutions, gzip 6 with shuffle, an enum, a
  two-level chunk B-tree) to ``tests/data/torch_port_cooler_layout.
  {cool,mcool}``, and the JAX reader's triplets of them (intra and
  inter, balanced and not) as sha256 digests
  (``chip_smoke.cool_digests``) to ``tests/data/torch_port_cool_expected.
  json``;
* ``batches_f64_5kb``: a five-block map at 5 kb (``synthetic_hic(7700,
  120, seed=141, n_loops=60, loop_strength=3.0)``, 600 kb: blocks of
  2000^2) at ``precision="float64"``, sort-mode BH, under the JAX
  package's test harness settings, to
  ``tests/data/torch_port_batches_f64_5kb_golden.tsv``, read by
  ``tests/test_torch_whole_chrom.py`` (the port in five pipelined batches
  with a regrow);
* ``chr21_1kb`` and ``chr1_1kb``: whole chromosomes at 1 kb, the 1 kb
  slice's parameters over hg38 chr21 (``synthetic_hic(46710, 2000,
  seed=1011, n_loops=580, loop_strength=3.0, density=0.95)``: 23 blocks
  of 4000^2) and hg38 chr1 at a density falling away from the diagonal
  (``synthetic_hic(248956, 2000, seed=1001, n_loops=3100,
  loop_strength=3.0, density=0.9, density_decay=0.25)``: 124 blocks), in
  sort-mode BH, to ``tests/data/torch_port_chr21_1kb_golden.tsv`` and
  ``tests/data/torch_port_chr1_1kb_golden.tsv`` (chip_smoke.py phase 14);
* ``rowaxis``: the 8 blocks of ``tests/test_sharding.py::
  test_sharded_equals_unsharded`` (256^2, d_px 64, seeds 40-47) through
  the JAX dense runner on a 4 x 2 ``(block, row)`` mesh of the harness's
  8 CPU devices (GSPMD splits each block's rows over the ``row`` pair),
  float32, sort-mode BH: each block's valid candidates ``[x, y, sigidx,
  log q]`` and its counts, to ``tests/data/torch_port_rowaxis_golden.json``.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--slice NAME] [--out PATH]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

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
    "oct5_5kb": ((9629, 400), dict(seed=2021, n_loops=300,
                                   loop_strength=3.0),
                 5000, "chr21", "sort"),
    "inter_5kb": ((9342, 10164), dict(seed=2121, n_loops=300), 5000,
                  ("chr21", "chr22"), None),
    "cpu_f64": (None, None, 5000, None, "sort"),
    "cpu_f32": (None, None, 5000, None, "sort"),
    "rowshard_5kb": ((9629, 400), dict(seed=2021, n_loops=300,
                                       loop_strength=3.0),
                     5000, "chr21", "sort"),
    "rowaxis": (None, None, 5000, None, "sort"),
    "cool_card": (None, None, 5000, None, None),
    "batches_f64_5kb": ((7700, 120), dict(seed=141, n_loops=60,
                                      loop_strength=3.0),
                    5000, "chr2", "sort"),
    "chr21_1kb": ((46710, 2000), dict(seed=1011, n_loops=580,
                                      loop_strength=3.0, density=0.95),
                  1000, "chr21", "sort"),
    "chr1_1kb": ((248956, 2000), dict(seed=1001, n_loops=3100,
                                      loop_strength=3.0, density=0.9,
                                      density_decay=0.25),
                 1000, "chr1", "sort"),
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
       "oct5_5kb": os.path.join(ROOT, "tests", "data",
                                "torch_port_chr21_5kb_oct5_golden.tsv"),
       "inter_5kb": os.path.join(ROOT, "tests", "data",
                                 "torch_port_inter_5kb_golden.tsv"),
       "cpu_f64": os.path.join(ROOT, "tests", "data",
                               "torch_port_cpu_f64_golden.json"),
       "cpu_f32": os.path.join(ROOT, "tests", "data",
                               "torch_port_cpu_f32_golden.json"),
       "rowshard_5kb": os.path.join(
           ROOT, "tests", "data", "torch_port_chr21_5kb_rowshard_golden.tsv"),
       "rowaxis": os.path.join(ROOT, "tests", "data",
                               "torch_port_rowaxis_golden.json"),
       "cool_card": os.path.join(ROOT, "tests", "data",
                                 "torch_port_cool_expected.json"),
       "batches_f64_5kb": os.path.join(ROOT, "tests", "data",
                                   "torch_port_batches_f64_5kb_golden.tsv"),
       "chr21_1kb": os.path.join(ROOT, "tests", "data",
                                 "torch_port_chr21_1kb_golden.tsv"),
       "chr1_1kb": os.path.join(ROOT, "tests", "data",
                                "torch_port_chr1_1kb_golden.tsv")}
# slices whose distance filter is not 2 Mb
DISTANCE_BP = {"batches_f64_5kb": 600_000}
# slices run under the JAX package's test harness settings
# (tests/conftest.py): x64 on and 8 virtual CPU devices
HARNESS = ("cpu_f32", "rowshard_5kb", "rowaxis", "batches_f64_5kb")
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
    _dump(out, gold)


def _inter_rows(rows):
    return [[int(r[0]), int(r[1]), float(r[2]), float(r[3])] for r in rows]


def _dump(out, gold):
    with open(out, "w") as fh:
        fh.write("{\n" + ",\n".join(
            f"{json.dumps(k)}: {json.dumps(v)}" for k, v in gold.items())
            + "\n}\n")


def cpu_f32_golden(out):
    """Run the JAX package on the F32_* cases of tests/torch_port_cases.py
    and write their rows and the CLIs' output files to one JSON file."""
    import tempfile

    import jax

    import torch_port_cases as C
    from hic_writer import write_hic
    from mustache_tpu.cli import main as cli_main
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.diff import detect_diff_loops_coo
    from mustache_tpu.diff_cli import main as diff_cli_main
    from mustache_tpu.inter import detect_inter_loops_coo
    from mustache_tpu.pipeline import detect_loops_coo
    from mustache_tpu.sharding import make_mesh, make_runner
    from synthetic import synthetic_hic, synthetic_inter

    cpu = ["--engine-platform", "cpu"]
    gold = {"_command": "JAX_PLATFORMS=cpu python tools/make_torch_golden.py "
                        "--slice cpu_f32",
            "_jax": f"jax {jax.__version__} on {jax.default_backend()} "
                    f"({len(jax.devices())} devices, x64 "
                    f"{jax.config.jax_enable_x64})"}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ref = os.path.join(tmp, "out")
        txt = C.write_text(os.path.join(tmp, "two.txt"), C.F32_CLI_CHROMS)
        assert cli_main(["-f", txt, "-ch", "20", "21", "-o", ref]
                        + C.F32_CLI_FLAGS + cpu) == 0
        gold["cli_text"] = open(ref).read()
        (nb, d_px), kw = C.F32_CLI_HIC
        path = os.path.join(tmp, "m.hic")
        write_hic(path, [("chr21", nb * C.RES)], C.RES,
                  {"chr21": synthetic_hic(nb, d_px, **kw)[:3]}, version=8,
                  norms={("KR", "chr21"): C.kr_vector(nb)})
        assert cli_main(["-f", path, "-o", ref] + C.F32_CLI_FLAGS + cpu) == 0
        gold["cli_hic"] = open(ref).read()
        print(f"cli_text, cli_hic ({time.time() - t0:.1f} s)")
        t0 = time.time()
        paths = [C.write_text(os.path.join(tmp, f"{c}.txt"), chroms)
                 for c, chroms in C.F32_DIFF_CLI_CONDS.items()]
        sfxs = (".loop1", ".diffloop1", ".loop2", ".diffloop2")
        assert diff_cli_main(["-f1", paths[0], "-f2", paths[1], "-ch", "20",
                              "21", "-o", ref] + C.F32_DIFF_CLI_FLAGS + cpu
                             + ["--engine-mesh", "off"]) == 0
        gold["diff_cli_text"] = {s: open(ref + s).read() for s in sfxs}
        hics = []
        for cond, seed in (("a", 12), ("b", 13)):
            hics.append(os.path.join(tmp, f"{cond}.hic"))
            write_hic(hics[-1], [("chr21", nb * C.RES)], C.RES,
                      {"chr21": synthetic_hic(nb, d_px, seed=seed,
                                              n_loops=15)[:3]},
                      version=8, norms={("KR", "chr21"): C.kr_vector(nb)})
        assert diff_cli_main(["-f1", hics[0], "-f2", hics[1], "-o", ref]
                             + C.F32_DIFF_CLI_FLAGS + cpu
                             + ["--engine-mesh", "off"]) == 0
        gold["diff_cli_hic"] = {s: open(ref + s).read() for s in sfxs}
        print(f"diff_cli_text, diff_cli_hic ({time.time() - t0:.1f} s)")
    t0 = time.time()
    x1, y1, v1, x2, y2, v2 = C.diff_slice_maps()
    gold["diff_slice"] = _rows(detect_diff_loops_coo(
        x1, y1, v1.copy(), x2, y2, v2.copy(),
        DetectionConfig(precision="float32", **C.F32_DIFF_KW)))
    print(f"diff_slice: {len(gold['diff_slice'])} rows "
          f"({time.time() - t0:.1f} s)")
    t0 = time.time()
    (n1, n2), kw = C.F32_INTER_MAP
    x, y, v, _ = synthetic_inter(n1, n2, **kw)
    for prec in ("float32", "float64"):
        gold[f"inter_grid_{prec}"] = _inter_rows(detect_inter_loops_coo(
            x, y, v.copy(), DetectionConfig(precision=prec,
                                            **C.F32_INTER_KW),
            chunk=C.F32_INTER_CHUNK))
    print(f"inter grids: {len(gold['inter_grid_float32'])} rows "
          f"({time.time() - t0:.1f} s)")
    t0 = time.time()

    (nb, d_px), kw = C.F32_SHARD_MAP
    x, y, v, _ = synthetic_hic(nb, d_px, **kw)
    mesh = make_mesh(n_block=4, n_row=1, devices=jax.devices()[:4])
    gold["rowshard_map"] = _rows(detect_loops_coo(
        x, y, v.copy(), DetectionConfig(precision="float32",
                                        **C.F32_SHARD_KW),
        runner=make_runner(mesh, "rowshard")))
    print(f"rowshard_map: {len(gold['rowshard_map'])} rows "
          f"({time.time() - t0:.1f} s)")
    _dump(out, gold)


def cool_card_golden(out):
    """The card's ``.cool`` fixtures and the JAX reader's digests."""
    import chip_smoke
    import torch_port_cases as C
    from mustache_tpu.io import cool as jcool

    C.write_cool_card_fixtures()
    gold = {"_command": "JAX_PLATFORMS=cpu python tools/make_torch_golden.py "
                        "--slice cool_card"}
    gold.update(chip_smoke.cool_digests(jcool, C.COOL_CARD["cool"],
                                        C.COOL_CARD["mcool"]))
    for path in C.COOL_CARD.values():
        print(f"{path}: {os.path.getsize(path)} bytes")
    _dump(out, gold)


def rowaxis_golden(out):
    """The JAX dense runner on a 4 x 2 (block, row) mesh."""
    import jax

    import torch_port_cases as C
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.detect import build_detector
    from mustache_tpu.sharding import make_mesh, make_runner

    det = build_detector(DetectionConfig(precision="float32",
                                         **C.ROWAXIS_KW), C.ROWAXIS_N)
    mesh = make_mesh(n_block=4, n_row=2, devices=jax.devices()[:8])
    got = jax.tree.map(np.asarray, make_runner(mesh)(det,
                                                    C.rowaxis_blocks()))
    gold = {"_command": "JAX_PLATFORMS=cpu python tools/make_torch_golden.py "
                        "--slice rowaxis",
            "_jax": f"jax {jax.__version__} on {jax.default_backend()} "
                    f"({len(jax.devices())} devices, mesh "
                    f"{dict(mesh.shape)})"}
    for b in range(got["cand_x"].shape[0]):
        ok = got["cand_valid"][b]
        gold[f"block{b}"] = {
            "counts": [int(got[k][b]) for k in ("n_tested", "sig_count",
                                                 "nz_count")],
            "cands": [[int(x), int(y), int(s), float(q)] for x, y, s, q in zip(
                got["cand_x"][b][ok], got["cand_y"][b][ok],
                got["cand_sigidx"][b][ok], got["cand_logq"][b][ok])]}
        print(f"block {b}: {len(gold[f'block{b}']['cands'])} candidates")
    _dump(out, gold)


def rowshard_golden(out, x, y, v, cfg, chrom):
    """The JAX row-sharded runner on a 4-device CPU mesh."""
    import jax

    from mustache_tpu.pipeline import detect_loops_coo, write_loops
    from mustache_tpu.sharding import make_mesh, make_runner

    mesh = make_mesh(n_block=4, n_row=1, devices=jax.devices()[:4])
    loops = detect_loops_coo(x, y, v, cfg,
                             runner=make_runner(mesh, "rowshard"))
    write_loops(out, [(chrom, chrom, cfg.resolution, loops)])
    return loops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice", choices=sorted(SLICES), default="5kb")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or OUT[args.slice]
    if "f64" in args.slice or args.slice in HARNESS:
        # float64 arrays stay float64 in JAX only with x64 on (the JAX
        # package's tests turn it on in tests/conftest.py)
        os.environ["JAX_ENABLE_X64"] = "true"
    if args.slice in HARNESS:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8").strip()

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
    if args.slice in ("cpu_f64", "cpu_f32", "rowaxis", "cool_card"):
        {"cpu_f64": cpu_f64_golden, "cpu_f32": cpu_f32_golden,
         "rowaxis": rowaxis_golden,
         "cool_card": cool_card_golden}[args.slice](out)
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
        resolution=res, distance_bp=DISTANCE_BP.get(args.slice, 2_000_000),
        pt=0.1, st=0.8, pt2=0.1,
        precision="float64" if "f64" in args.slice else "float32",
        octaves=5 if args.slice == "oct5_5kb" else 2)
    if args.slice in ("diff5kb", "diff_f64_5kb"):
        from mustache_tpu.diff import detect_diff_loops_coo

        x2, y2, v2, _ = synthetic_hic(*shape, **dict(kw, seed=DIFF_SEED2))
        loops = detect_diff_loops_coo(x, y, v, x2, y2, v2, cfg)
        write_diff_rows(out, chrom, cfg.resolution, loops)
    elif args.slice == "rowshard_5kb":
        loops = rowshard_golden(out, x, y, v, cfg, chrom)
    else:
        loops = detect_loops_coo(x, y, v, cfg,
                                 exact_normalize=args.slice == "exact_5kb")
        write_loops(out, [(chrom, chrom, cfg.resolution, loops)])
    print(f"{len(loops)} rows -> {out} ({time.time() - t0:.1f} s, "
          f"jax {jax.__version__} on {jax.default_backend()}, BH "
          f"{jdetect._BH_MODE})")


if __name__ == "__main__":
    main()
