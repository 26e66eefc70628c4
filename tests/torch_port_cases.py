"""The small cases the port's CPU tests hold to the JAX package through a
committed golden of the JAX package's own output, shared by
``tools/make_torch_golden.py`` and the tests that read the goldens:

* ``--slice cpu_f64``: the float64 / host-normalize cases below, into
  ``tests/data/torch_port_cpu_f64_golden.json``, read by
  ``tests/test_torch_f64_pipeline.py`` and ``tests/test_torch_f64_diff.py``;
* ``--slice cpu_f32``: the float32 CLI, differential, inter-chromosomal
  and row-sharded runs of ``tests/test_torch_cli.py``,
  ``tests/test_torch_diff_cli.py``, ``tests/test_torch_diff.py``,
  ``tests/test_torch_inter.py`` and ``tests/test_torch_sharding.py`` (the
  ``F32_*`` names below), into ``tests/data/torch_port_cpu_f32_golden.json``.
  Each of those ran the whole JAX CLI or pipeline beside the port's in
  every test run (150-250 s of one test worker each); the port's modules
  keep live JAX comparisons at the block and tile level.

The float64 cases' maps are those of ``tests/test_pipeline.py`` and
``tests/test_diff.py`` (the JAX package's own f64 pipeline tests), the
CLI files those of ``tests/test_torch_cli.py`` and
``tests/test_torch_diff_cli.py``. Each of their JAX results is a float64
run of the JAX package on the CPU with its BH in exact sort mode (the
port's only mode): one JAX f64 block of 2000^2 takes 15-25 s there,
which is why the tests read a golden instead.

The module also keeps torch on one intra-op thread in every process that
imports it (each port test module does): the Tier-1 command runs six
xdist workers on an eight-core host, and six processes each spinning
eight OpenMP threads there ran a two-block detection of the plain path
in 55 s instead of 1 s. The port tests' subprocesses get the same through
``SUBPROCESS_ENV``. No result depends on the thread count.
"""

import json
import os

import torch

from synthetic import synthetic_hic

torch.set_num_threads(1)
SUBPROCESS_ENV = {"OMP_NUM_THREADS": "1"}

RES = 5000
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_cpu_f64_golden.json")
GOLDEN_F32 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "torch_port_cpu_f32_golden.json")

# name -> (synthetic_hic args (n_bins, d_px), kwargs, DetectionConfig
# kwargs, detect_loops_coo keywords)
SINGLE = {
    # tests/test_pipeline.py::test_single_block_map
    "single_exact": ((900, 120), dict(seed=22, n_loops=20),
                     dict(distance_bp=120 * RES), dict(exact_normalize=True)),
    "single_raw": ((900, 120), dict(seed=22, n_loops=20),
                   dict(distance_bp=120 * RES), dict(normalize=False)),
    # tests/test_pipeline.py::test_multiblock_pipeline_matches_oracle
    "multi_exact": ((3000, 200), dict(seed=21, n_loops=60),
                    dict(distance_bp=200 * RES), dict(exact_normalize=True)),
}
# the one-call APIs at float64 on the single-block map, with the fast
# host normalize: find_loops(x, y, v, **FIND_KW); its distance clamps to
# 200 bins, as the reference's
FIND_MAP = ((900, 120), dict(seed=22, n_loops=20))
FIND_KW = dict(resolution=RES, distance_bp=120 * RES, precision="float64")
# name -> (args, cond-1 kwargs, cond-2 kwargs, config kwargs, keywords)
DIFF = {
    # tests/test_diff.py::test_diff_pipeline_multiblock
    "diff_exact": ((2600, 150), dict(seed=71, n_loops=40),
                   dict(seed=72, n_loops=40), dict(distance_bp=150 * RES),
                   dict(exact_normalize=True)),
}
# find_diff_loops(*maps, **FIND_DIFF_KW) on tests/test_diff.py::make_pair's
# maps, raw values (its distance clamps to 200 bins)
FIND_DIFF_MAPS = ((700, 120), dict(seed=61, n_loops=20),
                  dict(seed=1061, n_loops=20))
FIND_DIFF_KW = dict(resolution=RES, distance_bp=120 * RES,
                    precision="float64", normalize=False)
# the CLI files: tests/test_torch_cli.py::two_chroms and
# tests/test_torch_diff_cli.py::text_runs, run with float64
CLI_CHROMS = {"chr20": ((1200, 150), dict(seed=7, n_loops=20)),
              "chr21": ((1200, 150), dict(seed=8, n_loops=20))}
CLI_FLAGS = ["-r", "5kb", "-d", "750kb", "-pt", "0.2", "-st", "0.6",
             "-ch", "20", "21", "--engine-precision", "float64"]
DIFF_CLI_CONDS = {
    "c1": {"chr20": ((1100, 140), dict(seed=62, n_loops=18)),
           "chr21": ((1100, 140), dict(seed=63, n_loops=18))},
    "c2": {"chr20": ((1100, 140), dict(seed=82, n_loops=18)),
           "chr21": ((1100, 140), dict(seed=83, n_loops=18))},
}
DIFF_CLI_FLAGS = ["-r", "5kb", "-d", "700kb", "-pt", "0.2", "-st", "0.6",
                  "-pt2", "0.2", "-ch", "20", "21",
                  "--engine-precision", "float64"]


# the float32 cases (--slice cpu_f32); the JAX side runs as the JAX
# package's tests run it (x64 on, 8 virtual CPU devices, BH in sort mode)
# tests/test_torch_cli.py: the two-chromosome text file and the .hic of
# one chromosome with a KR vector (1 on every bin but 2 on every 97th)
F32_CLI_CHROMS = {"chr20": ((1200, 150), dict(seed=7, n_loops=20)),
                  "chr21": ((1200, 150), dict(seed=8, n_loops=20))}
F32_CLI_FLAGS = ["-r", "5kb", "-d", "750kb", "-pt", "0.2", "-st", "0.6"]
F32_CLI_HIC = ((1000, 150), dict(seed=12, n_loops=15))
# tests/test_torch_diff_cli.py: two conditions of chr20 and chr21 as text
F32_DIFF_CLI_CONDS = {
    "c1": {"chr20": ((1100, 140), dict(seed=62, n_loops=18)),
           "chr21": ((1100, 140), dict(seed=63, n_loops=18))},
    "c2": {"chr20": ((1100, 140), dict(seed=82, n_loops=18)),
           "chr21": ((1100, 140), dict(seed=83, n_loops=18))},
}
F32_DIFF_CLI_FLAGS = ["-r", "5kb", "-d", "700kb", "-pt", "0.2", "-st", "0.6",
                      "-pt2", "0.2"]
# tests/test_torch_diff.py: two conditions of 4000 bins at d_px 120
# (3 blocks of 2000^2), batches of 2
F32_DIFF_SLICE = dict(n=4000, d_px=120, seed=71)
F32_DIFF_KW = dict(resolution=RES, distance_bp=120 * RES, pt=0.1, st=0.8,
                   pt2=0.1, block_batch=2)
# tests/test_torch_inter.py: synthetic_inter(900, 800) on a 2 x 2 grid of
# 512^2 tiles
F32_INTER_MAP = ((900, 800), dict(seed=7, n_loops=10))
F32_INTER_KW = dict(resolution=RES, distance_bp=2_000_000, pt=0.1, st=0.5,
                    min_tested=5000)
F32_INTER_CHUNK = 512
# tests/test_torch_sharding.py: two blocks of 2000^2 (starts 0 and 600)
# through the JAX row-sharded runner on 4 virtual CPU devices
F32_SHARD_MAP = ((2600, 100), dict(seed=91, n_loops=30))
F32_SHARD_KW = dict(resolution=RES, distance_bp=100 * RES, pt=0.1, st=0.8)


def kr_vector(n: int):
    """The KR vector of the .hic cases: ones, 2.0 on every 97th bin."""
    import numpy as np

    kr = np.ones(n)
    kr[::97] = 2.0
    return kr


def diff_slice_maps():
    """Both conditions of the differential slice."""
    n, d_px, seed = (F32_DIFF_SLICE[k] for k in ("n", "d_px", "seed"))
    return (synthetic_hic(n, d_px, seed=seed, n_loops=40)[:3]
            + synthetic_hic(n, d_px, seed=seed + 1, n_loops=40)[:3])


def cfg_kwargs(extra: dict) -> dict:
    """DetectionConfig keywords of a case (the defaults of the JAX tests'
    configs: pt 0.2, st 0.88)."""
    return dict(resolution=RES, precision="float64", **extra)


def single_map(name):
    args, kw = FIND_MAP if name == "find_fast" else SINGLE[name][:2]
    return synthetic_hic(*args, **kw)[:3]


def diff_maps(name):
    args, kw1, kw2 = (FIND_DIFF_MAPS if name == "find_diff_raw"
                      else DIFF[name][:3])
    return synthetic_hic(*args, **kw1)[:3] + synthetic_hic(*args, **kw2)[:3]


def write_text(path, chroms: dict) -> str:
    """A 5-column text contact file of ``chroms`` (name -> (args,
    kwargs)), written as the CLI tests write theirs."""
    with open(path, "w") as fh:
        for chrom, (args, kw) in chroms.items():
            x, y, v, _ = synthetic_hic(*args, **kw)
            for a, b, c in zip(x, y, v):
                fh.write(f"{chrom}\t{a * RES}\t{chrom}\t{b * RES}\t{c}\n")
    return str(path)


def load_golden(path: str = GOLDEN) -> dict:
    with open(path) as fh:
        return json.load(fh)
