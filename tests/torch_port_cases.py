"""The small float64 / host-normalize cases the port's CPU tests hold to
the JAX package, shared by ``tools/make_torch_golden.py --slice cpu_f64``
(which runs the JAX package on them and writes
``tests/data/torch_port_cpu_f64_golden.json``) and the tests that read
that file (``tests/test_torch_f64_pipeline.py``,
``tests/test_torch_f64_diff.py``).

The maps are those of ``tests/test_pipeline.py`` and ``tests/test_diff.py``
(the JAX package's own f64 pipeline tests), the CLI files those of
``tests/test_torch_cli.py`` and ``tests/test_torch_diff_cli.py``. Every
JAX result is a float64 run of the JAX package on the CPU with its BH in
exact sort mode (the port's only mode): one JAX f64 block of 2000^2 takes
15-25 s there, which is why the tests read a golden instead.
"""

import json
import os

from synthetic import synthetic_hic

RES = 5000
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_cpu_f64_golden.json")

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


def load_golden() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)
