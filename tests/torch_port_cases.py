"""The small cases the port's CPU tests hold to the JAX package through a
committed golden of the JAX package's own output, shared by
``tools/make_torch_golden.py`` and the tests that read the goldens:

* ``--slice cpu_f64``: the float64 / host-normalize cases below, into
  ``tests/data/torch_port_cpu_f64_golden.json``, read by
  ``tests/test_torch_f64_pipeline.py`` and ``tests/test_torch_f64_diff.py``;
* ``--slice rowaxis``: the dense runner on a 4 x 2 (block, row) mesh
  (``ROWAXIS_*`` below), into ``tests/data/torch_port_rowaxis_golden.json``,
  read by ``tests/test_torch_row_axis.py``;
* ``--slice cool_card``: two small files in cooler's own layout
  (:func:`write_cooler_layout`, a ``.cool`` and a ``.mcool`` of two
  resolutions) and the JAX reader's triplets of them as sha256 digests,
  into ``tests/data/torch_port_cooler_layout.{cool,mcool}`` and
  ``tests/data/torch_port_cool_expected.json``, read by
  ``chip_smoke.py`` phase 11 on the card (which has no h5py) and by
  ``tests/test_torch_h5.py``;
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
port's two modes give the same rows): one JAX f64 block of 2000^2 takes
15-25 s there,
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
GOLDEN_ROWAXIS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "torch_port_rowaxis_golden.json")

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


# tests/test_torch_row_axis.py: the 8 blocks of tests/test_sharding.py::
# test_sharded_equals_unsharded through the dense runner
ROWAXIS_N, ROWAXIS_D_PX = 256, 64
ROWAXIS_KW = dict(resolution=RES, distance_bp=ROWAXIS_D_PX * RES,
                  max_candidates=256)


def rowaxis_blocks(seeds=range(40, 48)):
    """``[len(seeds), 256, 256]`` float32 blocks: each the raw contacts of
    ``synthetic_hic(256, 64, seed, n_loops=4)`` placed densely."""
    import numpy as np

    n = ROWAXIS_N
    blocks = np.zeros((len(seeds), n, n), dtype=np.float32)
    for b, seed in enumerate(seeds):
        x, y, v, _ = synthetic_hic(n, ROWAXIS_D_PX, seed=seed, n_loops=4)
        blocks[b][x, y] = v
    return blocks


def write_cooler_layout(path, group="", n1=900, n2=500, d_px=80, chunk=100,
                        n_inter=3000, seed=61, res=RES):
    """Write (with h5py) a cooler group as cooler writes it: every column
    chunked with gzip 6 and shuffle, ``bins/chrom`` an enum of the names,
    string attributes of variable length (h5py's ``str``), chr1 (``n1``
    bins) and chr2 (``n2``) maps with chr1 x chr2 pixels, NaN weights.
    Returns the pixel count."""
    import h5py
    import numpy as np

    x1, y1, v1, _ = synthetic_hic(n1, d_px, seed=seed, n_loops=8)
    x2, y2, v2, _ = synthetic_hic(n2, d_px, seed=seed + 1, n_loops=6)
    rng = np.random.default_rng(seed + 2)
    xi, yi = rng.integers(0, n1, n_inter), rng.integers(0, n2, n_inter)
    names = ["chr1", "chr2", "chrM"]
    nb = [n1, n2, 4]
    off = np.concatenate([[0], np.cumsum(nb)])
    b1 = np.concatenate([x1, off[1] + x2, xi])
    b2 = np.concatenate([y1, off[1] + y2, off[1] + yi])
    cnt = np.concatenate([np.round(v1), np.round(v2),
                          rng.integers(1, 9, n_inter)]).astype(np.int32)
    key = b1 * off[-1] + b2
    _, keep = np.unique(key, return_index=True)
    order = keep[np.lexsort((b2[keep], b1[keep]))]
    b1, b2, cnt = b1[order], b2[order], cnt[order]
    with h5py.File(path, "a") as f:
        g = f.require_group(group) if group else f

        def col(name, data, **kw):
            g.create_dataset(name, data=data, chunks=(min(chunk, len(data)),),
                             compression="gzip", compression_opts=6,
                             shuffle=True, **kw)

        g.attrs.update({"format": "HDF5::Cooler", "format-version": 3,
                        "bin-type": "fixed", "bin-size": res,
                        "generated-by": "cooler-0.9.3",
                        "metadata": '{"assay": "Hi-C"}',
                        "storage-mode": "symmetric-upper"})
        col("chroms/name", np.array(names, "S4"))
        col("chroms/length", np.array(nb, np.int32) * res)
        enum = h5py.enum_dtype(dict(zip(names, range(3))),
                               basetype=np.int32)
        col("bins/chrom", np.repeat(np.arange(3), nb).astype(np.int32),
            dtype=enum)
        start = np.concatenate([np.arange(n) * res for n in nb])
        col("bins/start", start.astype(np.int32))
        col("bins/end", (start + res).astype(np.int32))
        w = rng.uniform(0.5, 1.5, off[-1])
        w[::41] = np.nan
        col("bins/weight", w)
        col("pixels/bin1_id", b1)
        col("pixels/bin2_id", b2)
        col("pixels/count", cnt)
        col("indexes/chrom_offset", off)
        col("indexes/bin1_offset", np.searchsorted(b1, np.arange(off[-1] + 1)))
    return len(b1)


# chip_smoke.py phase 11's fixtures (--slice cool_card): a .cool and a
# .mcool of two resolutions in cooler's layout, a few tens of KB
COOL_CARD = {"cool": os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "data", "torch_port_cooler_layout.cool"),
             "mcool": os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "data", "torch_port_cooler_layout.mcool")}
COOL_CARD_KW = dict(n1=210, n2=100, d_px=16, chunk=48, n_inter=300)


def write_cool_card_fixtures():
    """Write the two files of ``COOL_CARD`` (h5py)."""
    import h5py

    for path in COOL_CARD.values():
        if os.path.exists(path):
            os.remove(path)
    write_cooler_layout(COOL_CARD["cool"], **COOL_CARD_KW)
    for res in (RES, 2 * RES):
        kw = dict(COOL_CARD_KW, res=res)
        kw["n1"], kw["n2"] = kw["n1"] * RES // res, kw["n2"] * RES // res
        write_cooler_layout(COOL_CARD["mcool"], f"resolutions/{res}", **kw)
    with h5py.File(COOL_CARD["mcool"], "a") as f:
        f.attrs["format"] = "HDF5::MCOOL"


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
