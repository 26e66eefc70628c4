"""Tests of the benchmark's own code, run on their own:

    python -m pytest benchmark/tests -q

They import the benchmark as the package ``benchmark`` from the
checkout's root. Tests that need a CUDA card are marked ``cuda`` and
skip without one; whether there is a card is decided in the ``cuda``
fixture, never at import.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda():
    """The card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "benchmark/tests -m cuda)")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# small cells for CPU runs of the harness: a 5 kb map of 1,300 bins (one
# block) or 2,600 (two blocks) at a 1 Mb distance, each held to the limits
# of the real cell of its kind
TINY_CONFIG = {"resolution": 5000, "distance_bp": 1000000, "pt": 0.1,
               "st": 0.8, "pt2": 0.1, "sigma0": 1.6, "octaves": 2,
               "precision": "float32"}


def tiny_map(chrom="chr21", n_bins=1300, seed_offset=0):
    return {"chrom": chrom, "bp": n_bins * 5000, "seed_offset": seed_offset}


# the real cells' depth: a tiny chromosome takes its share by length
DEPTH = json.loads((ROOT / "benchmark/traffic/chr21_hg19_5kb.json")
                   .read_text())["depth"]

TINY = {
    "tiny.detect": ("detect", [tiny_map(n_bins=2600)], "hic_5kb.chr21"),
    "tiny.diff": ("diff", [tiny_map(), tiny_map(seed_offset=1)],
                  "hic_5kb.diff"),
    "tiny.cli": ("cli_hic", [tiny_map(), tiny_map("chr22", 1250, 1)],
                 "hic_5kb.cli_hic"),
}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added as files and
    manifest entries, and the program's package beside it."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_5kb", "source": "test",
                           "file": "benchmark/configs/tiny_5kb.json",
                           "reduced": [], "why": "CPU tests"})
    (root / "benchmark/configs/tiny_5kb.json").write_text(
        json.dumps(TINY_CONFIG))
    for name, (kind, maps, like) in TINY.items():
        man["workloads"].append({"name": name, "config": "tiny_5kb",
                                 "traffic": name.replace(".", "_"),
                                 "chips": 1, "why": "CPU tests"})
        (root / f"benchmark/traffic/{name.replace('.', '_')}.json"
         ).write_text(json.dumps({"kind": kind, "depth": DEPTH,
                                  "maps": maps}))
        spec = json.loads((ROOT / f"benchmark/workloads/{like}.json")
                          .read_text())
        spec["trace_calls"] = 1
        (root / f"benchmark/workloads/{name}.json").write_text(
            json.dumps(spec))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    os.environ.setdefault("MUSTACHE_TPU_TORCH_BUILD_DIR",
                          str(ROOT / "mustache_tpu_torch/kernels/_build"))
    return root
