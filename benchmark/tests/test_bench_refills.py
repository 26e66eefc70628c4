"""``upload_refills_per_call``: its count on a hand-built trace, and a
traced run of each small CPU cell (``conftest.TINY``) that reads it."""

import io
import json
import shutil
import time

import pytest

from benchmark.harness import cell, manifest
from benchmark.harness.trace import Trace

METRIC = "upload_refills_per_call"


def span(name, a, b):
    return {"cat": "user_annotation", "name": name, "ph": "X", "ts": a,
            "dur": b - a}


def read(spans, calls):
    ctx = {"trace": Trace([span(*s) for s in spans]), "calls": calls,
           "fused_flop": 0.0, "fused_bytes": 0.0}
    return manifest.metric_reader(METRIC)(ctx)


def test_refills_count_the_refill_ranges():
    # two calls: the first fills its band again (census, then the fill),
    # the second fills it once
    spans = [
        ("pipeline.call", 0, 1000), ("pipeline.upload", 100, 400),
        ("upload.fill", 110, 200), ("upload.refill", 200, 390),
        ("upload.census", 210, 250), ("upload.fill", 250, 390),
        ("pipeline.call", 2000, 2400), ("pipeline.upload", 2100, 2200),
        ("upload.fill", 2110, 2190),
    ]
    assert read(spans, 2) == 0.5
    # a call with no refill reads 0, not nothing; the diff's call too
    assert read(spans[6:], 1) == 0.0
    assert read([("diff.call",) + s[1:] if s[0] == "pipeline.call" else s
                 for s in spans[6:]], 1) == 0.0
    # a program without the call ranges has nothing to read
    assert read([s for s in spans if s[0] != "pipeline.call"], 2) is None


# the real cell each small cell stands for, and its refills a call
TINY_REFILLS = {"tiny.detect": ("hic_5kb.chr21", 0.0),
                "tiny.diff": ("hic_5kb.diff", 0.0),
                "tiny.cli": ("hic_5kb.cli_hic", 2.0)}


@pytest.fixture(scope="module")
def refills_root(tiny_root, tmp_path_factory):
    """The small cells' benchmark with each small cell listed where its
    real cell is in this metric's workloads."""
    root = tmp_path_factory.mktemp("refills") / "bench"
    shutil.copytree(tiny_root, root)
    man = json.loads((root / "BENCHMARK.json").read_text())
    (m,) = [m for m in man["per_layer"] if m["name"] == METRIC]
    m["workloads"] += [t for t, (real, _) in TINY_REFILLS.items()
                       if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.mark.parametrize("name", sorted(TINY_REFILLS))
def test_a_traced_run_reads_the_refills(refills_root, name):
    """Maps sorted by row, of integer counts, fill in one pass (0 a
    call); the CLI's ``.hic`` records come in block order, not by row, so
    each of its two chromosomes is filled again (2 a call)."""
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run(name, 2 ** 31 + 23, 0.5, True,
                  t_start=time.perf_counter(), device="cpu",
                  root=refills_root, out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    got = res["metrics"][METRIC]
    assert got["unit"] == "refills"
    assert got["value"] == TINY_REFILLS[name][1]
