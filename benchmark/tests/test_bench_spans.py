"""The readers of the program's stage spans: their arithmetic on a
hand-built trace, and a traced run of each small CPU cell
(``conftest.TINY``) in which every host metric of its real cell is
read."""

import io
import json
import shutil
import time

import pytest

from benchmark.harness import cell, manifest
from benchmark.harness.trace import Trace


def span(name, a, b):
    return {"cat": "user_annotation", "name": name, "ph": "X", "ts": a,
            "dur": b - a}


# two calls of one entry: the first with a census, fill and stage inside
# its upload, a launch, a collect and a rerun inside its block's finish;
# the second with no rerun. Each leaves 200 us of its pipeline.call
# covered by no narrower range: 10-20, 400-500 and 900-990 in the
# first, 2100-2300 in the second
CALL_SPANS = [
    ("bench.call", 0, 1000), ("pipeline.call", 10, 990),
    ("pipeline.prepare", 20, 100), ("pipeline.upload", 100, 400),
    ("upload.census", 110, 150), ("upload.fill", 150, 300),
    ("upload.stage", 300, 390), ("mesh.launch", 500, 600),
    ("detect.epilogue", 520, 580), ("mesh.collect", 600, 700),
    ("pipeline.finish", 700, 900), ("pipeline.regrow", 750, 800),
    ("bench.call", 2000, 2500), ("pipeline.call", 2000, 2400),
    ("pipeline.prepare", 2000, 2100), ("pipeline.finish", 2300, 2400),
]


def ctx_of(spans, calls=2):
    return {"trace": Trace([span(*s) for s in spans]), "calls": calls,
            "fused_flop": 0.0, "fused_bytes": 0.0}


def read(name, ctx):
    return manifest.metric_reader(name)(ctx)


def test_unnamed_is_the_call_ranges_own_time():
    ctx = ctx_of(CALL_SPANS)
    assert read("unnamed_ms", ctx) == pytest.approx(0.2)
    # the differential entry's call range counts the same
    diff = [("diff.call" if s[0] == "pipeline.call" else s[0],) + s[1:]
            for s in CALL_SPANS]
    assert read("unnamed_ms", ctx_of(diff)) == pytest.approx(0.2)
    # a call with every piece named has none
    whole = [("pipeline.call", 0, 100), ("pipeline.prepare", 0, 40),
             ("mesh.launch", 40, 100)]
    assert read("unnamed_ms", ctx_of(whole, 1)) == 0.0


def test_regrows_count_the_rerun_ranges():
    assert read("regrows_per_call", ctx_of(CALL_SPANS)) == 0.5
    # calls with no rerun read 0, not nothing
    second = [s for s in CALL_SPANS if s[1] >= 2000]
    assert read("regrows_per_call", ctx_of(second, 1)) == 0.0
    # a program without the call ranges has nothing to read
    bare = [s for s in CALL_SPANS if not s[0].endswith(".call")
            or s[0] == "bench.call"]
    assert read("regrows_per_call", ctx_of(bare)) is None
    assert read("unnamed_ms", ctx_of(bare)) is None


def test_stage_readers():
    ctx = ctx_of(CALL_SPANS)
    want = {"prepare_ms": 0.09, "upload_census_ms": 0.02,
            "upload_fill_ms": 0.075, "upload_stage_ms": 0.045,
            "dispatch_ms": 0.05, "collect_wait_ms": 0.05}
    for name, ms in want.items():
        assert read(name, ctx) == pytest.approx(ms), name
    # the upload's stages account for its range but for its gaps, 100-110
    # and 390-400: 10 us a call
    stages = sum(want[k] for k in ("upload_census_ms", "upload_fill_ms",
                                   "upload_stage_ms"))
    assert read("upload_ms", ctx) - stages == pytest.approx(0.01)
    for name in ("diff_finish_ms", "hic_decode_ms", "hic_assemble_ms"):
        assert read(name, ctx) is None
    # per span, not per call: two chromosomes' reads in one call
    hic = [("hic.decode", 0, 300), ("hic.assemble", 300, 400),
           ("hic.decode", 1000, 1100), ("hic.assemble", 1100, 1300)]
    one = ctx_of(hic, 1)
    assert read("hic_decode_ms", one) == pytest.approx(0.2)
    assert read("hic_assemble_ms", one) == pytest.approx(0.15)


def test_cumsum_reads_the_kernels_launched_in_its_range():
    ev = [span("bandnorm.cumsum", 0, 100)]
    for corr, (launch, k0, k1) in enumerate([(10, 200, 260),
                                             (150, 300, 320)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ph": "X", "ts": launch, "dur": 5,
                   "args": {"correlation": corr}})
        ev.append({"cat": "kernel", "name": f"k{corr}", "ph": "X",
                   "ts": k0, "dur": k1 - k0, "args": {"correlation": corr}})
    ctx = {"trace": Trace(ev), "calls": 1}
    # the second kernel was launched after the range closed
    assert read("cumsum_ms", ctx) == pytest.approx(0.06)


# the real cell whose host metrics each small cell reports
NEW_HOST = {
    "tiny.detect": ("hic_5kb.chr21", {
        "prepare_ms", "upload_census_ms", "upload_fill_ms",
        "upload_stage_ms", "dispatch_ms", "collect_wait_ms",
        "regrows_per_call", "unnamed_ms"}),
    "tiny.diff": ("hic_5kb.diff", {
        "prepare_ms", "upload_census_ms", "upload_fill_ms",
        "upload_stage_ms", "dispatch_ms", "collect_wait_ms",
        "diff_finish_ms", "regrows_per_call", "unnamed_ms"}),
    "tiny.cli": ("hic_5kb.cli_hic", {"hic_decode_ms", "hic_assemble_ms"}),
}


@pytest.fixture(scope="module")
def spans_root(tiny_root, tmp_path_factory):
    """The small cells' benchmark with each small cell listed wherever
    its real cell is."""
    root = tmp_path_factory.mktemp("spans") / "bench"
    shutil.copytree(tiny_root, root)
    man = json.loads((root / "BENCHMARK.json").read_text())
    for m in man["per_layer"]:
        for tiny, (real, _) in NEW_HOST.items():
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.mark.parametrize("name", sorted(NEW_HOST))
def test_a_traced_run_reads_every_new_host_metric(spans_root, name):
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run(name, 2 ** 31 + 17, 0.5, True,
                  t_start=time.perf_counter(), device="cpu",
                  root=spans_root, out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert NEW_HOST[name][1] <= set(got), sorted(got)
    if name != "tiny.cli":
        assert got["regrows_per_call"]["value"] == 0.0
        assert got["regrows_per_call"]["unit"] == "reruns"
        assert got["unnamed_ms"]["value"] >= 0.0
