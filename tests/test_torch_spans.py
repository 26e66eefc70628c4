"""The port's stage spans (``torch.profiler.record_function`` ranges) on
the CPU: each entry's call is one range holding every stage's range,
nested as the benchmark's readers take them; a rerun of an overflowing
block is one ``pipeline.regrow`` range; the ``.hic`` reader splits each
chromosome it reads on the profiled thread into a ``hic.decode`` and a
``hic.assemble``; and the answers are the same with the profiler on."""

import json
import threading

import numpy as np
import pytest
import torch

import torch_port_cases as C
from hic_writer import write_hic
from mustache_tpu_torch import (
    DetectionConfig, detect_diff_loops_coo, detect_loops_coo, pipeline,
)
from mustache_tpu_torch.cli import main
from synthetic import synthetic_hic

RES = 5000
# two blocks of 2000^2 in batches of one: two launches and collects
CFG = DetectionConfig(resolution=RES, distance_bp=120 * RES, pt=0.1,
                      st=0.8, pt2=0.1, block_batch=1)

# child -> the range it sits in; every span of an entry's call
DETECT_NESTING = {
    "pipeline.prepare": "pipeline.call",
    "pipeline.upload": "pipeline.call",
    "upload.fill": "pipeline.upload",
    "upload.stage": "pipeline.upload",
    "pipeline.normalize": "pipeline.call",
    "bandnorm.cumsum": "pipeline.normalize",
    "mesh.launch": "pipeline.call",
    "detect.preamble": "mesh.launch",
    "detect.kernel": "mesh.launch",
    "detect.epilogue": "mesh.launch",
    "mesh.collect": "pipeline.call",
    "pipeline.finish": "pipeline.call",
}
DIFF_NESTING = {
    **{k: ("diff.call" if v == "pipeline.call" else v)
       for k, v in DETECT_NESTING.items()
       if not k.startswith("detect.") and k != "pipeline.finish"},
    "diff.preamble": "mesh.launch",
    "diff.fused_ladder": "mesh.launch",
    "diff.planes": "mesh.launch",
    "diff.epilogue": "mesh.launch",
    "diff.finish": "diff.call",
}


def profiled(fn, tmp_path):
    """``fn()``'s result and the ranges the profiler saw, as ``{name:
    [(start, end, thread id)]}`` from its Chrome trace (times in us, the
    system's thread ids)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and "dur" in e:
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    return out, spans


def assert_nested(spans, nesting, top=None):
    if top is not None:
        assert len(spans[top]) == 1, spans.get(top)
    for child, parent in nesting.items():
        assert spans.get(child), f"no {child} range"
        for a, b, _ in spans[child]:
            assert any(pa <= a and b <= pb for pa, pb, _ in spans[parent]), (
                child, parent)


@pytest.fixture(scope="module")
def one_map():
    return synthetic_hic(2600, 120, seed=31, n_loops=10)[:3]


@pytest.fixture(scope="module")
def two_maps():
    return (synthetic_hic(2600, 120, seed=32, n_loops=10)[:3]
            + synthetic_hic(2600, 120, seed=33, n_loops=10)[:3])


@pytest.fixture(scope="module")
def detect_rows(one_map):
    return detect_loops_coo(*one_map, CFG, device="cpu")


@pytest.fixture(scope="module")
def diff_rows(two_maps):
    return detect_diff_loops_coo(*two_maps, CFG, device="cpu")


def test_detect_call_holds_every_stage(one_map, detect_rows, tmp_path):
    rows, spans = profiled(
        lambda: detect_loops_coo(*one_map, CFG, device="cpu"), tmp_path)
    assert rows == detect_rows and len(rows) > 0
    assert_nested(spans, DETECT_NESTING, "pipeline.call")
    assert len(spans["pipeline.prepare"]) == 2
    assert len(spans["mesh.launch"]) == len(spans["mesh.collect"]) == 2
    assert "pipeline.regrow" not in spans
    # a map sorted by row, of integer counts: the fill's one pass takes
    # the census, and nothing is filled again
    assert len(spans["upload.fill"]) == 1
    assert "upload.census" not in spans and "upload.refill" not in spans


def test_diff_call_holds_every_stage(two_maps, diff_rows, tmp_path):
    rows, spans = profiled(
        lambda: detect_diff_loops_coo(*two_maps, CFG, device="cpu"), tmp_path)
    assert rows == diff_rows and len(rows) > 0
    assert_nested(spans, DIFF_NESTING, "diff.call")
    assert len(spans["pipeline.upload"]) == 2
    assert "pipeline.regrow" not in spans
    assert "upload.census" not in spans and "upload.refill" not in spans


def test_unsorted_map_takes_census_and_refill(one_map, detect_rows,
                                              tmp_path):
    """The same map in another order of rows: the one pass finds the
    disorder, so the upload takes the census and fills the band again by
    the full scan, one ``upload.census`` and one ``upload.refill`` inside
    ``pipeline.upload``; the rows are the sorted map's."""
    x, y, v = one_map
    assert len(v) >= 1 << 16       # the threaded walk
    order = np.random.default_rng(5).permutation(len(v))
    rows, spans = profiled(
        lambda: detect_loops_coo(x[order], y[order], v[order], CFG,
                                 device="cpu"), tmp_path)
    assert rows == detect_rows
    assert len(spans["upload.census"]) == len(spans["upload.refill"]) == 1
    assert_nested(spans, {"upload.census": "pipeline.upload",
                          "upload.refill": "pipeline.upload"})


@pytest.mark.parametrize("entry", ["detect", "diff"])
def test_one_regrow_range_a_rerun(entry, one_map, two_maps, detect_rows,
                                  diff_rows, monkeypatch, tmp_path):
    """At a capacity of 4 candidates blocks overflow; each rerun is one
    ``pipeline.regrow`` range inside the block's finish, and the rows are
    those of the default capacity. Both entries regrow through the one
    block loop's ``_maybe_regrow``."""
    real = pipeline._maybe_regrow
    reruns = []

    def counted(block_out, cfg, rerun, sig_count):
        def again(cap):
            reruns.append(cap)
            return rerun(cap)
        return real(block_out, cfg, again, sig_count)

    monkeypatch.setattr(pipeline, "_maybe_regrow", counted)
    cfg = CFG.with_(max_candidates=4)
    if entry == "detect":
        rows, spans = profiled(
            lambda: detect_loops_coo(*one_map, cfg, device="cpu"), tmp_path)
        want, finish = detect_rows, "pipeline.finish"
    else:
        rows, spans = profiled(
            lambda: detect_diff_loops_coo(*two_maps, cfg, device="cpu"),
            tmp_path)
        want, finish = diff_rows, "diff.finish"
    assert rows == want
    assert len(reruns) > 0
    assert len(spans["pipeline.regrow"]) == len(reruns)
    assert_nested(spans, {"pipeline.regrow": finish})


@pytest.fixture(scope="module")
def two_chrom_hic(tmp_path_factory):
    """A v8 ``.hic`` of chr20 and chr21 (one block each) with KR vectors,
    and the CLI's TSV of it without the profiler."""
    (nb, d_px), kw = C.F32_CLI_HIC
    tmp = tmp_path_factory.mktemp("spans_hic")
    pixels, norms = {}, {}
    for i, chrom in enumerate(("chr20", "chr21")):
        x, y, v, _ = synthetic_hic(nb, d_px, **dict(kw, seed=kw["seed"] + i))
        pixels[chrom] = (x, y, v)
        norms[("KR", chrom)] = C.kr_vector(nb)
    path = str(tmp / "two.hic")
    write_hic(path, [(c, nb * RES) for c in pixels], RES, pixels,
              version=8, norms=norms)
    out = str(tmp / "plain.tsv")
    assert main(cli_argv(path, out)) == 0
    return path, open(out).read()


def cli_argv(path, out):
    return (["-f", path, "-o", out, "-ch", "chr20", "chr21"] + C.F32_CLI_FLAGS
            + ["--engine-platform", "cpu"])


@pytest.mark.parametrize("prefetch", [True, False])
def test_hic_read_splits_into_decode_and_assemble(two_chrom_hic, tmp_path,
                                                  prefetch):
    """Each chromosome read on the profiled (main) thread gives one
    ``hic.decode`` and one ``hic.assemble`` after it; with the prefetch
    on, the second chromosome is read on a worker thread, which the
    profiler may or may not record. The TSV is the unprofiled run's."""
    path, plain = two_chrom_hic
    out = str(tmp_path / "t.tsv")
    argv = cli_argv(path, out) + ([] if prefetch else
                                  ["--engine-no-prefetch"])
    rc, spans = profiled(lambda: main(argv), tmp_path)
    assert rc == 0 and open(out).read() == plain
    assert len(plain.splitlines()) > 2
    main_tid = threading.get_native_id()
    for name in ("hic.decode", "hic.assemble"):
        on_main = [s for s in spans[name] if s[2] == main_tid]
        assert len(on_main) == (1 if prefetch else 2), (name, spans[name])
        assert len(spans[name]) in (1, 2)
    for (d0, d1, dt), (a0, a1, at) in zip(sorted(spans["hic.decode"]),
                                          sorted(spans["hic.assemble"])):
        assert dt == at and d1 <= a0

