"""The port's cooler reader on a file laid out as the 4DN portal ships
``.mcool`` (``benchmark/harness/coolfile.py``: every column chunked,
shuffled and deflated at level 6; every cis pixel, diagonal 0 and the
far field beyond the distance included; NaN weights on masked bins; the
maps of ``benchmark/harness/farfield.py``, raw counts under a lognormal
bias):

* ``read_mcooler`` gives a plain numpy balance and band filter of the
  writer's inputs, bit for bit;
* its ``cool.read``, ``cool.select`` and ``cool.balance`` ranges open
  once a fetch, not once a chunk, and its counters count the rows and
  the chunks, every chunk decoded by the native decoder and every row
  sifted by the native pass;
* the CLI's ``ingest`` events carry the counters (the prefetched
  chromosome's too, ``chunks_native`` equal to ``chunks_inflated`` and
  ``rows_native`` to ``rows_read``), and its rows are
  ``detect_loops_coo``'s on the plain
  balance; the balanced (real-valued) band goes up as f32 after one
  refill of the one-pass u8 fill."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_port_cases as C  # noqa: F401  (torch on one thread)
from mustache_tpu_torch import DetectionConfig, detect_loops_coo
from mustache_tpu_torch.cli import main
from mustache_tpu_torch.detect import band_width
from mustache_tpu_torch.io import cool
from mustache_tpu_torch.pipeline import fill_raw_band_compact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.harness import coolfile, farfield  # noqa: E402

RES = 5000
D_PX = 200                     # -d 1 Mb, the CLI's least at 5 kb
CHROMS = [("chr1", 520 * RES), ("chr2", 450 * RES - 9), ("chrX", 40 * RES)]
COUNTERS = {"rows_read", "rows_native", "rows_kept", "chunks_inflated",
            "bytes_inflated", "inflate_s", "unshuffle_s", "chunks_native"}


@pytest.fixture(scope="module")
def mcool(tmp_path_factory):
    """``(path, maps, weight)``: chr1 and chr2 whole, chrX without
    pixels (NaN weights), as ``coolfile.write_mcool`` writes them."""
    maps = {}
    for i, (name, bp) in enumerate(CHROMS[:2]):
        maps[name] = farfield.make_whole_map(
            -(-bp // RES), D_PX, seed=31 + i, bias_seed=41 + i,
            device="cpu", contacts=3.0e6, exponent=1.08, n_loops=8,
            loop_strength=3.0, sigma=0.2, masked_share=0.02)
    weight = np.concatenate([maps["chr1"]["weight"], maps["chr2"]["weight"],
                             np.full(40, np.nan)])
    path = str(tmp_path_factory.mktemp("mcool4dn") / "sample.mcool")
    coolfile.write_mcool(path, RES, CHROMS,
                         {k: (m["x"], m["y"], m["count"])
                          for k, m in maps.items()}, weight, "hg38",
                         workers=2)
    return path, maps, weight


def plain_balance(m):
    """The writer's inputs balanced and band-filtered in numpy, as the
    reader's contract states it."""
    x, y, c, w = m["x"], m["y"], m["count"], m["weight"]
    keep = np.abs(y - x) <= D_PX
    x, y = x[keep], y[keep]
    v = c[keep].astype(np.float64) * w[x]
    v *= w[y]
    pos = (v > 0) & np.isfinite(v)
    return x[pos], y[pos], v[pos]


def test_read_mcooler_is_a_plain_balance_and_band_filter(mcool):
    path, maps, _ = mcool
    for name, m in maps.items():
        d = m["y"] - m["x"]
        # the file holds diagonal 0, the far field and masked bins
        assert (d == 0).sum() > 100 and (d > D_PX).sum() > 10_000
        assert np.isnan(m["weight"]).sum() >= 8
        got = cool.read_mcooler(path, 1_000_000, name, name, RES, False)
        want = plain_balance(m)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (got[0] == got[1]).any()           # diagonal 0 kept
    with cool.CoolFile(path, RES) as clr:
        raw = clr.fetch_band("chr2", 1_000_000, balance=False)
        m = maps["chr2"]
        band = np.abs(m["y"] - m["x"]) <= D_PX
        assert np.array_equal(raw[2], m["count"][band].astype(np.float64))
        ds = clr._h5._dataset(clr._g + "pixels/count")
        assert len(clr._h5._chunk_index(ds)) > 8  # several chunks a column


def test_ranges_open_once_a_fetch_and_counters_count(mcool):
    path, maps, _ = mcool
    counters = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x, y, v = cool.read_mcooler(path, 1_000_000, "chr1", "chr1", RES,
                                    False, counters)
    names = [e.name for e in prof.events()]
    for stage in ("cool.read", "cool.select", "cool.balance"):
        assert names.count(stage) == 1, stage
    assert set(counters) == COUNTERS
    assert counters["rows_read"] == len(maps["chr1"]["count"])
    assert counters["rows_native"] == counters["rows_read"]
    assert counters["rows_kept"] == len(v)
    # the three pixel columns' chunks, the index's and the weights'
    assert counters["chunks_inflated"] > 3 * 8
    assert counters["bytes_inflated"] >= 20 * counters["rows_read"]
    assert counters["inflate_s"] > 0 and counters["unshuffle_s"] > 0
    # every chunk through the native decoder
    assert counters["chunks_native"] == counters["chunks_inflated"]


def test_the_cli_logs_the_counters_and_detects_the_balanced_band(
        mcool, tmp_path, capsys):
    path, maps, _ = mcool
    out = str(tmp_path / "loops.tsv")
    assert main(["-f", path, "-ch", "chr1", "chr2", "-r", "5kb", "-d",
                 "1000000", "-o", out, "-pt", "0.1", "-st", "0.8",
                 "--engine-platform", "cpu", "--engine-json-log"]) == 0
    events = [json.loads(line) for line in capsys.readouterr().err
              .splitlines() if line.startswith("{")]
    ingest = [e for e in events if e["event"] == "ingest"]
    assert [e["chromosome"] for e in ingest] == ["chr1", "chr2"]
    assert [e["prefetched"] for e in ingest] == [False, True]
    for e in ingest:
        assert COUNTERS <= set(e)
        assert e["chunks_native"] == e["chunks_inflated"] > 0
        assert e["rows_read"] == len(maps[e["chromosome"]]["count"])
        assert e["rows_native"] == e["rows_read"]
        assert e["rows_kept"] == len(plain_balance(maps[e["chromosome"]])[2])
    # chr1's rows are detect_loops_coo's on the plain balance
    cfg = DetectionConfig(resolution=RES, distance_bp=1_000_000, pt=0.1,
                          st=0.8)
    want = [lp.to_row("chr1", "chr1", RES) for lp in detect_loops_coo(
        *plain_balance(maps["chr1"]), cfg, device="cpu")]
    rows = open(out).read().splitlines(keepends=True)[1:]
    assert len(want) > 3
    assert sorted(r for r in rows if r.startswith("chr1\t")) == sorted(want)
    assert any(r.startswith("chr2\t") for r in rows)


def test_a_balanced_band_goes_up_as_f32_after_one_refill(mcool):
    x, y, v = plain_balance(mcool[1]["chr1"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        n = int(y.max()) + 1
        band, exc, packed4 = fill_raw_band_compact(
            x, y, v, (n, band_width(n, D_PX)))
    assert [e.name for e in prof.events()].count("upload.refill") == 1
    assert band.dtype == np.float32 and exc is None and not packed4
    assert np.array_equal(band[x, y - x], v.astype(np.float32))
