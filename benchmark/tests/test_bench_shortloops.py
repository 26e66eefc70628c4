"""The short-range loop generator (``harness/shortloops.py``, run here on
the CPU generator) against its law: mapgen's background draw for draw,
each diagonal's mean within Poisson error of ``A * d ** -1.08`` at the
depth chr21 takes at 1 kb (``A`` 215.5), the loops' separations in the
traffic's ``loop_bp`` and their bumps where they are planted; the
traffic's depth as its source states it; and a traced run of a small
CPU cell of the ``detect_short_loops`` kind that reads
``epilogue_scan_ms`` and ``h2d_MB``."""

import io
import json
import shutil
import time

import numpy as np
import pytest

from benchmark.harness import cell, manifest, mapgen, shortloops
from conftest import ROOT

TRAFFIC = json.loads((ROOT / "benchmark/traffic/"
                      "chr21_hg38_1kb_short_loops.json").read_text())
DEPTH = TRAFFIC["depth"]
RES = 1000
CHR21_BINS = -(-TRAFFIC["maps"][0]["bp"] // RES)
CHR21_CONTACTS = (DEPTH["genome_contacts"] * TRAFFIC["maps"][0]["bp"]
                  / DEPTH["genome_bp"])
A = mapgen.depth_scale(CHR21_BINS, CHR21_CONTACTS, DEPTH["exponent"])
LOOP_PX = tuple(b / RES for b in DEPTH["loop_bp"])
# three 1 kb blocks' worth of chr21, every diagonal of its 2 Mb band
N, D = 6000, 2000


def contacts_at_chr21_depth(n):
    """The contacts that give ``n`` bins chr21's ``A``."""
    d = np.arange(1, n, dtype=np.float64)
    return A * ((n - d) * d ** -DEPTH["exponent"]).sum()


def law_map(seed, n_loops):
    return shortloops.make_map(
        N, D, seed=seed, device="cpu", contacts=contacts_at_chr21_depth(N),
        exponent=DEPTH["exponent"], n_loops=n_loops,
        loop_strength=DEPTH["loop_strength"], loop_px=LOOP_PX)


def test_traffic_depth_is_the_cited_one():
    assert DEPTH["genome_contacts"] == 4.9e9 and DEPTH["exponent"] == 1.08
    assert DEPTH["loop_bp"] == [10000, 100000]
    assert TRAFFIC["kind"] == "detect_short_loops"
    # hg38 chr21 at 1 kb: 46,710 bins, 73.8 M contacts, 151 loops, and
    # the background's mean at d = 1 is 215.5
    assert CHR21_BINS == 46710
    assert round(CHR21_CONTACTS / 1e5) == 738
    assert round(DEPTH["genome_loops"] * TRAFFIC["maps"][0]["bp"]
                 / DEPTH["genome_bp"]) == 151
    assert round(A, 1) == 215.5


def test_background_is_mapgens_draw_for_draw():
    kw = dict(seed=2**31 + 21, device="cpu", contacts=3.0e6, exponent=1.08,
              n_loops=0, loop_strength=3.0)
    want = mapgen.make_map(2500, 300, **kw)
    got = shortloops.make_map(2500, 300, **kw, loop_px=LOOP_PX)
    assert got[3] == []
    assert all(np.array_equal(a, b) for a, b in zip(got[:3], want))


def test_each_diagonal_holds_the_laws_mean():
    x, y, v, _ = law_map(seed=2**31 + 23, n_loops=0)
    d = np.arange(1, D + 1)
    lam = A * d ** -DEPTH["exponent"]
    pixels = N - d
    mean = np.bincount(y - x, v, minlength=D + 1)[1:] / pixels
    z = (mean - lam) * pixels / np.sqrt(pixels * lam)
    assert np.abs(z).max() < 5
    # the map is what the reader hands: sorted, in the band, counts
    assert np.all((y > x) & (y - x <= D)) and np.all(v > 0)
    assert np.all(np.diff(x * N + y) > 0)


def test_anchors_lie_inside_the_law_and_carry_their_bumps():
    x, y, v, anchors = law_map(seed=2**31 + 25, n_loops=60)
    assert len(anchors) == 60
    dd = np.array([b - a for a, b in anchors])
    assert dd.min() >= LOOP_PX[0] and dd.max() <= LOOP_PX[1]
    assert min(a for a, _ in anchors) >= 10
    assert max(b for _, b in anchors) < N - 10
    # a loop's centre has 1 + loop_strength times the background's mean
    counts = dict(zip(zip(x.tolist(), y.tolist()), v.tolist()))
    got = np.array([counts.get(a, 0.0) for a in anchors])
    want = (1 + DEPTH["loop_strength"]) * A * dd ** -DEPTH["exponent"]
    ratio = got.sum() / want.sum()
    assert 0.85 < ratio < 1.15


def test_seed_decides_the_map():
    a = law_map(seed=2**31 + 11, n_loops=10)
    b = law_map(seed=2**31 + 11, n_loops=10)
    c = law_map(seed=2**31 + 12, n_loops=10)
    assert all(np.array_equal(p, q) for p, q in zip(a[:3], b[:3]))
    assert a[3] == b[3] and a[3] != c[3]


# a small 1 kb cell of the kind: 2,600 bins (two blocks of 2000^2) at a
# 200 kb distance, the microc_1kb deployment's thresholds
TINY_1KB = {"resolution": 1000, "distance_bp": 200000, "pt": 0.01,
            "st": 0.8, "pt2": 0.1, "sigma0": 1.6, "octaves": 2,
            "precision": "float32"}
NEW_METRICS = ("epilogue_scan_ms", "h2d_MB")


@pytest.fixture(scope="module")
def short_root(tiny_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("short") / "bench"
    shutil.copytree(tiny_root, root)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_1kb", "source": "test",
                           "file": "benchmark/configs/tiny_1kb.json",
                           "reduced": [], "why": "CPU tests"})
    (root / "benchmark/configs/tiny_1kb.json").write_text(
        json.dumps(TINY_1KB))
    man["workloads"].append({"name": "tiny.short", "config": "tiny_1kb",
                             "traffic": "tiny_short", "chips": 1,
                             "why": "CPU tests"})
    (root / "benchmark/traffic/tiny_short.json").write_text(json.dumps(
        {**TRAFFIC, "maps": [{"chrom": "chr21", "bp": 2600 * RES,
                              "seed_offset": 0}]}))
    spec = json.loads((ROOT / "benchmark/workloads/microc_1kb.chr21.json")
                      .read_text())
    (root / "benchmark/workloads/tiny.short.json").write_text(
        json.dumps({**spec, "trace_calls": 1}))
    for m in man["per_layer"]:
        if "microc_1kb.chr21" in m.get("workloads", ()):
            m["workloads"].append("tiny.short")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def test_a_traced_run_reads_the_scans_and_the_upload_bytes(short_root):
    from mustache_tpu_torch.bandnorm import bucket_rows
    from mustache_tpu_torch.detect import band_width

    seed = 2**31 + 29
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run("tiny.short", seed, 0.5, True, t_start=time.perf_counter(),
                  device="cpu", root=short_root, out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(NEW_METRICS) <= set(got), sorted(got)
    assert got["epilogue_scan_ms"]["value"] >= 0.0
    # one call's band (u8 at this size) and its exceptions, 12 B each
    c = manifest.find_cell("tiny.short", short_root)
    (m,) = shortloops.make_maps(c, seed, "cpu")
    rows = bucket_rows(max(m["n_bins"], 2000))
    want = rows * band_width(2000, 200) + 12 * int((m["v"] > 255).sum())
    assert got["h2d_MB"]["value"] == pytest.approx(want / 1e6)
    assert got["h2d_MB"]["unit"] == "MB"
