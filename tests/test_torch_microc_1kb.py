"""The port at 1 kb on maps with Micro-C's short-range loops
(``benchmark/harness/shortloops.py``: loops 10-100 kb apart on the
background of ``benchmark/harness/mapgen.py``, at the depth of the
benchmark's ``microc_1kb`` deployment, whose ``pt`` 0.01 and ``st`` 0.8
these runs take):

* at ``precision="float64"`` its rows are those of the benchmark's plain
  reference (``benchmark/reference/chromosome.loops`` at float64):
  anchors and scales exact, q within the north star's rtol, and the
  reference calls most of the planted loops;
* the generator's separations lie in the traffic's ``loop_bp``;
* the epilogue's int32 prefix sums are ``detect.scan`` ranges inside
  ``detect.epilogue``, three a batch (count-mode BH's marks and rank
  histogram, the support's column sums);
* ``pipeline.H2D_BYTES`` counts a call's band upload, the band's bytes
  plus 12 bytes an exception record, on the one-shot and the streamed
  path."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_port_cases as C  # noqa: F401  (torch on one thread)
from mustache_tpu_torch import DetectionConfig, detect_loops_coo, pipeline
from mustache_tpu_torch.bandnorm import bucket_rows
from mustache_tpu_torch.detect import band_width

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.harness import mapgen, shortloops  # noqa: E402
from benchmark.reference import chromosome as reference  # noqa: E402

RES = 1000
TRAFFIC = json.load(open(os.path.join(
    ROOT, "benchmark/traffic/chr21_hg38_1kb_short_loops.json")))
DEPTH = TRAFFIC["depth"]
CONFIG = json.load(open(os.path.join(
    ROOT, "benchmark/configs/microc_1kb.json")))
CHR21_BINS = -(-TRAFFIC["maps"][0]["bp"] // RES)
# the background's mean at d = 1 on chr21 at the cited depth, 215.5
A = mapgen.depth_scale(
    CHR21_BINS, DEPTH["genome_contacts"] * TRAFFIC["maps"][0]["bp"]
    / DEPTH["genome_bp"], DEPTH["exponent"])
LOOP_PX = tuple(b / RES for b in DEPTH["loop_bp"])
NORTH_STAR_RTOL = 2e-4


def short_map(n_bins, d_px, seed, n_loops):
    """A map of ``n_bins`` at chr21's depth per bin, its loops by the
    traffic's law: ``(x, y, v, anchors)``."""
    d = np.arange(1, n_bins, dtype=np.float64)
    contacts = A * ((n_bins - d) * d ** -DEPTH["exponent"]).sum()
    return shortloops.make_map(
        n_bins, d_px, seed=seed, device="cpu", contacts=contacts,
        exponent=DEPTH["exponent"], n_loops=n_loops,
        loop_strength=DEPTH["loop_strength"], loop_px=LOOP_PX)


# two blocks of 2000^2 at a 200 kb distance, the least the reference's
# normalize takes at 1 kb
N_SMALL, D_SMALL = 2600, 200


def small_cfg(precision):
    return DetectionConfig(resolution=RES, distance_bp=D_SMALL * RES,
                           pt=CONFIG["pt"], st=CONFIG["st"],
                           precision=precision)


@pytest.fixture(scope="module")
def small():
    return short_map(N_SMALL, D_SMALL, seed=2**31 + 3, n_loops=12)


@pytest.fixture(scope="module")
def reference_rows(small):
    x, y, v, _ = small
    cfg = {**CONFIG, "distance_bp": D_SMALL * RES}
    # the reference's dense float64 ladder takes 30 s on one thread for
    # these two blocks, 18 s on two
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return reference.loops(x, y, v, cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def f64_call(small):
    """The float64 call's rows and the names of the ranges it opened."""
    x, y, v, _ = small
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rows = detect_loops_coo(x, y, v, small_cfg("float64"), device="cpu")
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    return rows, spans


def test_float64_rows_are_the_references(small, reference_rows, f64_call):
    got = {(lp.bin1, lp.bin2): (lp.q, lp.scale) for lp in f64_call[0]}
    want = {(r[0], r[1]): (r[2], r[3]) for r in reference_rows}
    assert len(want) >= 6 and set(got) == set(want)
    for k, (q, scale) in want.items():
        assert got[k][1] == scale, k
        assert abs(got[k][0] - q) <= NORTH_STAR_RTOL * q, k
    # a map that calls nothing checks nothing: most planted loops are
    # called within 2 bins
    anchors = small[3]
    hit = sum(any(abs(r[0] - ax) <= 2 and abs(r[1] - ay) <= 2
                  for r in reference_rows) for ax, ay in anchors)
    assert hit >= 0.75 * len(anchors)


def test_separations_lie_in_loop_bp():
    gen = torch.Generator().manual_seed(2**31 + 5)
    anchors = shortloops.loop_anchors(gen, CHR21_BINS, 5000, *LOOP_PX, "cpu")
    assert len(anchors) == 5000
    x = np.array([a for a, _ in anchors])
    dd = np.array([b - a for a, b in anchors])
    assert dd.min() >= LOOP_PX[0] and dd.max() <= LOOP_PX[1]
    assert x.min() >= 10 and (x + dd).max() < CHR21_BINS - 10
    # log-uniform: the median separation is the range's geometric middle
    assert abs(np.median(dd) - np.sqrt(LOOP_PX[0] * LOOP_PX[1])) < 2.5


def test_scans_are_ranges_inside_the_epilogue(f64_call):
    spans = f64_call[1]
    epilogues, scans = spans["detect.epilogue"], spans["detect.scan"]
    assert len(epilogues) >= 1
    assert len(scans) == 3 * len(epilogues)
    for a, b in scans:
        assert any(ea <= a and b <= eb for ea, eb in epilogues)


@pytest.mark.parametrize("n_bins,d_px,streamed", [
    (N_SMALL, D_SMALL, False),     # 0.7 M cells: the one-shot upload
    (4200, 2000, True),            # 9 M cells, 1.5 M values: two slabs
])
def test_h2d_counts_the_band_and_its_exceptions(n_bins, d_px, streamed):
    x, y, v, _ = short_map(n_bins, d_px, seed=2**31 + 7, n_loops=8)
    cfg = DetectionConfig(resolution=RES, distance_bp=d_px * RES, pt=0.01,
                          st=0.8)
    rows = bucket_rows(max(n_bins, cfg.chunk_size))
    Dl = band_width(cfg.chunk_size, d_px)
    before = pipeline.H2D_BYTES
    _, sent = pipeline.normalized_bands(
        x, y, v, cfg, (rows, Dl), n_bins, pipeline.local_runner("cpu"),
        normalize=True, exact=False)
    got = pipeline.H2D_BYTES - before
    # integer counts: u8 with the counts over 255 as exceptions, or
    # nibble-packed u4 with those over 15
    packed4 = "band=u4" in sent
    assert packed4 == streamed and f"slabs={1 + streamed}" in sent
    if packed4:
        want = rows * Dl // 2 + 12 * int((v > 15).sum())
    else:
        want = rows * Dl + 12 * int((v > 255).sum())
    assert got == want and f"bytes={want} " in sent
