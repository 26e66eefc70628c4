"""The cooler fetch's native sift (``io/native/cool_select.cpp``, called
as ``native.cool_select``) against its numpy twin ``cool._select_plain``,
bit for bit:

* through ``CoolFile.fetch_band`` and ``fetch_rect``, once as the program
  runs and once with the twin patched in, on files of
  ``tools/write_cool.py`` that hold NaN weights, +-inf, zero and negative
  counts, a second weight column, trans pixels beyond the chromosome, a
  chromosome without pixels, at distances that are and are not a whole
  number of bins;
* called directly on one thread and on ``native.N_THREADS``, on a row
  count no thread count divides;
* a kept pixel whose bin lies outside its chromosome's weights raises
  ``ValueError`` naming the file on both paths;
* callers on more threads than cores, each sifting on ``N_THREADS``,
  get the twin's rows and are each counted once in ``COOL_SELECTS``;
* on a file of ``benchmark/harness/coolfile.py`` (chunked, shuffled and
  deflated as 4DN ships ``.mcool``), every fetch takes the native pass:
  ``rows_native`` equals ``rows_read`` and ``native.COOL_SELECTS`` grows
  by one a fetch."""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mustache_tpu_torch.io import cool, native
from synthetic import synthetic_hic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import write_cool  # noqa: E402
from benchmark.harness import coolfile  # noqa: E402

RES = 5000
CHROMS = [("chr1", 700 * RES), ("chr2", 520 * RES - 7), ("chrM", 16_000)]
N_BINS = 700 + 520 + 4


def _special(v, rng):
    """``v`` as float64 with some counts +-inf, zero and negative."""
    v = np.asarray(v, np.float64).copy()
    for value, share in ((np.inf, 0.01), (-np.inf, 0.01), (0.0, 0.03),
                         (-2.5, 0.03)):
        v[rng.random(len(v)) < share] = value
    return v


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``{"cool": path}``: chr1 and chr2 with every distance up to 300
    bins, a chr1 x chr2 rectangle (chr1's rows then run past its last
    bin), chrM without pixels; a ``weight`` column with NaN and a ``KR``
    column; float64 counts with +-inf, zero and negative values."""
    rng = np.random.default_rng(2203)
    x1, y1, v1, _ = synthetic_hic(700, 300, seed=81, n_loops=6)
    x2, y2, v2, _ = synthetic_hic(520, 300, seed=82, n_loops=6)
    n_rect = 4000
    rect = (rng.integers(0, 700, n_rect), rng.integers(0, 520, n_rect),
            rng.poisson(2.0, n_rect) + 1.0)
    pixels = {"chr1": (x1, y1, _special(v1, rng)),
              "chr2": (x2, y2, _special(v2, rng)),
              ("chr1", "chr2"): (rect[0], rect[1], _special(rect[2], rng))}
    weight = rng.lognormal(0.0, 0.2, N_BINS)
    weight[rng.random(N_BINS) < 0.02] = np.nan
    tree = write_cool.cooler_tree(CHROMS, RES, pixels, weight, np.float64)
    tree["bins"]["KR"] = rng.lognormal(0.0, 0.3, N_BINS)
    path = str(tmp_path_factory.mktemp("sift") / "sift.cool")
    write_cool.write_h5(path, tree)
    return {"cool": path}


def _fetch(path, method, args, monkeypatch, plain):
    """``CoolFile.<method>(*args)`` with the native sift, or with its
    twin patched in."""
    with monkeypatch.context() as m:
        if plain:
            m.setattr(native, "cool_select", cool._select_plain)
        with cool.CoolFile(path) as clr:
            return getattr(clr, method)(*args)


FETCHES = {
    "band_nan_weights": ("fetch_band", ("chr1", 1_000_000, True)),
    "special_counts": ("fetch_band", ("chr2", 1_500_000, True)),
    "unbalanced": ("fetch_band", ("chr1", 1_000_000, False)),
    "named_column": ("fetch_band", ("chr2", 1_000_000, "KR")),
    "distance_between_bins": ("fetch_band", ("chr1", 1_234_567, True)),
    "rows_beyond_hi": ("fetch_band", ("chr1", 10_000_000, True)),
    "empty_chromosome": ("fetch_band", ("chrM", 1_000_000, True)),
    "rect": ("fetch_rect", ("chr1", "chr2", True)),
    "rect_flipped": ("fetch_rect", ("chr2", "chr1", "KR")),
}


def _columns(seed):
    """``(b1, b2, v, bounds, w, w)``: 100,003 rows (no thread count
    divides them) of a band with NaN weights and special counts."""
    rng = np.random.default_rng(seed)
    n, nb = 100_003, 900
    b1 = np.sort(rng.integers(0, nb, n)).astype(np.int64)
    b2 = b1 + rng.integers(0, 400, n)
    v = _special(rng.poisson(3.0, n), rng)
    w = rng.lognormal(0.0, 0.2, nb + 400)
    w[::37] = np.nan
    bounds = (cool._I64_MIN, nb + 100, cool._band_kmax(1_100_000, RES), 0, 0)
    return b1, b2, v, bounds, w, w


def _direct(n_threads):
    """Both sides called directly on :func:`_columns`."""
    args = _columns(n_threads)
    return (native.cool_select(*args, n_threads=n_threads),
            cool._select_plain(*args))


CASES = list(FETCHES) + ["threads_1", "threads_all"]


@pytest.mark.parametrize("case", CASES)
def test_native_sift_equals_its_numpy_twin(files, monkeypatch, case):
    if case in FETCHES:
        method, args = FETCHES[case]
        got, want = (_fetch(files["cool"], method, args, monkeypatch, plain)
                     for plain in (False, True))
    else:
        got, want = _direct(1 if case == "threads_1" else native.N_THREADS)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    v = got[2]
    assert len(v) > 0 or case == "empty_chromosome"
    assert np.all(np.isfinite(v)) and np.all(v > 0)
    if case == "rows_beyond_hi":     # chr1's rows hold the rectangle,
        with cool.CoolFile(files["cool"]) as clr:   # within the distance
            lo, hi = clr._chrom_bin_range("chr1")
            b1, b2, _ = clr._read_pixels(0, clr._h5.read(
                "indexes/bin1_offset", hi, hi + 1)[0])
        assert ((b2 >= hi) & (b2 - b1 <= 2000)).sum() > 1000
        assert got[1].max() < hi - lo


def test_a_bin_outside_its_weights_raises_on_both_paths(tmp_path,
                                                        monkeypatch):
    """chr2's rows hold a pixel in chr1's last bin (a lower-triangular
    trans pixel): its shifted bin is -1, which numpy's indexing would
    wrap to chr2's last weight."""
    x, y, v, _ = synthetic_hic(200, 50, seed=83, n_loops=2)
    x, y = np.append(x, 5), np.append(y, -1)
    v = np.append(v, 4.0)
    path = str(tmp_path / "bad.cool")
    write_cool.write_cool(path, CHROMS[:2], RES, {"chr2": (x, y, v)},
                          np.ones(700 + 520))
    for plain in (False, True):
        with pytest.raises(ValueError, match="bad.cool"):
            _fetch(path, "fetch_band", ("chr2", 500_000, True), monkeypatch,
                   plain)
        # unbalanced, no weight vector bounds the bins: both keep the pixel
        got = _fetch(path, "fetch_band", ("chr2", 500_000, False),
                     monkeypatch, plain)
        assert (got[1] == -1).sum() == 1
    b1 = np.array([700 + 5, 700 + 900], np.int64)   # x beyond the weights
    b2 = np.array([700 + 6, 700 + 901], np.int64)
    args = (b1, b2, np.ones(2), (cool._I64_MIN, 10_000, 5, 700, 700),
            np.ones(520), np.ones(520))
    assert native.cool_select(*args) is None
    assert cool._select_plain(*args) is None


def test_concurrent_callers_sift_alike_and_are_counted():
    """The CLI sifts on two threads; here 24 callers on 8-thread sifts,
    the interpreter switching threads every 10 us."""
    args = _columns(3)
    want = cool._select_plain(*args)
    before, interval = native.COOL_SELECTS, sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=24) as pool:
            jobs = [pool.submit(native.cool_select, *args)
                    for _ in range(48)]
            outs = [job.result(timeout=60) for job in jobs]
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() < 24
    assert native.COOL_SELECTS == before + 48
    for got in outs:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_coolfile_fetches_take_the_native_pass(tmp_path):
    x, y, v, _ = synthetic_hic(600, 250, seed=84, n_loops=4)
    chroms = [("chr21", 600 * RES), ("chr22", 420 * RES)]
    x2, y2, v2, _ = synthetic_hic(420, 250, seed=85, n_loops=4)
    w = np.random.default_rng(86).lognormal(0.0, 0.2, 1020)
    w[::53] = np.nan
    path = str(tmp_path / "4dn.mcool")
    coolfile.write_mcool(path, RES, chroms, {"chr21": (x, y, v),
                                             "chr22": (x2, y2, v2)}, w,
                         "hg38", workers=2)
    before = native.COOL_SELECTS
    with cool.CoolFile(path, RES) as clr:
        for i, name in enumerate(("chr21", "chr22")):
            got = clr.fetch_band(name, 1_000_000)
            assert native.COOL_SELECTS == before + i + 1
            assert clr.counters["rows_native"] == clr.counters["rows_read"]
            lo, _ = clr._chrom_bin_range(name)
            m = (x, y, v) if name == "chr21" else (x2, y2, v2)
            keep = np.abs(m[1] - m[0]) <= 200
            want = cool._select_plain(
                m[0][keep] + lo, m[1][keep] + lo,
                np.asarray(m[2][keep], np.int32).astype(np.float64),
                (cool._I64_MIN, 1 << 40, 200, lo, lo), w[lo:lo + 600],
                w[lo:lo + 600])
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert clr.counters["rows_read"] == len(v) + len(v2)
