"""The device map generator (run here on the CPU generator) against the
law it draws from: Poisson counts about ``A * d ** -exponent`` with the
chromosome's expected contacts, and the traffic's depth as its source
states it."""

import json

import numpy as np

from benchmark.harness import mapgen
from conftest import ROOT

N, D = 3000, 200
PARAMS = dict(contacts=2.0e6, exponent=1.08, n_loops=20, loop_strength=3.0)


def _per_diagonal(x, y, v):
    d = y - x
    pixels = N - np.arange(1, D + 1)
    occ = np.bincount(d, minlength=D + 1)[1:] / pixels
    mean = np.bincount(d, v, minlength=D + 1)[1:] / pixels
    return occ, mean


def test_statistics_follow_the_law():
    x, y, v = mapgen.make_map(N, D, seed=3, device="cpu",
                              **{**PARAMS, "n_loops": 0})
    a = mapgen.depth_scale(N, PARAMS["contacts"], PARAMS["exponent"])
    d = np.arange(1, D + 1)
    lam = a * d ** -1.08
    pixels = N - d
    # each diagonal's contacts and occupied pixels, within five standard
    # deviations of the Poisson law's
    occ, mean = _per_diagonal(x, y, v)
    z = (mean - lam) * pixels / np.sqrt(pixels * lam)
    assert np.abs(z).max() < 5
    p = 1 - np.exp(-lam)
    z = (occ - p) * pixels / np.sqrt(pixels * p * (1 - p) + 1e-9)
    assert np.abs(z).max() < 5


def test_depth_scale_spreads_the_contacts_over_the_chromosome():
    a = mapgen.depth_scale(N, 1.0e6, 1.08)
    d = np.arange(1, N)
    assert np.isclose((a * (N - d) * d ** -1.08).sum(), 1.0e6)


def test_traffic_depth_is_the_cited_one():
    t = json.loads((ROOT / "benchmark/traffic/chr21_hg19_5kb.json")
                   .read_text())
    depth = t["depth"]
    assert depth["genome_contacts"] == 4.9e9 and depth["exponent"] == 1.08
    share = t["maps"][0]["bp"] / depth["genome_bp"]
    # chr21 at 5 kb: 76 M contacts in all, 155 loops
    assert round(depth["genome_contacts"] * share / 1e6) == 76
    assert round(depth["genome_loops"] * share) == 155


def test_map_is_sorted_in_the_band_and_positive():
    x, y, v = mapgen.make_map(N, D, seed=5, device="cpu", **PARAMS)
    assert x.dtype == np.int64 and y.dtype == np.int64
    assert np.all((y > x) & (y - x <= D) & (y < N)) and np.all(v > 0)
    assert np.all(v == np.floor(v))
    key = x * N + y
    assert np.all(np.diff(key) > 0)


def test_seed_decides_the_map():
    a = mapgen.make_map(N, D, seed=2**31 + 11, device="cpu", **PARAMS)
    b = mapgen.make_map(N, D, seed=2**31 + 11, device="cpu", **PARAMS)
    c = mapgen.make_map(N, D, seed=2**31 + 12, device="cpu", **PARAMS)
    assert all(np.array_equal(p, q) for p, q in zip(a, b))
    assert not (len(a[0]) == len(c[0]) and np.array_equal(a[2], c[2]))


def test_loops_raise_the_counts_they_cover():
    x, y, v = mapgen.make_map(N, D, seed=7, device="cpu",
                              **{**PARAMS, "n_loops": 200})
    x0, y0, v0 = mapgen.make_map(N, D, seed=7, device="cpu",
                                 **{**PARAMS, "n_loops": 0})
    # the background draws come first, so both maps share them; 200
    # bumps of some 28 times the local mean add about 0.3 %
    assert 0.001 * v0.sum() < v.sum() - v0.sum() < 0.01 * v0.sum()


def test_bumps_multiply_in_anchor_order():
    keys, prod = mapgen.bump_factors([(50, 90), (51, 91)], 200, 100, 3.0)
    assert len(set(keys.tolist())) == len(keys)
    centre = 50 * 100 + (90 - 50 - 1)
    (i,) = np.nonzero(keys == centre)[0]
    w = 3.0 * np.exp(-2 / 3.0)
    assert np.isclose(prod[i], 4.0 * (1 + w))
