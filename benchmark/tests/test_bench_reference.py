"""The plain reference, row for row, against the frozen numpy/scipy
oracle at small sizes.

Rows and scales must be equal. q within a relative 1e-3: the method's q
moves by a few 1e-4 under float64 rounding of the normalized values
(the oracle's ``np.convolve`` window sums against the reference's
prefix sums, 1e-12 apart), through the choice among near-equal maxima
and BH's running minimum."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import frozen_oracle as oracle
from benchmark.harness import mapgen
from benchmark.reference import chromosome, detect
from benchmark.reference.normalize import normalize_coo
from frozen_synthetic import synthetic_hic

RES = 5000
CFG = {"resolution": RES, "pt": 0.1, "st": 0.8, "pt2": 0.1, "sigma0": 1.6,
       "octaves": 2}
Q_RTOL = 1e-3
# the oracle's p is ``1 - cdf``, a multiple of 2**-53 (reference/detect.py
# takes ``exp(-z)``), which BH scales by the tested pixels over the rank
# (at most some 1e6): a q is good to about 1e-10 absolute
Q_ATOL = 1e-10


def _same_rows(got, want, key=lambda r: (int(r[0]), int(r[1]))):
    g = {key(r): r for r in got}
    w = {key(r): r for r in want}
    assert set(g) == set(w)
    for k in w:
        assert g[k][3] == w[k][3], k
        assert abs(g[k][2] - w[k][2]) <= Q_RTOL * w[k][2] + Q_ATOL, (
            k, g[k], w[k])


def _oracle_blocks(maps, d_px, fn):
    dep = chromosome.Deployment({**CFG, "distance_bp": d_px * RES})
    vns = []
    for x, y, v in maps:
        vv = v.copy()
        oracle.normalize_sparse_oracle(x, y, vv, RES, d_px)
        vns.append(vv)
    n = max(int(max(x.max(), y.max())) + 1 for x, y, _ in maps)
    start, end = chromosome.chunk_grid(n, dep.chunk, d_px)
    masks = chromosome.mask_sizes(start, end, d_px)
    rows = []
    for i, (s, e) in enumerate(zip(start, end)):
        blocks = []
        for (x, y, _), vv in zip(maps, vns):
            sel = (x >= s) & (x < e) & (y >= s) & (y < e)
            c = np.zeros((dep.chunk, dep.chunk))
            c[x[sel] - s, y[sel] - s] = vv[sel]
            blocks.append(c)
        for r in fn(blocks, dep, s):
            if r[0] >= s + masks[i] or r[1] >= s + masks[i]:
                rows.append(r)
    return rows


def test_blur_is_scipys():
    rng = np.random.default_rng(0)
    c = rng.random((60, 60))
    sig = detect.octave_sigmas(3.2)
    got = detect.blur_stack(torch.tensor(c), sig).numpy()
    for i, s in enumerate(sig):
        np.testing.assert_allclose(got[i], oracle.scipy_blur(c, s),
                                   rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        detect.blur_stack(torch.tensor(c), [1.6]).numpy()[0],
        gaussian_filter(c, 1.6, truncate=((2 * 4 + 1 - 1) / 2 - 0.5) / 1.6),
        rtol=0, atol=1e-14)


def test_max3_and_bh_are_the_oracles():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 40, 40))
    np.testing.assert_array_equal(detect.max3(torch.tensor(a)).numpy(),
                                  np.stack([oracle.max3(p) for p in a]))
    p = rng.random(500) ** 4
    np.testing.assert_allclose(detect.bh_fdr(torch.tensor(p)).numpy(),
                               oracle.bh_fdr(p), rtol=1e-15)


def test_normalize_is_the_oracles():
    x, y, v, _ = synthetic_hic(2600, 100, seed=5, n_loops=30)
    want = v.copy()
    oracle.normalize_sparse_oracle(x, y, want, RES, 100)
    got = normalize_coo(torch.tensor(x), torch.tensor(y), torch.tensor(v),
                        RES, 100).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def _cited_depth_map(n_bins, d_px, seed):
    """A map of the benchmark's own law at GM12878's depth (the cells'
    traffic), for a chromosome of ``n_bins`` bins at 5 kb."""
    share = n_bins * RES / 3.1e9
    return mapgen.make_map(n_bins, d_px, seed=seed, device="cpu",
                           contacts=4.9e9 * share, exponent=1.08,
                           n_loops=round(1e4 * share) * 2,
                           loop_strength=3.0)


@pytest.mark.parametrize("model", ["frozen", "cited_depth"])
def test_single_map_rows_equal_the_oracles(model):
    d_px = 100
    if model == "frozen":
        x, y, v, _ = synthetic_hic(2600, d_px, seed=5, n_loops=40,
                                   loop_strength=3.0)
    else:
        x, y, v = _cited_depth_map(2600, d_px, seed=5)
    got = chromosome.loops(x, y, v, {**CFG, "distance_bp": d_px * RES},
                           device="cpu")

    def fn(blocks, dep, s):
        return oracle.detect_block_oracle(blocks[0], dep.octave_values,
                                          d_px, dep.st, dep.pt, start=s)

    want = _oracle_blocks([(x, y, v)], d_px, fn)
    assert len(want) > 20
    _same_rows(got, want)


def test_diff_rows_equal_the_oracles():
    d_px = 100
    m1 = synthetic_hic(1300, d_px, seed=71, n_loops=40, loop_strength=3.0)
    m2 = synthetic_hic(1300, d_px, seed=72, n_loops=40, loop_strength=3.0)
    got = chromosome.diff_loops(*m1[:3], *m2[:3],
                                {**CFG, "distance_bp": d_px * RES},
                                device="cpu")

    def fn(blocks, dep, s):
        groups = oracle.diff_detect_block_oracle(
            blocks[0], blocks[1], dep.octave_values, d_px, dep.st, dep.pt,
            dep.pt2, start=s)
        return [(*r, tag) for tag, g in zip((1, 2, 3, 4), groups)
                for r in g]

    want = _oracle_blocks([m1[:3], m2[:3]], d_px, fn)
    assert {r[4] for r in want} == {1, 2, 3, 4}
    _same_rows(got, want, key=lambda r: (r[4], int(r[0]), int(r[1])))
