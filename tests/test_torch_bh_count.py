"""The port's count-mode BH (the default, ``detect._BH_MODE``) against its
sort mode and against the JAX package's count mode, its exact overflow
decision, and the epilogue batched over a batch's blocks, on the CPU.

* count mode against sort mode on the three blocks of
  ``tests/test_bh_count.py``, float32 (the kernel route's plain version)
  and float64 (the ladder route), with that file's assertions: sig_count
  and n_tested equal, the valid table and pass flags bit-identical, the
  loop rows equal, significant neighbours bit-identical;
* the port's count mode against the JAX package's on one of them, run as
  ``tests/test_bh_count.py`` runs it: rows equal, valid log q within the
  f32 parity rule (rtol 2e-4);
* overflow on tied and clustered p (the case the JAX package's one-pass
  test misses: 50 of 100 tested tied at p = 0.02, pt = 0.05, K = 35),
  at the K+1 boundary ranks, and over random tie patterns (hypothesis):
  count mode never misses an overflow, and after the regrow its
  rejections are sort mode's and a numpy statsmodels-form BH's;
* the batched epilogue: ``BlockDetector._epilogues`` and the diff
  epilogue over B = 3 blocks with a pad slot in the middle equal the
  per-block ``_detect_one`` / ``_diff_detect_one`` outputs bit for bit
  in both modes; the pipelined entry points give the rows of one batch
  at ``block_batch`` 1 and 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hs

import mustache_tpu.detect as jdetect
from mustache_tpu.normalize import normalize_sparse as jax_normalize
from mustache_tpu.scalespace import build_ladder as jax_ladder
from mustache_tpu_torch import (
    DetectionConfig, detect_diff_loops_coo, detect_loops_coo,
)
from mustache_tpu_torch import detect as tdetect
from mustache_tpu_torch import diff as tdiff
from mustache_tpu_torch.detect import _maybe_regrow
from oracle import bh_fdr
from synthetic import synthetic_hic
import torch_port_cases as C

CPU = torch.device("cpu")
TABLE_KEYS = ("cand_x", "cand_y", "cand_sigidx", "cand_logq", "pass_sparse",
              "pass_enrich", "cand_pass")


def _block(n, d_px, seed, n_loops=8):
    """tests/test_bh_count.py's block: a normalized synthetic map."""
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed, n_loops=n_loops)
    jax_normalize(x, y, v, 5000, d_px, work_dtype=np.float32)
    c = np.zeros((n, n), dtype=np.float32)
    c[x, y] = v
    return c


def _cfg(d_px, precision):
    return DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                           precision=precision, max_candidates=256,
                           min_nz=50, min_tested=500)


def _port(c, cfg, mode, monkeypatch):
    monkeypatch.setattr(tdetect, "_BH_MODE", mode)
    det = tdetect.build_detector(cfg, c.shape[0], device=CPU)
    out = det.fn_single(torch.from_numpy(c))
    return {k: a.numpy() for k, a in out.items()}, det.spec


def _rows(out, cfg, spec):
    return tdetect.finish_block(out, block_index=0, start=0, cfg=cfg,
                                spec=spec)


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("n,d_px,seed", [(256, 64, 7), (200, 40, 11),
                                         (320, 120, 23)])
def test_count_matches_sort_full_surface(n, d_px, seed, precision,
                                         monkeypatch):
    cfg = _cfg(d_px, precision)
    c = _block(n, d_px, seed)
    ref, spec = _port(c, cfg, "sort", monkeypatch)
    got, _ = _port(c, cfg, "count", monkeypatch)
    assert int(got["sig_count"]) == int(ref["sig_count"])
    assert int(got["n_tested"]) == int(ref["n_tested"])
    ok = ref["cand_valid"]
    assert ok.any()
    np.testing.assert_array_equal(got["cand_valid"], ok)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(got[k][ok], ref[k][ok], err_msg=k)
    rows = _rows(ref, cfg, spec)
    assert _rows(got, cfg, spec) == rows and len(rows) > 0
    # significant neighbours carry bit-identical q; the others are >= pt
    # in both modes (count mode gives those beyond its table q = 1)
    lpt = tdetect.thresholds(cfg)[1]
    sig_r = ref["neigh_logq"][ok] < lpt
    np.testing.assert_array_equal(got["neigh_logq"][ok] < lpt, sig_r)
    np.testing.assert_array_equal(got["neigh_logq"][ok][sig_r],
                                  ref["neigh_logq"][ok][sig_r])
    np.testing.assert_array_equal(got["neigh_sigidx"][ok],
                                  ref["neigh_sigidx"][ok])


def test_count_matches_jax_count(monkeypatch):
    """One block through the JAX package's count mode (its XLA path, as
    tests/test_bh_count.py runs it) and the port's (the kernel route's
    plain version): the same candidates and rows."""
    n, d_px, seed = 256, 64, 7
    cfg = _cfg(d_px, "float32")
    c = _block(n, d_px, seed)
    monkeypatch.setattr(jdetect, "_BH_MODE", "count")
    jspec = jax_ladder(cfg.octave_values)
    want = jdetect._detect_one(
        jnp.asarray(c), np.float32(cfg.st), np.float32(np.log(cfg.pt)),
        kernels=jspec.kernels.astype(np.float32), det_ceil=jspec.det_ceil,
        planes_per_octave=jspec.planes_per_octave,
        n_octaves=len(cfg.octave_values), d_px=d_px, intra=True,
        K=cfg.max_candidates)
    want = {k: np.asarray(a) for k, a in want.items()}
    got, spec = _port(c, cfg, "count", monkeypatch)
    for k in ("n_tested", "sig_count", "nz_count"):
        assert int(got[k]) == int(want[k]), k

    def cands(out):
        ok = out["cand_valid"]
        return {(int(x), int(y), int(s)): (lq, p) for x, y, s, lq, p in zip(
            out["cand_x"][ok], out["cand_y"][ok], out["cand_sigidx"][ok],
            out["cand_logq"][ok], out["cand_pass"][ok])}

    g, w = cands(got), cands(want)
    assert set(g) == set(w) and len(w) > 0
    for key, (lq, ok) in w.items():
        np.testing.assert_allclose(g[key][0], lq, rtol=2e-4, atol=1e-4)
        assert g[key][1] == ok
    rows_w = jdetect.finish_block(want, block_index=0, start=0,
                                  cfg=jdetect.DetectionConfig(**{
                                      f: getattr(cfg, f)
                                      for f in cfg.__dataclass_fields__}),
                                  spec=jspec)
    rows_g = _rows(got, cfg, spec)
    assert [r[:2] + r[3:] for r in rows_g] == [r[:2] + r[3:] for r in rows_w]
    assert len(rows_w) > 0
    np.testing.assert_allclose([r[2] for r in rows_g],
                               [r[2] for r in rows_w], rtol=2e-4)


# ---------------------------------------------------------------------------
# overflow: tied and clustered p
# ---------------------------------------------------------------------------

N_T, D_T = 16, 8            # a 16 x 16 band holds 136 in-matrix cells


def _tables(p, K, pt, mode, monkeypatch, dtype=torch.float32):
    """``_band_candidates`` on one block whose first ``len(p)`` in-matrix
    band cells are tested with p-values ``p`` (row-major), the rest
    untested."""
    monkeypatch.setattr(tdetect, "_BH_MODE", mode)
    geom = tdetect._BandGeom(N_T, D_T, CPU)
    cells = torch.nonzero(geom.band_validl.reshape(-1))[:len(p), 0]
    logp = torch.full((N_T * geom.Dl,), float("inf"), dtype=dtype)
    logp[cells] = torch.from_numpy(np.log(np.asarray(p, np.float64))).to(
        dtype)
    nz = torch.zeros(N_T * geom.Dl, dtype=torch.bool)
    nz[cells] = True
    shape = (1, N_T, geom.Dl)
    lpt = float(np.float32(np.log(pt))) if dtype == torch.float32 \
        else float(np.log(pt))
    out = tdetect._band_candidates(
        geom, band_logp=logp.reshape(shape), band_nz=nz.reshape(shape),
        band_sigidx=torch.zeros(shape, dtype=torch.int32),
        band_c=torch.ones(shape, dtype=dtype),
        ceil_table=torch.ones(18, dtype=torch.int64), ceil_max=1, st=0.0,
        log_pt=lpt, K=K)
    return {k: a[0].numpy() for k, a in out.items()}, cells.numpy()


def _rejected(out):
    """Flat band indices of the table's significant pixels."""
    ok = out["cand_valid"]
    return set((out["cand_x"][ok] * tdetect.band_width(N_T, D_T)
                + out["cand_y"][ok] - out["cand_x"][ok]).tolist())


def _regrown(p, K, pt, monkeypatch):
    """Count mode at capacity K, regrown as the pipeline regrows."""
    first, _ = _tables(p, K, pt, "count", monkeypatch)
    cfg = DetectionConfig(max_candidates=K)
    return first, _maybe_regrow(
        first, cfg, lambda cap: _tables(p, cap, pt, "count",
                                        monkeypatch)[0],
        lambda o: int(o["sig_count"]))


def _bh_rejections(p, pt, cells):
    """The flat cells a numpy statsmodels-form BH rejects."""
    return set(cells[bh_fdr(np.asarray(p, np.float64)) < pt].tolist())


def test_tied_overflow_is_seen_and_regrows(monkeypatch):
    """50 of 100 tested tied at p = 0.02, pt = 0.05, K = 35: nothing is
    marked at K+1 (0.02 > 0.05 * 36 / 100), yet all 50 reject."""
    rng = np.random.default_rng(0)
    p = np.concatenate([np.full(50, 0.02), rng.uniform(0.5, 1.0, 50)])
    rng.shuffle(p)
    first, final = _regrown(p, 35, 0.05, monkeypatch)
    assert int(first["sig_count"]) >= 50
    sort, cells = _tables(p, 64, 0.05, "sort", monkeypatch)
    assert int(sort["sig_count"]) == 50
    assert int(final["sig_count"]) == 50
    assert _rejected(final) == _rejected(sort) == _bh_rejections(p, 0.05,
                                                                 cells)
    ok = sort["cand_valid"]
    np.testing.assert_array_equal(final["cand_valid"][:len(ok)], ok)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(final[k][:len(ok)][ok], sort[k][ok],
                                      err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [-2, -1, 0, 1, 2, 30])
def test_cluster_at_boundary_ranks(offset, dtype, monkeypatch):
    """A cluster of k0 = K + offset tied p just below the rank-k0 BH line
    (p = pt k0 / n (1 - 1e-3)), the rest far above: the cutoff is k0, so
    the table overflows exactly when k0 > K; when it fits, count mode
    equals sort mode; after a regrow, the rejections are BH's."""
    K, n, pt = 32, 120, 0.1
    k0 = K + offset
    p = np.concatenate([np.full(k0, pt * k0 / n * (1 - 1e-3)),
                        np.full(n - k0, 0.9)])
    got, cells = _tables(p, K, pt, "count", monkeypatch, dtype)
    sort, _ = _tables(p, K, pt, "sort", monkeypatch, dtype)
    assert int(sort["sig_count"]) == k0
    assert (int(got["sig_count"]) > K) == (k0 > K)
    if k0 <= K:
        assert int(got["sig_count"]) == k0
        ok = sort["cand_valid"]
        np.testing.assert_array_equal(got["cand_valid"], ok)
        for k in TABLE_KEYS:
            np.testing.assert_array_equal(got[k][ok], sort[k][ok], err_msg=k)
    else:
        assert int(got["sig_count"]) == k0     # the exact cutoff
    _, final = _regrown(p, K, pt, monkeypatch)
    assert _rejected(final) == _bh_rejections(p, pt, cells)


@settings(max_examples=60, deadline=None)
@given(groups=hs.lists(hs.tuples(hs.integers(1, 40), hs.integers(1, 30),
                                 hs.sampled_from([-1e-3, 0.0, 1e-3])),
                       min_size=1, max_size=6),
       fill=hs.integers(0, 60), K=hs.integers(1, 70),
       pt=hs.sampled_from([0.05, 0.1, 0.2]))
def test_random_ties_never_miss_overflow(groups, fill, K, pt):
    """Random tie patterns: groups of tied p at (or a hair off) BH line
    points ``pt j / n``, plus untied p above pt. Count mode reports
    overflow whenever sort mode's exact sig_count exceeds K; when it
    reports none it equals sort mode; after the regrow its rejections are
    sort mode's."""
    mp = pytest.MonkeyPatch()
    try:
        n = min(sum(m for m, _, _ in groups) + fill, 136)
        p = []
        for m, j, rel in groups:
            p += [min(pt * j / n * (1 + rel), 1.0)] * m
        p = np.asarray((p + list(np.linspace(pt, 1.0, fill)))[:n])
        sort, cells = _tables(p, 136, pt, "sort", mp)
        want = int(sort["sig_count"])
        first, final = _regrown(p, K, pt, mp)
        if want > K:
            assert int(first["sig_count"]) > K
        if int(first["sig_count"]) <= K:
            assert int(first["sig_count"]) == want
        assert int(final["sig_count"]) == want
        assert _rejected(final) == _rejected(sort)
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# the epilogue over the whole batch
# ---------------------------------------------------------------------------

N_B, D_B = 256, 64
STARTS = [0, -1, 60]         # B = 3, a pad slot in the middle


@pytest.fixture(scope="module")
def bands():
    """Two conditions' normalized bands on the CPU, built as the pipeline
    builds them."""
    from mustache_tpu_torch.bandnorm import bucket_rows, normalize_band_device
    from mustache_tpu_torch.pipeline import fill_raw_band

    n_bins = N_B + 60
    shape = (bucket_rows(n_bins), tdetect.band_width(N_B, D_B))
    out = []
    for seed in (7, 8):
        x, y, v, _ = synthetic_hic(n_bins, D_B, seed=seed, n_loops=10)
        band = torch.from_numpy(fill_raw_band(x, y, v, shape))
        out.append(normalize_band_device(band, n_bins, 5000, D_B)[0])
    return out


def _cfg_b():
    return DetectionConfig(resolution=5000, distance_bp=D_B * 5000,
                           max_candidates=256, min_nz=50, min_tested=500)


def _assert_same(a, b, label):
    assert set(a) == set(b), label
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{label} {k}")


@pytest.mark.parametrize("mode", ["count", "sort"])
def test_batched_epilogue_equals_per_block(mode, bands, monkeypatch):
    monkeypatch.setattr(tdetect, "_BH_MODE", mode)
    det = tdetect.build_detector(_cfg_b(), N_B, device=CPU)
    band = bands[0]
    slices = torch.stack([band[max(s, 0): max(s, 0) + N_B] for s in STARTS])
    cs, nz = tdetect._preamble(tdetect.dense_from_band(slices), D_B)
    state = det.route_state(cs, nz, slices, [int(s >= 0) for s in STARTS])
    batched = det._epilogues(slices, state)
    _assert_same(batched, det.fn_band(band, STARTS), "fn_band")
    st, lpt = tdetect.thresholds(det.cfg)
    assert int(batched["n_tested"][1]) == 0          # the pad slot
    for b in range(len(STARTS)):
        one = tdetect._detect_one(
            tuple(a[b] for a in state), slices[b], det_ceil=det.spec.det_ceil,
            d_px=D_B, K=det.K, st=st, log_pt=lpt)
        _assert_same({k: a[b] for k, a in batched.items()}, one,
                     f"{mode} block {b}")


@pytest.mark.parametrize("mode", ["count", "sort"])
def test_batched_diff_epilogue_equals_per_block(mode, bands, monkeypatch):
    monkeypatch.setattr(tdetect, "_BH_MODE", mode)
    det = tdiff.build_diff_detector(_cfg_b(), N_B, device=CPU)
    base, B = det.base, len(STARTS)
    valid = [int(s >= 0) for s in STARTS]
    slices = torch.stack([bd[max(s, 0): max(s, 0) + N_B]
                          for bd in bands for s in STARTS])
    cs, nz = tdetect._preamble(tdetect.dense_from_band(slices), D_B)
    state = base.route_state(cs, nz, slices, valid * 2, scrub_nan=True)
    geom = tdetect._BandGeom(N_B, D_B, CPU)
    dp = tdiff.diff_p_band(cs[:B], cs[B:], nz[:B], nz[B:],
                           base.taps[tdiff.diff_planes(base.spec)],
                           R=base.spec.radius, Dl=geom.Dl, valid=valid)
    st, lpt = tdetect.thresholds(base.cfg)
    kw = dict(ceil_table=base.ceil_table,
              ceil_max=int(max(base.spec.det_ceil)),
              planes_per_octave=base.spec.planes_per_octave, d_px=D_B,
              K=base.K, st=st, log_pt=lpt)

    def tables(slots, dps):
        support = tdetect._slice_support(geom, slices[slots], D_B)
        best = base.best_state(tuple(a[slots] for a in state), support,
                               scrub_nan=True)
        return tdiff._diff_detect_one(best, support, dps, **kw)

    batched = tables(torch.arange(2 * B), dp)
    _assert_same(batched, det.fn_band(*bands, STARTS), "fn_band")
    assert int(batched["n_tested1"][1]) == 0 == int(batched["n_tested2"][1])
    for b in range(B):
        one = tables(torch.tensor([b, B + b]), dp[b:b + 1])
        _assert_same({k: a[b] for k, a in batched.items()},
                     {k: a[0] for k, a in one.items()}, f"{mode} block {b}")


@pytest.fixture(scope="module")
def one_batch_rows():
    """The differential slice's maps (3 blocks of 2000^2) through both
    entry points in one batch."""
    maps = C.diff_slice_maps()
    cfg = DetectionConfig(**{**C.F32_DIFF_KW, "block_batch": 3})
    return (maps, detect_loops_coo(*maps[:3], cfg, device="cpu"),
            detect_diff_loops_coo(*maps, cfg, device="cpu"))


@pytest.mark.parametrize("block_batch", [1, 2])
def test_pipelined_batches_give_one_batch_rows(block_batch, one_batch_rows):
    maps, single, diff = one_batch_rows
    assert len(single) > 0 and {r[4] for r in diff} == {1, 2, 3, 4}
    cfg = DetectionConfig(**{**C.F32_DIFF_KW, "block_batch": block_batch})
    logs = []
    assert detect_loops_coo(*maps[:3], cfg, device="cpu",
                            log=logs.append) == single
    assert f"batch={block_batch} " in logs[0] and "blocks=3 " in logs[0]
    assert detect_diff_loops_coo(*maps, cfg, device="cpu") == diff
