"""The port's device epilogue and host finish vs the JAX package's, fed
the same band state.

The band state (best response, best plane, per-plane partials) comes from
the port's plain fused-ladder version on a normalized synthetic band; the
JAX side runs ``_detect_one(band_state=..., band_slice=...)``. Both
packages' BH are held in exact "sort" mode, whose neighbour export gives
every tested neighbour its q (count mode gives the non-significant ones
q = 1; tests/test_torch_bh_count.py holds the modes to each other).
Counts and candidate sets must be equal, log q within rtol 2e-4 / atol
1e-4 (the f32 tolerance of tests/test_pallas.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mustache_tpu.detect as jdetect
from mustache_tpu.scalespace import build_ladder
from mustache_tpu_torch import detect as tdetect
from mustache_tpu_torch.bandnorm import bucket_rows, normalize_band_device
from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.kernels.fused_ladder import fused_ladder_nms_batched
from mustache_tpu_torch.pipeline import fill_raw_band
from mustache_tpu_torch.scalespace import ladder_tensor
from oracle import bh_fdr
from synthetic import synthetic_hic
import torch_port_cases  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")


def _state(n, d_px, seed, start):
    """(band slice [n, Dl], dense block [n, n], band state) on the CPU."""
    n_bins = n + start
    x, y, v, _ = synthetic_hic(n_bins, d_px, seed=seed, n_loops=10)
    Dl = tdetect.band_width(n, d_px)
    band = torch.from_numpy(fill_raw_band(x, y, v, (bucket_rows(n_bins), Dl)))
    band, _ = normalize_band_device(band, n_bins, 5000, d_px)
    sl = band[start:start + n]
    dense = tdetect.dense_from_band(sl)
    cs, nz = tdetect._preamble(dense[None], d_px)
    spec = build_ladder((1.6, 3.2))
    state = fused_ladder_nms_batched(
        cs, nz.to(torch.float32), ladder_tensor(spec.kernels, CPU),
        R=spec.radius, n_octaves=2, planes_per_octave=9, DB=Dl)
    return sl, dense, tuple(a[0] for a in state), spec


def _run_both(n, d_px, seed, start, monkeypatch, K=256):
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          max_candidates=K, min_nz=50, min_tested=500)
    sl, dense, state, spec = _state(n, d_px, seed, start)
    st, lp = np.float32(cfg.st), np.float32(np.log(cfg.pt))
    monkeypatch.setattr(jdetect, "_BH_MODE", "sort")
    monkeypatch.setattr(tdetect, "_BH_MODE", "sort")
    want = jdetect._detect_one(
        jnp.asarray(dense.numpy()), st, lp,
        kernels=spec.kernels.astype(np.float32), det_ceil=spec.det_ceil,
        planes_per_octave=9, n_octaves=2, d_px=d_px, intra=True, K=K,
        band_state=tuple(jnp.asarray(a.numpy()) for a in state),
        band_slice=jnp.asarray(sl.numpy()))
    want = {k: np.asarray(a) for k, a in want.items()}
    got = tdetect._detect_one(state, sl, det_ceil=spec.det_ceil, d_px=d_px,
                              K=K, st=float(st), log_pt=float(lp))
    return cfg, spec, want, {k: a.numpy() for k, a in got.items()}


def _cands(out, flag="cand_valid"):
    return {(int(x), int(y), int(s)) for x, y, s, ok in zip(
        out["cand_x"], out["cand_y"], out["cand_sigidx"], out[flag]) if ok}


@pytest.mark.parametrize("n,d_px,seed,start", [(256, 64, 7, 0),
                                               (200, 40, 11, 60)])
def test_epilogue_matches_jax_sort_mode(n, d_px, seed, start, monkeypatch):
    _, _, want, got = _run_both(n, d_px, seed, start, monkeypatch)
    for k in ("nz_count", "n_tested", "sig_count"):
        assert int(got[k]) == int(want[k]), k
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert _cands(got) == _cands(want) and len(_cands(want)) > 0
    assert _cands(got, "cand_pass") == _cands(want, "cand_pass")
    ok = want["cand_valid"]
    np.testing.assert_allclose(got["cand_logq"][ok], want["cand_logq"][ok],
                               rtol=2e-4, atol=1e-4)
    for k in ("cand_x", "cand_y", "cand_sigidx", "pass_sparse",
              "pass_enrich", "neigh_sigidx"):
        np.testing.assert_array_equal(got[k][ok], want[k][ok], err_msg=k)
    np.testing.assert_allclose(got["neigh_logq"][ok], want["neigh_logq"][ok],
                               rtol=2e-4, atol=1e-4)


def test_packed_finish_block_rows_match_jax(monkeypatch):
    cfg, spec, want, got = _run_both(256, 64, 7, 0, monkeypatch)
    K = got["cand_x"].shape[0]
    spec_out = tdetect._out_spec(tdetect.out_shapes(K))
    packed = tdetect._pack_batched(
        {k: torch.from_numpy(np.asarray(a))[None] for k, a in got.items()})
    assert packed.dtype == torch.float32 and packed.shape[0] == 1
    back = tdetect.unpack_block(spec_out, packed[0].numpy())
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
        assert back[k].dtype == got[k].dtype, k
    jcfg = jdetect.DetectionConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jspec = build_ladder(cfg.octave_values)
    for start in (0, 1000):
        rows_t = tdetect.finish_block(back, block_index=0, start=start,
                                      cfg=cfg, spec=spec)
        rows_j = jdetect.finish_block(back, block_index=0, start=start,
                                      cfg=jcfg, spec=jspec)
        assert rows_t == rows_j and len(rows_t) > 0
    rows_w = jdetect.finish_block(want, block_index=0, start=0, cfg=jcfg,
                                  spec=jspec)
    rows_t = tdetect.finish_block(back, block_index=0, start=0, cfg=cfg,
                                  spec=spec)
    assert [r[:2] + r[3:] for r in rows_t] == [r[:2] + r[3:] for r in rows_w]
    np.testing.assert_allclose([r[2] for r in rows_t],
                               [r[2] for r in rows_w], rtol=2e-4)


@pytest.mark.parametrize("entry", ["detect", "diff", "inter"])
def test_one_emission_gives_every_finish_its_rows(entry, monkeypatch):
    """One candidate table through the single-map, differential and inter
    finishes: each gives the JAX package's rows, and its loop rows are
    those of the shared emission (``detect.emit_components``). The diff
    reads the table as both conditions' with seeded pair, v1 and v2
    neighbourhoods; the inter tile starts its columns elsewhere."""
    import mustache_tpu.diff as jdiff
    import mustache_tpu.inter as jinter
    from mustache_tpu_torch import diff as tdiff, inter as tinter

    cfg, spec, _, got = _run_both(256, 64, 7, 0, monkeypatch)
    cfg = cfg.with_(pt2=0.1)
    jcfg = jdetect.DetectionConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jspec = build_ladder(cfg.octave_values)
    start1, start2 = 1000, (3000 if entry == "inter" else 1000)
    passing = got["cand_pass"]
    emitted = tdetect.emit_components(
        *(got[k][passing] for k in
          ("cand_x", "cand_y", "neigh_logq", "neigh_sigidx")),
        start1=start1, start2=start2, det_sigmas=spec.det_sigmas)
    rows = [r for r, _ in emitted]
    assert len(rows) > 0
    if entry == "detect":
        got_rows = tdetect.finish_block(got, block_index=0, start=start1,
                                        cfg=cfg, spec=spec)
        assert got_rows == jdetect.finish_block(
            got, block_index=0, start=start1, cfg=jcfg, spec=jspec)
        assert got_rows == rows
    elif entry == "inter":
        got_rows = tinter.finish_inter_block(got, start1=start1,
                                             start2=start2, cfg=cfg,
                                             spec=spec)
        assert got_rows == jinter.finish_inter_block(
            got, start1=start1, start2=start2, cfg=jcfg, spec=jspec)
        assert got_rows == rows
    else:
        rng = np.random.default_rng(3)
        shape = got["neigh_logq"].shape
        extras = {"neigh_pair": rng.uniform(0.0, 0.3, shape),
                  "neigh_v1": rng.random(shape), "neigh_v2": rng.random(shape)}
        out = {"nz1_count": got["nz_count"], "nz2_count": got["nz_count"]}
        for m in "12":
            out.update({k + m: a for k, a in got.items()})
            out.update({k + m: a.astype(np.float32)
                        for k, a in extras.items()})
        groups = tdiff.finish_diff_block(out, start=start1, cfg=cfg,
                                         spec=spec)
        assert groups == jdiff.finish_diff_block(out, start=start1, cfg=jcfg,
                                                 spec=jspec)
        assert groups[0] == groups[2] == rows
        assert 0 < len(groups[1]) < len(rows)


@pytest.mark.parametrize("case", ["ties", "random"])
def test_bh_logq_matches_statsmodels_formula(case):
    """Exact BH on tied p (the case the JAX package's count-mode overflow
    test gets wrong, ROADMAP Queue 3 item 2: 50 tied p=0.02 of 100 at
    pt=0.05 all reject)."""
    rng = np.random.default_rng(5)
    if case == "ties":
        p = np.concatenate([np.full(50, 0.02), rng.uniform(0.5, 1.0, 50)])
    else:
        p = rng.uniform(0, 1, 1000) ** 3
    lp = torch.from_numpy(np.log(p).astype(np.float32))
    sp, order = torch.sort(lp, stable=True)
    q = tdetect._logq_from_sorted(sp, torch.tensor(len(p), dtype=torch.int32))
    want = bh_fdr(p)[order.numpy()]
    np.testing.assert_allclose(np.exp(q.numpy().astype(np.float64)), want,
                               rtol=2e-5)
    if case == "ties":
        assert int((q < np.float32(np.log(0.05))).sum()) == 50
