"""The port's inter-chromosomal detection (``mustache_tpu_torch.inter``) on
the CPU against the JAX package's (``mustache_tpu.inter``) on the same
inputs from ``tests/synthetic.py::synthetic_inter``.

Tolerances. float64: rows and raw outputs equal, q (log q for the raw
tables) within rtol 1e-9. float32: anchors, scales, flags and row order
exact; rows' q within rtol 2e-4, raw log q within the JAX package's own
f32 parity rule (rtol 2e-4, atol 1e-4, ``tests/test_pallas.py:71-72``).
Inter q values are tiny (log q -40 to -60), so rtol 2e-4 in q is 2e-4 in
log q: about the distance of either f32 path from float64 (the DoG
planes' rounding times |log p|; up to ~5e-4 on other maps of this size,
PERF.md). The f32 judge below holds both f32 paths within 1e-3 of
float64 in log q.

The tile's raw outputs are held to a live JAX call; the whole grid's
rows to the JAX package's rows on the same map at float32 and float64,
the committed golden ``tests/data/torch_port_cpu_f32_golden.json``
(``tools/make_torch_golden.py --slice cpu_f32``)."""

import math

import numpy as np
import pytest
import torch

from mustache_tpu.config import DetectionConfig as JConfig
from mustache_tpu.inter import (
    _dedup_boundary_loops as jax_dedup, build_inter_detector as jax_build,
    detect_inter_loops_coo as jax_detect, normalize_inter as jax_normalize,
)
from mustache_tpu_torch import inter
from mustache_tpu_torch.config import DetectionConfig
import torch_port_cases as C
from synthetic import synthetic_inter

CPU = torch.device("cpu")
KW = C.F32_INTER_KW
F32_LOGQ = dict(rtol=2e-4, atol=1e-4)
F64_LOGQ = dict(rtol=1e-9, atol=0)


def _cfgs(**kw):
    return JConfig(**KW, **kw), DetectionConfig(**KW, **kw)


def _assert_rows(got, want, rtol):
    """Rows equal in order: anchors and scale exact, q within rtol."""
    assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=rtol)


def test_normalize_inter_semantics():
    v = np.array([1.0, 2.0, 3.0, np.nan, np.inf], np.float64)
    out = inter.normalize_inter(v)
    assert out is v
    ref = np.array([1.0, 2.0, 3.0, 0.0, 0.0])
    np.testing.assert_allclose(out, (ref - ref.mean()) / ref.std(),
                               rtol=1e-12)
    v2 = np.full(5, 7.0)
    assert not np.isnan(inter.normalize_inter(v2)).any()
    assert (v2 == 0).all()
    rng = np.random.default_rng(3)
    w = rng.gamma(2.0, 3.0, 1000)
    w[[5, 9, 77]] = [np.nan, -np.inf, np.inf]
    assert np.array_equal(inter.normalize_inter(w.copy()),
                          jax_normalize(w.copy()))


@pytest.fixture(scope="module")
def grid_map():
    (n1, n2), kw = C.F32_INTER_MAP
    x, y, v, anchors = synthetic_inter(n1, n2, **kw)
    return x, y, v, anchors


@pytest.fixture(scope="module")
def golden():
    """The JAX package's grid rows at float32 and float64."""
    gold = C.load_golden(C.GOLDEN_F32)
    return {p: gold[f"inter_grid_{p}"]
            for p in ("float32", "float64")}


def _tile(grid_map, dtype):
    """The grid's first 512^2 tile, normalized over the whole map."""
    x, y, v, _ = grid_map
    v = inter.normalize_inter(v.copy())
    c = np.zeros((512, 512), np.float64)
    sel = (x < 512) & (y < 512)
    c[x[sel], y[sel]] = v[sel]
    return c.astype(np.float32).astype(dtype)


@pytest.fixture(scope="module", params=["float32", "float64"])
def tile_outputs(request, grid_map):
    """One tile's raw outputs from both packages (one JAX call)."""
    prec = request.param
    dtype = np.float64 if prec == "float64" else np.float32
    c = _tile(grid_map, dtype)
    jcfg, tcfg = _cfgs(precision=prec)
    ref = {k: np.asarray(a)
           for k, a in jax_build(jcfg, 512).fn_single(c).items()}
    det = inter.build_inter_detector(tcfg, 512, device=CPU)
    got = {k: a[0].numpy() for k, a in det.fn(torch.from_numpy(c)[None])
           .items()}
    return prec, got, ref


def test_tile_raw_outputs_match_jax(tile_outputs):
    prec, got, ref = tile_outputs
    tol = F64_LOGQ if prec == "float64" else F32_LOGQ
    for k in ("nz_count", "n_tested", "sig_count"):
        assert int(got[k]) == int(ref[k]), k
    assert set(got) == set(ref)
    assert all(got[k].shape == ref[k].shape for k in ref)

    def table(out):
        sig = out["cand_logq"] < math.log(0.1)
        return {(int(x), int(y)): i for i, (x, y) in enumerate(
            zip(out["cand_x"][sig], out["cand_y"][sig]))}, np.nonzero(sig)[0]

    (gpos, gi), (rpos, ri) = table(got), table(ref)
    assert set(gpos) == set(rpos) and len(rpos) > 0
    for xy, j in rpos.items():
        a, b = gi[gpos[xy]], ri[j]
        assert got["cand_sigidx"][a] == ref["cand_sigidx"][b]
        assert got["cand_pass"][a] == ref["cand_pass"][b]
        np.testing.assert_array_equal(got["neigh_sigidx"][a],
                                      ref["neigh_sigidx"][b])
        np.testing.assert_allclose(got["cand_logq"][a], ref["cand_logq"][b],
                                   **tol)
        np.testing.assert_allclose(got["neigh_logq"][a],
                                   ref["neigh_logq"][b], **tol)
    if prec == "float64":
        # no f32 tie can reorder the table: the whole table is equal
        for k in ("cand_x", "cand_y", "cand_sigidx", "cand_pass",
                  "neigh_sigidx"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_allclose(got["cand_logq"], ref["cand_logq"],
                                   **F64_LOGQ)


@pytest.fixture(scope="module")
def grid_rows(grid_map, golden):
    """The 2x2 grid (900 x 800, chunk 512): JAX f32 rows (the golden), the
    port's f32 and f64 rows."""
    x, y, v, _ = grid_map
    _, tcfg = _cfgs()
    want = golden["float32"]
    got = inter.detect_inter_loops_coo(x, y, v.copy(), tcfg, chunk=512,
                                       device="cpu")
    got64 = inter.detect_inter_loops_coo(
        x, y, v.copy(), tcfg.with_(precision="float64"), chunk=512,
        device="cpu")
    return want, got, got64


def test_grid_rows_match_jax(grid_rows, grid_map):
    want, got, _ = grid_rows
    assert len(want) >= 8
    _assert_rows(got, want, 2e-4)
    anchors = grid_map[3]
    assert sum(any(abs(r[0] - a) <= 2 and abs(r[1] - b) <= 2
                   for a, b in anchors) for r in got) >= 8


def test_f32_within_bound_of_f64(grid_rows):
    """Both f32 paths sit within 1e-3 of the float64 one in log q."""
    want, got, got64 = grid_rows
    for rows in (want, got):
        assert [r[:2] + r[3:] for r in rows] == \
            [r[:2] + r[3:] for r in got64]
        np.testing.assert_allclose([math.log(r[2]) for r in rows],
                                   [math.log(r[2]) for r in got64],
                                   rtol=0, atol=1e-3)


def test_f64_rows_match_jax_f64(grid_rows, golden):
    _assert_rows(grid_rows[2], golden["float64"], 1e-9)


def test_regrow_small_capacity(grid_map, grid_rows, monkeypatch):
    """max_candidates below a tile's significant count: that tile alone is
    rerun at the next power of two, and the rows are the JAX rows."""
    x, y, v, _ = grid_map
    built = []
    real = inter.build_inter_detector

    def spy(cfg, n, *, device, max_candidates=None):
        built.append(max_candidates)
        return real(cfg, n, device=device, max_candidates=max_candidates)

    monkeypatch.setattr(inter, "build_inter_detector", spy)
    _, tcfg = _cfgs(max_candidates=4)
    got = inter.detect_inter_loops_coo(x, y, v.copy(), tcfg, chunk=512,
                                       device="cpu")
    grown = [k for k in built if k is not None]
    assert grown and all(k > 4 and k & (k - 1) == 0 for k in grown)
    _assert_rows(got, grid_rows[0], 2e-4)


def test_batch_size_does_not_change_rows(grid_map, grid_rows):
    x, y, v, _ = grid_map
    _, tcfg = _cfgs(block_batch=3)
    got = inter.detect_inter_loops_coo(x, y, v.copy(), tcfg, chunk=512,
                                       device="cpu")
    assert got == grid_rows[1]


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_blur_octave_matches_jax_and_row_slabs(monkeypatch, dtype, rtol):
    """The dense rectangle blur (symmetric pad, Toeplitz passes) equals the
    JAX ``_blur_ladder`` on a rectangle, and its row-slab form (tiles
    above ``ROWS_ONE_SHOT`` rows) equals the one-shot form."""
    import jax.numpy as jnp

    from mustache_tpu.detect import _blur_ladder
    from mustache_tpu_torch.kernels.fused_ladder import _symmetric_pad
    from mustache_tpu_torch.scalespace import build_ladder

    spec = build_ladder((1.6, 3.2))
    rng = np.random.default_rng(8)
    c = rng.standard_normal((2, 230, 190))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    taps = torch.as_tensor(spec.kernels[12:], dtype=dtype)
    cpad = _symmetric_pad(torch.as_tensor(c, dtype=dtype), spec.radius)
    one = inter.blur_octave(cpad, taps, 230, 190)
    want = np.stack([np.asarray(_blur_ladder(jnp.asarray(c[b].astype(np_dt)),
                                             jnp.asarray(spec.kernels[12:]
                                                         .astype(np_dt))))
                     for b in range(2)])
    np.testing.assert_allclose(one.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    monkeypatch.setattr(inter, "ROWS_ONE_SHOT", 100)
    monkeypatch.setattr(inter, "SLAB", 48)
    slabs = inter.blur_octave(cpad, taps, 230, 190)
    np.testing.assert_allclose(slabs.numpy(), one.numpy(), rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_dedup_boundary_loops_matches_jax():
    loops = [[10, 10, 0.01, 2.0], [11, 12, 0.005, 2.0], [40, 40, 0.02, 1.5],
             [43, 43, 0.02, 1.5], [47, 40, 0.001, 3.0], [10, 14, 0.001, 2.0],
             [100, 5, 0.05, 2.0], [100, 5, 0.04, 2.0], [90, 90, 0.1, 1.0]]
    want = jax_dedup([list(r) for r in loops])
    got = inter._dedup_boundary_loops([list(r) for r in loops])
    assert got == want
    assert len(got) < len(loops)


def test_rectangle_orientation():
    """x stays on the first chromosome's (rows) axis; a tile wider than
    the map is zero-padded."""
    x, y, v, _ = synthetic_inter(600, 300, seed=11, n_loops=6)
    jcfg, tcfg = _cfgs()
    want = jax_detect(x, y, v.copy(), jcfg, chunk=1024)
    got = inter.detect_inter_loops_coo(x, y, v.copy(), tcfg, chunk=1024,
                                       device="cpu")
    _assert_rows(got, want, 2e-4)
    assert any(r[0] >= 300 for r in got)


def test_given_sizes_drop_outside_contacts(grid_map):
    """``n1``/``n2`` smaller than the map: contacts beyond them count in
    the z-score but in no tile, as in the JAX package."""
    x, y, v, _ = grid_map
    jcfg, tcfg = _cfgs()
    want = jax_detect(x, y, v.copy(), jcfg, n1=850, n2=700, chunk=512)
    got = inter.detect_inter_loops_coo(x, y, v.copy(), tcfg, n1=850,
                                       n2=700, chunk=512, device="cpu")
    assert all(r[0] < 850 and r[1] < 700 for r in want)
    _assert_rows(got, want, 2e-4)


def test_empty_tiny_and_device(monkeypatch):
    _, cfg = _cfgs()
    assert inter.detect_inter_loops_coo([], [], np.array([]), cfg,
                                        device="cpu") == []
    x = np.arange(10)
    assert inter.detect_inter_loops_coo(x, x, np.ones(10), cfg, chunk=512,
                                        device="cpu") == []
    # the card by default: without CUDA it raises, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        inter.detect_inter_loops_coo(x, x, np.ones(10), cfg)


def test_duplicate_pixels_keep_the_last_value():
    """Duplicate (x, y) triplets resolve to the last value in input order,
    as the JAX host densify's fancy assignment does."""
    x, y, v, _ = synthetic_inter(300, 200, seed=5, n_loops=3)
    src = inter._TileSource(np.r_[x, x[:50]], np.r_[y, y[:50]],
                            np.r_[v, v[:50] + 100.0], 300, 200, np.float64,
                            CPU)
    tile = src.tiles([(0, 300, 0, 200)], 512)[0].numpy()
    want = np.zeros((512, 512))
    want[x, y] = v
    want[x[:50], y[:50]] = v[:50] + 100.0
    assert np.array_equal(tile, want)
