"""The port's differential detection (``mustache_tpu_torch.diff``) against
the JAX package's (``mustache_tpu.diff``) on the same numpy inputs, on the
CPU. Both packages run their BH in exact "sort" mode here, whose
neighbour export gives every tested neighbour its q (the modes are held
to each other in tests/test_torch_bh_count.py).

* ``_band_candidates`` with extras: equal tables on the same band state;
* the difference planes and their folded-normal p: the port's two f32
  conv passes against the JAX ``_blur_matmul`` + ``norm.cdf``, rtol 2e-3 /
  atol 1e-5 (the JAX package's own ``neigh_pair`` tolerance,
  tests/test_pallas.py:224-225);
* one stacked batch (B=2 with a pad slot, so kernel slots 1 and 3 are
  pads) through ``DiffBlockDetector.fn_band`` against the JAX fused-kernel
  ``fn_band`` in interpret mode, to the tolerances of
  tests/test_pallas.py:196-230;
* the whole chromosome: ``detect_diff_loops_coo`` rows with bins, scales
  and tags exact and q within rtol 2e-4 of the JAX package's rows on the
  same slice, the committed golden ``tests/data/
  torch_port_cpu_f32_golden.json`` (``tools/make_torch_golden.py --slice
  cpu_f32``).
"""

import jax
import jax.numpy as jnp
import jax.scipy.stats
import numpy as np
import pytest
import torch

import mustache_tpu.detect as jdetect
from mustache_tpu.diff import _build_diff_detector_cached
from mustache_tpu.config import clamp_distance_filter as jax_clamp
from mustache_tpu_torch import DetectionConfig, detect_diff_loops_coo, find_diff_loops
from mustache_tpu_torch import detect as tdetect
from mustache_tpu_torch import diff as tdiff
from mustache_tpu_torch.bandnorm import bucket_rows, normalize_band_device
from mustache_tpu_torch.pipeline import fill_raw_band
from mustache_tpu_torch.scalespace import build_ladder, ladder_tensor
from mustache_tpu_torch.sharding import make_mesh, make_runner
import torch_port_cases as C
from synthetic import synthetic_hic

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _sort_mode_bh(monkeypatch):
    monkeypatch.setattr(jdetect, "_BH_MODE", "sort")
    monkeypatch.setattr(tdetect, "_BH_MODE", "sort")


def _bands(n_bins, d_px, n, seeds):
    """Both conditions' normalized bands [rows, Dl] on the CPU, built as
    the pipeline builds them (raw fill, device normalize)."""
    shape = (bucket_rows(max(n_bins, n)), tdetect.band_width(n, d_px))
    out = []
    for seed in seeds:
        x, y, v, _ = synthetic_hic(n_bins, d_px, seed=seed, n_loops=10)
        band = torch.from_numpy(fill_raw_band(x, y, v, shape))
        out.append(normalize_band_device(band, n_bins, 5000, d_px)[0])
    return out


def test_band_candidates_extras_match_jax():
    """Same band state, same extras: the port's table equals the JAX
    package's key for key (the extras are gathers, so exactly)."""
    rng = np.random.default_rng(3)
    N, d_px, K = 256, 64, 96
    Dl = tdetect.band_width(N, d_px)
    d = np.arange(Dl)[None, :]
    valid = (np.arange(N)[:, None] + d) < N
    nz = valid & (d >= 4) & (rng.random((N, Dl)) < 0.8)
    logp = np.where(rng.random((N, Dl)) < 0.1,
                    -3.0 - 5.0 * rng.exponential(size=(N, Dl)), np.inf)
    # a candidate on the band's last column: its neighbour at d = Dl lies
    # in the matrix beyond the band (the inside fill)
    nz[10, Dl - 1], logp[10, Dl - 1] = True, -100.0
    arrs = dict(
        band_logp=logp.astype(np.float32),
        band_sigidx=rng.integers(-1, 18, (N, Dl)).astype(np.int32),
        band_nz=nz,
        band_c=np.where(valid, rng.normal(size=(N, Dl)), 0).astype(np.float32))
    extras = [("pair", rng.random((N, Dl)).astype(np.float32), 1.0, np.inf),
              ("v1", rng.normal(size=(N, Dl)).astype(np.float32), 1.0, 1.0),
              ("v2", rng.normal(size=(N, Dl)).astype(np.float32), 1.0, 1.0)]
    det_ceil = build_ladder((1.6, 3.2)).det_ceil
    st, lp = np.float32(0.8), np.float32(np.log(0.1))

    want = jax.jit(lambda arrs, ex: jdetect._band_candidates(
        jdetect._BandGeom(jnp.zeros((N, N), jnp.float32), d_px), **arrs,
        ceil_table=jnp.asarray(det_ceil, jnp.int32), ceil_max=max(det_ceil),
        st=st, log_pt=lp, K=K,
        extras=tuple((nm, a, i, o) for (nm, _, i, o), a in zip(extras, ex))))(
        arrs, [a for _, a, _, _ in extras])
    got = tdetect._band_candidates(
        tdetect._BandGeom(N, d_px, CPU),
        **{k: torch.from_numpy(a)[None] for k, a in arrs.items()},
        ceil_table=torch.as_tensor(det_ceil), ceil_max=max(det_ceil),
        st=float(st), log_pt=float(lp), K=K,
        extras=tuple((nm, torch.from_numpy(a)[None], i, o)
                     for nm, a, i, o in extras))
    got = {k: a[0] for k, a in got.items()}
    assert set(got) == set(want) >= {"neigh_pair", "neigh_v1", "neigh_v2"}
    assert int(want["sig_count"]) > 0
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=2e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    # the fills: outside the matrix, inside it beyond the band
    npair = got["neigh_pair"].numpy()
    assert np.isinf(npair).any() and npair[0, 1, 2] == 1.0


def test_extras_default_keeps_the_single_map_table():
    """No extras: the table has exactly the single-map keys and layout."""
    sl_state = _bands(300, 64, 256, (5,))[0][:256]
    geom = tdetect._BandGeom(256, 64, CPU)
    Dl = geom.Dl
    bs = torch.where(geom.band_validl, sl_state[:, :Dl], 0.0)
    nz = geom.band_validl & (bs != 0) & (geom.band_dl >= 4)
    out = tdetect._band_candidates(
        geom, band_logp=torch.where(nz, -bs.abs() * 10, float("inf"))[None],
        band_sigidx=torch.zeros_like(nz, dtype=torch.int32)[None],
        band_nz=nz[None], band_c=bs[None],
        ceil_table=torch.as_tensor([2] * 18), ceil_max=2,
        st=0.8, log_pt=float(np.log(0.1)), K=64)
    shapes = tdetect.out_shapes(64)
    assert set(out) == set(shapes) - {"nz_count"}


def _jax_diff_p(cs1, cs2, nz1, nz2, kernels_sel, Dl):
    """The JAX package's difference planes and p, as
    ``mustache_tpu/diff.py:384-412`` computes them."""
    N = cs1.shape[-1]
    il = np.arange(N)[:, None]
    dl = np.arange(Dl)[None, :]
    validl = il + dl < N

    def band_of(x, fill):
        lead = x.shape[:-2]
        flat = x.reshape(lead + (N * N,))
        ext = jnp.concatenate([flat, flat[..., :N]], axis=-1)
        bnd = ext[..., : N * (N + 1)].reshape(lead + (N, N + 1))[..., :Dl]
        return jnp.where(validl, bnd, fill)

    nzd = nz1 & nz2
    cds = jnp.where(nzd, cs1 - cs2, 0.0)
    gdb = band_of(jdetect._blur_matmul(cds, kernels_sel), 0.0)
    nzdb = band_of(nzd, False)
    inv = 1.0 / jnp.maximum(jnp.sum(nzd, axis=(1, 2), dtype=jnp.int32),
                            1).astype(jnp.float32)
    dps = []
    for o in range(kernels_sel.shape[0] // 2):
        L = gdb[:, 2 * o] - gdb[:, 2 * o + 1]
        mu = (jnp.sum(L * nzdb, axis=(1, 2)) * inv)[:, None, None]
        var = jnp.sum(jnp.where(nzdb, (L - mu) ** 2, 0.0), axis=(1, 2)) * inv
        phi = jax.scipy.stats.norm.cdf(L, loc=mu,
                                       scale=jnp.sqrt(var)[:, None, None])
        phi = jnp.where(jnp.isnan(phi), 1.0, phi)
        dps.append(jnp.where(phi > 0.5, 1.0 - phi, phi) * 2.0)
    return np.asarray(jnp.stack(dps, axis=1))


@pytest.mark.parametrize("n,d_px,octaves", [
    (256, 64, (1.6, 3.2)), (200, 40, (1.6, 3.2, 6.4)),
    (256, 64, (1.6, 3.2, 6.4, 12.8, 25.6))])     # -oc 5: R=110
def test_diff_planes_match_jax(n, d_px, octaves):
    bands = _bands(n + 40, d_px, n, (11, 12))
    slices = torch.stack([b[20:20 + n] for b in bands])
    cs, nz = tdetect._preamble(tdetect.dense_from_band(slices), d_px)
    spec = build_ladder(octaves)
    sel = tdiff.diff_planes(spec)
    assert sel == [k for o in range(len(octaves))
                   for k in (12 * o + 1, 12 * o + 2)]
    Dl = tdetect.band_width(n, d_px)
    got = tdiff.diff_p_band(cs[:1], cs[1:], nz[:1], nz[1:],
                            ladder_tensor(spec.kernels, CPU)[sel],
                            R=spec.radius, Dl=Dl, valid=[1]).numpy()
    want = _jax_diff_p(cs[:1].numpy(), cs[1:].numpy(), nz[:1].numpy(),
                       nz[1:].numpy(), spec.kernels[sel].astype(np.float32),
                       Dl)
    assert got.shape == want.shape == (1, len(octaves), n, Dl)
    assert ((want > 0) & (want < 0.05)).any()      # real differences
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)
    # a pad slot stays empty
    pad = tdiff.diff_p_band(cs[:1], cs[1:], nz[:1], nz[1:],
                            ladder_tensor(spec.kernels, CPU)[sel],
                            R=spec.radius, Dl=Dl, valid=[0])
    assert not pad.any()


def test_band_of_is_the_shear():
    x = torch.arange(36, dtype=torch.float32).reshape(1, 6, 6)
    b = tdiff.band_of(x, 4, -1.0)[0]
    for i in range(6):
        for d in range(4):
            assert b[i, d] == (x[0, i, i + d] if i + d < 6 else -1.0)


def _cand_map(out, tag, b):
    keys = ("cand_logq", "neigh_pair", "neigh_v1", "neigh_v2", "cand_pass")
    return {(int(x), int(y), int(s)): tuple(np.asarray(out[k + tag][b][i])
                                            for k in keys)
            for i, (x, y, s, ok) in enumerate(zip(
                out["cand_x" + tag][b], out["cand_y" + tag][b],
                out["cand_sigidx" + tag][b], out["cand_valid" + tag][b]))
            if ok}


def test_stacked_batch_matches_jax_fused():
    """B=2 with slot 1 a pad: the stacked kernel batch has pads at slots 1
    and 3. The real block's two tables agree with the JAX fused-kernel
    path (interpret mode); the pad block's tables are empty on both."""
    n, d_px = 256, 64
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          max_candidates=256)
    band1, band2 = _bands(320, d_px, n, (95, 96))
    starts = [40, -1]
    det = tdiff.build_diff_detector(cfg, n, device=CPU)
    got = {k: a.numpy() for k, a in det.fn_band(band1, band2, starts).items()}
    parts = _build_diff_detector_cached(
        cfg.octave_values, cfg.precision, cfg.distance_px, n,
        cfg.max_candidates, True, True)
    want = parts[3](band1.numpy(), band2.numpy(),
                    np.asarray(starts, np.int32), np.float32(cfg.st),
                    np.float32(np.log(cfg.pt)))
    want = {k: np.asarray(a) for k, a in want.items()}
    assert set(got) == set(want) == set(tdiff.out_shapes(256))
    for k, (shape, dtype) in tdiff.out_shapes(256).items():
        assert got[k].shape == (2,) + shape, k

    for tag in ("1", "2"):
        for k in ("nz{}_count", "n_tested{}", "sig_count{}"):
            key = k.format(tag)
            assert int(got[key][0]) == int(want[key][0]), key
        g, w = _cand_map(got, tag, 0), _cand_map(want, tag, 0)
        assert set(g) == set(w) and len(w) > 0, f"map {tag}"
        for key, (lq, pair, v1, v2, ok) in w.items():
            glq, gpair, gv1, gv2, gok = g[key]
            np.testing.assert_allclose(glq, lq, rtol=2e-4, atol=1e-4)
            np.testing.assert_allclose(gpair, pair, rtol=2e-3, atol=1e-5)
            np.testing.assert_allclose(gv1, v1, rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(gv2, v2, rtol=2e-4, atol=1e-5)
            assert gok == ok
        # the pad slot (kernel slots 1 and 3): nothing detected
        assert int(got["n_tested" + tag][1]) == 0 == int(want["n_tested" + tag][1])
        assert int(got["sig_count" + tag][1]) == 0
        assert not got["cand_valid" + tag][1].any()

    # the packed buffer round-trips through the diff layout
    packed = det.fn_band_packed(band1, band2, starts).numpy()
    back = tdetect.unpack_block(det.out_spec, packed[0])
    for k in got:
        np.testing.assert_array_equal(back[k], got[k][0], err_msg=k)
        assert back[k].dtype == np.dtype(tdiff.out_shapes(256)[k][1]), k


@pytest.fixture(scope="module")
def slice_rows():
    """The slice through the port: two conditions of 4000 bins, 3 blocks,
    batches of 2 (one full batch, one of a single block); the JAX
    package's rows on it from the golden."""
    maps = C.diff_slice_maps()
    inputs = tuple(a.copy() for a in maps)
    logs = []
    got = detect_diff_loops_coo(*maps, DetectionConfig(**C.F32_DIFF_KW),
                                device="cpu", log=logs.append)
    for a, b in zip(maps, inputs):
        assert np.array_equal(a, b)               # inputs untouched
    want = [tuple(r) for r in C.load_golden(C.GOLDEN_F32)["diff_slice"]]
    return got, want, logs


def _assert_same_rows(got, want):
    assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=2e-4)


def test_detect_diff_loops_coo_matches_jax(slice_rows):
    got, want, logs = slice_rows
    assert "blocks=3 " in logs[0] and "batch=2 " in logs[0]
    assert "device=cpu" in logs[0]
    assert {r[4] for r in want} == {1, 2, 3, 4}
    _assert_same_rows(got, want)


def test_diff_rows_are_loops_of_their_condition(slice_rows):
    """Each differential row (tag 2, 4) is also a loop of its condition
    (tag 1, 3), with the same q and scale."""
    got, _, _ = slice_rows
    for diff_tag, loop_tag in ((2, 1), (4, 3)):
        loops = {r[:4] for r in got if r[4] == loop_tag}
        assert {r[:4] for r in got if r[4] == diff_tag} <= loops


def test_find_diff_loops_copies_and_configures(monkeypatch):
    """find_diff_loops hands detect_diff_loops_coo copies of its inputs
    (a callee that writes into them leaves the caller's arrays as they
    were) and the differential distance clamp; its rows come back."""
    x1, y1, v1, _ = synthetic_hic(300, 40, seed=31, n_loops=2)
    x2, y2, v2, _ = synthetic_hic(300, 40, seed=32, n_loops=2)
    inputs = [a.copy() for a in (x1, y1, v1, x2, y2, v2)]
    seen = {}

    def fake(*arrays, cfg, normalize, device=None):
        for a in arrays:
            a[:] = 0
        seen.update(cfg=cfg, normalize=normalize, device=device)
        return [(1, 2, 0.01, 1.6, 1)]

    monkeypatch.setattr(tdiff, "detect_diff_loops_coo",
                        lambda *a, **k: fake(*a[:6], cfg=a[6], **k))
    got = find_diff_loops(x1, y1, v1, x2, y2, v2, pt=0.1, pt2=0.05, st=0.8,
                          distance_bp=9_000_000, device="cpu")
    assert got == [(1, 2, 0.01, 1.6, 1)]
    for a, b in zip((x1, y1, v1, x2, y2, v2), inputs):
        assert np.array_equal(a, b)
    cfg = seen["cfg"]
    # the diff clamp caps at 2 Mb (the single-map one at 10 Mb)
    assert cfg.distance_bp == 2_000_000
    assert cfg.distance_bp == jax_clamp(9_000_000, 5000, diff=True)
    assert (cfg.pt, cfg.pt2, cfg.st, cfg.precision) == (0.1, 0.05, 0.8,
                                                        "float32")
    assert seen["device"] == "cpu" and seen["normalize"] is True


def test_empty_input_gives_no_rows():
    e = np.zeros(0, np.int64)
    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    assert find_diff_loops(e, e, e.astype(float), x, y, v, device="cpu") == []
    assert find_diff_loops(x, y, v, e, e, e.astype(float), device="cpu") == []


def test_no_device_means_the_card(monkeypatch):
    """No device means the card: without CUDA both entry points raise, and
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    cfg = DetectionConfig(resolution=5000, distance_bp=200_000)
    with pytest.raises(RuntimeError, match="cuda"):
        detect_diff_loops_coo(x, y, v, x, y, v, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        find_diff_loops(x, y, v, x, y, v)


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_unported_modes_raise(device, monkeypatch):
    """Sharded runs are ported: a runner over a mesh of CPU entries is
    accepted whatever the device (the mesh names the devices), and a mesh
    of the card raises without CUDA (the runs themselves:
    tests/test_torch_sharding.py). float64, exact_normalize and
    normalize=False are ported: they are accepted, so without CUDA a card
    device raises for want of the card, and on the CPU they return (their
    parity with the JAX package: tests/test_torch_f64_diff.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    cfg = DetectionConfig(resolution=5000, distance_bp=200_000)
    e0 = np.zeros(0, np.int64)
    m0 = (e0, e0, e0.astype(float))
    for placement in ("replicate", "rowshard"):
        runner = make_runner(make_mesh(devices=["cpu"] * 2), placement)
        assert detect_diff_loops_coo(*m0, *m0, cfg, runner=runner, device=device) == []
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(devices=["cuda:0"])
    # on the CPU an empty map shows the mode accepted without a run
    e = np.zeros(0, np.int64)
    m = (e, e, e.astype(float)) if device == "cpu" else (x, y, v)
    calls = [lambda: detect_diff_loops_coo(
                 *m, *m, cfg.with_(precision="float64"), device=device),
             lambda: find_diff_loops(*m, *m, precision="float64",
                                     normalize=False, device=device),
             lambda: detect_diff_loops_coo(*m, *m, cfg, exact_normalize=True,
                                           device=device)]
    for call in calls:
        if device == "cpu":
            assert call() == []
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()