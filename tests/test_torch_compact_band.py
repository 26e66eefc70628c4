"""The port's compact band upload (uint8 / uint16 / nibble-packed uint4
plus an exception list), mirroring tests/test_compact_band.py.

Widening the narrow band on the device and scattering the exceptions must
give the f32 band bit for bit, so the port's ``normalize_band_device`` on
a compact band equals its own f32-band result exactly, and the JAX
``normalize_band_device`` with the same exceptions within rtol 1e-6. The
atol of 1e-5 covers z-scores near 0: their error is that of the column
mean (f32 sums in another order), about 1e-7 of mean/std."""

import numpy as np
import pytest
import torch

from mustache_tpu import bandnorm as jbandnorm
from mustache_tpu import pipeline as jpipeline
from mustache_tpu_torch import bandnorm as tbandnorm
from mustache_tpu_torch import pipeline as tpipeline
from mustache_tpu_torch.config import DetectionConfig
from synthetic import synthetic_hic

CPU = torch.device("cpu")


def _coo(rows, Dl, *, seed, frac_float=0.0, frac_big=0.0, lam=40.0, n=None):
    """Unique-pair COO triplets over a (rows, Dl) band with a controllable
    misfit tail (as tests/test_compact_band.py)."""
    rng = np.random.default_rng(seed)
    n = n or rows * Dl // 3
    flat = rng.choice(rows * Dl, size=n, replace=False)
    x = (flat // Dl).astype(np.int64)
    d = (flat % Dl).astype(np.int64)
    v = rng.poisson(lam, size=n).astype(np.float64)
    nf = int(n * frac_float)
    if nf:
        v[:nf] += rng.random(nf) * 0.5 + 0.25
    nb = int(n * frac_big)
    if nb:
        v[nf:nf + nb] = 70000.0 + rng.integers(0, 1000, nb)
    return x, x + d, v


def _f32(x, y, v, shape):
    ref = np.zeros(shape, np.float32)
    ref[x, y - x] = v.astype(np.float32)
    return ref


def _widen(band, exc, packed4=False):
    pad = None if exc is None else tbandnorm.pad_exceptions(exc, band.shape[0])
    return tbandnorm.widen_with_exceptions(torch.from_numpy(band), pad,
                                           packed4).numpy()


@pytest.mark.parametrize("frac_float,frac_big,lam,want", [
    (0.0, 0.0, 40.0, np.uint8),
    (0.02, 0.0, 40.0, np.uint8),
    (0.02, 0.01, 40.0, np.uint8),
    (0.0, 0.0, 500.0, np.uint16),       # counts straddle 256
    (0.01, 0.0, 500.0, np.uint16),
    (1.0, 0.0, 40.0, np.float32),       # float-heavy: the f32 band
])
def test_compact_widens_to_f32_band(frac_float, frac_big, lam, want):
    rows, Dl = 300, 96
    x, y, v = _coo(rows, Dl, seed=7, frac_float=frac_float,
                   frac_big=frac_big, lam=lam)
    band, exc, p4 = tpipeline.fill_raw_band_compact(x, y, v, (rows, Dl))
    assert band.dtype == want and not p4
    jband, jexc, _ = jpipeline.fill_raw_band_compact(x, y, v, (rows, Dl))
    np.testing.assert_array_equal(band, jband)
    assert (exc is None) == (jexc is None)
    misfits = int(frac_float * len(v)) + int(frac_big * len(v))
    if want != np.float32 and misfits:
        assert len(exc[0]) == misfits
    np.testing.assert_array_equal(_widen(band, exc), _f32(x, y, v, (rows, Dl)))


@pytest.mark.parametrize("lam,tail", [(2.0, 40), (1.0, 0)])
def test_u4_widens_to_f32_band(monkeypatch, lam, tail):
    monkeypatch.setattr(tpipeline, "_U4_MIN_BYTES", 0)
    monkeypatch.setattr(jpipeline, "_U4_MIN_BYTES", 0)
    rows, Dl = 300, 96
    x, y, v = _coo(rows, Dl, seed=19, lam=lam)
    v[:tail] = 100.0                    # 16..255: exceptions in u4
    v[tail:tail + 5] += 0.5
    band, exc, p4 = tpipeline.fill_raw_band_compact(x, y, v, (rows, Dl))
    assert p4 and band.dtype == np.uint8 and band.shape == (rows, Dl // 2)
    assert len(exc[0]) == tail + 5
    jband, jexc, jp4 = jpipeline.fill_raw_band_compact(x, y, v, (rows, Dl))
    assert jp4
    np.testing.assert_array_equal(band, jband)
    np.testing.assert_array_equal(_widen(band, exc, True),
                                  _f32(x, y, v, (rows, Dl)))


def test_pad_exceptions_bucketing():
    rows = 50
    exc = (np.arange(5, dtype=np.int64), np.arange(5, dtype=np.int64),
           np.linspace(1.5, 5.5, 5))
    r, c, v = tbandnorm.pad_exceptions(exc, rows)
    assert len(r) == 16 and r.dtype == np.int32 and v.dtype == np.float32
    np.testing.assert_array_equal(r[:5], np.arange(5))
    assert (r[5:] == rows).all() and (c[5:] == 0).all() and (v[5:] == 0).all()
    for ne, bucket in ((0, 16), (1, 16), (16, 16), (17, 32), (300, 512),
                       (512, 512), (513, 1024)):
        e = (np.zeros(ne, np.int64), np.zeros(ne, np.int64), np.ones(ne))
        got = tbandnorm.pad_exceptions(e, rows)
        want = jbandnorm.pad_exceptions(e, rows)
        assert len(got[0]) == bucket
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_pad_slots_are_dropped():
    """Pad slots (row index ``rows``) never land in the band, and a band
    without exceptions widens as is."""
    band = np.arange(12, dtype=np.uint8).reshape(3, 4)
    exc = (np.array([1]), np.array([2]), np.array([9.5]))
    got = _widen(band, exc)
    want = band.astype(np.float32)
    want[1, 2] = 9.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbandnorm.widen_with_exceptions(torch.from_numpy(band)).numpy(),
        band.astype(np.float32))


@pytest.mark.parametrize("encoding", ["u8", "u16", "u4"])
def test_normalize_compact_matches_f32_and_jax(monkeypatch, encoding):
    """normalize_band_device on the compact band + exceptions == on the
    f32 band (port, bit for bit), and == the JAX normalize with the same
    exceptions (rtol 1e-6)."""
    monkeypatch.setattr(tpipeline, "_U4_MIN_BYTES", 0)
    n, d_px, res = 400, 96, 5000
    rows, Dl = n, 98
    lam = {"u8": 40.0, "u16": 500.0, "u4": 2.0}[encoding]
    x, y, v = _coo(rows, Dl, seed=13, frac_float=0.02, frac_big=0.005,
                   lam=lam)
    if encoding == "u4":
        v[:30] = 200.0
    y = np.minimum(y, rows - 1)
    keep = y > x
    x, y, v = x[keep], y[keep], v[keep]
    _, idx = np.unique(x * Dl + (y - x), return_index=True)
    x, y, v = x[idx], y[idx], v[idx]

    band, exc, p4 = tpipeline.fill_raw_band_compact(x, y, v, (rows, Dl))
    assert p4 == (encoding == "u4") and exc is not None
    assert band.dtype == (np.uint16 if encoding == "u16" else np.uint8)
    pad = tbandnorm.pad_exceptions(exc, rows)
    got, gw = tbandnorm.normalize_band_device(
        torch.from_numpy(band), n, res, d_px, exceptions=pad, packed4=p4)
    f32 = _f32(x, y, v, (rows, Dl))
    want, ww = tbandnorm.normalize_band_device(torch.from_numpy(f32), n, res,
                                               d_px)
    assert torch.equal(got, want) and torch.equal(gw, ww)
    # the widened band is the JAX package's bit for bit
    jwide = jbandnorm._build_exc_fn(rows, Dl, str(band.dtype), len(pad[0]),
                                    p4)(band, *pad)
    np.testing.assert_array_equal(
        tbandnorm.widen_with_exceptions(torch.from_numpy(band), pad,
                                        p4).numpy(), np.asarray(jwide))
    jgot, _ = jbandnorm.normalize_band_device(band, n, res, d_px,
                                              exceptions=pad, packed4=p4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("lam,want", [(2.0, "u4"), (40.0, "u8"),
                                      (500.0, "u16")])
def test_stream_band_to_device(lam, want):
    """The streamed upload (rows >= 4096, >= 2^20 contacts, >= 8 M band
    cells) goes as two slabs of u8 or u4; u16 data goes one-shot. Either
    way the widened band equals the f32 band bit for bit."""
    rows, Dl = 4096, 2048
    x, y, v = _coo(rows, Dl, seed=31, frac_float=0.001, lam=lam,
                   n=(1 << 20) + 5)
    up = tpipeline.stream_band_to_device(x, y, v, (rows, Dl), CPU)
    assert up.encoding == want
    assert up.slabs == (1 if want == "u16" else 2)
    assert up.n_exceptions >= int(0.001 * len(v))
    width = Dl // 2 if want == "u4" else Dl
    assert up.nbytes == (rows * width * (2 if want == "u16" else 1)
                         + 12 * up.n_exceptions)
    if want != "u16":
        # the same encoding and bytes as the one-shot compact fill
        band, exc, p4 = tpipeline.fill_raw_band_compact(x, y, v, (rows, Dl))
        assert torch.equal(up.band, torch.from_numpy(band))
        assert sorted(zip(*(e.tolist() for e in exc))) == \
            sorted(zip(*(e.tolist() for e in up.exceptions)))
    pad = tbandnorm.pad_exceptions(up.exceptions, rows)
    got = tbandnorm.widen_with_exceptions(up.band, pad, up.packed4)
    assert torch.equal(got, torch.from_numpy(_f32(x, y, v, (rows, Dl))))


def test_pipeline_loops_identical_with_float_tail(monkeypatch):
    """detect_loops_coo through the compact path (mixed int/float values)
    gives the loop calls of the same data through the f32 band."""
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000, pt=0.1,
                          st=0.8)
    x, y, v, _ = synthetic_hic(1500, 300, seed=17, n_loops=30)
    rng = np.random.default_rng(17)
    tail = rng.choice(len(v), size=len(v) // 200, replace=False)
    v = v.copy()
    v[tail] += 0.5
    logs = []
    loops = tpipeline.detect_loops_coo(x, y, v, cfg, device="cpu",
                                       log=logs.append)
    assert "band=u8" in logs[0] and "exceptions=0" not in logs[0]

    def f32_only(xx, yy, vv, shape, counts=None):
        band = np.zeros(shape, np.float32)
        tpipeline.native.fill_band(xx, yy, vv, band)
        return band, None, False

    monkeypatch.setattr(tpipeline, "fill_raw_band_compact", f32_only)
    logs = []
    loops_f32 = tpipeline.detect_loops_coo(x, y, v, cfg, device="cpu",
                                           log=logs.append)
    assert "band=f32" in logs[0]
    assert loops == loops_f32 and len(loops) > 5
