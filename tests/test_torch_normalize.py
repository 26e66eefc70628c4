"""The port's host normalize (``mustache_tpu_torch.normalize``) against the
JAX package's (``mustache_tpu.normalize``) on the same seeded COO, at the
sizes of tests/test_normalize.py: both regimes (local and global), exact
and fast mode, the numpy fast path and the native one, with and without
the fused f32 band.

The numpy paths are copies and agree bit for bit. The native paths are
the same C++ source built two ways: the JAX package's library with
``-march=native`` (which may contract multiply-adds into FMAs), the
port's without, so they differ in the last bits: measured at most 3.2e-14
absolute (4.7e-15 relative) on these maps; held here to 1e-12."""

import numpy as np
import pytest

from mustache_tpu.io import native as jnative
from mustache_tpu.normalize import normalize_sparse as jax_normalize
from mustache_tpu_torch.io import native
from mustache_tpu_torch.normalize import normalize_sparse
from synthetic import synthetic_hic
import torch_port_cases  # noqa: F401  (one torch thread per worker)

# (n_bins, d_px, seed): the local regime ((n - d_px) * res > 2 Mb at
# 5 kb) and the global one
MAPS = {"local": (1200, 100, 5), "global": (300, 60, 6)}
NATIVE_TOL = 1e-12


def _both(monkeypatch, regime, *, exact, use_native, band):
    n, d_px, seed = MAPS[regime]
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed)
    vt, vj = v.copy(), v.copy()
    bt = np.zeros((n, 128), np.float32) if band else None
    bj = np.zeros((n, 128), np.float32) if band else None
    if not use_native:
        # both packages' numpy fast path: their fallback without the
        # native library
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    wt = normalize_sparse(x, y, vt, 5000, d_px, exact=exact, band_out=bt)
    wj = jax_normalize(x, y, vj, 5000, d_px, exact=exact, band_out=bj)
    assert not np.array_equal(vt, v)                  # it did normalize
    return (vt, wt, bt), (vj, wj, bj)


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("regime,exact,use_native", [
    ("local", True, True), ("local", False, False), ("global", False, True),
    ("global", True, False)])
def test_numpy_paths_bit_equal(monkeypatch, regime, exact, use_native, band):
    """Every pass that runs numpy: exact mode, the numpy fast path, and
    the global regime (which never calls the native core)."""
    (vt, wt, bt), (vj, wj, bj) = _both(monkeypatch, regime, exact=exact,
                                       use_native=use_native, band=band)
    assert np.array_equal(vt, vj)
    assert wt == wj
    if band:
        assert np.array_equal(bt, bj) and bt.any()


@pytest.mark.parametrize("band", [False, True])
def test_native_matches_jax_native(monkeypatch, band):
    assert jnative.available()
    before = native.normalize_library()               # builds at first use
    (vt, wt, bt), (vj, wj, bj) = _both(monkeypatch, "local", exact=False,
                                       use_native=True, band=band)
    assert native.normalize_library() is before
    np.testing.assert_allclose(vt, vj, rtol=NATIVE_TOL, atol=NATIVE_TOL)
    np.testing.assert_allclose(wt, wj, rtol=NATIVE_TOL)
    if band:
        # the f32 band holds the same z, rounded once
        np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=1e-6)
        assert np.array_equal(bt != 0, bj != 0)


def test_native_matches_numpy_twin(monkeypatch):
    """The native pass against the port's own numpy fast path (the
    reference's cumsum windows): 1e-8, the JAX package's own tolerance
    between the two (tests/test_normalize.py)."""
    n, d_px, seed = MAPS["local"]
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed)
    a, b = v.copy(), v.copy()
    assert native.available()
    wa = normalize_sparse(x, y, a, 5000, d_px)
    monkeypatch.setattr(native, "available", lambda: False)
    wb = normalize_sparse(x, y, b, 5000, d_px)
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(wa, wb, rtol=1e-12)


def test_available_follows_the_compiler(monkeypatch):
    """``available`` reports whether a host C++ compiler is found; it
    builds nothing."""
    assert native.available()
    monkeypatch.setenv("CXX", "no-such-compiler-mtpu")
    assert not native.available()


def test_native_rejects_bad_arrays():
    x = np.arange(4, dtype=np.int64)
    with pytest.raises(TypeError, match="float64"):
        native.normalize_coo(x, x + 1, np.ones(4, np.float32), 8, 3, 2)
    with pytest.raises(TypeError, match="band"):
        native.normalize_coo(x, x + 1, np.ones(4), 8, 3, 2,
                             band_out=np.zeros((8, 4)))
