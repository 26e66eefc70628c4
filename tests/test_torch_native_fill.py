"""The port's native host band fill (``mustache_tpu_torch/io/native``,
built with g++ at first use) against its numpy twins and against the JAX
package's native library (``mustache_tpu.io.native``) on the same COO:
bands bit for bit, censuses equal, exception lists equal as sets (their
order across threads is not fixed)."""

import numpy as np
import pytest

from mustache_tpu.io import native as jnative
from mustache_tpu_torch.io import native as tn


def _coo(rows, Dl, *, seed, n=None, lam=3.0, floats=0, big8=0, big16=0,
         out_of_band=0, dtype=np.int64):
    """Unique (x, y) pairs over a (rows, Dl) band with controllable tails:
    non-integers, counts >= 256, counts >= 65536, and entries outside the
    band (d < 0, d >= Dl, x >= rows)."""
    rng = np.random.default_rng(seed)
    n = n or rows * Dl // 3
    flat = rng.choice(rows * Dl, size=n, replace=False)
    x, d = flat // Dl, flat % Dl
    v = rng.poisson(lam, size=n).astype(np.float64)
    k = 0
    for count, make in ((floats, lambda m: rng.random(m) + 0.25),
                        (big8, lambda m: 256.0 + rng.integers(0, 60000, m)),
                        (big16, lambda m: 65536.0 + rng.integers(0, 9, m))):
        v[k:k + count] = np.floor(v[k:k + count]) + make(count)
        k += count
    if out_of_band:
        o = slice(k, k + out_of_band)
        x[o] = rng.choice([0, rows + 2], out_of_band)
        d[o] = np.where(x[o] == 0, rng.choice([-3, Dl, Dl + 5], out_of_band),
                        1)
    return x.astype(dtype), (x + d).astype(dtype), v


def _as_set(exc):
    return sorted(zip(*(np.asarray(a).tolist() for a in exc)))


CASES = {
    "small": dict(),
    "floats": dict(floats=40),
    "over_u8": dict(floats=10, big8=25),
    "over_u16": dict(floats=10, big8=25, big16=7),
    "out_of_band": dict(floats=5, big8=5, out_of_band=30),
    "int32": dict(floats=5, big8=5, dtype=np.int32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_census_matches_twin_and_jax(case):
    _, _, v = _coo(120, 64, seed=1, **CASES[case])
    v = np.concatenate([v, [np.nan, np.inf, -1.0, -0.0, 15.0, 16.0]])
    assert tn.classify_values(v) == tn.classify_values_plain(v) \
        == jnative.classify_values(v)
    assert tn.classify_values4(v) == tn.classify_values4_plain(v) \
        == jnative.classify_values4(v)
    fit = tn.values_fit_u16(v[:-6])
    assert fit == tn.values_fit_u16_plain(v[:-6]) \
        == jnative.values_fit_u16(v[:-6])
    assert not tn.values_fit_u16(v)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_fill_band_compact(case, dtype):
    rows, Dl = 150, 80
    x, y, v = _coo(rows, Dl, seed=2, **CASES[case])
    ne = tn.classify_values(v)[dtype == np.uint16]
    got, twin, jax = (np.zeros((rows, Dl), dtype) for _ in range(3))
    exc = tn.fill_band_compact(x, y, v, got, ne + 16)
    exc_twin = tn.fill_band_compact_plain(x, y, v, twin)
    exc_jax = jnative.fill_band_compact(x, y, v, jax, ne + 16)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, jax)
    assert _as_set(exc) == _as_set(exc_twin) == _as_set(exc_jax)
    assert [a.dtype for a in exc] == [np.int32, np.int32, np.float32]


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_slab_ranges_compose_the_band(case):
    """The streamed upload's two range fills give the one-shot band and
    its exceptions (rows of the second slab as global indices)."""
    rows, Dl = 151, 64
    x, y, v = _coo(rows, Dl, seed=3, **CASES[case])
    ne8 = tn.classify_values(v)[0]
    whole = np.zeros((rows, Dl), np.uint8)
    exc_whole = tn.fill_band_compact(x, y, v, whole, ne8 + 16)
    per = -(-rows // 2)
    parts, excs = [], []
    for g0 in range(0, rows, per):
        g1 = min(g0 + per, rows)
        slab, twin, jax = (np.zeros((g1 - g0, Dl), np.uint8) for _ in range(3))
        exc = tn.fill_band_compact_range(x, y, v, slab, g0, g1, ne8 + 16)
        exc_twin = tn.fill_band_compact_range_plain(x, y, v, twin, g0, g1)
        exc_jax = jnative.fill_band_compact_range(x, y, v, jax, g0, g1,
                                                  ne8 + 16)
        np.testing.assert_array_equal(slab, twin)
        np.testing.assert_array_equal(slab, jax)
        assert _as_set(exc) == _as_set(exc_twin) == _as_set(exc_jax)
        parts.append(slab)
        excs.extend(_as_set(exc))
    assert len(parts) == 2
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    assert sorted(excs) == _as_set(exc_whole)


@pytest.mark.parametrize("seed", [4, 5])
def test_pack_band4(seed):
    rows, Dl = 97, 48
    x, y, v = _coo(rows, Dl, seed=seed, lam=6.0, big8=20)
    v[-20:] = 100.0                 # in the u8 band, over the nibble
    band = np.zeros((rows, Dl), np.uint8)
    tn.fill_band_compact(x, y, v, band, 64)
    ne4 = tn.classify_values4(v)
    before = band.copy()
    packed, big = tn.pack_band4(band, ne4 + 16)
    twin, big_twin = tn.pack_band4_plain(band)
    jax, big_jax = jnative.pack_band4(band, ne4 + 16)
    np.testing.assert_array_equal(band, before)   # input untouched
    np.testing.assert_array_equal(packed, twin)
    np.testing.assert_array_equal(packed, jax)
    assert _as_set(big) == _as_set(big_twin) == _as_set(big_jax)
    assert len(big[0]) > 0 and packed.shape == (rows, Dl // 2)
    out = np.empty_like(packed)
    again, _ = tn.pack_band4(band, ne4 + 16, out=out)
    assert again is out and np.array_equal(out, packed)


@pytest.mark.parametrize("vdtype", [np.float64, np.float32])
def test_fill_band_f32_and_u16(vdtype):
    """The f32 and u16 fills, duplicates included (last write wins as in
    input order), against the twin and the JAX library."""
    rows, Dl = 130, 40
    x, y, v = _coo(rows, Dl, seed=6, floats=30, out_of_band=10)
    x, y, v = np.concatenate([x, x[:50]]), np.concatenate([y, y[:50]]), \
        np.concatenate([v, v[:50] + 1.0])
    v = v.astype(vdtype)
    got, twin, jax = (np.zeros((rows, Dl), np.float32) for _ in range(3))
    tn.fill_band(x, y, v, got)
    tn.fill_band_plain(x, y, v, twin)
    assert jnative.fill_band(x, y, v, jax)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, jax)

    vi = np.floor(np.abs(v.astype(np.float64)))
    u16, twin16 = (np.zeros((rows, Dl), np.uint16) for _ in range(2))
    tn.fill_band_u16(x, y, vi, u16)
    tn.fill_band_plain(x, y, vi, twin16)
    np.testing.assert_array_equal(u16, twin16)


def test_fill_counts_and_rejects_bad_buffers():
    x, y, v = _coo(40, 16, seed=7)
    before = tn.FILLS
    tn.fill_band_compact(x, y, v, np.zeros((40, 16), np.uint8), 32)
    assert tn.FILLS == before + 1
    with pytest.raises(TypeError):
        tn.fill_band_compact(x, y, v, np.zeros((40, 16), np.float32), 32)
    with pytest.raises(TypeError):
        tn.fill_band(x, y, v, np.zeros((16, 40), np.float32).T)
    with pytest.raises(ValueError):
        tn.fill_band_compact_range(x, y, v, np.zeros((5, 16), np.uint8),
                                   0, 10, 32)
    with pytest.raises(RuntimeError, match="overflow"):
        vf = v + 0.5
        tn.fill_band_compact(x, y, vf, np.zeros((40, 16), np.uint8), 1)
