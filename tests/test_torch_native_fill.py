"""The port's native host band fill (``mustache_tpu_torch/io/native``,
built with g++ at first use) against its numpy twins and against the JAX
package's native library (``mustache_tpu.io.native``) on the same COO:
bands bit for bit, censuses equal, exception lists equal as sets (their
order across threads is not fixed). The nibble-packed u4 fill is held to
the u8 fill followed by the nibble pack (``pack_band4_plain``, and the
JAX package's ``pack_band4``)."""

import numpy as np
import pytest

from mustache_tpu.io import native as jnative
from mustache_tpu_torch.io import native as tn
import torch_port_cases  # noqa: F401  (one torch thread per worker)


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
    # one pass: the u8, u16 and u4 counts
    assert tn.classify_values(v) == (*tn.classify_values_plain(v),
                                     tn.classify_values4_plain(v)) \
        == (*jnative.classify_values(v), jnative.classify_values4(v))


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


def _packed_twin(x, y, v, g0, g1, Dl):
    """Rows [g0, g1) of the u4 band as the u8 fill and the nibble pack
    give them (the numpy twins): ``(packed, exceptions)``, the pack's
    rows as global indices."""
    band = np.zeros((g1 - g0, Dl), np.uint8)
    exc = tn.fill_band_compact_range_plain(x, y, v, band, g0, g1)
    packed, big = tn.pack_band4_plain(band)
    big = (big[0] + np.int32(g0), big[1], big[2])
    return packed, tuple(np.concatenate([a, b]) for a, b in zip(exc, big))


# CASES, and the two COOs the native pack was held to the JAX pack on
U4_CASES = {**CASES, "pack_seed4": dict(seed=4, lam=6.0, big8=20),
            "pack_seed5": dict(seed=5, lam=6.0, big8=20)}


@pytest.mark.parametrize("case", sorted(U4_CASES))
def test_u4_fill_is_the_pack_of_the_u8_fill(case):
    """The nibble-packed u4 fill, of the whole band and of both halves of
    the streamed upload's row window, by the walk and by the full scan,
    into an output that does not come zeroed: the packed band of the u8
    fill bit for bit, the twins' and the JAX package's native fill and
    pack, and its exceptions as a set (values in [16, 256) among them)."""
    kw = dict(U4_CASES[case])
    rows, Dl = 97, 48
    x, y, v = _coo(rows, Dl, seed=kw.pop("seed", 8), **kw)
    v[-20:] = 100.0                 # in the u8 band, over the nibble
    cap = tn.classify_values(v)[2] + 16
    jax = np.zeros((rows, Dl), np.uint8)
    exc_jax = jnative.fill_band_compact(x, y, v, jax, cap)
    jax, big_jax = jnative.pack_band4(jax, cap)
    exc_jax = tuple(np.concatenate([a, b]) for a, b in zip(exc_jax, big_jax))
    half = rows // 2
    for g0, g1 in ((0, rows), (0, half), (half, rows)):
        packed, twin_exc = _packed_twin(x, y, v, g0, g1, Dl)
        if (g0, g1) == (0, rows):
            np.testing.assert_array_equal(packed, jax)
            assert _as_set(twin_exc) == _as_set(exc_jax)
        for scan in (False, True):
            out = np.full((g1 - g0, Dl // 2), 0xAB, np.uint8)
            if (g0, g1) == (0, rows):
                exc = tn.fill_band_compact(x, y, v, out, cap, scan=scan,
                                           packed4=True)
            else:
                exc = tn.fill_band_compact_range(x, y, v, out, g0, g1, cap,
                                                 scan=scan, packed4=True)
            np.testing.assert_array_equal(out, packed)
            assert _as_set(exc) == _as_set(twin_exc)
            assert [a.dtype for a in exc] == [np.int32, np.int32, np.float32]
    assert any(16 <= e < 256 for e in exc_jax[2])


@pytest.mark.parametrize("vdtype", [np.float64, np.float32])
def test_fill_band_f32_and_u16(vdtype):
    """The f32 fill, duplicates included (last write wins as in input
    order), against the twin and the JAX library, of fractional values
    and of counts (the u16 band is ``test_fill_band_compact``'s)."""
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
    counts, twin = (np.zeros((rows, Dl), np.float32) for _ in range(2))
    tn.fill_band(x, y, vi, counts)
    tn.fill_band_plain(x, y, vi, twin)
    np.testing.assert_array_equal(counts, twin)


def test_fill_counts_and_rejects_bad_buffers():
    x, y, v = _coo(40, 16, seed=7)
    before, before4 = tn.FILLS, tn.FILLS4
    tn.fill_band_compact(x, y, v, np.zeros((40, 16), np.uint8), 32)
    assert (tn.FILLS, tn.FILLS4) == (before + 1, before4)
    tn.fill_band_compact(x, y, v, np.zeros((40, 8), np.uint8), 32,
                         packed4=True)
    assert (tn.FILLS, tn.FILLS4) == (before + 2, before4 + 1)
    with pytest.raises(TypeError):
        tn.fill_band_compact(x, y, v, np.zeros((40, 16), np.float32), 32)
    with pytest.raises(TypeError):
        tn.fill_band_compact(x, y, v, np.zeros((40, 8), np.uint16), 32,
                             packed4=True)
    with pytest.raises(TypeError):
        tn.fill_band(x, y, v, np.zeros((16, 40), np.float32).T)
    with pytest.raises(ValueError):
        tn.fill_band_compact_range(x, y, v, np.zeros((5, 16), np.uint8),
                                   0, 10, 32)
    with pytest.raises(RuntimeError, match="overflow"):
        vf = v + 0.5
        tn.fill_band_compact(x, y, vf, np.zeros((40, 16), np.uint8), 1)


# the threaded fills: at least 2^16 entries (fewer run on one thread)
BIG_ROWS, BIG_DL = 600, 256


def _big_coo(case, *, seed=11):
    """About 80,000 entries over a (600, 256) band, sorted by row (a
    stable sort, so duplicate pairs keep their input order) unless the
    case is ``unsorted``; ``misfits`` puts every kind of value that fits
    no narrow band (256 and up, 65536 and up, fractions, NaN, +-inf,
    negatives) and -0.0 among them; ``outside`` adds entries off the band
    (d < 0, d >= ldb) and off its rows (x < 0, x >= rows); ``duplicates``
    repeats 3,000 pairs with other values; ``nearly_sorted`` moves five
    entries one place; ``int32`` and ``mixed`` give int32 indices to both
    and to x alone."""
    rng = np.random.default_rng(seed)
    n = 80_000
    flat = rng.choice(BIG_ROWS * BIG_DL, size=n, replace=False)
    x, d = flat // BIG_DL, flat % BIG_DL
    v = rng.poisson(6.0, size=n).astype(np.float64)
    v[rng.choice(n, 200, replace=False)] = 300.0     # u8 misfits
    if case == "misfits":
        odd = [256.0, 65535.0, 65536.0, 2.0 ** 53, 2.0 ** 53 + 2, 3.5, 0.25,
               np.nan, np.inf, -np.inf, -1.0, -0.5, -0.0]
        at = rng.choice(n, 40 * len(odd), replace=False)
        v[at] = np.repeat(odd, 40)
    if case == "outside":
        k = 400
        at = rng.choice(n, 4 * k, replace=False)
        d[at[:k]] = -rng.integers(1, 9, k)                     # d < 0
        d[at[k:2 * k]] = BIG_DL + rng.integers(0, 9, k)        # d >= ldb
        x[at[2 * k:3 * k]] = -rng.integers(1, 4, k)            # x < 0
        x[at[3 * k:]] = BIG_ROWS + rng.integers(0, 4, k)       # x >= rows
    if case == "duplicates":
        at = rng.choice(n, 3000, replace=False)
        x, d = np.concatenate([x, x[at]]), np.concatenate([d, d[at]])
        v = np.concatenate([v, v[at] + rng.choice([1.0, 0.5, 300.0], 3000)])
    y = x + d
    order = (rng.permutation(len(x)) if case == "unsorted"
             else np.argsort(x, kind="stable"))
    x, y, v = x[order], y[order], v[order]
    if case == "nearly_sorted":
        # five entries one place late, each at a row's end: descents that
        # only the walk can see (between the evenly spaced samples)
        ends = np.flatnonzero(np.diff(x) > 0)
        ends = ends[~np.isin(ends, _samples(len(x)))
                    & ~np.isin(ends + 1, _samples(len(x)))]
        for i in rng.choice(ends, 5, replace=False):
            for a in (x, y, v):
                a[i], a[i + 1] = a[i + 1], a[i]
    ix = np.int32 if case in ("int32", "mixed") else np.int64
    iy = np.int32 if case == "int32" else np.int64
    return x.astype(ix), y.astype(iy), v


def _samples(n):
    """The entries whose rows the walk compares before any write."""
    return np.arange(4096, dtype=np.int64) * n // 4096


def _exc_bits(exc):
    """An exception list as a sorted list of (row, col, f32 bits), so NaN
    compares equal to itself."""
    r, c, v = (np.asarray(a) for a in exc)
    return sorted(zip(r.tolist(), c.tolist(),
                      v.astype(np.float32).view(np.int32).tolist()))


BIG_CASES = ["sorted", "unsorted", "nearly_sorted", "duplicates", "misfits",
             "outside", "int32", "mixed"]


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("case", BIG_CASES)
def test_threaded_compact_fills_match_twins(case, threads):
    """The row-range walk (each thread its own rows' entries, found by
    binary search) against the numpy twins, band bit for bit and the
    exceptions as a set, for the one-shot fill in both widths, both
    halves of the streamed upload's row window, and the one pass that
    also counts the census. The walk declines (None, the band zero)
    exactly where x and y differ in dtype, or where the rows are not
    sorted and more than one thread shares the work; ``scan=True`` then
    fills as the twin does."""
    x, y, v = _big_coo(case)
    assert len(v) >= 1 << 16
    declines = case == "mixed" or (
        case in ("unsorted", "nearly_sorted") and threads > 1)

    def check(fill, band, twin_exc, twin_band):
        exc = fill(band)
        assert (exc is None) == declines
        if exc is None:
            assert not band.any()
            exc = fill(band, scan=True)
        np.testing.assert_array_equal(band, twin_band)
        assert _exc_bits(exc) == _exc_bits(twin_exc)

    for dtype in (np.uint8, np.uint16):
        twin = np.zeros((BIG_ROWS, BIG_DL), dtype)
        twin_exc = tn.fill_band_compact_plain(x, y, v, twin)
        check(lambda b, **kw: tn.fill_band_compact(
                  x, y, v, b, len(v), n_threads=threads, **kw),
              np.zeros_like(twin), twin_exc, twin)
    half = BIG_ROWS // 2
    for g0, g1 in ((0, half), (half, BIG_ROWS)):
        twin = np.zeros((g1 - g0, BIG_DL), np.uint8)
        twin_exc = tn.fill_band_compact_range_plain(x, y, v, twin, g0, g1)
        check(lambda b, **kw: tn.fill_band_compact_range(
                  x, y, v, b, g0, g1, len(v), n_threads=threads, **kw),
              np.zeros_like(twin), twin_exc, twin)

    band = np.zeros((BIG_ROWS, BIG_DL), np.uint8)
    got = tn.fill_band_u8_census(x, y, v, band, n_threads=threads)
    assert (got is None) == declines
    if got is not None:
        exc, counts = got
        twin = np.zeros_like(band)
        assert _exc_bits(exc) == _exc_bits(
            tn.fill_band_compact_plain(x, y, v, twin))
        np.testing.assert_array_equal(band, twin)
        assert counts == tn.classify_values_plain(v) \
            == tn.classify_values(v)[:2]
    else:
        assert not band.any()


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("case", BIG_CASES)
def test_threaded_u4_fill_matches_twins(case, threads):
    """The u4 fill's row-range walk against the u8 twin and the nibble
    pack, packed band bit for bit and the exceptions as a set, for the
    whole band and both halves of the streamed upload's row window, into
    outputs that do not come zeroed; where the walk declines (as the u8
    fill does) the output is untouched or zeroed and ``scan=True`` fills
    it. The one-pass census equals both twins' counts."""
    x, y, v = _big_coo(case)
    declines = case == "mixed" or (
        case in ("unsorted", "nearly_sorted") and threads > 1)
    ne8, ne16, ne4 = tn.classify_values(v, n_threads=threads)
    assert (ne8, ne16) == tn.classify_values_plain(v)
    assert ne4 == tn.classify_values4_plain(v)
    half = BIG_ROWS // 2
    for g0, g1 in ((0, BIG_ROWS), (0, half), (half, BIG_ROWS)):
        packed, twin_exc = _packed_twin(x, y, v, g0, g1, BIG_DL)
        if (g0, g1) == (0, BIG_ROWS):
            def fill(b, **kw):
                return tn.fill_band_compact(x, y, v, b, ne4 + 16,
                                            n_threads=threads, packed4=True,
                                            **kw)
        else:
            def fill(b, **kw):
                return tn.fill_band_compact_range(
                    x, y, v, b, g0, g1, ne4 + 16, n_threads=threads,
                    packed4=True, **kw)
        out = np.full(packed.shape, 0xAB, np.uint8)
        exc = fill(out)
        assert (exc is None) == declines
        if exc is None:
            assert (out == 0xAB).all() or not out.any()
            out[:] = 0xAB
            exc = fill(out, scan=True)
        np.testing.assert_array_equal(out, packed)
        assert _exc_bits(exc) == _exc_bits(twin_exc)


@pytest.mark.parametrize("threads", [1, 8])
def test_census_pass_returns_every_exception(threads):
    """The one pass has no exception capacity: a band whose every value
    is a misfit gives all of them, with the census; the fill with a
    capacity raises on the same input."""
    x, y, v = _big_coo("sorted")
    v = v + 0.5
    band, twin = (np.zeros((BIG_ROWS, BIG_DL), np.uint8) for _ in range(2))
    exc, counts = tn.fill_band_u8_census(x, y, v, band, n_threads=threads)
    twin_exc = tn.fill_band_compact_plain(x, y, v, twin)
    assert len(exc[0]) == len(v) and not band.any()
    assert _exc_bits(exc) == _exc_bits(twin_exc)
    assert counts == tn.classify_values_plain(v) == (len(v), len(v))
    with pytest.raises(RuntimeError, match="overflow"):
        tn.fill_band_compact(x, y, v, np.zeros_like(band), 100,
                             n_threads=threads)


def test_walk_finds_disorder_outside_its_rows():
    """A COO sorted by row but for one entry among rows a slab does not
    own: the slab's walk still declines, since the other rows are read
    for their order."""
    x, y, v = _big_coo("sorted")
    i = int(np.searchsorted(x, BIG_ROWS - 20))
    i += np.isin(i, _samples(len(x)))       # between the samples
    x, y = x.copy(), y.copy()
    x[i], y[i] = 2, 2 + 5                          # a row-2 entry late
    slab = np.zeros((BIG_ROWS // 2, BIG_DL), np.uint8)
    assert tn.fill_band_compact_range(x, y, v, slab, 0, BIG_ROWS // 2,
                                      len(v)) is None
    assert not slab.any()
    exc = tn.fill_band_compact_range(x, y, v, slab, 0, BIG_ROWS // 2,
                                     len(v), scan=True)
    twin = np.zeros_like(slab)
    twin_exc = tn.fill_band_compact_range_plain(x, y, v, twin, 0,
                                                BIG_ROWS // 2)
    np.testing.assert_array_equal(slab, twin)
    assert _exc_bits(exc) == _exc_bits(twin_exc)


def test_walk_checks_the_seams_between_pieces():
    """A COO whose every piece is sorted, with one descent exactly where
    two pieces meet: among the rows before a slab, read in three pieces by
    three threads, the last entry of the first piece moved one row past
    the next piece's first. Only the check of the seams after the join
    finds it."""
    x, y, v = _big_coo("sorted")
    g0, g1 = BIG_ROWS // 2, BIG_ROWS
    b = int(np.searchsorted(x, g0)) // 3      # the second piece's start
    x, y = x.copy(), y.copy()
    x[b - 1] = x[b] + 1
    y[b - 1] = x[b - 1] + 3
    assert not np.isin([b - 1, b], _samples(len(x))).any()
    assert np.all(np.diff(x[:b]) >= 0) and np.all(np.diff(x[b:]) >= 0)
    slab = np.zeros((g1 - g0, BIG_DL), np.uint8)
    assert tn.fill_band_compact_range(x, y, v, slab, g0, g1, len(v),
                                      n_threads=3) is None
    assert not slab.any()


@pytest.mark.parametrize("order", ["permuted", "blocks"])
def test_other_orders_are_refused_before_any_write(order):
    """A COO in another order (a random one, or a ``.hic`` file's: blocks
    of 128 rows, each by column and then row) is refused from the rows
    of evenly spaced entries, before any thread writes: a band that
    holds something keeps it, the u4 band and slab as the u8 band."""
    x, y, v = _big_coo("sorted")
    if order == "permuted":
        perm = np.random.default_rng(3).permutation(len(x))
    else:
        perm = np.lexsort((x, y, x // 128))
    x, y, v = x[perm], y[perm], v[perm]
    band = np.full((BIG_ROWS, BIG_DL), 7, np.uint8)
    assert tn.fill_band_compact(x, y, v, band, len(v)) is None
    assert tn.fill_band_u8_census(x, y, v, band) is None
    assert (band == 7).all()
    packed = np.full((BIG_ROWS, BIG_DL // 2), 7, np.uint8)
    assert tn.fill_band_compact(x, y, v, packed, len(v), packed4=True) \
        is None
    assert tn.fill_band_compact_range(x, y, v, packed[:100], 100, 200,
                                      len(v), packed4=True) is None
    assert (packed == 7).all()
