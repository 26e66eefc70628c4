"""The port's device band normalization vs the JAX package's, on the same
raw bands (f32 and uint16), in both regimes. Tolerance rtol 2e-4,
atol 2e-4: the one tests/test_bandnorm.py uses for the f32 band."""

import numpy as np
import pytest
import torch

from mustache_tpu.bandnorm import normalize_band_device as jax_normalize
from mustache_tpu.detect import band_width
from mustache_tpu_torch.bandnorm import bucket_rows, normalize_band_device
from mustache_tpu_torch.pipeline import fill_raw_band
from synthetic import synthetic_hic


def _raw_band(x, y, v, rows, Dl, dtype):
    band = np.zeros((rows, Dl), dtype)
    d = y - x
    sel = d < Dl
    band[x[sel], d[sel]] = v[sel]
    return band


@pytest.mark.parametrize("n,d_px,res,dtype", [
    (900, 120, 5000, np.float32),    # local regime (F=400 < column lengths)
    (900, 120, 5000, np.uint16),     # same, integer counts widened on device
    (2000, 400, 5000, np.float32),   # local regime, chr-scale shape
    (300, 200, 5000, np.float32),    # global regime ((n-d)*res <= 2Mb)
    (300, 200, 5000, np.uint16),
    (560, 120, 5000, np.float32),    # short columns: centering-swap gather
])
def test_normalize_band_matches_jax(n, d_px, res, dtype):
    x, y, v, _ = synthetic_hic(n, d_px, seed=3, n_loops=10)
    width = max(n, 256)
    raw = _raw_band(x, y, v, max(n, width), band_width(width, d_px), dtype)
    want, wj = jax_normalize(raw.copy(), n, res, d_px)
    got, wt = normalize_band_device(torch.from_numpy(raw.copy()), n, res,
                                    d_px)
    assert got.dtype == torch.float32 and got.shape == raw.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=2e-4,
                               atol=2e-4)


def test_fill_raw_band_picks_u16_and_matches_f32():
    x, y, v, _ = synthetic_hic(600, 100, seed=4, n_loops=0)  # integer counts
    shape = (bucket_rows(600), band_width(600, 100))
    b16 = fill_raw_band(x, y, v, shape)
    assert b16.dtype == np.uint16
    bf = fill_raw_band(x, y, v + 0.5, shape)
    assert bf.dtype == np.float32
    np.testing.assert_array_equal(b16.astype(np.float32) + (bf != 0) * 0.5,
                                  bf)
    a = normalize_band_device(torch.from_numpy(b16), 600, 5000, 100)[0]
    b = normalize_band_device(torch.from_numpy(b16.astype(np.float32)),
                              600, 5000, 100)[0]
    assert torch.equal(a, b)


def test_bucket_rows_matches_jax():
    from mustache_tpu.bandnorm import bucket_rows as jax_bucket

    for r in (1, 512, 513, 2000, 9629, 12000, 250_000):
        assert bucket_rows(r) == jax_bucket(r)
