"""End to end on the CPU: the port's detect_loops_coo vs the JAX package's
(its f32 default path on the CPU), loop for loop. Anchors and scales
equal, q within rtol 2e-4."""

import numpy as np
import pytest

from mustache_tpu.config import DetectionConfig as JaxConfig
from mustache_tpu.pipeline import detect_loops_coo as jax_detect
from mustache_tpu.pipeline import write_loops as jax_write
from mustache_tpu_torch import DetectionConfig, detect_loops_coo, find_loops, write_loops
from synthetic import synthetic_hic

KW = dict(resolution=5000, distance_bp=2_000_000, pt=0.1, st=0.8)


def _assert_same_loops(got, want):
    assert [(lp.bin1, lp.bin2, lp.scale) for lp in got] == \
        [(lp.bin1, lp.bin2, lp.scale) for lp in want]
    np.testing.assert_allclose([lp.q for lp in got], [lp.q for lp in want],
                               rtol=2e-4)


@pytest.mark.parametrize("n_bins,d_px,nblocks", [(900, 120, 1),
                                                 (3000, 200, 2)])
def test_detect_loops_coo_matches_jax(n_bins, d_px, nblocks, tmp_path):
    x, y, v, anchors = synthetic_hic(n_bins, d_px, seed=21, n_loops=20)
    v0 = v.copy()
    logs = []
    got = detect_loops_coo(x, y, v, DetectionConfig(**KW), device="cpu",
                           log=logs.append)
    assert np.array_equal(v, v0)                 # caller's array untouched
    assert f"blocks={nblocks} " in logs[0]
    want = jax_detect(x, y, v.copy(), JaxConfig(**KW))
    assert len(want) > 5
    _assert_same_loops(got, want)

    # the TSV writer is the reference format, byte for byte
    pt, pj = tmp_path / "t.tsv", tmp_path / "j.tsv"
    write_loops(str(pt), [("chr21", "chr21", 5000, want)])
    jax_write(str(pj), [("chr21", "chr21", 5000, want)])
    assert pt.read_bytes() == pj.read_bytes()


def test_find_loops_leaves_input_and_matches_detect():
    x, y, v, _ = synthetic_hic(900, 120, seed=22, n_loops=10)
    v0 = v.copy()
    got = find_loops(x, y, v, pt=0.1, st=0.8)
    assert np.array_equal(v, v0)
    _assert_same_loops(got, detect_loops_coo(
        x, y, v, DetectionConfig(**KW), device="cpu"))


def test_unported_modes_raise():
    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    cfg = DetectionConfig(**KW)
    with pytest.raises(NotImplementedError, match="float64"):
        detect_loops_coo(x, y, v, cfg.with_(precision="float64"))
    with pytest.raises(NotImplementedError, match="exact_normalize"):
        detect_loops_coo(x, y, v, cfg, exact_normalize=True)
    with pytest.raises(NotImplementedError, match="sharding"):
        detect_loops_coo(x, y, v, cfg, runner=object())
