"""End to end on the CPU: the port's detect_loops_coo vs the JAX package's
(its f32 default path on the CPU), loop for loop. Anchors and scales
equal, q within rtol 2e-4."""

import numpy as np
import pytest
import torch

from mustache_tpu.config import DetectionConfig as JaxConfig
from mustache_tpu.pipeline import detect_loops_coo as jax_detect
from mustache_tpu.pipeline import write_loops as jax_write
from mustache_tpu_torch import DetectionConfig, detect_loops_coo, find_loops, write_loops
from mustache_tpu_torch.sharding import make_mesh, make_runner
from synthetic import synthetic_hic
import torch_port_cases  # noqa: F401  (one torch thread per worker)

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
    got = find_loops(x, y, v, pt=0.1, st=0.8, device="cpu")
    assert np.array_equal(v, v0)
    _assert_same_loops(got, detect_loops_coo(
        x, y, v, DetectionConfig(**KW), device="cpu"))


def test_entry_points_default_to_the_card(monkeypatch):
    """No device means the card: on a host without CUDA both entry points
    raise, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    with pytest.raises(RuntimeError, match="cuda"):
        detect_loops_coo(x, y, v, DetectionConfig(**KW))
    with pytest.raises(RuntimeError, match="cuda"):
        find_loops(x, y, v, pt=0.1, st=0.8)


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_unported_modes_raise(device, monkeypatch):
    """Sharded runs are ported: a runner over a mesh of CPU entries is
    accepted whatever the device (the mesh names the devices), and a mesh
    of the card raises without CUDA (the runs themselves:
    tests/test_torch_sharding.py). float64, exact_normalize and
    normalize=False are ported: they are accepted, so without CUDA a card
    device raises for want of the card, and on the CPU they return (their
    parity with the JAX package: tests/test_torch_f64_pipeline.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    cfg = DetectionConfig(**KW)
    e0 = np.zeros(0, np.int64)
    m0 = (e0, e0, e0.astype(float))
    for placement in ("replicate", "rowshard"):
        runner = make_runner(make_mesh(devices=["cpu"] * 2), placement)
        assert detect_loops_coo(*m0, cfg, runner=runner, device=device) == []
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(devices=["cuda:0"])
    # on the CPU an empty map shows the mode accepted without a run
    e = np.zeros(0, np.int64)
    m = (e, e, e.astype(float)) if device == "cpu" else (x, y, v)
    calls = [lambda: detect_loops_coo(*m, cfg.with_(precision="float64"),
                                      device=device),
             lambda: find_loops(*m, precision="float64", normalize=False,
                                device=device),
             lambda: detect_loops_coo(*m, cfg, exact_normalize=True,
                                      device=device)]
    for call in calls:
        if device == "cpu":
            assert call() == []
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
