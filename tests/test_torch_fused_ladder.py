"""The fused ladder/DoG/NMS stage: the port's plain PyTorch version vs the
JAX package's Pallas kernel run in interpret mode on the CPU.

band_sig must be exact on the support; band_v, locs and sums agree to
rtol 2e-4 (the f32 blur sums run in another order: cuDNN/ATen conv here,
Toeplitz matmuls there). The CUDA kernel itself is held against the same
plain version on the card by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from mustache_tpu.kernels.fused_ladder import (
    build_fused_mats, fused_ladder_nms_batched as jax_fused,
)
from mustache_tpu.normalize import normalize_sparse
from mustache_tpu.scalespace import build_ladder
from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.detect import band_width, build_detector
from mustache_tpu_torch.device import resolve_device
from mustache_tpu_torch.kernels import fused_ladder as fl
from mustache_tpu_torch.scalespace import ladder_tensor
from synthetic import synthetic_hic


def _sentinel_block(n, d_px, seed):
    """(cs, nz) as numpy: a normalized synthetic block after the support
    mask and sentinel fill."""
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed, n_loops=8)
    normalize_sparse(x, y, v, 5000, d_px, work_dtype=np.float32)
    c = np.zeros((n, n), np.float32)
    c[x, y] = v
    r = np.arange(n)
    diag = r[None, :] - r[:, None]
    nz = (c != 0) & (diag >= 4)
    cs = np.where(diag <= 4, 2.0, c)
    cs = np.where(diag >= d_px + 1, 2.0, cs).astype(np.float32)
    return cs, nz.astype(np.float32)


def _both(cs, nz, octaves, d_px, valid):
    spec = build_ladder(octaves)
    n = cs.shape[-1]
    DB = band_width(n, d_px)
    KR, WC, R, TOPPAD, WINROWS = build_fused_mats(spec.kernels)
    want = jax.jit(lambda c, z, vd: jax_fused(
        c, z, KR, WC, R=R, TOPPAD=TOPPAD, WINROWS=WINROWS,
        n_octaves=len(octaves), planes_per_octave=9, DB=DB, valid=vd,
        interpret=True))(cs, nz, valid)
    got = fl.fused_ladder_nms_batched(
        torch.from_numpy(cs), torch.from_numpy(nz),
        ladder_tensor(spec.kernels, torch.device("cpu")), R=spec.radius,
        n_octaves=len(octaves), planes_per_octave=9, DB=DB,
        valid=torch.from_numpy(valid))
    return [np.asarray(a) for a in want], [a.numpy() for a in got], DB


def _assert_state_equal(want, got, nz, DB):
    wv, ws, wl, wsum = want
    gv, gs, gl, gsum = got
    n = nz.shape[-1]
    i = np.arange(n)[:, None]
    j = i + np.arange(DB)[None, :]                  # band (i, d) -> dense j
    sup = (nz[:, i, np.minimum(j, n - 1)] > 0.5) & (j < n)
    assert sup.any()
    np.testing.assert_array_equal(gs[sup], ws[sup])
    assert (gs[~sup] == -1).all()
    np.testing.assert_allclose(gv, wv, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(gl, wl, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(gsum, wsum, rtol=2e-4)


@pytest.mark.parametrize("n,d_px,octaves", [
    (256, 64, (1.6, 3.2)),
    (200, 40, (1.6, 3.2)),
    (256, 64, (1.6, 3.2, 6.4)),
])
def test_plain_matches_pallas_interpret(n, d_px, octaves):
    cs, nz = _sentinel_block(n, d_px, seed=91)
    valid = np.ones(1, np.int32)
    want, got, DB = _both(cs[None], nz[None], octaves, d_px, valid)
    assert (got[1] >= 0).sum() > 10
    _assert_state_equal(want, got, nz[None], DB)


def test_plain_pad_slots_match_pallas_interpret():
    """A batch with a pad slot in the middle (the diff path's stacked
    batch has such slots): empty state and zero partials there, valid
    slots unchanged."""
    n, d_px = 256, 64
    blocks = [_sentinel_block(n, d_px, seed=s) for s in (97, 98, 99)]
    cs = np.stack([b[0] for b in blocks])
    nz = np.stack([b[1] for b in blocks])
    valid = np.array([1, 0, 1], np.int32)
    want, got, DB = _both(cs, nz, (1.6, 3.2), d_px, valid)
    nz_valid = nz * valid[:, None, None]
    _assert_state_equal(want, got, nz_valid, DB)
    assert (got[0][1] == 0).all() and (got[1][1] == -1).all()
    assert (got[2][1] == 0).all() and (got[3][1] == 0).all()


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    from mustache_tpu_torch import detect_loops_coo

    x, y, v, _ = synthetic_hic(300, 40, seed=1, n_loops=2)
    with pytest.raises(RuntimeError, match="cuda"):
        detect_loops_coo(x, y, v, DetectionConfig(), device="cuda")


def test_wrapper_has_no_other_device_path():
    """Neither a CPU nor a CUDA tensor: the wrapper raises instead of
    running anything."""
    spec = build_ladder((1.6, 3.2))
    cs = torch.zeros((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fl.fused_ladder_nms_batched(
            cs, cs, torch.zeros(spec.kernels.shape, device="meta"),
            R=spec.radius, n_octaves=2, planes_per_octave=9, DB=64)
    assert fl.LAUNCHES == 0


@pytest.mark.parametrize("DB", [1, 31, 32, 33, 128, 512, 2048])
def test_tile_grid_covers_band_exactly(DB):
    """Tile (ti, ti + k), k < tiles_per_row, meets the band; k = tiles_per_row
    would not. Checked cell by cell on a small grid."""
    T = fl.TILE
    k_max = fl.tiles_per_row(DB)
    r = np.arange(T)
    for k in range(k_max + 1):
        d = (k * T + r[None, :]) - r[:, None]
        meets = ((d >= 0) & (d < DB)).any()
        assert meets == (k < k_max)


def test_shared_memory_gate():
    assert fl.smem_bytes(14, 2) <= 48 * 1024      # default ladder: static
    assert fl.kernel_fits(14, 3)
    spec = build_ladder(DetectionConfig(sigma0=1.6, octaves=6).octave_values)
    assert not fl.kernel_fits(spec.radius, 6)
    with pytest.raises(ValueError, match="shared memory"):
        build_detector(DetectionConfig(octaves=6), 2000,
                       device=torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="float64"):
        build_detector(DetectionConfig(precision="float64"), 2000,
                       device=resolve_device("cpu"))
