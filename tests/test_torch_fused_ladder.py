"""The fused ladder/DoG/NMS stage: the port's plain PyTorch version vs the
JAX package's Pallas kernel run in interpret mode on the CPU.

band_sig must be exact on the support; band_v, locs and sums agree to
rtol 2e-4 (the f32 blur sums run in another order: banded Toeplitz
matmuls on the band here, the TPU kernel's Toeplitz matmuls there). The CUDA kernel itself is held against the same
plain version on the card by chip_smoke.py.
"""

import re
from pathlib import Path

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
from mustache_tpu_torch.scalespace import (
    kernel_radius, ladder_tensor, radii_tensor,
)
from synthetic import synthetic_hic
import torch_port_cases  # noqa: F401  (one torch thread per worker)


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
    # the streamed mode's ladders: sigma0 1.6 -oc 5 (R=110) and sigma0
    # 3.0 -oc 4 (R=103)
    (256, 64, (1.6, 3.2, 6.4, 12.8, 25.6)),
    (300, 64, (3.0, 6.0, 12.0, 24.0)),
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
    """The launched tiles (row tile ti, column tile k < tiles_per_row,
    those starting at a column < N; the kernel returns at once from the
    rest) cover each band cell 0 <= j - i < DB, j < N, exactly once, and
    each of them meets the band. The same with the streamed mode's grid,
    padded to whole clusters per row tile (CTA x of the launch is column
    tile x % tpg of row tile x // tpg): the padding CTAs (k >=
    tiles_per_row) write nothing, the parts index of the rest is the slab
    grid's (row tile, k), so the parts tensor and its reduction are the
    same for both grids."""
    TR, TC = fl.TILE_ROWS, fl.TILE_COLS
    N = DB + 97
    tpr = fl.tiles_per_row(DB)
    for tpg in (tpr, fl.grid_tiles_per_row(DB)):      # slab, streamed
        cover = np.zeros((N, N), np.int16)
        parts = np.zeros(fl.n_tiles(N, DB), np.int16)
        launched = 0
        for x in range(fl.row_tiles(N) * tpg):
            ti, k = divmod(x, tpg)
            r0, c0 = ti * TR, ti * TR + k * TC
            if k >= tpr:                     # a padding rank: no output
                continue
            parts[ti * tpr + k] += 1
            if c0 >= N:
                continue
            launched += 1
            cover[r0:r0 + TR, c0:c0 + TC] += 1
            i = np.arange(r0, min(r0 + TR, N))[:, None]
            j = np.arange(c0, min(c0 + TC, N))[None, :]
            assert ((j - i >= 0) & (j - i < DB)).any(), (ti, k)
        i = np.arange(N)[:, None]
        d = np.arange(N)[None, :] - i
        band = (d >= 0) & (d < DB)
        assert (cover[band] == 1).all()
        assert (parts == 1).all()
        assert launched > 0


# an H100 SM's shared memory, and the runtime's reserve per CTA (bytes)
SM_SMEM, CTA_RESERVED = 233_472, 1_024


def ctas_per_sm(nbytes):
    """CTAs of ``nbytes`` of shared memory an H100 SM holds at once (the
    kernel's 256 threads at <= 128 registers allow two)."""
    return 2 if 2 * (nbytes + CTA_RESERVED) <= SM_SMEM else 1


def test_cluster_rule_for_every_band_width():
    """The streamed mode's cluster size is the kernel's, a portable one
    (1-8 CTAs), and serves every ladder of that mode and every band DB =
    128 m up to 4096: the padded grid holds whole clusters, pads fewer
    than one cluster per row tile, and two CTAs fit an SM (the rule's
    reason)."""
    src = (Path(fl.__file__).parent / "csrc" / "fused_ladder.cu").read_text()
    assert re.findall(r"constexpr int CLUSTER = (\d+);", src) == [
        str(fl.CLUSTER)]
    c = fl.CLUSTER
    assert 1 <= c <= 8
    ladders = [(R, o) for R in (56, 80, 103, 110, 127) for o in range(1, 7)
               if fl.ladder_mode(R, o) == "stream"]
    assert (110, 5) in ladders and (127, 6) in ladders
    for R, o in ladders:
        assert ctas_per_sm(fl.smem_bytes(R, o, "stream")) == 2
    for m in range(1, 33):
        DB = 128 * m
        tpr, tpg = fl.tiles_per_row(DB), fl.grid_tiles_per_row(DB)
        assert tpr == 2 * m + 1                      # always odd
        assert tpg % c == 0 and 0 <= tpg - tpr < c
    # the pipeline's bands: 9 tiles a row at 5 kb, 33 at 1 kb
    assert fl.grid_tiles_per_row(512) == 12
    assert fl.grid_tiles_per_row(2048) == 36


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("r", [14, 55, 103, 110, 127])
def test_share_columns_partition_the_union(r, m):
    """A numpy model of the streamed mode's column split, for a cluster
    whose first m ranks have cells: the ranks' pieces are disjoint, their
    union is exactly the columns the m tiles' horizontal passes read
    (tile q: [64 q, 64 q + 66 + 2r)), each piece fits its rank's share
    buffer at the widest sigma (R = 127 bounds every r here), and the
    kernel's 16-byte copy groups of tile q, from 64 q up to 66 + 2r
    rounded up to 4, each sit in one piece and read no column outside
    the union but the last group's padding."""
    C, R = fl.CLUSTER, 127
    assert m <= C
    pitch = fl.share_pitch(R)
    assert pitch % 64 == 0
    U, ranks = fl.share_columns(r, m)
    assert U == 64 * m + 2 + 2 * r and len(ranks) == C
    assert sum(w for p in ranks for _, w in p) == U
    owner = np.full(U, -1)
    for q, pieces in enumerate(ranks):
        for j, (u0, width) in enumerate(pieces):
            assert u0 == 64 * (q + j * C) and 0 < width <= 64
            assert 64 * j + width <= pitch
            assert (owner[u0:u0 + width] == -1).all()
            owner[u0:u0 + width] = q
    assert (owner >= 0).all()
    reads = np.zeros(U, bool)
    for q in range(m):
        reads[64 * q: 64 * q + 66 + 2 * r] = True
        for u in range(64 * q, 64 * q + 66 + 2 * r, 4):
            assert u // 64 == (u + 3) // 64           # one piece a group
            assert u < U and owner[u] == (u // 64) % C
    assert reads.all()


def test_shared_memory_gate(monkeypatch):
    """Every ladder the JAX package fuses (at most 6 octaves, R <= 127)
    passes the gate and fits one block's shared memory in the mode it
    takes: the slab mode wherever the whole slab fits, else the streamed
    one; no other ladder passes."""
    modes = set()
    for sigma0 in (0.5, 1.0, 1.6, 2.0, 2.5, 3.0, 4.0):
        for octaves in range(1, 8):
            spec = build_ladder(DetectionConfig(
                sigma0=sigma0, octaves=octaves).octave_values)
            R = spec.radius
            fits = octaves <= 6 and R <= 127
            assert fl.kernel_fits(R, octaves) == fits, (sigma0, octaves)
            if not fits:
                continue
            mode = fl.ladder_mode(R, octaves)
            modes.add(mode)
            assert fl.smem_bytes(R, octaves) == fl.smem_bytes(R, octaves,
                                                             mode)
            assert fl.smem_bytes(R, octaves) <= fl.SMEM_LIMIT
            assert (mode == "slab") == (
                fl.smem_bytes(R, octaves, "slab") <= fl.SMEM_LIMIT)
            if mode == "stream":             # two clusters' CTAs an SM
                assert ctas_per_sm(fl.smem_bytes(R, octaves)) == 2
    assert modes == {"slab", "stream"}
    # the corner of the domain, and the default and 5-octave ladders: the
    # streamed mode's CTA in clusters of 4, and where two fit (not in
    # clusters of 3: a rank's share then takes three 64-column pieces)
    assert fl.CLUSTER == 4
    assert fl.smem_bytes(127, 6) == 114_612 <= fl.SMEM_LIMIT
    assert fl.smem_bytes(110, 5) == 109_636
    assert ctas_per_sm(fl.smem_bytes(127, 6)) == 2
    assert ctas_per_sm(115_712) == 2 and ctas_per_sm(115_713) == 1
    monkeypatch.setattr(fl, "CLUSTER", 3)
    assert fl.smem_bytes(110, 5) == 126_020
    assert ctas_per_sm(fl.smem_bytes(110, 5)) == 1
    assert fl.ladder_mode(28, 2) == "slab"
    assert fl.ladder_mode(110, 5) == "stream"
    assert fl.smem_bytes(110, 5, "slab") == 419_920
    with pytest.raises(ValueError, match="mode"):
        fl.smem_bytes(28, 2, "tiles")
    spec = build_ladder(DetectionConfig(sigma0=1.6, octaves=6).octave_values)
    assert spec.radius == 220 and not fl.kernel_fits(spec.radius, 6)
    # a ladder beyond the gate takes the ladder route (detect.resolve_route),
    # on every device; so does float64
    assert build_detector(DetectionConfig(octaves=6), 2000,
                          device=resolve_device("cpu")).route == "ladder"
    assert build_detector(DetectionConfig(octaves=5), 2000,
                          device=resolve_device("cpu")).route == "kernel"
    det = build_detector(DetectionConfig(precision="float64"), 2000,
                         device=resolve_device("cpu"))
    assert det.route == "ladder" and det.taps.dtype == torch.float64


@pytest.mark.parametrize("octaves", [2, 3, 4])
def test_ladder_radii_are_the_sigmas_own(octaves):
    """The radii the kernel reads are scipy's radius of each blur sigma,
    whether the detector builds them with the taps or the wrapper derives
    them from the zero-padded taps alone."""
    spec = build_ladder(DetectionConfig(octaves=octaves).octave_values)
    taps = ladder_tensor(spec.kernels, torch.device("cpu"))
    want = [kernel_radius(s) for s in spec.blur_sigmas]
    got = fl.ladder_radii(taps, spec.radius)
    assert got.dtype == torch.int32
    assert got.tolist() == want
    built = radii_tensor(spec.blur_sigmas, torch.device("cpu"))
    assert built.dtype == torch.int32 and built.tolist() == want
