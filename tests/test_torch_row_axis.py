"""The mesh's row axis in the port (``make_mesh(n_block, n_row > 1)``): the
dense runner splits each block's rows over its group's entries through
the row-window launch of the fused kernel (its plain version here) and
joins them on the group's owner.

* against the JAX package's 4 x 2 mesh on the 8 blocks of
  ``tests/test_sharding.py::test_sharded_equals_unsharded`` (the
  committed golden of ``tools/make_torch_golden.py --slice rowaxis``):
  the candidate sets ``(x, y, sigidx)`` identical, log q within rtol 2e-4;
* against the port's own ``n_row = 1``: bit-identical on the kernel route
  (4 x 2, 2 x 4, 8 x 1; a 1 x 3 mesh whose first part is one row tile
  under a halo of 56 rows; a partial batch of 3 blocks), within rtol 1e-9
  on the ladder route at float64;
* the windowed plain kernel against the whole-block call, part by part;
* the band-resident pipeline on a 2 x 2 runner: the 2 x 1 runner's rows.

Meshes are of repeated ``"cpu"`` entries."""

import numpy as np
import pytest
import torch

import torch_port_cases as C
from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.detect import _preamble, build_detector
from mustache_tpu_torch.kernels import fused_ladder as fl
from mustache_tpu_torch.pipeline import detect_loops_coo
from mustache_tpu_torch.scalespace import build_ladder, ladder_tensor
from mustache_tpu_torch.sharding import make_mesh, make_runner
from synthetic import synthetic_hic

CPU = torch.device("cpu")


def _cfg(precision="float32", **kw):
    return DetectionConfig(precision=precision, **dict(C.ROWAXIS_KW, **kw))


def _run(cfg, n_block, n_row, blocks, n=C.ROWAXIS_N):
    runner = make_runner(make_mesh(n_block, n_row,
                                   devices=["cpu"] * (n_block * n_row)))
    dets = runner.per_device(lambda d: build_detector(cfg, n, device=d))
    return runner(dets, blocks), runner


def _unsplit(cfg, blocks, n=C.ROWAXIS_N):
    det = build_detector(cfg, n, device=CPU)
    return {k: a.numpy() for k, a in det.fn(torch.from_numpy(blocks)).items()}


@pytest.fixture(scope="module")
def blocks():
    return C.rowaxis_blocks()


@pytest.fixture(scope="module")
def one_row(blocks):
    return _unsplit(_cfg(), blocks)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.array_equal(got[k], w, equal_nan=w.dtype.kind == "f"), k


def test_row_axis_matches_jax_golden(blocks):
    """The JAX 4 x 2 runner's valid candidates (x, y, sigidx) on every
    block, log q within rtol 2e-4. On two blocks the two f32 paths test
    one cell apart (396/397 and 363/362): an f32 near tie in a cell's
    detection, which the float64 route decides once each way (396, 362),
    the same on ``n_row = 1``; BH's count then moves every log q there by
    log(397/396), so those blocks hold log q - log(n_tested), the part
    that the row split could move, to the same rtol."""
    gold = C.load_golden(C.GOLDEN_ROWAXIS)
    out, _ = _run(_cfg(), 4, 2, blocks)
    f64 = _unsplit(_cfg("float64"), blocks)["n_tested"]
    for b in range(blocks.shape[0]):
        ok = out["cand_valid"][b]
        got = {(int(x), int(y), int(s)): float(q) for x, y, s, q in zip(
            out["cand_x"][b][ok], out["cand_y"][b][ok],
            out["cand_sigidx"][b][ok], out["cand_logq"][b][ok])}
        want = {tuple(c[:3]): c[3] for c in gold[f"block{b}"]["cands"]}
        assert len(want) > 50 and set(got) == set(want), b
        n_got = int(out["n_tested"][b])
        n_want, sig_want, nz_want = gold[f"block{b}"]["counts"]
        assert (int(out["sig_count"][b]), int(out["nz_count"][b])) == \
            (sig_want, nz_want)
        keys = sorted(want)
        g = np.array([got[k] for k in keys])
        w = np.array([want[k] for k in keys])
        if n_got != n_want:
            assert abs(n_got - n_want) == 1 and f64[b] in (n_got, n_want)
            g, w = g - np.log(n_got), w - np.log(n_want)
        np.testing.assert_allclose(g, w, rtol=2e-4, err_msg=f"block {b}")


@pytest.mark.parametrize("n_block,n_row", [(4, 2), (2, 4), (8, 1)])
def test_row_axis_bit_identical_to_one_row(blocks, one_row, n_block, n_row):
    out, runner = _run(_cfg(), n_block, n_row, blocks)
    _assert_same(out, one_row)
    held = runner.last_held
    if n_row > 1:
        # every entry holds a window of its group's blocks, never a block
        per = blocks.shape[0] // n_block
        assert len(held) == n_block * n_row
        assert all(0 < h < per * blocks[0].nbytes for h in held)


def test_single_tile_part_under_a_wider_halo():
    """A 1 x 3 mesh over 128^2 blocks with the 4-octave ladder (R = 55):
    the first part is one row tile (30 rows) and its halo (56 rows) is
    wider than the part; the state and outputs stay bit-identical."""
    cfg = DetectionConfig(precision="float32", octaves=4,
                          **dict(C.ROWAXIS_KW, max_candidates=128))
    blocks = C.rowaxis_blocks(range(40, 42))[:, :128, :128].copy()
    spec = build_ladder(cfg.octave_values)
    assert fl.halo(spec.radius) > fl.TILE_ROWS
    assert fl.row_cuts(128, 3)[:2] == [0, 1]
    out, runner = _run(cfg, 1, 3, blocks, n=128)
    _assert_same(out, _unsplit(cfg, blocks, n=128))
    assert int(out["n_tested"].min()) > 0


def test_partial_batch_padded(blocks):
    """Three blocks on 4 x 2 entries: padded to four, the real blocks'
    outputs are ``fn``'s on the three."""
    three = blocks[:3].copy()
    out, _ = _run(_cfg(), 4, 2, three)
    assert out["cand_x"].shape[0] == 3
    _assert_same(out, _unsplit(_cfg(), three))


def test_ladder_route_float64_within_1e9(blocks):
    """The ladder route at float64 on 2 x 2 and 1 x 3: the best state is
    bit-identical; only the partial sums' order differs (each part sums
    its rows, the owner adds the parts), so log q is within rtol 1e-9 and
    every other output equal."""
    cfg = _cfg("float64")
    want = _unsplit(cfg, blocks[:4])
    for n_block, n_row in ((2, 2), (1, 3)):
        got, _ = _run(cfg, n_block, n_row, blocks[:4])
        for k, w in want.items():
            if k in ("cand_logq", "neigh_logq"):
                np.testing.assert_allclose(got[k], w, rtol=1e-9, err_msg=k)
            else:
                assert np.array_equal(got[k], w), k


@pytest.mark.parametrize("n,octaves,n_parts", [
    (256, (1.6, 3.2), 2), (256, (1.6, 3.2), 4), (241, (1.6, 3.2), 3),
    (128, (1.6, 3.2, 6.4, 12.8), 3),
    (256, (1.6, 3.2, 6.4, 12.8, 25.6), 4)])        # -oc 5: R=110
def test_windowed_plain_kernel_is_the_whole_call(blocks, n, octaves,
                                                  n_parts):
    """``fused_ladder_nms_reference`` on each row window equals the whole
    call restricted to its rows; the windows' per-tile partials, joined,
    are the whole call's."""
    spec = build_ladder(octaves)
    taps = ladder_tensor(spec.kernels, CPU)
    cs, nz = _preamble(torch.from_numpy(blocks[:2, :n, :n].copy()), 64)
    nzf = nz.float()
    R, DB = spec.radius, min(128, n)
    kw = dict(R=R, n_octaves=len(octaves), planes_per_octave=9, DB=DB)
    full = fl.fused_ladder_window(cs, nzf, taps, **kw)
    cuts = fl.row_cuts(n, n_parts)
    joined = []
    for lo, hi in zip(cuts, cuts[1:]):
        w0, w1 = fl.window_rows(n, lo, hi, R)
        win = dict(N=n, base=w0, t_lo=lo, t_hi=hi)
        part = fl.fused_ladder_window(cs[:, w0:w1], nzf[:, w0:w1], taps,
                                      **kw, **win)
        ref = fl.fused_ladder_nms_reference(cs[:, w0:w1], nzf[:, w0:w1],
                                            taps, **kw, **win)
        rows = slice(lo * fl.TILE_ROWS, min(hi * fl.TILE_ROWS, n))
        assert torch.equal(ref[0], full[0][:, rows])
        assert torch.equal(ref[1], full[1][:, rows])
        locs, sums = fl.reduce_parts(full[2][:, lo:hi], 9 * len(octaves))
        assert torch.equal(ref[2], locs) and torch.equal(ref[3], sums)
        joined.append(part)
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in joined], 1), full[i])


def test_window_must_hold_its_halo(blocks):
    spec = build_ladder((1.6, 3.2))
    cs = torch.zeros((1, 60, 256))
    with pytest.raises(ValueError, match="do not hold the window"):
        fl.fused_ladder_window(cs, cs, ladder_tensor(spec.kernels, CPU),
                               R=spec.radius, n_octaves=2,
                               planes_per_octave=9, DB=128, N=256, base=30,
                               t_lo=1, t_hi=3)


def test_pipeline_on_a_row_mesh_runs_on_the_owners():
    """``detect_loops_coo`` on a 2 x 2 runner: the 2 x 1 runner's rows
    (the band-resident path runs each group's share on its owner)."""
    (n, d_px), kw = C.F32_SHARD_MAP
    x, y, v = synthetic_hic(n, d_px, **kw)[:3]
    cfg = DetectionConfig(precision="float32", **C.F32_SHARD_KW)
    rows = []
    for n_row in (1, 2):
        runner = make_runner(make_mesh(2, n_row, devices=["cpu"] * 4))
        rows.append([(lp.bin1, lp.bin2, lp.q, lp.scale)
                     for lp in detect_loops_coo(x, y, v, cfg,
                                                runner=runner)])
    assert len(rows[0]) > 5 and rows[1] == rows[0]
