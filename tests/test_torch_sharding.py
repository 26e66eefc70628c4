"""The port's sharding (``mustache_tpu_torch.sharding``) on the CPU: meshes
of repeated ``"cpu"`` entries stand for several devices.

* the mesh's shape and its (block, row) grid order;
* ``RowShardPlan`` against the JAX package's on the same starts;
* the dense runner against ``BlockDetector.fn``, a partial batch padded:
  bit-identical;
* the replicate placement bit-identical to the unsharded run;
* the row-shard placement bit-identical to itself across 1, 2 and 4
  entries, and held to the JAX row-sharded runner on 4 virtual CPU devices
  (the committed golden of ``tools/make_torch_golden.py --slice cpu_f32``:
  anchors and scales exact, log q within rtol 2e-4); its regrow; its
  ``rowshard_band`` event;
* the differential pipeline under both placements.

A block of 2000^2 costs seconds on the CPU, so the maps have two blocks
and the runs are shared by the tests of the module."""

import numpy as np
import pytest
import torch

import torch_port_cases as C
from mustache_tpu.sharding import RowShardPlan as JaxPlan
from mustache_tpu_torch import pipeline, sharding
from mustache_tpu_torch.bandnorm import bucket_rows
from mustache_tpu_torch.config import DetectionConfig
from mustache_tpu_torch.detect import build_detector
from mustache_tpu_torch.diff import detect_diff_loops_coo
from mustache_tpu_torch.dryrun import _example_block
from mustache_tpu_torch.pipeline import detect_loops_coo
from mustache_tpu_torch.runlog import RunLog
from mustache_tpu_torch.sharding import (
    RowShardPlan, make_mesh, make_runner, shard_chromosomes,
)
from synthetic import synthetic_hic

CPU = torch.device("cpu")
CFG = DetectionConfig(precision="float32", **C.F32_SHARD_KW)


def _mesh(k):
    return make_mesh(devices=["cpu"] * k)


def _sig(loops):
    return [(lp.bin1, lp.bin2, lp.q, lp.scale) for lp in loops]


@pytest.fixture(scope="module")
def shard_map():
    (n, d_px), kw = C.F32_SHARD_MAP
    return synthetic_hic(n, d_px, **kw)[:3]


@pytest.fixture(scope="module")
def unsharded(shard_map):
    return detect_loops_coo(*shard_map, CFG, device="cpu")


@pytest.fixture(scope="module")
def rowshard(shard_map):
    """The row-shard runs on 1, 2 and 4 entries: k -> (rows, runner,
    log)."""
    out = {}
    for k in (1, 2, 4):
        log = RunLog(quiet=True)
        runner = make_runner(_mesh(k), "rowshard", log=log)
        out[k] = (detect_loops_coo(*shard_map, CFG, runner=runner), runner,
                  log)
    return out


def test_mesh_shapes(monkeypatch):
    mesh = _mesh(4)
    assert mesh.shape == {"block": 4, "row": 1}
    assert mesh.block_devices == [CPU] * 4
    assert make_mesh(n_block=2, devices=["cpu"] * 4).shape == \
        {"block": 2, "row": 1}
    # the JAX order: devices.reshape(n_block, n_row), owners in column 0
    # (four named cards stand in; nothing here touches them)
    monkeypatch.setattr(sharding, "resolve_device", torch.device)
    cards = [torch.device(f"cuda:{i}") for i in range(5)]
    grid = make_mesh(n_block=2, n_row=2, devices=cards)
    assert grid.shape == {"block": 2, "row": 2}
    assert grid.block_devices == [cards[0], cards[2]]
    assert grid.row_devices(1) == cards[2:4]
    assert make_runner(grid).launches == [0] * 4
    monkeypatch.undo()
    with pytest.raises(ValueError):
        make_mesh(n_block=5, devices=["cpu"] * 4)
    assert make_runner(mesh).nb == 4 and make_runner(mesh).round_batch(5) == 8
    with pytest.raises(ValueError):
        make_runner(mesh, "columns")
    # the default mesh is every visible CUDA device: none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


@pytest.mark.parametrize("starts,nd,Bl", [
    ([0, 600], 4, 1),
    (list(range(0, 9000, 1800)), 2, 2),
    (list(range(0, 7 * 1600, 1600)), 4, 1),
    ([0], 3, 2),
])
def test_rowshard_plan_matches_jax(starts, nd, Bl):
    got, want = RowShardPlan(starts, 2000, nd), JaxPlan(starts, 2000, nd)
    assert (got.c0, got.c1, got.per_chip, got.slab_rows) == \
        (want.c0, want.c1, want.per_chip, want.slab_rows)
    np.testing.assert_array_equal(got.r0, want.r0)
    for (gi, gs), (wi, ws) in zip(got.launches(Bl), want.launches(Bl),
                                  strict=True):
        assert gi == wi
        np.testing.assert_array_equal(gs, ws)
    band = np.arange((max(starts) + 2000) * 4, dtype=np.float32).reshape(
        -1, 4)
    stack = want.slab_stack(band)
    for i in range(nd):
        np.testing.assert_array_equal(got.slab(band, i), stack[i])


def test_dense_runner_matches_fn():
    """Three 256^2 blocks on two entries: the runner pads to four, and the
    real blocks' outputs equal ``fn`` on the three, bit for bit."""
    cfg = DetectionConfig(resolution=5000, distance_bp=64 * 5000,
                          max_candidates=128)
    blocks = np.stack([_example_block(256, 64, seed=s) for s in range(3)])
    runner = make_runner(_mesh(2))
    dets = runner.per_device(lambda d: build_detector(cfg, 256, device=d))
    assert dets[0] is dets[1]                     # one detector per device
    got = runner(dets, blocks)
    want = dets[0].fn(torch.from_numpy(blocks))
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        assert got[k].shape == w.shape, k
        assert np.array_equal(got[k], w, equal_nan=w.dtype.kind == "f"), k
    one = dets[0].fn_single(torch.from_numpy(blocks[1]))
    for k, a in one.items():
        assert np.array_equal(a.numpy(), want[k][1].numpy(),
                              equal_nan=a.dtype.is_floating_point), k


def test_replicate_bit_identical_to_unsharded(shard_map, unsharded):
    """Three entries, two blocks: each entry normalizes its own copy of
    the raw band, one entry stays idle, and the rows are the unsharded
    run's, q bit for bit."""
    logs = []
    runner = make_runner(_mesh(3))
    got = detect_loops_coo(*shard_map, CFG, runner=runner, log=logs.append)
    assert len(unsharded) > 5
    assert _sig(got) == _sig(unsharded)
    assert "mesh=3 placement=replicate" in logs[0] and "blocks=2 " in logs[0]


def test_rowshard_bit_identical_across_mesh_sizes(rowshard):
    rows = [_sig(rowshard[k][0]) for k in (1, 2, 4)]
    assert len(rows[0]) > 5
    assert rows[1] == rows[0] and rows[2] == rows[0]


def test_rowshard_matches_jax_rowshard(rowshard, unsharded):
    """The JAX row-sharded runner's rows (4 virtual CPU devices): anchors
    and scales exact, log q within rtol 2e-4; and the unsharded rows
    within the JAX dryrun's rtol 5e-3 (host vs device normalize)."""
    got = rowshard[4][0]
    want = C.load_golden(C.GOLDEN_F32)["rowshard_map"]
    assert [(lp.bin1, lp.bin2, lp.scale) for lp in got] == \
        [(r[0], r[1], r[3]) for r in want]
    np.testing.assert_allclose(np.log([lp.q for lp in got]),
                               np.log([r[2] for r in want]), rtol=2e-4)
    assert [(lp.bin1, lp.bin2, lp.scale) for lp in got] == \
        [(lp.bin1, lp.bin2, lp.scale) for lp in unsharded]
    np.testing.assert_allclose([lp.q for lp in got],
                               [lp.q for lp in unsharded], rtol=5e-3)


def test_rowshard_band_event(rowshard, shard_map):
    """Each entry holds its slab; the event reports the JAX fields, and
    the slab is smaller than the band."""
    _, runner, log = rowshard[4]
    ev = [e for e in log.events if e["event"] == "rowshard_band"]
    assert len(ev) == 1
    ev = ev[0]
    plan = runner.last_plan
    assert (plan.nd, plan.per_chip, plan.c0, plan.c1) == (4, 1, [0, 1, 2, 2],
                                                          [1, 2, 2, 2])
    n = int(max(shard_map[0].max(), shard_map[1].max())) + 1
    Dl = 128
    assert plan.slab_rows == bucket_rows(2000) < bucket_rows(n)
    slab_mb = round(plan.slab_rows * Dl * 4 / 1e6, 2)
    assert ev == dict(ev, chips=4, per_chip_mb=slab_mb,
                      total_mb=round(4 * plan.slab_rows * Dl * 4 / 1e6, 2),
                      replicated_mb=round(4 * bucket_rows(n) * Dl * 4 / 1e6,
                                          2))
    assert runner.last_band_event == {k: v for k, v in ev.items()
                                      if k not in ("t", "event")}


def test_rowshard_regrow(rowshard, shard_map, monkeypatch):
    """A candidate capacity of 16: each overflowing block is rerun on its
    own entry's slab at the next power of two, and the rows are the
    capacity-2048 run's."""
    built = []
    real = pipeline.build_detector

    def spy(cfg, n, *, device, max_candidates=None):
        built.append(max_candidates)
        return real(cfg, n, device=device, max_candidates=max_candidates)

    monkeypatch.setattr(pipeline, "build_detector", spy)
    got = detect_loops_coo(*shard_map, CFG.with_(max_candidates=16),
                           runner=make_runner(_mesh(2), "rowshard"))
    grown = [k for k in built if k is not None]
    assert grown and all(k > 16 and k & (k - 1) == 0 for k in grown)
    assert _sig(got) == _sig(rowshard[2][0])


@pytest.fixture(scope="module")
def diff_maps():
    (n, d_px), kw = C.F32_SHARD_MAP
    return (synthetic_hic(n, d_px, **kw)[:3]
            + synthetic_hic(n, d_px, **dict(kw, seed=kw["seed"] + 1))[:3])


def test_diff_under_both_placements(diff_maps):
    """Two entries: replicate gives the unsharded rows bit for bit;
    rowshard (a slab pair per entry, host normalize) the tags, anchors and
    scales exactly, q within rtol 5e-3; its event counts each condition's
    slabs."""
    cfg = CFG.with_(pt2=0.1)
    base = detect_diff_loops_coo(*diff_maps, cfg, device="cpu")
    rep = detect_diff_loops_coo(*diff_maps, cfg, runner=make_runner(_mesh(2)))
    log = RunLog(quiet=True)
    rs = detect_diff_loops_coo(*diff_maps, cfg,
                               runner=make_runner(_mesh(2), "rowshard", log))
    assert len(base) > 5 and {r[4] for r in base} >= {1, 3}
    assert rep == base
    assert [r[:2] + r[3:] for r in rs] == [r[:2] + r[3:] for r in base]
    np.testing.assert_allclose([r[2] for r in rs], [r[2] for r in base],
                               rtol=5e-3)
    assert [e["chips"] for e in log.events
            if e["event"] == "rowshard_band"] == [2, 2]


def test_shard_chromosomes():
    units = ["1", "2", "3", "4", "5"]
    parts = [shard_chromosomes(units, p, 2) for p in range(2)]
    assert parts == [["1", "3", "5"], ["2", "4"]]
    assert shard_chromosomes(units, 0, 1) == units
