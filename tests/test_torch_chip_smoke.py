"""chip_smoke.py off the card: it refuses to run without CUDA, and its
golden comparisons, near-tie check, kernel bound, file writers, band
check, phase 8's plain kernel route and phase 12's golden and launch
counter behave as documented."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import torch_port_cases  # noqa: F401  (one torch thread per worker)


def test_exits_nonzero_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "cuda" in res.stderr.lower()


def test_golden_comparison():
    header, golden = chip_smoke.read_tsv(chip_smoke.GOLDEN)
    assert header.startswith("BIN1_CHR") and len(golden) == 290
    assert chip_smoke.compare_to_golden(golden, golden) == (290, 0.0)
    # a q inside the tolerance passes, one outside fails
    near = [r[:6] + [repr(float(r[6]) * (1 + 1e-4))] + r[7:] for r in golden]
    assert chip_smoke.compare_to_golden(near, golden)[0] == 290
    far = [list(r) for r in golden]
    far[5][6] = repr(float(far[5][6]) * (1 + 1e-3))
    with pytest.raises(SystemExit):
        chip_smoke.compare_to_golden(far, golden)
    # a missing row is allowed only when its q sits at pt
    with pytest.raises(SystemExit):
        chip_smoke.compare_to_golden(golden[1:], golden)
    at_pt = [list(golden[0])]
    at_pt[0][0] = "chrX"
    at_pt[0][6] = repr(chip_smoke.PT * (1 - 1e-5))
    assert chip_smoke.compare_to_golden(golden + at_pt, golden)[0] == 290


def test_oct5_golden_and_launch_counter():
    """Phase 12's golden (the JAX package at sigma0 1.6 -oc 5) is a
    reference-format TSV of the same chromosome, and ``counted`` records
    each call's fused launches from 0."""
    from mustache_tpu_torch.kernels import fused_ladder as fl

    header, golden = chip_smoke.read_tsv(chip_smoke.GOLDEN_OCT5)
    assert header == chip_smoke.read_tsv(chip_smoke.GOLDEN)[0]
    assert len(golden) == 290 and {r[0] for r in golden} == {"chr21"}
    assert chip_smoke.compare_to_golden(golden, golden) == (290, 0.0)

    def launch(n):
        fl.LAUNCHES += n
        return n
    saved = fl.LAUNCHES
    fl.LAUNCHES = 7
    try:
        run, counts = chip_smoke.counted(lambda: launch(len(counts) + 1))
        assert [run(), run(), run()] == [1, 2, 3]
        assert counts == [1, 2, 3]
    finally:
        fl.LAUNCHES = saved


def test_near_tie_margin():
    from mustache_tpu_torch.scalespace import build_ladder

    spec = build_ladder((1.6, 3.2))
    rng = np.random.default_rng(0)
    block = rng.standard_normal((64, 64)).astype(np.float32)
    m = chip_smoke.near_tie(block, 30, 40, spec)
    assert 0 < m < 1
    # a constant map ties everywhere
    assert chip_smoke.near_tie(np.ones((64, 64), np.float32), 30, 40,
                               spec) == 0


def test_kernel_bound_counts_the_ladder():
    """The FP32 bound chip_smoke reports: 392 nonzero taps of the default
    ladder, two passes, at each band cell of the real slots."""
    from mustache_tpu_torch.scalespace import build_ladder

    spec = build_ladder((1.6, 3.2))
    flop, nbytes, ms, by = chip_smoke.kernel_bound(spec, 2000, 512, 3)
    cells = 3 * sum(min(512, 2000 - i) for i in range(2000))
    assert cells == 3 * 893_184
    assert flop == 2 * 2 * 392 * cells and nbytes == 16 * cells
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flop / chip_smoke.FP32_FLOPS)
    _, _, ms_1kb, _ = chip_smoke.kernel_bound(spec, 4000, 2048, 3)
    assert round(ms, 4) == 0.0627 and round(ms_1kb, 3) == 0.428


def test_executed_fmas_count_the_kernel_geometry():
    """Phase 3's count of the FMAs the kernel's passes execute: by hand on
    a one-row-tile block, and at the 5 kb `-oc 5` shape the clusters'
    shared vertical pass executes fewer than the lone tiles' (never fewer
    than the band cells need)."""
    from mustache_tpu_torch.scalespace import build_ladder, kernel_radius

    spec = build_ladder((1.6, 3.2))
    t = [2 * kernel_radius(s) + 1 for s in spec.blur_sigmas]
    # N = 30, DB = 30: one row tile of one tile with cells
    horiz = 80 * 32 * sum(t)
    assert chip_smoke.executed_fmas(spec, 30, 30, 2, "slab", 1) == 2 * (
        horiz + 32 * sum((65 + k) * k for k in t))
    assert chip_smoke.executed_fmas(spec, 30, 30, 2, "stream", 4) == 2 * (
        horiz + 32 * sum((64 + 1 + k) * k for k in t))
    oct5 = build_ladder((1.6, 3.2, 6.4, 12.8, 25.6))
    need = chip_smoke.kernel_bound(oct5, 2000, 512, 3)[0] / 2
    slab = chip_smoke.executed_fmas(oct5, 2000, 512, 3, "slab", 1) / need
    stream = chip_smoke.executed_fmas(oct5, 2000, 512, 3, "stream", 4) / need
    assert 1 < stream < slab
    assert round(slab, 3) == 2.429 and round(stream, 3) == 1.717


def test_phase5_writers_read_back(tmp_path):
    """The text and .hic files phase 5 writes read back through the port's
    readers to the same COO (text exactly, in file order; .hic with counts
    rounded to f32, as the format stores them)."""
    from mustache_tpu_torch.io.hic import read_hic_file
    from mustache_tpu_torch.io.text import read_text_contacts
    from synthetic import synthetic_hic

    x, y, v, _ = synthetic_hic(700, 80, seed=4, n_loops=10)
    assert np.any(v != np.floor(v))             # loop pixels: 17 digits
    txt, hic = str(tmp_path / "c.txt"), str(tmp_path / "c.hic")
    chip_smoke.write_text_contacts(txt, x, y, v, 5000, "chr21")
    chip_smoke.write_hic_contacts(hic, x, y, v, 5000, "chr21", 700)
    got = read_text_contacts(txt, 2_000_000, False, "chr21", 5000)
    for g, w in zip(got, (x, y, v)):
        np.testing.assert_array_equal(g, w)
    X, Y, V = read_hic_file(hic, False, False, 2_000_000, "chr21", "chr21",
                            5000)
    order = np.lexsort((Y, X))
    np.testing.assert_array_equal(X[order], x)
    np.testing.assert_array_equal(Y[order], y)
    np.testing.assert_array_equal(V[order],
                                  v.astype(np.float32).astype(np.float64))


def test_phase6_band_check_catches_one_cell():
    import torch

    band = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    chip_smoke.check_band_equal(band, band.clone(), "same")
    other = band.clone()
    other[2, 3] = torch.nextafter(other[2, 3], torch.tensor(1e9))
    with pytest.raises(SystemExit):
        chip_smoke.check_band_equal(other, band, "one cell")
    with pytest.raises(SystemExit):
        chip_smoke.check_band_equal(band[:3], band, "shape")


def test_cli_events_and_timers():
    """The JSON-log reader phases 5 and 6 use: one event of a kind, or
    fail."""
    events = [{"event": "ingest", "seconds": 1.5},
              {"event": "detect", "seconds": 2.0},
              {"event": "detect", "seconds": 2.5}]
    assert chip_smoke.event(events, "ingest")["seconds"] == 1.5
    with pytest.raises(SystemExit):
        chip_smoke.event(events, "detect")
    with pytest.raises(SystemExit):
        chip_smoke.event(events, "throughput")
    calls = []
    ms = chip_smoke.host_ms(lambda: calls.append(1), reps=3)
    assert len(calls) == 4 and ms >= 0


def test_trace_device_time(tmp_path):
    """Device time by category and the top kernels from a Chrome trace as
    torch.profiler writes it; host events are not counted."""
    import json

    events = [{"cat": "kernel", "name": "k1", "dur": 1500},
              {"cat": "kernel", "name": "k2", "dur": 250},
              {"cat": "kernel", "name": "k1", "dur": 500},
              {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 100},
              {"cat": "cpu_op", "name": "aten::add", "dur": 9999}]
    (tmp_path / "a.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    (tmp_path / "notes.txt").write_text("not a trace")
    by_cat, top = chip_smoke.trace_device_time(str(tmp_path))
    assert by_cat == {"kernel": 2.25, "gpu_memcpy": 0.1}
    assert top == [("k1", 2.0, 2), ("k2", 0.25, 1)]


def test_diff_golden_comparison():
    """Per tag as the single-map comparison; a differential row on one
    side only passes only where the tie check says so."""
    header, golden = chip_smoke.read_tsv(chip_smoke.GOLDEN_DIFF)
    assert header.rstrip("\n").endswith("\tTAG") and len(golden) == 1099
    assert {r[8] for r in golden} == set("1234")
    assert chip_smoke.compare_diff_to_golden(golden, golden,
                                             lambda r: False) == (1099, 0.0)
    i = next(k for k, r in enumerate(golden) if r[8] == "2"
             and not chip_smoke.math.isclose(float(r[6]), chip_smoke.PT,
                                             rel_tol=chip_smoke.RTOL))
    fewer = golden[:i] + golden[i + 1:]
    seen = []
    assert chip_smoke.compare_diff_to_golden(
        fewer, golden, lambda r: seen.append(r) or True)[0] == 1098
    assert seen == [golden[i]]
    with pytest.raises(SystemExit):
        chip_smoke.compare_diff_to_golden(fewer, golden, lambda r: False)
    # a loop row (tag 1) never passes by the tie check
    j = next(k for k, r in enumerate(golden) if r[8] == "1"
             and float(r[6]) < 0.05)
    with pytest.raises(SystemExit):
        chip_smoke.compare_diff_to_golden(golden[:j] + golden[j + 1:],
                                          golden, lambda r: True)


def test_diff_near_tie():
    pt2 = chip_smoke.PT2
    assert chip_smoke.diff_near_tie(pt2 * (1 + 1e-3), 1.0, 0.5)
    assert not chip_smoke.diff_near_tie(pt2 * 0.9, 1.0, 0.5)
    assert chip_smoke.diff_near_tie(0.01, 0.5, 0.5 * (1 + 1e-4))
    assert not chip_smoke.diff_near_tie(0.01, 0.5, 0.5 * (1 + 1e-3))


def test_diff_tie_reads_the_port_block():
    """The tie check re-detects the row's block on the CPU and finds the
    port's call at its pixel; a row outside every block is no tie."""
    import types

    import torch

    from mustache_tpu_torch import DetectionConfig
    from mustache_tpu_torch.detect import unpack_block
    from mustache_tpu_torch.diff import _finish_map, build_diff_detector
    from mustache_tpu_torch.pipeline import local_runner
    from synthetic import synthetic_hic

    x1, y1, v1, _ = synthetic_hic(900, 100, seed=62, n_loops=15)
    x2, y2, v2, _ = synthetic_hic(900, 100, seed=82, n_loops=15)
    cfg = DetectionConfig(resolution=5000, distance_bp=500_000, pt=0.2,
                          st=0.6, pt2=0.2)
    cpu = torch.device("cpu")
    b1, b2, n = chip_smoke.diff_bands(x1, y1, v1, x2, y2, v2, cfg,
                                      local_runner(cpu))
    det = build_diff_detector(cfg, cfg.chunk_size, device=cpu)
    packed = det.fn_band_packed(b1, b2, [0])         # the one block
    calls = []

    def fn_band_packed(band1, band2, starts):
        calls.append(starts)
        return packed
    spy = types.SimpleNamespace(n=det.n, out_spec=det.out_spec,
                                spec=det.spec, fn_band_packed=fn_band_packed)
    _, rows = _finish_map(unpack_block(det.out_spec, packed.numpy()[0]), "1",
                          start=0, spec=det.spec)
    x, y, q, sigma = rows[0][0]
    row = chip_smoke.diff_tsv_rows([(x, y, q, sigma, 2)], "chr1",
                                   cfg.resolution)[0]
    tie = chip_smoke.make_diff_tie(spy, b1, b2, [0], cfg.resolution)
    said = []
    orig = chip_smoke.say
    chip_smoke.say = said.append
    try:
        assert tie(row) is chip_smoke.diff_near_tie(*rows[0][1])
        assert tie(["chr1", "99995000", "", "chr1", "99999000"] + row[5:]) \
            is False
    finally:
        chip_smoke.say = orig
    assert calls == [[0]]
    assert len(said) == 1 and "port pair" in said[0]


def test_trace_range_time(tmp_path):
    """Kernels count for the range whose CPU span holds their launch,
    matched by correlation id; kernels launched elsewhere, other ranges
    and the GPU-side annotation spans count for nothing."""
    import json

    events = [
        {"cat": "user_annotation", "name": "diff.planes", "ts": 100, "dur": 50},
        {"cat": "user_annotation", "name": "other", "ts": 200, "dur": 50},
        {"cat": "gpu_user_annotation", "name": "diff.planes", "ts": 100,
         "dur": 900, "args": {}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110,
         "dur": 5, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 140,
         "dur": 5, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 210,
         "dur": 5, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "k1", "ts": 500, "dur": 1500,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k2", "ts": 700, "dur": 250,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k3", "ts": 900, "dur": 4000,
         "args": {"correlation": 3}},
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke.trace_range_time(str(tmp_path),
                                      ("diff.planes", "diff.epilogue"))
    assert got == {"diff.planes": 1.75, "diff.epilogue": 0.0}


def test_phase8_helpers():
    """Phase 8's float64 row check, its TSV rows of loops, and the plain
    kernel route (a check only) that it restores afterwards."""
    import torch

    import mustache_tpu_torch.detect as D
    from mustache_tpu_torch import DetectionConfig, write_loops
    from mustache_tpu_torch.kernels import fused_ladder as fl
    from mustache_tpu_torch.pipeline import Loop
    from mustache_tpu_torch.scalespace import build_ladder, ladder_tensor

    _, golden = chip_smoke.read_tsv(chip_smoke.GOLDEN_F64)
    assert len(golden) == 290
    assert chip_smoke.compare_exact(golden, golden, "same") == 0.0
    off = [r[:6] + [repr(float(r[6]) * (1 + 1e-8))] + r[7:] for r in golden]
    with pytest.raises(SystemExit):
        chip_smoke.compare_exact(off, golden, "q")
    assert chip_smoke.compare_exact(off, golden, "q", rtol=1e-7) > 0
    with pytest.raises(SystemExit):
        chip_smoke.compare_exact(golden[1:], golden, "rows")

    loops = [Loop(10, 30, 1.25e-05, 2.111212657236631), Loop(7, 9, 0.5, 1.0)]
    path = os.path.join(chip_smoke.tempfile.mkdtemp(), "l.tsv")
    write_loops(path, [("chr1", "chr1", 5000, loops)])
    assert chip_smoke.loops_tsv_rows(loops, "chr1", 5000) == \
        chip_smoke.read_tsv(path)[1]

    cfg = DetectionConfig(octaves=6)          # phase 8 (f): R=220
    assert D.resolve_route(cfg) == "ladder"
    spec = build_ladder((1.6, 3.2))
    taps = ladder_tensor(spec.kernels, torch.device("cpu"))
    cs = torch.rand(1, 96, 96)
    nzf = (cs > 0.5).float()
    kw = dict(R=spec.radius, n_octaves=2, planes_per_octave=9, DB=32)
    saved = D.resolve_route, fl.fused_ladder_nms_batched
    with chip_smoke.plain_kernel_route():
        assert D.resolve_route(cfg) == "kernel"
        got = fl.fused_ladder_nms_batched(cs, nzf, taps, radii=None, **kw)
    assert (D.resolve_route, fl.fused_ladder_nms_batched) == saved
    want = fl.fused_ladder_nms_reference(cs, nzf, taps, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # phase 3's streamed mode on a slab-mode ladder, and back
    with chip_smoke.streamed_mode():
        assert fl.ladder_mode(spec.radius, 2) == "stream"
        assert fl.smem_bytes(spec.radius, 2) == fl.smem_bytes(
            spec.radius, 2, "stream")
    assert fl.ladder_mode(spec.radius, 2) == "slab"


def test_inter_golden_comparison():
    """Phase 9's rule: rows in order with anchors and scales exact, q
    within rtol 2e-4; a row on one side only passes only at pt."""
    header, golden = chip_smoke.read_tsv(chip_smoke.GOLDEN_INTER)
    assert header.startswith("BIN1_CHR") and len(golden) == 280
    assert {(r[0], r[3]) for r in golden} == {("chr21", "chr22")}
    assert chip_smoke.compare_inter(golden, golden) == (280, 0.0, 0.0)

    def scaled(rows, i, f):
        out = [list(r) for r in rows]
        out[i][6] = repr(float(out[i][6]) * f)
        return out
    n, q_err, lq_err = chip_smoke.compare_inter(
        scaled(golden, 7, 1 + 1.5e-4), golden)
    assert n == 280 and 1.4e-4 < q_err < 1.6e-4 and lq_err > 0
    with pytest.raises(SystemExit):
        chip_smoke.compare_inter(scaled(golden, 7, 1 + 2.5e-4), golden)
    with pytest.raises(SystemExit):
        chip_smoke.compare_inter(golden[1:], golden)
    with pytest.raises(SystemExit):
        chip_smoke.compare_inter([golden[1], golden[0]] + golden[2:], golden)
    moved = [list(r) for r in golden]
    moved[3][7] = "9.9"
    with pytest.raises(SystemExit):
        chip_smoke.compare_inter(moved, golden)
    at_pt = [list(golden[0])]
    at_pt[0][1] = "0"
    at_pt[0][6] = repr(chip_smoke.INTER_PT * (1 - 1e-5))
    assert chip_smoke.compare_inter(golden + at_pt, golden)[0] == 280


def test_inter_rows_and_pair_file(tmp_path):
    """Phase 9's TSV fields match the CLI's, and its two-chromosome .hic
    reads back through the port's reader (inter rectangle and intra
    map)."""
    from mustache_tpu_torch.io.hic import read_hic_file
    from mustache_tpu_torch.pipeline import Loop
    from synthetic import synthetic_hic, synthetic_inter

    rows = [[3, 7, 1.5e-20, 2.111212657236631], [10, 2, 0.04, 1.6]]
    want = [Loop(*r).to_row("c1", "c2", 5000).rstrip("\n").split("\t")
            for r in rows]
    assert chip_smoke.inter_tsv_rows(rows, "c1", "c2", 5000) == want

    xi, yi, vi, _ = synthetic_inter(120, 90, seed=3, n_loops=2)
    xa, ya, va, _ = synthetic_hic(120, 20, seed=4)
    path = str(tmp_path / "pair.hic")
    chip_smoke.write_hic_pairs(path, 120, 90, (xa, ya, va), (xi, yi, vi))
    X, Y, V = read_hic_file(path, False, False, 2_000_000, "c1", "c2", 5000)
    got = sorted(zip(X.tolist(), Y.tolist(), V.tolist()))
    assert got == sorted(zip(xi.tolist(), yi.tolist(),
                             vi.astype(np.float32).astype(float).tolist()))
    X, _, _ = read_hic_file(path, False, False, 2_000_000, "c1", "c1", 5000)
    assert len(X) > 0


def test_anchor_census():
    rows = [[10, 10, 1e-20, 2.0], [52, 48, 1e-19, 2.0], [54, 49, 1e-19, 2.0],
            [300, 300, 1e-20, 2.0]]
    anchors = [(11, 9), (50, 50), (127, 200), (400, 10)]
    got = chip_smoke.anchor_census(rows, anchors, [128], [500])
    assert got == {"anchors": 4, "recovered": 2, "missed": 2,
                   "missed_at_a_cut": 1, "rows_near_no_anchor": 2,
                   "row_pairs_within_3": 1}


def test_phase10_q_distance_and_rowshard_golden():
    """Phase 10's row check: keys in order or a failure, else the largest
    relative q distance; and the JAX rowshard golden reads as phase 4's
    golden does, within rtol 5e-3 of it on the same rows."""
    key, q = (lambda r: r[:2]), (lambda r: r[2])
    base = [(1, 2, 0.01), (3, 4, 0.02)]
    assert chip_smoke.q_distance(base, base, key, q) == 0.0
    moved = [(1, 2, 0.0101), (3, 4, 0.02)]
    assert chip_smoke.q_distance(moved, base, key, q) == pytest.approx(0.01)
    with pytest.raises(SystemExit):
        chip_smoke.q_distance(base[:1], base, key, q)
    header, rs = chip_smoke.read_tsv(chip_smoke.GOLDEN_ROWSHARD)
    _, golden = chip_smoke.read_tsv(chip_smoke.GOLDEN)
    assert header.startswith("BIN1_CHR") and len(rs) > 250
    common = {tuple(r[:6]): r for r in golden}
    shared = [(r, common[tuple(r[:6])]) for r in rs if tuple(r[:6]) in common]
    assert len(shared) >= len(rs) - 2
    for r, g in shared:
        assert r[7] == g[7]
        assert float(r[6]) == pytest.approx(float(g[6]),
                                            rel=chip_smoke.RTOL_ROWSHARD)


def test_phase10_two_process_cli_stops_its_processes(tmp_path):
    """The two-process launcher returns each process's exit code, wall
    and output; here, without a card, both stop at once with an error."""
    rcs, walls, outs = chip_smoke.two_process_cli(
        str(tmp_path / "missing.hic"), str(tmp_path / "o.tsv"),
        {"CUDA_VISIBLE_DEVICES": ""})
    assert rcs == [1, 1] and len(walls) == 2 and walls[0] <= walls[1]
    assert all("cuda" in o.lower() for o in outs)
    assert chip_smoke.CLI3[0][0] == "c0" and len(chip_smoke.CLI3) == 3
