"""chip_smoke.py off the card: it refuses to run without CUDA, and its
golden comparison, near-tie check, kernel bound, file writers and band
check behave as documented."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


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
