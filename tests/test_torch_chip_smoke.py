"""chip_smoke.py off the card: it refuses to run without CUDA, and its
golden comparison and near-tie check behave as documented."""

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
