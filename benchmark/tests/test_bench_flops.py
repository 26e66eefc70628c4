"""The benchmark's count of the fused kernel's work against the kernel
table's (PERF.md): 4.20 GFLOP at N=2000, DB=512 for B=4 with one pad
slot, and 152.9 GFLOP at N=4000, DB=2048 for B=16."""

import pytest

from benchmark.harness import flops


def test_kernel_table_counts():
    f, b = flops.fused_ladder_work(2000, 512, 1.6, 2, 3)
    assert f / 1e9 == pytest.approx(4.2015, abs=1e-4)
    assert flops.bound_seconds(f, b) * 1e3 == pytest.approx(0.0627, abs=1e-4)
    f, b = flops.fused_ladder_work(4000, 2048, 1.6, 2, 16)
    assert f / 1e9 == pytest.approx(152.93, abs=1e-2)
    assert flops.bound_seconds(f, b) * 1e3 == pytest.approx(2.2826, abs=1e-4)


def test_band_geometry():
    assert flops.band_diagonals(2000, 400) == 512
    assert flops.band_diagonals(4000, 2000) == 2048
    assert flops.band_cells(5, 2) == 2 + 2 + 2 + 2 + 1
    assert flops.kernel_radius(1.6) == 4
