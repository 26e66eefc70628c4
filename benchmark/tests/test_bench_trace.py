"""Launch correlation, busy and idle time and the breakdown, on a small
committed Chrome trace (``data/trace_fixture.json``: two calls of 1000
and 500 us; kernels of 50, 40, 100 and 100 us and a copy of 20 us)."""

from pathlib import Path

import pytest

from benchmark.harness.trace import Trace
from benchmark.harness import manifest

FIXTURE = Path(__file__).parent / "data" / "trace_fixture.json"


@pytest.fixture
def tr():
    return Trace.load(FIXTURE)


def test_ranges_by_launch(tr):
    assert tr.host_us("pipeline.upload") == 200
    assert tr.host_us("absent") is None
    # both kernels launched inside the normalize range, though they ran
    # after it closed
    assert tr.range_device_us("pipeline.normalize") == 90
    assert tr.range_device_us("detect.epilogue") == 100
    assert tr.range_device_us("pipeline.finish") == 0
    assert tr.range_device_us("absent") is None
    assert tr.kernel_us("fused_ladder_nms") == 200
    assert len(tr.kernels()) == 4


def test_busy_idle_and_breakdown(tr):
    assert tr.window_us() == 1500
    # the copy overlaps the kernel before it: 50 + 40 + 110 + 100
    assert tr.busy_us() == 300
    ops = dict(tr.top_device_ops())
    assert ops["fused_ladder_nms_kernel"] == pytest.approx(200e-6)
    # a gap is cut where a range opens or closes: the first call's first
    # gap (0-400 us) crosses the upload and the normalize, its last
    # (710-1000 us) the finish
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({
        "bench.call": 550e-6, "pipeline.finish": 250e-6,
        "pipeline.upload": 200e-6, "pipeline.normalize": 100e-6,
        "detect.epilogue": 100e-6})


def test_readers(tr):
    ctx = {"trace": tr, "calls": 2, "fused_flop": 4.2e9,
           "fused_bytes": 1.6e7}
    read = manifest.metric_reader
    assert read("upload_ms")(ctx) == pytest.approx(0.1)
    assert read("normalize_ms")(ctx) == pytest.approx(0.045)
    assert read("epilogue_ms")(ctx) == pytest.approx(0.05)
    assert read("fused_ladder_ms")(ctx) == pytest.approx(0.1)
    assert read("launches_per_call")(ctx) == 2
    assert read("device_idle_pct")(ctx) == pytest.approx(80.0)
    # 4.2 GFLOP at 67 TFLOP/s against 100 us a call
    assert read("fused_ladder_roofline")(ctx) == pytest.approx(
        100 * 4.2e9 / 67e12 / 100e-6)
    assert read("diff_planes_ms")(ctx) is None
    assert read("ingest_ms")(ctx) is None
    ctx["runlog"] = [{"event": "ingest", "seconds": 0.5},
                     {"event": "detect", "seconds": 0.2},
                     {"event": "ingest", "seconds": 0.3}]
    assert read("ingest_ms")(ctx) == pytest.approx(400.0)
