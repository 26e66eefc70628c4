"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``.

Each has ``read(ctx) -> float | None``. ``ctx`` holds ``trace`` (a
``harness.trace.Trace`` of the profiled calls), ``calls`` (how many),
``fused_flop`` and ``fused_bytes`` (what the fused kernel needs per call,
``harness/flops.py``) and whatever the traffic kind logged beside the
trace (the CLI's ``runlog`` events). A reader that finds nothing to read
returns None, and the metric is left out of the result line. Times are
means per call.
"""
