"""``normalize_ms``: device time of the kernels launched inside the
``pipeline.normalize`` range, the device normalize of ``bandnorm``, by launch
correlation, per call."""


def read(ctx):
    us = ctx["trace"].range_device_us("pipeline.normalize")
    return None if us is None else us / 1e3 / ctx["calls"]
