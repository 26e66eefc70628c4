"""``cumsum_ms``: device time of the kernels launched inside the
``bandnorm.cumsum`` ranges (the normalize's stacked float64 cumsum and
the copies that build its buffer), by launch correlation, per call."""


def read(ctx):
    us = ctx["trace"].range_device_us("bandnorm.cumsum")
    return None if us is None else us / 1e3 / ctx["calls"]
