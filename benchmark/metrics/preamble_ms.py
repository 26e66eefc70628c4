"""``preamble_ms``: device time of the kernels launched inside the
``detect.preamble`` range (slice, densify and sentinel), by launch correlation,
per call."""


def read(ctx):
    us = ctx["trace"].range_device_us("detect.preamble")
    return None if us is None else us / 1e3 / ctx["calls"]
