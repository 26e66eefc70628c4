"""``epilogue_ms``: device time of the kernels launched inside the
``detect.epilogue`` range (BH, filters and export), by launch correlation, per
call."""


def read(ctx):
    us = ctx["trace"].range_device_us("detect.epilogue")
    return None if us is None else us / 1e3 / ctx["calls"]
