"""``diff_epilogue_ms``: device time of the kernels launched inside the
``diff.epilogue`` range (the two-condition epilogue), by launch correlation,
per call."""


def read(ctx):
    us = ctx["trace"].range_device_us("diff.epilogue")
    return None if us is None else us / 1e3 / ctx["calls"]
