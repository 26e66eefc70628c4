"""``diff_planes_ms``: device time of the kernels launched inside the
``diff.planes`` range (the difference planes), by launch correlation, per
call."""


def read(ctx):
    us = ctx["trace"].range_device_us("diff.planes")
    return None if us is None else us / 1e3 / ctx["calls"]
