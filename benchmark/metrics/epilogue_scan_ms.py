"""``epilogue_scan_ms``: device time of the kernels launched inside the
``detect.scan`` ranges (the epilogue's int32 prefix sums: the support's
column sums, count-mode BH's marks and rank histogram), by launch
correlation, per call. ``epilogue_ms`` holds them too."""


def read(ctx):
    us = ctx["trace"].range_device_us("detect.scan")
    return None if us is None else us / 1e3 / ctx["calls"]
