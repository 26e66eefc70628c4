"""``diff_finish_ms``: host time of the differential entry's per-block
finish (reruns, both conditions' clustering, ownership), the
``diff.finish`` ranges, per call."""


def read(ctx):
    us = ctx["trace"].host_us("diff.finish")
    return None if us is None else us / 1e3 / ctx["calls"]
