"""``collect_wait_ms``: host time spent waiting for the batches' D2H
copies, the ``mesh.collect`` ranges, per call."""


def read(ctx):
    us = ctx["trace"].host_us("mesh.collect")
    return None if us is None else us / 1e3 / ctx["calls"]
