"""``finish_ms``: host time of the finish (regrow, clustering, ownership),
the ``pipeline.finish`` range, per call."""


def read(ctx):
    us = ctx["trace"].host_us("pipeline.finish")
    return None if us is None else us / 1e3 / ctx["calls"]
