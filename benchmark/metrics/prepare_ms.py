"""``prepare_ms``: host time of an entry's set-up, the ``pipeline.prepare``
ranges (the COO coercion, the block grid, the detectors, the band's
shape, and after the band the batch size), per call."""


def read(ctx):
    us = ctx["trace"].host_us("pipeline.prepare")
    return None if us is None else us / 1e3 / ctx["calls"]
