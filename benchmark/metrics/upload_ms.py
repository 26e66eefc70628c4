"""``upload_ms``: host time of the band fill and streamed upload, the
``pipeline.upload`` range, per call."""


def read(ctx):
    us = ctx["trace"].host_us("pipeline.upload")
    return None if us is None else us / 1e3 / ctx["calls"]
