"""``upload_census_ms``: host time of the band upload's value census, the
``upload.census`` ranges inside ``pipeline.upload``, per call."""


def read(ctx):
    us = ctx["trace"].host_us("upload.census")
    return None if us is None else us / 1e3 / ctx["calls"]
