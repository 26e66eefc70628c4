"""``upload_fill_ms``: host time of the band upload's host fill (the
band's allocation, the native fills, the u4 pack and the exception
list), the ``upload.fill`` ranges, per call."""


def read(ctx):
    us = ctx["trace"].host_us("upload.fill")
    return None if us is None else us / 1e3 / ctx["calls"]
