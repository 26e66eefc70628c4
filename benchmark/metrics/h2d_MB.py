"""``h2d_MB``: megabytes the band upload (``pipeline.upload``) handed to
the card per call, the band's slabs and its exception records: the
program's ``pipeline.H2D_BYTES`` counter over the profiled calls, as the
traffic kind logs it (``h2d_bytes``)."""


def read(ctx):
    b = ctx.get("h2d_bytes")
    return None if b is None else b / 1e6 / ctx["calls"]
