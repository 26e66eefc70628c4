"""``hic_decode_ms``: the ``.hic`` reader's native block decode, the mean
duration of a ``hic.decode`` range (one a chromosome). Ranges of the
CLI's prefetch thread count only where the profiler records that
thread."""


def read(ctx):
    spans = ctx["trace"].ranges.get("hic.decode")
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / len(spans)
