"""``upload_refills_per_call``: band fills the upload made again, one
``upload.refill`` range each, per call: the one-pass fill's census picked
another encoding than unpacked u8, or the COO was not sorted by row. 0
where the trace holds the entries' ``pipeline.call`` or ``diff.call``
ranges and no refill; None where it holds neither (a program without
those ranges)."""

from benchmark.metrics.unnamed_ms import CALLS


def read(ctx):
    tr = ctx["trace"]
    if not any(tr.ranges.get(name) for name in CALLS):
        return None
    return len(tr.ranges.get("upload.refill", [])) / ctx["calls"]
