"""``regrows_per_call``: blocks detected again with a larger candidate
table, one ``pipeline.regrow`` range each, per call. 0 where the trace
holds the entries' ``pipeline.call`` or ``diff.call`` ranges and no
rerun; None where it holds neither (a program without those ranges)."""

from benchmark.metrics.unnamed_ms import CALLS


def read(ctx):
    tr = ctx["trace"]
    if not any(tr.ranges.get(name) for name in CALLS):
        return None
    return len(tr.ranges.get("pipeline.regrow", [])) / ctx["calls"]
