"""``unnamed_ms``: host time inside the entries' ``pipeline.call`` or
``diff.call`` ranges that no narrower range of the program covers (the
pieces of ``Trace.innermost_segments`` named by a call range), per
call."""

CALLS = ("pipeline.call", "diff.call")


def read(ctx):
    tr = ctx["trace"]
    if not any(tr.ranges.get(name) for name in CALLS):
        return None
    us = sum(hi - lo for lo, hi, name in tr.innermost_segments()
             if name in CALLS)
    return us / 1e3 / ctx["calls"]
