"""``ingest_ms``: the CLI's ``ingest`` phase per chromosome, from its JSON
phase log (``RunLog``). The next chromosome's ingest runs beside this
one's detect, so this is busy time, not time the call waits."""


def read(ctx):
    secs = [e["seconds"] for e in ctx.get("runlog", [])
            if e.get("event") == "ingest" and "seconds" in e]
    return None if not secs else 1e3 * sum(secs) / len(secs)
