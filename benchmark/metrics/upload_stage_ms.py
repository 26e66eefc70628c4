"""``upload_stage_ms``: host time of the band upload's staging (pinning,
the H2D enqueue, the exceptions' padding, copies to other mesh entries),
the ``upload.stage`` ranges, per call."""


def read(ctx):
    us = ctx["trace"].host_us("upload.stage")
    return None if us is None else us / 1e3 / ctx["calls"]
