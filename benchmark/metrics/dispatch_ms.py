"""``dispatch_ms``: host time of queueing the batches on the device, the
``mesh.launch`` ranges (the ``detect.*`` or ``diff.*`` stages' launches,
the outputs' packing and the D2H enqueue), per call."""


def read(ctx):
    us = ctx["trace"].host_us("mesh.launch")
    return None if us is None else us / 1e3 / ctx["calls"]
