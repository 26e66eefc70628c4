"""``launches_per_call``: kernels the device ran, per call."""


def read(ctx):
    n = len(ctx["trace"].kernels())
    return None if n == 0 else n / ctx["calls"]
