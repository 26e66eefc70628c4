"""``fused_ladder_roofline``: the least time the card could take for
the work the fused kernel needs (the benchmark's count,
``harness/flops.py``), as a share of the kernel's device time."""

from benchmark.harness.flops import bound_seconds
from benchmark.metrics.fused_ladder_ms import KERNEL


def read(ctx):
    us = ctx["trace"].kernel_us(KERNEL)
    if not us:
        return None
    per_call_s = us / 1e6 / ctx["calls"]
    return 100.0 * bound_seconds(ctx["fused_flop"],
                                 ctx["fused_bytes"]) / per_call_s
