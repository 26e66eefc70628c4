"""``fused_ladder_ms``: device time of the fused ladder/DoG/NMS kernel
(``fused_ladder_nms_kernel``), per call."""

KERNEL = "fused_ladder_nms"


def read(ctx):
    us = ctx["trace"].kernel_us(KERNEL)
    return None if us is None else us / 1e3 / ctx["calls"]
