"""``device_idle_pct``: the share of the profiled calls' wall in which no
kernel or copy ran on the device."""


def read(ctx):
    tr = ctx["trace"]
    window = tr.window_us()
    if window <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / window)
