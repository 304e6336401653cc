"""idle_share.sweep: the share of the profiled steady window in which no
operation ran on the device (the union of the trace's device intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return 100.0 * ctx.trace.idle_share()
