"""tick_ms_p95.host: the 95th percentile over all ticks of the window, each
timed from the end of the tick before it to its u0 on the host (host
clock).  Per layer: its spread between runs on the host-paced cells is too
wide for a bound (PERF.md)."""


def read(ctx):
    ticks = ctx.window.tick_s
    return 1e3 * ctx.stats.quantile(ticks, 0.95) if ticks else None
