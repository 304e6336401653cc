"""idle_in_step_ms.fleet: device idle milliseconds per tick in the gaps whose
midpoint lies inside an ``nmpc.step`` (the gaps as ``Trace.top_idle_gaps`` finds them)."""

from portbench.yardstick import spans


def read(ctx):
    return spans.idle_in_step_ms(ctx.trace)
