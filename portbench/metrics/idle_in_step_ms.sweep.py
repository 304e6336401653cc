"""idle_in_step_ms.sweep: device idle milliseconds per step in the gaps whose
midpoint lies inside an ``nmpc.step``, in rank 0's profiled window; the rest of the idle
time falls in the traffic driver and the plant."""

from portbench.yardstick import spans


def read(ctx):
    return spans.idle_in_step_ms(ctx.trace)
