"""step_wait_ms.sweep: host milliseconds per step in blocking calls (a synchronize,
a ``cudaMemcpy*``) inside ``nmpc.step``, in rank 0's profiled window."""

from portbench.yardstick import spans


def read(ctx):
    return spans.step_wait_ms(ctx.trace)
