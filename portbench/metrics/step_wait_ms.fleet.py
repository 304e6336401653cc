"""step_wait_ms.fleet: host milliseconds per tick in blocking calls (a synchronize,
a ``cudaMemcpy*``) inside ``nmpc.step``: the step waiting for the card."""

from portbench.yardstick import spans


def read(ctx):
    return spans.step_wait_ms(ctx.trace)
