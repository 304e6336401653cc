"""step_host_ms.fleet: host milliseconds inside the program's ``nmpc.step`` spans per
tick of the profiled window (``yardstick/spans.py``)."""

from portbench.yardstick import spans


def read(ctx):
    return spans.step_host_ms(ctx.trace)
