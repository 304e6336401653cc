"""step_launches.fleet: kernel launches, copies and fills the host issues inside
``nmpc.step`` per tick."""

from portbench.yardstick import spans


def read(ctx):
    return spans.step_launches(ctx.trace)
