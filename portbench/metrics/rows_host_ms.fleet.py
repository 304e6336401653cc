"""rows_host_ms.fleet: host milliseconds per tick inside the step's linearization,
constraint-row and terminal-row stages (``nmpc.step.lin``, ``.rows``, ``.terminal``)."""

from portbench.yardstick import spans


def read(ctx):
    return spans.stages_host_ms(ctx.trace, spans.ROWS)
