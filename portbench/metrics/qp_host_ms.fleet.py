"""qp_host_ms.fleet: host milliseconds per tick inside the step's condensing, Gram,
QP and update stages (``nmpc.step.condense``, ``.gram``, ``.qp``, ``.update``)."""

from portbench.yardstick import spans


def read(ctx):
    return spans.stages_host_ms(ctx.trace, spans.QP)
