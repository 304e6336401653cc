"""kernel_host_ms.fleet: host milliseconds per tick inside the kernel wrappers'
``nmpc.kernel.*`` spans: their checks, allocations and ctypes launches."""

from portbench.yardstick import spans


def read(ctx):
    return spans.kernel_host_ms(ctx.trace)
