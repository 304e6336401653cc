"""fleet_solves_per_s: scenarios x ticks completed in the window over the
window's wall time (host clock), in the host-paced cells, where every tick
ends with its u0 on the host."""


def read(ctx):
    return ctx.stats.rate(ctx.B * ctx.window.units, ctx.window.wall_s)
