"""solves_per_s: scenarios x steps completed in the window over the
window's wall time (host clock) in the card-paced sweeps; the window ends
with a synchronize, and a sharded sweep's is its slowest rank's."""


def read(ctx):
    return ctx.stats.rate(ctx.B * ctx.window.units, ctx.window.wall_s)
