"""host_issue_ms.fleet: host milliseconds from each tick's step call to its
return, before the tick's read-back, averaged over the window's ticks."""


def read(ctx):
    s = ctx.window.issue_s
    return 1e3 * sum(s) / len(s) if s else None
