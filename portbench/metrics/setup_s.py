"""setup_s: host seconds from the process's start to the window's first
unit: imports, the kernels' build where the checkout has none, the
weights, the program's construction, the cold step and the warm-up."""


def read(ctx):
    return ctx.setup_s
