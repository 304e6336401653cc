"""step_mfu.sweep: the step's counted operations (SDF rows, condensing, the
f64 Gram product, the QP), each part's over the peak of the unit it runs
on, over the window's wall time per step."""


def read(ctx):
    w = ctx.window
    if not w.units:
        return None
    return 100.0 * ctx.counts.step_peak_s(ctx.conf, ctx.B_card, "steady") / (w.wall_s / w.units)
