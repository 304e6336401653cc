"""tick_mfu.fleet: the tick's counted operations (the step's SDF rows,
condensing, f64 Gram product and QP, and the encoder's convolutions where
the cell has them), each part's over the peak of the unit it runs on, over
the window's wall time per tick."""


def read(ctx):
    w = ctx.window
    if not w.units:
        return None
    t = ctx.counts.step_peak_s(ctx.conf, ctx.B_card, "steady")
    if "perception" in ctx.conf:
        t += ctx.counts.encoder_ops(ctx.conf, ctx.B_card) / ctx.peaks.FP32
    return 100.0 * t / (w.wall_s / w.units)
