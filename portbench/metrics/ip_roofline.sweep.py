"""ip_roofline.sweep: the least time of the steady budget's QP work (the
frozen count: nz, nc, k_stiff and the warm and stiff iterations from the
configuration file) over the profiler's device time of kernel 4 per step."""

KERNELS = ("ip_phase_kernel",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.kernel_s(KERNELS) / tr.units
    if not t > 0:
        return None
    return 100.0 * ctx.counts.qp_bound_s(ctx.conf, ctx.B_card, "steady") / t
