"""sdf_roofline.sweep: the least time of kernel 2's rows on its f32x3 route
(B N stage points, a primal and three tangent rows each; three TF32 passes)
over the profiler's device time of the kernel per step."""

KERNELS = ("sdf_fused_x3_kernel",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.kernel_s(KERNELS) / tr.units
    if not t > 0:
        return None
    return 100.0 * ctx.counts.sdf_bound_s(ctx.conf, ctx.B_card) / t
