"""nccl_ms.sweep: device milliseconds of NCCL kernels per step in rank 0's
profiled window (BatchStats' all-reduces; a kernel's time includes its wait
for the slowest rank)."""

KERNELS = ("ncclDevKernel", "ncclKernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.kernel_s(KERNELS)
    return 1e3 * t / tr.units if t > 0 else None
