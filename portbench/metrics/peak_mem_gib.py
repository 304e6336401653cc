"""peak_mem_gib: torch.cuda.max_memory_allocated over the set-up's end and
the window (the peak statistics are reset just before the window)."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes > 0 else None
