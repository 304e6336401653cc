"""encode_ms.fleet: device milliseconds from CUDA events around the
harness's call into the program's preprocessing and encoder, averaged over
the window's ticks."""


def read(ctx):
    ms = ctx.spans.get("encode_ms")
    return sum(ms) / len(ms) if ms else None
