"""encoder_roofline.fleet: the least time of the encoder's counted
operations (its convolutions and mean head, from the frame's shape) at the
FP32 peak (cuDNN with TF32 off), over ``encode_ms.fleet``."""


def read(ctx):
    ms = ctx.spans.get("encode_ms")
    if not ms or "perception" not in ctx.conf:
        return None
    t = sum(ms) / len(ms) / 1e3
    return 100.0 * ctx.counts.encoder_ops(ctx.conf, ctx.B) / ctx.peaks.FP32 / t
