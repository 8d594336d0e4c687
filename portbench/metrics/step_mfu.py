"""The whole step's share of the card's float32 peak: the model operations
per training sample (``counts.model_flops_per_sample``, the same whatever
implements them) times the window's samples per second, over 67 TFLOP/s."""


def read(ctx):
    if not ctx.calls or ctx.window_s <= 0:
        return None
    flops = ctx.counts.model_flops_per_sample(ctx.cfg)
    rate = ctx.samples / ctx.window_s
    return 100.0 * flops * rate / ctx.counts.PEAKS["f32_flops_per_s"]
