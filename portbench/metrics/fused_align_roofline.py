"""K2 (fused alignment, ``fused_align_*_kernel``): the least time its bytes
need at the card's memory rate, over the median device time of one launch
in the profiled slice. Every launch aligns one batch of the configuration's
batch size."""

import statistics


def read(ctx):
    tr = ctx.trace
    runs = tr.named("fused_align_") if tr is not None else []
    if not runs:
        return None
    c = ctx.counts
    bound = c.bound_seconds(nbytes=c.k2_bytes(ctx.cfg["batch_size"],
                                              ctx.cfg["n_atoms"]))
    return 100.0 * bound / (statistics.median(e.dur_us for e in runs) * 1e-6)
