"""K3 (statistics forward, ``stats_fwd_kernel`` and the
``reduce_partials_kernel`` launched after it): the least time its
operations need at the float32 peak, over the median device time of one
launch in the profiled slice."""

import statistics


def read(ctx):
    runs = (ctx.trace.launches("stats_fwd_kernel", "reduce_partials_kernel")
            if ctx.trace is not None else [])
    if not runs:
        return None
    c, cfg = ctx.counts, ctx.cfg
    flops = c.k3_flops(cfg["batch_size"], cfg["k"], cfg["layer_dims"])
    return 100.0 * c.bound_seconds(flops=flops) / statistics.median(runs)
