"""Device activities (kernels, copies, fills) per train step in the
profiled slice, the test batches' and the fetch's included."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.steps <= 0:
        return None
    return len(tr.device) / tr.steps
