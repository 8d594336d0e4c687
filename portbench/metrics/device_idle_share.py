"""Share of the time in which no operation ran on the device, per train
step: 1 - (the union of the device activities' intervals in the profiled
slice, per train step) / (the unprofiled window's wall time per train
step). The profiler's own cost (it instruments every node of a replayed
graph, which lengthens each launch on the host) is kept out of the wall
time; the device times it records are the kernels' own."""


def read(ctx):
    tr = ctx.trace
    steps = sum(c["steps"] for c in ctx.calls)
    if tr is None or not tr.device or tr.steps <= 0 or steps <= 0:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.steps) / (ctx.window_s / steps))
