"""Training samples stepped on per second: every train batch's samples of
every call in the window (every replica's, in a sweep), over the window's
wall time, test batches and fetches included in the time."""


def read(ctx):
    if not ctx.calls or ctx.window_s <= 0:
        return None
    return ctx.samples / ctx.window_s
