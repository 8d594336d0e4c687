"""Seconds from the start of the run's process to the first timed call:
imports, the seeded inputs, the program's construction, its kernel builds
or loads, and the warm-up calls that capture what the window replays."""


def read(ctx):
    return ctx.setup_s
