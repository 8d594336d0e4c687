"""Share of the sweep calls' wall time outside the sweep's own device window
(``parallel.ensemble.last_run_seconds``, the program's host timer of its
replayed epochs and its one fetch): the building of the inputs and of the
R results around it."""


def read(ctx):
    spans = [c["program_s"] for c in ctx.calls if c.get("program_s")]
    if not spans:
        return None
    wall = sum(c["wall_s"] for c in ctx.calls if c.get("program_s"))
    return 100.0 * (1.0 - sum(spans) / wall)
