"""Share of the pair distances the program's feature layer evaluated
through a grouped pair list (one evaluation for a run of bonds, K5 on the
card): the recorder's ``cvf.features.pairs_grouped`` over it plus
``cvf.features.pairs_single`` (lone bonds, each evaluated on its own),
over the whole process, replays included. None for a program without
those counters."""


def read(ctx):
    try:
        from colvarsfinder_tpu_torch import logging_utils
    except ImportError:
        return None
    counters = getattr(logging_utils, "counters", None)
    if counters is None:
        return None
    now = counters()
    grouped = now.get("cvf.features.pairs_grouped", 0)
    total = grouped + now.get("cvf.features.pairs_single", 0)
    return 100.0 * grouped / total if total else None
