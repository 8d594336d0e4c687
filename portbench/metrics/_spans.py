"""The program's own spans (``colvarsfinder_tpu_torch.logging_utils``) for
the readers of ``program_span`` metrics. Durations leave out the spans
recorded while a profiler was recording (``profiled``), which the profiler
stretches. A program without the span recorder reads None."""

from __future__ import annotations


def recorded():
    """Every span the program's recorder holds, or None without one."""
    try:
        from colvarsfinder_tpu_torch import logging_utils
    except ImportError:
        return None
    spans = getattr(logging_utils, "spans", None)
    return None if spans is None else spans()


def named(spans: list, name: str, profiled: bool = False) -> list:
    """The spans called ``name``, by start; the profiled ones only where
    ``profiled``."""
    return sorted((s for s in spans if s.name == name
                   and (profiled or not s.profiled)),
                  key=lambda s: s.start_ns)


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-9


def total_s(spans: list, name: str):
    """Summed seconds of the unprofiled spans ``name``; None if none."""
    found = named(spans, name)
    return sum(map(seconds, found)) if found else None


def apply(value):
    """``value(spans)`` of the program's spans; None without a recorder."""
    spans = recorded()
    return None if spans is None else value(spans)
