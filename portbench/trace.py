"""Reading a torch.profiler trace of the profiled slice: the device
activities (kernels, copies, fills) with their times, the union of their
intervals, and the breakdown of the slice (the device operations that took
most time, and the idle gaps named by what the host was doing).
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
NAME_CHARS = 96


class Event(NamedTuple):
    name: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


class Trace:
    """The device and host events of one profiled slice."""

    def __init__(self, events: list, window_s: float, steps: int):
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            ev = Event(str(e.get("name", "")), float(e["ts"]), float(e["dur"]))
            if cat in DEVICE_CATS:
                dev.append(ev)
            elif cat in HOST_CATS and not ev.name.startswith("ProfilerStep"):
                host.append(ev)
        self.device = sorted(dev, key=lambda e: e.start_us)
        self.host = sorted(host, key=lambda e: e.start_us)
        self.window_s = float(window_s)
        self.steps = int(steps)
        self.busy = self._union()

    def _union(self) -> list:
        merged = []
        for e in self.device:
            if merged and e.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end_us)
            else:
                merged.append([e.start_us, e.end_us])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy) * 1e-6

    def named(self, *parts: str) -> list:
        """Device events whose name holds any of ``parts``."""
        return [e for e in self.device if any(p in e.name for p in parts)]

    def launches(self, main: str, tail: str) -> list:
        """Seconds of each launch of a kernel that is ``main`` followed on
        the stream by ``tail`` (its reduction)."""
        times, pending = [], None
        for e in self.device:
            if main in e.name:
                pending = e.dur_us
            elif pending is not None and tail in e.name:
                times.append((pending + e.dur_us) * 1e-6)
                pending = None
        return times

    def _host_names(self, times: list) -> list:
        """The innermost host event running at each of ``times`` (sorted),
        in one sweep over the host events."""
        out, open_, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i].start_us <= t:
                open_.append(self.host[i])
                i += 1
            open_ = [e for e in open_ if e.end_us >= t]
            best = min(open_, key=lambda e: e.dur_us, default=None)
            out.append(best.name if best else "host idle")
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for e in self.device:
            ops[e.name[:NAME_CHARS]] += e.dur_us * 1e-6
        spans = [(a, b) for (_, a), (b, _) in zip(self.busy, self.busy[1:])]
        names = self._host_names([0.5 * (a + b) for a, b in spans])
        gaps = defaultdict(float)
        for (a, b), name in zip(spans, names):
            gaps[name[:NAME_CHARS]] += (b - a) * 1e-6
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(kv) for kv in order],
                "idle_gaps": [list(kv) for kv in idle]}


def profile(run_slice, warmup: int, active: int):
    """Profile ``active`` calls of ``run_slice()`` after ``warmup`` calls
    that are traced and thrown away (the profiler's own start-up); return
    ``(trace events, results of the active calls)``. The trace is written
    under the temporary directory and removed."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    sched = schedule(wait=0, warmup=warmup, active=active, repeat=1)
    results = []
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=sched,
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(warmup + active):
                r = run_slice()
                if i >= warmup:
                    results.append(r)
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events, results
