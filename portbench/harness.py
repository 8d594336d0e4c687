"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` (with the reference module it
names under ``references/``), ``workloads/<cell>.json`` (with the entry
module it names under ``entries/``), and ``metrics/<metric>.py`` for every
metric that ``BENCHMARK.json`` lists, each a ``read(ctx)`` that returns a
number or None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "colvarsfinder_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(cell: str):
    """``(workload, config)`` files of a cell."""
    wl = load_json(HERE / "workloads" / f"{cell}.json")
    cfg = load_json(HERE / "configs" / f"{wl['config']}.json")
    return wl, cfg


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a metric reader may read: the cell's files, the window's
    records, the set-up time and, in a traced run, the trace."""

    def __init__(self, cell, wl, cfg, setup_s, window_s, calls, trace=None):
        from portbench import counts

        self.cell, self.wl, self.cfg = cell, wl, cfg
        self.setup_s = setup_s
        self.window_s = window_s
        self.calls = calls
        self.trace = trace
        self.counts = counts

    @property
    def samples(self) -> int:
        return sum(c["samples"] for c in self.calls)


def read_metrics(ctx: Context, metrics: list, required: bool) -> dict:
    """Every metric of ``metrics`` that applies to the cell, by its reader;
    one that finds nothing is left out where it names its cells and is not
    ``required`` (the end-to-end metrics are), and is an error otherwise."""
    out = {}
    for m in metrics:
        if not applies(m, ctx.cell):
            continue
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = mod.read(ctx)
        if value is None:
            if required or "workloads" not in m:
                raise RuntimeError(f"metric {m['name']} found nothing to "
                                   f"read in {ctx.cell}")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class Stamps:
    """Logs the seconds since the process started at each set-up stage."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        log(f"imports: {time.perf_counter() - t_start:.3f} s")

    def __call__(self, what: str) -> None:
        log(f"{what}: {time.perf_counter() - self.t_start:.3f} s")


def check_device(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    return "cuda"


def entry(wl: dict):
    return importlib.import_module(f"portbench.entries.{wl['entry']}")


def start(cfg: dict, wl: dict, seed: int, dev: str, tmp: str, stamp=log):
    """``(inputs, runner)``: the seeded inputs and the program built on
    them and driven through its set-up from the seed."""
    from portbench import data

    inputs = data.Inputs(cfg, seed, dev, int(wl.get("replicas", 1)))
    stamp("inputs")
    runner = entry(wl).Runner(cfg, wl, inputs, dev, tmp)
    stamp("program built")
    runner.setup()
    return inputs, runner


def finish(runner, dev: str) -> dict:
    """What set-up saw the program produce; the program's state is then
    freed, so that the reference does not set the device's peak."""
    import torch

    readings = runner.readings()
    runner.release()
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return readings


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float) -> dict:
    """One run of a cell of ``BENCHMARK.json`` on the card."""
    wl, cfg = load_cell(cell)
    chips = int(next(w["chips"] for w in manifest()["workloads"]
                     if w["name"] == cell))
    return run(cell, cfg, wl, chips, check_device(chips), seed, seconds,
               trace, t_start)


def run(cell: str, cfg: dict, wl: dict, chips: int, dev: str, seed: int,
        seconds: float, trace: bool, t_start: float) -> dict:
    """One run of ``cell`` with its configuration ``cfg`` and workload
    ``wl`` on ``dev``; returns the result line's object."""
    import torch

    from portbench import check

    torch.set_num_threads(2)
    stamp = Stamps(t_start)
    with tempfile.TemporaryDirectory() as tmp:
        inputs, runner = start(cfg, wl, seed, dev, tmp, stamp)
        if dev == "cuda":
            torch.cuda.synchronize()
        stamp("warm-up calls")
        setup_s = time.perf_counter() - t_start

        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            calls.append(runner.call())
        window_s = time.perf_counter() - t0
        log("calls (s): " + " ".join(f"{c['wall_s']:.4f}" for c in calls))
        tr = None
        if trace:
            from portbench import trace as trace_mod

            sl = wl["trace"]
            events, res = trace_mod.profile(
                lambda: runner.call(sl.get("epochs")), sl["warmup"],
                sl["calls"])
            tr = trace_mod.Trace(events, sum(r["wall_s"] for r in res),
                                 sum(r["steps"] for r in res))
        peak = (torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
        readings = finish(runner, dev)

        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                             f"{found}")
        nums, lines = check.judge(cfg, wl, entry(wl).plan(cfg, wl), inputs,
                                  readings, dev)
        for line in lines:
            log(line)

    limits = wl["checks"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = all(v <= limits[k] for k, v in nums.items())

    ctx = Context(cell, wl, cfg, setup_s, window_s, calls, tr)
    spec = manifest()
    metrics = (read_metrics(ctx, spec["per_layer"], required=False) if trace
               else read_metrics(ctx, spec["end_to_end"], required=True))
    dev_info = {"platform": "gpu" if dev == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if dev == "cuda"
                         else "cpu"),
                "count": chips, "memory_peak_bytes": int(peak)}
    # a call that raises ends the run with no result line
    out = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
           "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out

