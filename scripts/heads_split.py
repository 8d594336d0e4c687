#!/usr/bin/env python3
"""Device time of the stacked heads' layer products, whole and split into
chunks of the batch axis (``models/module.py``: ``split_count``,
``_stacked_apply``), at the benchmark's shapes on one NVIDIA card: B =
20,000 rows, heads [30, 20, 20, 20, 1], k = 2, alone and mapped over R =
64 replicas.

    python3 scripts/heads_split.py [--splits 1,2,4] [--rows 20000]

Three steps, each captured as a CUDA graph and replayed:

- ``transfer``: the heads on two batches, and the backward of a loss of
  both outputs to the weights;
- ``gram``: the heads' per-sample input gradients recorded with
  ``create_graph=True`` (``core/losses.py:_input_jacobian``), then the
  backward of a loss of the gradients to the weights;
- ``sweep``: the transfer step under ``torch.func.vmap`` over R replicas.

For each step and split count S the script prints the median time of a
replay over 5 sets of 20 (CUDA events), the largest relative gap of the
weight gradients against S = 1, and the step's top kernels in one replay
under ``torch.profiler``; ``rule`` marks the S that ``split_count`` picks.
``--device cpu`` runs the same steps eagerly on the CPU at a small
``--rows``, with host times: a rehearsal, not a measurement.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.func import vmap

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from colvarsfinder_tpu_torch.models import module  # noqa: E402

DIMS = [30, 20, 20, 20, 1]
K = 2
REPLICAS = 64
SPLITS = {"transfer": [1, 2, 4, 8, 16, 32, 64, 78, 128],
          "gram": [1, 2, 4, 8, 16, 32, 64, 78, 128],
          "sweep": [1, 2, 3, 5, 10, 20, 40, 78]}


def _params(dev, replicas=None):
    gen = torch.Generator().manual_seed(0)
    lead = () if replicas is None else (replicas,)
    ws, bs = [], []
    for i in range(len(DIMS) - 1):
        bound = DIMS[i] ** -0.5
        ws.append((torch.rand(lead + (K, DIMS[i + 1], DIMS[i]), generator=gen)
                   * 2 - 1) * bound)
        bs.append((torch.rand(lead + (K, DIMS[i + 1]), generator=gen)
                   * 2 - 1) * bound)
    return [t.to(dev).requires_grad_() for t in ws + bs]


def _heads(params, x, splits):
    n = len(DIMS) - 1
    return module._stacked_apply(params[:n], params[n:], x, "tanh", None,
                                 (splits,) * n)


def _steps(dev, rows):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(rows, DIMS[0], generator=gen).to(dev)
    x_l = torch.randn(rows, DIMS[0], generator=gen).to(dev)

    def transfer(params, splits):
        y, y_l = _heads(params, x, splits), _heads(params, x_l, splits)
        return torch.autograd.grad((y * y_l).mean() + (y ** 2).mean(), params)

    def gram(params, splits):
        with torch.autograd.set_multithreading_enabled(False):
            xg = x.detach().requires_grad_()
            y = _heads(params, xg, splits)
            jac = torch.stack([
                torch.autograd.grad(y[:, i].sum(), xg, create_graph=True)[0]
                for i in range(K)])
            loss = (jac ** 2).mean() + (y ** 2).mean()
            return torch.autograd.grad(loss, params)

    def sweep(params, splits):
        n = len(DIMS) - 1

        def one(*p):
            y = _heads(p, x, splits)
            y_l = _heads(p, x_l, splits)
            return (y * y_l).mean() + (y ** 2).mean()

        loss = vmap(one)(*params).sum()
        return torch.autograd.grad(loss, params[:n] + params[n:])

    return {"transfer": (transfer, None), "gram": (gram, None),
            "sweep": (sweep, REPLICAS)}


def _capture(fn):
    """``fn()`` captured as a CUDA graph, after three eager runs on the
    capture stream; its outputs are the graph's static outputs."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _time(run, dev, reps=20, sets=5):
    times = []
    for _ in range(sets):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def _top(run, dev, n=4):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if dev.type == "cpu":
            t = e.self_cpu_time_total
        if t > 0:
            rows.append((t, e.count, e.key[:70]))
    rows.sort(reverse=True)
    return "; ".join(f"{key} x{c} {t / 1e3:.3f} ms" for t, c, key in rows[:n])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--splits", default=None,
                    help="comma-separated split counts for every step")
    ap.add_argument("--steps", default="transfer,gram,sweep")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"{card}; {sms} SMs; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}; matmul precision "
              f"{torch.get_float32_matmul_precision()}", flush=True)
    else:
        sms = 132
    for name, (step, replicas) in _steps(dev, args.rows).items():
        if name not in args.steps.split(","):
            continue
        params = _params(dev, replicas)
        batch = K * (replicas or 1)
        # every layer of DIMS is one 32 x 32 output tile: one S for all
        rule = module.split_count("cuda", True, args.rows, batch,
                                  torch.float32, sms, DIMS[1], DIMS[0])
        splits = ([int(s) for s in args.splits.split(",")] if args.splits
                  else SPLITS[name])
        if rule not in splits:
            splits = sorted(splits + [rule])
        ref = None
        for s in splits:
            if dev.type == "cuda":
                graph, out = _capture(lambda: step(params, s))
                run = graph.replay
            else:
                out = step(params, s)
                run = lambda: step(params, s)  # noqa: E731
            ms = _time(run, dev)
            run()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            grads = [g.detach().clone() for g in out]
            if ref is None:
                ref = grads
            gap = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(grads, ref))
            mark = " rule" if s == rule else ""
            print(f"{name} S={s}{mark}: {ms:.4f} ms a step, grad gap "
                  f"{gap:.2e}; top: {_top(run, dev)}", flush=True)
            del out, run
            if dev.type == "cuda":
                del graph
                torch.cuda.synchronize()


if __name__ == "__main__":
    main()
