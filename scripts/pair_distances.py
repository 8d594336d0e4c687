#!/usr/bin/env python3
"""Device time of the grouped pair distances (``ops/pair_cuda.py``, kernel
K5) at the CLN025 cell's shapes on one NVIDIA card: B = 20,000 frames of
N = 93 atoms, all P = 4,278 pairs.

    python3 scripts/pair_distances.py [--batch 20000] [--atoms 93]

For K5 and for the plain grouped version
(``ops/features.py: pair_distances``), the median time of one call over 5
sets of 20 (CUDA events), the bytes bound (frames read once, distances
written once, at 3.35 TB/s) and the share of it reached, and the largest
relative gap to the float64 distances; then the wall time of one call of
every distance evaluated on its own, as a feature layer without grouping
evaluates them (host clock, synchronised). Prints one JSON object a
line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from colvarsfinder_tpu_torch.ops import _cuda  # noqa: E402
from colvarsfinder_tpu_torch.ops.features import (  # noqa: E402
    _pair_distance,
    pair_distances,
)
from colvarsfinder_tpu_torch.ops.pair_cuda import (  # noqa: E402
    pair_distances_launch,
)

HBM = 3.35e12


def timed(fn, sets: int = 5, reps: int = 20) -> float:
    """Median seconds of one call of ``fn`` over ``sets`` sets of
    ``reps`` calls, after a warm-up set."""
    for _ in range(reps):
        fn()
    out = []
    for _ in range(sets):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) * 1e-3 / reps)
    return statistics.median(out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=20000)
    p.add_argument("--atoms", type=int, default=93)
    a = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, N = a.batch, a.atoms
    x = torch.randn(B, N, 3, device=dev, generator=g) * 2.0
    i, j = torch.triu_indices(N, N, offset=1, device=dev)
    pairs = torch.stack([i, j], 1).to(torch.int32)
    P = pairs.shape[0]
    nbytes = 4 * B * (3 * N + P)
    bound = nbytes / HBM
    exact = pair_distances(x.double(), pairs)

    def report(name, fn):
        t = timed(fn)
        gap = ((fn().double() - exact).abs() / exact).max().item()
        print(json.dumps({"card": card, "what": name, "B": B, "N": N, "P": P,
                          "us": t * 1e6, "bound_us": bound * 1e6,
                          "roofline_pct": 100 * bound / t,
                          "max_rel_gap": gap}), flush=True)

    _cuda.build_all()
    report("K5", lambda: pair_distances_launch(x, pairs))
    report("plain grouped", lambda: pair_distances(x, pairs))
    cols = [(int(u), int(v)) for u, v in pairs.tolist()]

    def one_by_one():
        return torch.cat([_pair_distance(x[:, u, :], x[:, v, :], None)[:, None]
                          for u, v in cols], dim=1)

    one_by_one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_by_one()
    torch.cuda.synchronize()
    print(json.dumps({"card": card, "what": "one by one (host clock)",
                      "B": B, "N": N, "P": P,
                      "ms": (time.perf_counter() - t0) * 1e3}), flush=True)


if __name__ == "__main__":
    main()
