#!/usr/bin/env python3
"""Run the port's seven examples (``examples/torch/*.py``) once each, on
the card, at their default sizes, and time them.

    python3 scripts/torch_examples.py [--device cuda|cpu] [--logdir DIR]
                                      [names ...]

Each example runs in a process of its own (as a user starts it), with
``--outdir`` a fresh directory in a temporary one, removed afterwards.
Prints the card's name and power limit, each example's exit code, wall
seconds and last output line, and one JSON line
``{"examples": {name: {"rc": ..., "seconds": ...}}}``; exits non-zero if an
example failed. With ``--logdir`` each example's whole output goes to
``<DIR>/<name>.log``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="examples to run (default all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--logdir", default=None)
    args = ap.parse_args()
    names = args.names or sorted(p.name for p in EXAMPLES.glob("*.py"))
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(card, flush=True)
    logdir = Path(args.logdir) if args.logdir else None
    if logdir:
        logdir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as scratch:
        results = {}
        for name in names:
            out = Path(scratch) / Path(name).stem
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, str(EXAMPLES / name), "--device",
                 args.device, "--outdir", str(out)],
                capture_output=True, text=True, timeout=1800)
            seconds = time.perf_counter() - t0
            results[name] = {"rc": run.returncode, "seconds": seconds}
            if logdir:
                (logdir / f"{Path(name).stem}.log").write_text(
                    run.stdout + "\n--- stderr ---\n" + run.stderr)
            tail = (run.stdout.strip().splitlines() or [""])[-1]
            print(f"{name}: rc {run.returncode}, {seconds:.1f} s; {tail}",
                  flush=True)
            if run.returncode:
                print(run.stderr[-3000:], flush=True)
    print(json.dumps({"examples": results}))
    sys.exit(int(any(r["rc"] for r in results.values())))


if __name__ == "__main__":
    main()
