"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It makes its inputs from the seed, sets up and warms up the program, runs
whole calls for ``--seconds``, with ``--trace 1`` profiles a short slice
after them, checks what the program produced against the plain reference,
and prints one JSON object as the last line of its output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def fixed_caches() -> None:
    """torch's extension and Triton caches at fixed paths inside the
    checkout, should anything build there; the program's own kernels build
    into ``build/cvf_torch_kernels/`` beside its package."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
