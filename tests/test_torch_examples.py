"""PyTorch port, the examples (``examples/torch/*.py``): each runs with
``--device cpu`` at the cut size its docstring names, in a process of its
own, exits 0 and prints no NaN (each script also checks its own results
are finite). At their default sizes they run on the card; the JAX
package's examples (``examples/*.py``) stay as they are."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"

CUT = {
    "2d_toy.py": ["--n-steps", "3000", "--step-size", "0.01",
                  "--report-interval", "10", "--epochs", "2",
                  "--batch-size", "100"],
    "dipeptide.py": ["--n-frames", "2000", "--epochs", "2",
                     "--skip-programs"],
    "enhanced_sampling.py": ["--n-steps", "1000", "--epochs", "2"],
    "adaptive_umbrella.py": ["--rounds", "2", "--unbiased-steps", "2000",
                             "--metad-steps", "2000", "--umbrella-steps",
                             "600", "--pre-steps", "300", "--epochs", "2"],
    "replica_exchange.py": ["--n-steps", "4000", "--epochs", "2"],
    "multireplica.py": ["--n-chains", "2", "--n-steps", "2000",
                        "--epochs", "2"],
    "deployed_biasing.py": ["--quick"],
}
# what each script prints last when it got through its steps
LAST = {
    "2d_toy.py": "CV on grid",
    "dipeptide.py": "PLUMED input written",
    "enhanced_sampling.py": "retrained CV on reweighted metadynamics frames",
    "adaptive_umbrella.py": "OK (figures with --plot)",
    "replica_exchange.py": "committor q(-1, 0, 1)",
    "multireplica.py": "leading CV along x",
    "deployed_biasing.py": "deployed-artifact biasing OK",
}


def test_every_example_is_ported():
    jax_names = sorted(p.name for p in (REPO / "examples").glob("*.py"))
    assert sorted(p.name for p in EXAMPLES.glob("*.py")) == jax_names
    assert sorted(CUT) == jax_names


@pytest.mark.parametrize("name", sorted(CUT))
def test_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / name), "--device", "cpu",
         "--outdir", str(tmp_path), *CUT[name]],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    # the last line, or the last two where numpy wraps an array
    tail = out.stdout.strip().splitlines()[-2:]
    assert any(line.startswith(LAST[name]) for line in tail), \
        out.stdout[-2000:]
    assert not re.search(r"\bnan\b", out.stdout, re.I), out.stdout[-2000:]
