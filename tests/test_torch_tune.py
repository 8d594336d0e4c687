"""PyTorch port, ``tune.autotune``: the six cases of ``tests/test_tune.py``
on port tasks (on the CPU), the final loss read from the task's arrays, a
failing variant's exception logged in full, and a run where pandas cannot
be imported. On the card the variants choose the kernels (chip_smoke.py
phase 14)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from colvarsfinder_tpu_torch import config
from colvarsfinder_tpu_torch.core import AutoEncoderTask
from colvarsfinder_tpu_torch.models import AutoEncoder
from colvarsfinder_tpu_torch.tune import DEFAULT_VARIANTS, autotune
from colvarsfinder_tpu_torch.utils import WeightedTrajectory

REPO = Path(__file__).resolve().parent.parent


def _factory(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 2)).astype(np.float32)
    traj = WeightedTrajectory(trajectory=x, dt=0.1, verbose=False)
    counter = {"n": 0}

    def factory(**overrides):
        counter["n"] += 1
        model = AutoEncoder([2, 6, 1], [1, 6, 2], seed=0)
        return AutoEncoderTask(
            traj, None, model, str(tmp_path / f"t{counter['n']}"),
            learning_rate=0.01, save_model_every_step=0, batch_size=32,
            num_epochs=2, test_ratio=0.25, seed=0, verbose=False,
            debug_mode=False, export_cv=False, tensorboard=False,
            device="cpu", **overrides,
        )

    return factory


@pytest.mark.parametrize("name,torch_name,tf32", [
    ("default", "medium", True), ("high", "high", True),
    ("bfloat16", "medium", True), ("highest", "highest", False),
    ("float32", "highest", False)])
def test_matmul_precision_knob_reads_back(name, torch_name, tf32):
    """The variant's knob, set and read as a captured epoch's key and
    ``torch.export`` read it: setting cuBLAS's legacy TF32 flag beside
    torch's precision API made ``matmul_precision()`` (and so every captured
    task) raise after 'default'."""
    try:
        config.set_matmul_precision(name)
        assert config.matmul_precision() == torch_name
        assert config.numerics_key()[0] == torch_name
        # the flags torch.export saves and restores
        assert torch._C._get_cudnn_allow_tf32() == tf32
        cuda_matmul = torch.backends.cuda.matmul
        if hasattr(cuda_matmul, "fp32_precision"):
            assert cuda_matmul.fp32_precision == ("tf32" if tf32 else "ieee")
    finally:
        config.set_matmul_precision("highest")
    assert config.matmul_precision() == "highest"


def test_autotune_ranks_and_restores_config(tmp_path):
    prev = (config.matmul_precision(), config.compute_dtype_name(),
            config.bf16_style())
    variants = [
        {},
        {"matmul_precision": "default"},
        {"compute_dtype": "bfloat16", "bf16_style": "acc32"},
    ]
    results = autotune(_factory(tmp_path), variants, reps=2, verbose=False)
    assert (config.matmul_precision(), config.compute_dtype_name(),
            config.bf16_style()) == prev
    assert len(results) == 3
    times = [r.best_seconds for r in results]
    assert times == sorted(times)
    assert all(np.isfinite(r.best_seconds) for r in results)
    assert all(np.isfinite(r.final_train_loss) for r in results)
    base = next(r for r in results if r.overrides == {})
    assert base.speedup == pytest.approx(1.0)
    bf16 = next(r for r in results if "compute_dtype" in r.overrides)
    assert bf16.ctor_overrides == {}
    assert bf16.config_overrides == {"compute_dtype": "bfloat16",
                                     "bf16_style": "acc32"}


def test_no_knob_carries_over_into_the_next_variant(tmp_path):
    """Every train() call runs under its own variant's knobs over the
    caller's settings (the JAX loop left bf16 on for the variants after
    it and for the baseline's timed calls); the caller's 'medium'
    precision is restored."""
    base_factory = _factory(tmp_path)
    seen = []

    def factory(**ctor):
        task = base_factory(**ctor)
        real = task.train

        def train():
            seen.append((len(seen), config.matmul_precision(),
                         config.compute_dtype_name()))
            real()

        task.train = train
        return task

    config.set_matmul_precision("medium")
    try:
        autotune(factory, [{}, {"compute_dtype": "bfloat16"},
                           {"matmul_precision": "highest"}],
                 reps=1, verbose=False)
        assert config.matmul_precision() == "medium"
    finally:
        config.set_matmul_precision("highest")
    # warm-ups in variant order, then one timed call each
    want = [("medium", "float32"), ("medium", "bfloat16"),
            ("highest", "float32")] * 2
    assert [s[1:] for s in seen] == want


def test_autotune_ctor_overrides_reach_factory(tmp_path):
    seen = []
    base_factory = _factory(tmp_path)

    def factory(**overrides):
        seen.append(dict(overrides))
        return base_factory(**overrides)

    results = autotune(factory, [{}, {"optimizer_name": "SGD"}], reps=1,
                       verbose=False)
    assert {"optimizer_name": "SGD"} in seen
    pb = next(r for r in results if r.overrides)
    assert pb.ctor_overrides == {"optimizer_name": "SGD"}
    assert pb.config_overrides == {}


def test_autotune_apply_config(tmp_path):
    prev_cdt = config.compute_dtype_name()
    results = autotune(_factory(tmp_path), [{}, {"compute_dtype": "bfloat16"}],
                       reps=1, verbose=False)
    try:
        bf16 = next(r for r in results if r.config_overrides)
        bf16.apply_config()
        assert config.compute_dtype_name() == "bfloat16"
    finally:
        config.set_compute_dtype(prev_cdt)


def test_default_variants_shape():
    assert DEFAULT_VARIANTS[0] == {}
    assert all(isinstance(v, dict) for v in DEFAULT_VARIANTS)
    # the JAX package's four knob settings, all config-level here
    assert len(DEFAULT_VARIANTS) == 4
    assert all(set(v) <= {"matmul_precision", "compute_dtype"}
               for v in DEFAULT_VARIANTS)


def test_autotune_skips_failing_variant(tmp_path, capsys):
    base_factory = _factory(tmp_path)

    def factory(**overrides):
        if overrides.get("boom"):
            raise RuntimeError("unsupported variant")
        overrides.pop("boom", None)
        return base_factory(**overrides)

    results = autotune(factory,
                       [{}, {"boom": True}, {"matmul_precision": "default"}],
                       reps=1, verbose=True)
    assert len(results) == 2
    assert all(not r.overrides.get("boom") for r in results)
    out = capsys.readouterr().out
    # the skip is logged with its whole traceback
    assert "SKIPPED (RuntimeError: unsupported variant)" in out
    assert "Traceback (most recent call last)" in out


def test_autotune_failing_baseline_raises(tmp_path):
    def factory(**overrides):
        raise RuntimeError("factory broken")

    with pytest.raises(RuntimeError, match="factory broken"):
        autotune(factory, [{}], reps=1, verbose=False)


def test_final_loss_is_the_loss_column(tmp_path):
    results = autotune(_factory(tmp_path), [{}], reps=1, verbose=False)
    # the warm-up call and one timed call, each continuing the training
    task = _factory(tmp_path)()
    task.train()
    task.train()
    assert task.loss_names[0] == "loss"
    assert results[0].final_train_loss == float(task.train_loss[-1, 0])


_NO_PANDAS = """
import json, sys
sys.modules["pandas"] = None
sys.path.insert(0, sys.argv[2])
import numpy as np
from test_torch_tune import _factory
from pathlib import Path
from colvarsfinder_tpu_torch.tune import autotune

res = autotune(_factory(Path(sys.argv[1])), [{}, {"compute_dtype":
               "bfloat16"}], reps=1, verbose=False)
assert len(res) == 2 and all(np.isfinite(r.final_train_loss) for r in res)
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if m.split(".")[0] == "pandas" and mod is not None)))
"""


def test_autotune_without_pandas(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _NO_PANDAS, str(tmp_path),
         str(REPO / "tests")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
