"""The run's refusals and its import guard, in fresh interpreters, and the
trace reader on a trace made by hand."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import counts, harness
from portbench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[2]
RUN = ["portbench/run.py", "--workload", "ala2_transfer.fused", "--seed",
       "2147484000", "--seconds", "1", "--trace", "0"]


def python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without")
    p = subprocess.run([sys.executable, *RUN], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, *RUN], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


GUARD = """
import sys
sys.path.insert(0, '.')
import importlib, pkgutil
import portbench.run, portbench.harness, portbench.calibrate
for pkg in ('entries', 'metrics', 'references'):
    mod = importlib.import_module('portbench.' + pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(f'portbench.{pkg}.{info.name}')
print(sorted({m.split('.')[0] for m in sys.modules}))
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, '.')
import portbench.references.eigen, portbench.check, portbench.counts
import portbench.data, portbench.trace
print(sorted({m.split('.')[0] for m in sys.modules}))
"""


def test_import_guard():
    p = python(GUARD)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "colvarsfinder_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "colvarsfinder_tpu"}
    p = python(REFERENCE_ONLY)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "colvarsfinder_tpu",
                      "colvarsfinder_tpu_torch"}


def test_forbidden_names_compare_whole():
    p = python("import sys, types; sys.path.insert(0, '.');"
               "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy');"
               "import colvarsfinder_tpu_torch;"
               "from portbench import harness;"
               "print(harness.forbidden_modules())")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "['jax.numpy']"


def event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reader_and_kernel_metrics():
    events = [
        event("cudaGraphLaunch", 0.0, 5.0, "cuda_runtime"),
        event("void (anonymous namespace)::fused_align_staged_kernel(x)",
              10.0, 4.0),
        event("void (anonymous namespace)::stats_fwd_kernel<2>(x)", 12.0,
              20.0),  # overlaps the previous kernel
        event("reduce_partials_kernel(x)", 40.0, 2.0),
        event("aten::copy_", 35.0, 3.0, "cpu_op"),
        event("sm90_xmma_gemm_f32f32", 50.0, 10.0),
        event("Memcpy DtoH", 60.0, 2.0, "gpu_memcpy"),
        event("ProfilerStep#1", 0.0, 100.0, "user_annotation"),
    ]
    tr = trace_mod.Trace(events, window_s=100e-6, steps=2)
    assert tr.busy_s == pytest.approx((32 - 10 + 2 + 12) * 1e-6)
    assert tr.launches("stats_fwd_kernel", "reduce_partials_kernel") == \
        pytest.approx([22e-6])
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "void (anonymous namespace)::stats_fwd_kernel<2>(x)"
    assert dict(b["idle_gaps"]) == pytest.approx({"aten::copy_": 8e-6,
                                                  "host idle": 8e-6})
    wl, cfg = harness.load_cell("ala2_transfer.fused")
    ctx = harness.Context("ala2_transfer.fused", wl, cfg, 1.0, 2.0,
                          [{"wall_s": 2.0, "samples": 4, "steps": 2}], tr)
    from portbench.metrics import (
        device_idle_share, fused_align_roofline, gemm_device_share,
        kernels_per_step, stats_fwd_roofline)

    assert kernels_per_step.read(ctx) == 2.5
    # 36 us busy over 2 steps against 2 s of window over 2 steps
    assert device_idle_share.read(ctx) == pytest.approx(100 * (1 - 36e-6 / 2.0))
    assert gemm_device_share.read(ctx) == pytest.approx(100 * 10 / 38)
    bound = counts.bound_seconds(nbytes=counts.k2_bytes(20_000, 10))
    assert fused_align_roofline.read(ctx) == pytest.approx(100 * bound / 4e-6)
    bound = counts.bound_seconds(flops=counts.k3_flops(20_000, 2,
                                                       cfg["layer_dims"]))
    assert stats_fwd_roofline.read(ctx) == pytest.approx(100 * bound / 22e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(p.stem for p in
                                        (ROOT / "portbench" / "workloads")
                                        .glob("*.json")))
def test_cell_on_the_card(cell):
    """One short run of each cell on the card, correct and with every
    end-to-end metric (card only: skips without one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", "2147483650", "--seconds", "3", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert "setup_s" in out["metrics"]
