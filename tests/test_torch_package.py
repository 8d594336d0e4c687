"""PyTorch port, package rules: it imports neither JAX nor the JAX package;
its entry points run on the card unless the caller asks for the CPU, and a
request for the card without one raises; every kernel wrapper takes CPU
tensors through its plain version without counting a launch, and its
launcher refuses a CPU tensor rather than falling back."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch.config import resolve_device
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops import fused_eigen as tfe
from colvarsfinder_tpu_torch.ops import kabsch_cuda as tkc

PKG = Path(port.__file__).resolve().parent
REPO = PKG.parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys, colvarsfinder_tpu_torch as p\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'colvarsfinder_tpu'"
        " or m.startswith('colvarsfinder_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(p.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import colvarsfinder_tpu\b(?!_torch)"
        r"|from colvarsfinder_tpu\b(?!_torch))|colvarsfinder_tpu\.",
        re.M,
    )
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, (f, hits)


def test_kernel_sources_ship_with_the_package():
    names = sorted(p.name for p in (PKG / "csrc").iterdir())
    assert names == ["fused_eigen.cu", "kabsch.cu", "qcp.cuh"]
    assert set(_cuda.SOURCES) == {"kabsch", "fused_eigen"}
    # built beside the package, in a directory git ignores
    assert _cuda.BUILD_DIR == REPO / "build" / "cvf_torch_kernels"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    # sm_90a, full-precision float32 math
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
    assert not any("fast" in flag for flag in _cuda.NVCC_FLAGS)
    for src in (PKG / "csrc").glob("*.cu"):
        text = src.read_text()
        assert "atomicAdd(" not in text  # fixed-order reductions only
        assert "__expf(" not in text  # full-precision expf in the tanh


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    x = np.zeros((50, 2, 3), np.float32)
    traj = port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False)
    args = dict(alpha=1.0, eig_weights=[1.0], lag_tau=0.1, k=1,
                verbose=False, tensorboard=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.EigenFunctionTask(traj, None, port.EigenFunctions([6, 4, 1], 1),
                               str(tmp_path), **args)
    task = port.EigenFunctionTask(traj, None,
                                  port.EigenFunctions([6, 4, 1], 1),
                                  str(tmp_path), device="cpu", **args)
    assert task.device == torch.device("cpu")
    assert next(task.model.parameters()).device.type == "cpu"


def test_wrappers_take_cpu_tensors_through_plain_versions():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((9, 5, 3)).astype(np.float32))
    ref = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    idx = torch.tensor([0, 1, 3, 4])
    C = torch.from_numpy(rng.standard_normal((9, 3, 3)).astype(np.float32))
    model = port.EigenFunctions([6, 5, 1], 2)
    F = torch.from_numpy(rng.standard_normal((11, 6)).astype(np.float32))
    w = torch.ones(11)
    _cuda.reset_launch_counts()

    tkc.kabsch_rotations_cuda(C)
    port.ops.align_frames(x, ref, idx, method="cuda")
    tkc.FusedAlignmentLayer(ref.numpy(), idx.numpy())(x)
    tkc.align_frames_fused_cuda(x, ref, idx)
    stats = tfe.transfer_stats(tfe.params_t_of(model), F, F, w, w)
    stats.sum().backward()
    assert _cuda.launch_counts() == {k: 0 for k in _cuda.LAUNCHES}

    # the launchers take CUDA tensors only: no fallback to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        tkc.kabsch_qcp_launch(C)
    with pytest.raises(ValueError, match="CUDA"):
        tkc.fused_align_launch(x, ref, idx.to(torch.int32))
    flat = tfe.flatten_params(tfe.params_t_of(model)).detach()
    with pytest.raises(ValueError, match="CUDA"):
        tfe.stats_fwd_launch(flat, F, F, w, w, (6, 5, 1), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tfe.stats_bwd_launch(flat, F, F, w, w, torch.zeros(2, 2, 11),
                             torch.zeros(13), (6, 5, 1), 2)
    assert _cuda.launch_counts() == {k: 0 for k in _cuda.LAUNCHES}


def test_flat_parameter_layout_round_trips():
    model = port.EigenFunctions([7, 5, 3, 1], 3)
    pt = tfe.params_t_of(model)
    flat = tfe.flatten_params(pt)
    assert flat.shape == (tfe._n_params((7, 5, 3, 1), 3),)
    back = tfe.unflatten_grads(flat, pt)
    for (w_t, b), (gw, gb) in zip(pt, back):
        assert torch.equal(w_t, gw) and torch.equal(b, gb)
