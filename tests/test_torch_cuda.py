"""PyTorch port, CUDA kernels K1-K4 against their plain PyTorch versions on
the card. Every test here needs an NVIDIA card and ``nvcc``: it carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops.alignment import align_frames, kabsch_rotations_quat
from colvarsfinder_tpu_torch.ops.fused_eigen import (
    eigen_loss_from_stats,
    fused_tile,
    params_t_of,
    transfer_stats,
    transfer_stats_reference,
)
from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
    FusedAlignmentLayer,
    fused_align_launch,
    kabsch_qcp_launch,
    kabsch_rotations_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _frames(B, N, m, seed, noise=0.3):
    """Noisy, randomly rotated and shifted copies of one structure, the
    align atoms a subset of the N atoms."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((N, 3))
    q = rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(B, 3, 3)
    fr = base[None] + noise * rng.standard_normal((B, N, 3))
    fr = np.einsum("bni,bij->bnj", fr, R) + rng.standard_normal((B, 1, 3))
    idx = np.sort(rng.choice(N, size=m, replace=False))
    ref = base[idx] - base[idx].mean(0)
    return fr.astype(np.float32), ref.astype(np.float32), idx


@pytest.mark.parametrize("B", [37, 20000])
def test_k1_kabsch_matches_plain(dev, B):
    x, ref, idx = _frames(B, 10, 10, seed=B)
    xt = torch.from_numpy(x).to(dev)
    sel = xt[:, idx]
    selc = sel - sel.mean(1, keepdim=True)
    C = torch.einsum("bmi,mj->bij", selc, torch.from_numpy(ref).to(dev))
    C[0] = 0.0  # a degenerate frame gets the identity
    _cuda.reset_launch_counts()
    R = kabsch_qcp_launch(C.contiguous())
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["kabsch_qcp"] == 1
    R_ref = kabsch_rotations_quat(C)
    # f32 Newton/adjugate arithmetic in two instruction orders (nvcc
    # contracts to FMA): the CPU tests' bar for the QCP paths
    torch.testing.assert_close(R, R_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(R[0], torch.eye(3, device=dev), atol=0, rtol=0)


def test_k1_backward_is_svd_autograd(dev):
    x, ref, idx = _frames(16, 6, 6, seed=1)
    sel = torch.from_numpy(x).to(dev)
    C = torch.einsum("bmi,mj->bij", sel - sel.mean(1, keepdim=True),
                     torch.from_numpy(ref).to(dev)).requires_grad_()
    (g,) = torch.autograd.grad((kabsch_rotations_cuda(C) ** 2 * C).sum(), C)
    C2 = C.detach().requires_grad_()
    (g2,) = torch.autograd.grad((kabsch_rotations_quat(C2) ** 2 * C2).sum(), C2)
    torch.testing.assert_close(g, g2, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("B", [37, 20000])
def test_k2_fused_align_matches_plain(dev, B):
    x, ref, idx = _frames(B, 10, 6, seed=B + 1)
    x[1, idx] = x[1, idx[0]]  # coincident align atoms: identity rotation
    xt = torch.from_numpy(x).to(dev)
    reft = torch.from_numpy(ref).to(dev)
    idx64 = torch.as_tensor(idx, device=dev)
    _cuda.reset_launch_counts()
    out = fused_align_launch(xt, reft, idx64.to(torch.int32))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fused_align"] == 1
    out_ref = align_frames(xt, reft, idx64, method="quaternion")
    # the CPU tests' bar for the fused alignment (near-degenerate frames
    # land up to ~1e-4 apart in f32)
    torch.testing.assert_close(out, out_ref, atol=2e-4, rtol=0)
    com = xt[1, idx].mean(0)
    torch.testing.assert_close(out[1], xt[1] - com, atol=1e-6, rtol=0)


def test_k2_layer_gradient_is_plain_autograd(dev):
    x, ref, idx = _frames(8, 10, 6, seed=3)
    layer = FusedAlignmentLayer(ref, idx).to(dev)
    xt = torch.from_numpy(x).to(dev).requires_grad_()
    (g,) = torch.autograd.grad((layer(xt) ** 2 * xt).sum(), xt)
    x2 = xt.detach().requires_grad_()
    out = align_frames(x2, layer.ref_centered, layer.align_idx,
                       method="quaternion")
    (g2,) = torch.autograd.grad((out ** 2 * x2).sum(), x2)
    torch.testing.assert_close(g, g2, rtol=1e-3, atol=1e-4)


def _stats_inputs(dev, B, k, dims, seed=0):
    rng = np.random.default_rng(seed)
    model = EigenFunctions(dims, k, seed=seed, device=dev)
    F = torch.from_numpy(rng.standard_normal((B, dims[0])).astype(np.float32))
    Fl = torch.from_numpy(rng.standard_normal((B, dims[0])).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32))
    wl = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32))
    return model, F.to(dev), Fl.to(dev), w.to(dev), wl.to(dev)


@pytest.mark.parametrize(
    "B,k,dims",
    [(37, 1, [12, 10, 10, 1]), (3000, 3, [12, 10, 10, 1]),
     (20000, 2, [30, 20, 20, 20, 1]),
     # past the JAX limits (k <= 9, k * hidden <= 256): a 32-sample tile
     (500, 12, [30, 32, 32, 1])],
)
def test_k3_k4_match_plain_and_repeat_bitwise(dev, B, k, dims):
    model, F, Fl, w, wl = _stats_inputs(dev, B, k, dims)
    eig_w = torch.linspace(1.0, 0.2, k, device=dev)
    assert fused_tile(dims, k) == (32 if k == 12 else 128)

    def loss_of(stats_fn):
        stats = stats_fn(params_t_of(model), F, Fl, w, wl)
        loss, _ = eigen_loss_from_stats(
            stats, k=k, alpha=20.0, eig_w=eig_w, lag_idx=5, traj_dt=0.002,
            sort_eigvals=True,
        )
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return stats.detach(), grads

    _cuda.reset_launch_counts()
    s1, g1 = loss_of(transfer_stats)
    s2, g2 = loss_of(transfer_stats)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stats_fwd"] == 2
    assert _cuda.LAUNCHES["stats_bwd"] == 2
    # fixed-order reductions, no atomics: two calls agree bit for bit
    assert torch.equal(s1, s2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    s_ref, g_ref = loss_of(transfer_stats_reference)
    # f32 sums in another order than cuBLAS/torch.sum: the CPU tests' bars
    torch.testing.assert_close(s1, s_ref, rtol=5e-6, atol=1e-4)
    for a, b in zip(g1, g_ref):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-3)
