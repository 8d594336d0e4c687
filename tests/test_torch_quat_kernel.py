"""PyTorch port, kernel K6 on the CPU: the route of
``AlignmentLayer(method='quaternion')`` (float32 frames on the card go
through the operator ``cvf_torch::kabsch_qcp_exact``; the CPU, float64,
``align_frames`` itself and K2's plain version and backward never reach
it), the operator's CPU kernel and its derivatives against the plain chain
bit for bit, its fake implementation, and a quaternion-aligned CV's
exported program holding it. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import io

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import logging_utils
from colvarsfinder_tpu_torch.export import _export_program
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops import alignment as tal
from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
    FusedAlignmentLayer,
    align_frames_fused_cuda,
    kabsch_exact_launch,
    kabsch_rotations_exact,
)

K6 = "cvf_torch.kabsch_qcp_exact.default"


class _Ops(TorchDispatchMode):
    """The names of the operators dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        return func(*args, **(kwargs or {}))


def _frames(B, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((10, 3))
    x = base[None] + 0.3 * rng.standard_normal((B, 10, 3))
    return x.astype(dtype), (base - base.mean(0)).astype(dtype)


def _covariances(B, seed):
    x, ref = _frames(B, seed)
    xc = x - x.mean(1, keepdims=True)
    C = np.einsum("bmi,mj->bij", xc, ref).astype(np.float32)
    C[3] = 0.0  # degenerate: the identity
    C[5] = -C[5]  # reflected
    return torch.from_numpy(C)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_layer_on_the_cpu_takes_the_plain_chain(dtype):
    """No operator, no launch: CPU frames of either dtype are solved by the
    plain chain, counted in ``cvf.align.quat_plain``, with the values of
    ``align_frames``."""
    x, ref = _frames(9, seed=1, dtype=dtype)
    layer = port.AlignmentLayer(ref, list(range(10)))
    xt = torch.from_numpy(x)
    layer = layer.to(xt.dtype)
    logging_utils.reset_trace()
    _cuda.reset_launch_counts()
    with _Ops() as ops:
        out = layer(xt)
    assert K6 not in ops.names
    assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)
    got = logging_utils.counters()
    assert got["cvf.align.quat_plain"] == 9
    assert "cvf.align.quat_kernel" not in got
    assert torch.equal(out, tal.align_frames(xt, layer.ref_centered,
                                             layer.align_idx))
    logging_utils.reset_trace()


def test_align_frames_and_k2_plain_paths_never_reach_k6():
    """``align_frames`` called directly, K2's plain version (its operator's
    CPU kernel) and K2's recorded vjp stay the plain chain; neither counts
    a quaternion layer's frames."""
    x, ref = _frames(7, seed=2)
    xt = torch.from_numpy(x).requires_grad_()
    reft = torch.from_numpy(ref)
    idx = torch.arange(10)
    logging_utils.reset_trace()
    with _Ops() as ops:
        tal.align_frames(xt, reft, idx, method="quaternion")
        out = align_frames_fused_cuda(xt, reft, idx)
        (g,) = torch.autograd.grad((out ** 2).sum(), xt, create_graph=True)
        g.sum().backward()
        FusedAlignmentLayer(ref, list(range(10)))(xt.detach())
    assert K6 not in ops.names
    assert not any(n.startswith("cvf.align.") for n in logging_utils.counters())


@pytest.mark.parametrize("diff_steps", [0, 2])
def test_k6_cpu_kernel_and_derivatives_equal_the_plain_chain(diff_steps):
    """The operator's CPU kernel is the plain chain under the Newton mode
    it is given; through K6's ``autograd.Function`` the rotations, the
    gradient by the covariances and the second derivative by parameters
    downstream of the first (the generator loss's) are the plain chain's to
    the bit. The second derivative by the covariances themselves sums its
    two branches into C in another order: equal within rounding."""
    C = _covariances(64, seed=3)
    gen = torch.Generator().manual_seed(diff_steps)
    theta = torch.randn(64, 3, 3, generator=gen).requires_grad_()

    def run(solve):
        Cg = C.clone().requires_grad_()
        R = solve(Cg)
        (gC,) = torch.autograd.grad((theta * torch.tanh(R)).sum(), Cg,
                                    create_graph=True)
        (g_theta,) = torch.autograd.grad((gC ** 2).sum(), theta,
                                         retain_graph=True)
        (g_C,) = torch.autograd.grad((gC ** 2).sum(), Cg)
        return R.detach(), gC.detach(), g_theta, g_C

    with tal.newton_diff_mode(diff_steps):
        plain = tal.kabsch_rotations_quat(C)
        assert torch.equal(
            torch.ops.cvf_torch.kabsch_qcp_exact(C, diff_steps), plain)
        got, want = run(kabsch_rotations_exact), run(tal.kabsch_rotations_quat)
    assert torch.equal(got[0], plain)
    assert torch.equal(plain[3], torch.eye(3))
    # bit for bit, the zero frame's NaN gradient included (sqrt at 0)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5,
                               equal_nan=True)


_W = torch.randn(3, 3, generator=torch.Generator().manual_seed(7))
_TRANSFORMS = {
    "vmap": lambda f, C: torch.func.vmap(f)(C.reshape(4, 16, 3, 3)),
    "vmap of dim 1": lambda f, C: torch.func.vmap(f, in_dims=1)(
        C.reshape(16, 4, 3, 3)),
    "grad": lambda f, C: torch.func.grad(
        lambda c: (torch.tanh(f(c)) * _W).sum())(C),
    "vmap of jacrev": lambda f, C: torch.func.vmap(torch.func.jacrev(f))(
        C.reshape(16, 4, 3, 3)),
    "jacfwd": lambda f, C: torch.func.jacfwd(f)(C[:4]),
    "jacrev of jacrev": lambda f, C: torch.func.jacrev(torch.func.jacrev(
        lambda c: (torch.tanh(f(c)) * _W).sum()))(C[:3]),
    "grad by a parameter of vjps": lambda f, C: torch.func.grad(
        lambda w: (torch.func.vjp(f, C)[1](torch.tanh(w).expand(64, 3, 3))[0]
                   ** 2).sum())(_W),
}


@pytest.mark.parametrize("transform", list(_TRANSFORMS))
@pytest.mark.parametrize("diff_steps", [0, 2])
def test_k6_under_torch_func_equals_the_plain_chain(transform, diff_steps):
    """K6's ``autograd.Function`` and operator compose with the
    ``torch.func`` transforms (the vmap rule folds the mapped dimension
    into the batch; backward and forward mode are the plain chain's
    ``torch.func.vjp`` and ``jvp``): every value equal to the plain chain's
    under the same transform, bit for bit, through the operator's CPU
    kernel; as in ordinary autograd, a second derivative by the covariances
    themselves sums its branches in another order, equal within rounding."""
    C = _covariances(64, seed=6)
    run = _TRANSFORMS[transform]
    with tal.newton_diff_mode(diff_steps):
        got = run(kabsch_rotations_exact, C)
        want = run(tal.kabsch_rotations_quat, C)
    assert float(want.nan_to_num().abs().max()) > 0
    tol = 1e-5 if transform == "jacrev of jacrev" else 0.0
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)


def test_k6_fake_implementation_and_what_it_refuses():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        C = torch.empty(11, 3, 3)
        R = torch.ops.cvf_torch.kabsch_qcp_exact(C, 0)
        assert R.shape == (11, 3, 3) and R.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        kabsch_rotations_exact(_covariances(8, seed=4).double())
    with pytest.raises(ValueError, match="CUDA"):
        kabsch_exact_launch(_covariances(8, seed=4), 16)
    assert _cuda.launch_counts()["kabsch_exact"] == 0


def test_exported_quaternion_cv_holds_k6():
    """A trace sees float32 frames as fake tensors: the quaternion layer
    puts the operator in the program, which runs its plain chain on the CPU
    and equals the live CV bit for bit."""
    x, ref = _frames(5, seed=5)
    cv = port.ColvarModel(
        port.PreprocessingANN(
            port.AlignmentLayer(ref, list(range(10))),
            port.FeatureLayer([port.Feature("p", "position",
                                            list(range(10)))])),
        port.EigenFunctions([30, 8, 1], 2))
    logging_utils.reset_trace()
    blob = _export_program(cv, (10, 3), with_grad=False)
    # a symbolic trace solves no frames, and counts none (the plain frames
    # are the probe call's, which sizes the CV's output)
    got = logging_utils.counters()
    assert "cvf.align.quat_kernel" not in got
    assert got["cvf.align.quat_plain"] == 2
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(K6) == 1
    params = [t.detach() for t in cv.state_dict().values()]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert torch.equal(program.module()(params, xt), cv(xt))
    logging_utils.reset_trace()


def test_exported_quaternion_gradient_program_holds_k6():
    """The gradient program of a quaternion-aligned CV traces K6's forward
    (the operator) and its backward (the plain chain's, by
    ``torch.func.grad``): values and input Jacobian equal the live CV's
    bit for bit."""
    x, ref = _frames(5, seed=6)
    cv = port.ColvarModel(
        port.PreprocessingANN(
            port.AlignmentLayer(ref, list(range(10))),
            port.FeatureLayer([port.Feature("p", "position",
                                            list(range(10)))])),
        port.EigenFunctions([30, 8, 1], 2))
    program = torch.export.load(io.BytesIO(
        _export_program(cv, (10, 3), with_grad=True)))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(K6) == 1
    params = [t.detach() for t in cv.state_dict().values()]
    y, jac = program.module()(params, torch.from_numpy(x))
    xg = torch.from_numpy(x).requires_grad_()
    out = cv(xg)
    want = torch.stack([torch.autograd.grad(out[:, i].sum(), xg,
                                            retain_graph=True)[0]
                        for i in range(out.shape[1])], dim=1)
    assert torch.equal(y, out.detach())
    assert float(want.abs().max()) > 0
    assert torch.equal(jac, want)
    logging_utils.reset_trace()
