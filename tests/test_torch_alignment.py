"""PyTorch port, alignment: the QCP and SVD Kabsch solvers, align_frames,
the plain path of kernel K1 (against the JAX Pallas kernel in interpret
mode) and of kernel K2 (FusedAlignmentLayer), all against the JAX package
on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.ops import alignment as jal
from colvarsfinder_tpu.ops.kabsch_pallas import FusedAlignmentLayer as JaxFused
from colvarsfinder_tpu.ops.kabsch_pallas import (
    align_frames_fused_pallas,
    kabsch_rotations_pallas,
)

from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops import alignment as tal
from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
    AlignShape,
    FusedAlignmentLayer,
    align_frames_fused_cuda,
    align_launch_shape,
    kabsch_rotations_cuda,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(B, N, m, seed, noise=0.3):
    """Noisy copies of one structure; align atoms a subset of the N."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((N, 3))
    x = base[None] + noise * rng.standard_normal((B, N, 3))
    idx = np.sort(rng.choice(N, size=m, replace=False))
    ref = base[idx] - base[idx].mean(0)
    return x.astype(np.float32), ref.astype(np.float32), idx


def _covariances(B, seed, m=6):
    x, ref, _ = _frames(B, m, m, seed)
    xc = x - x.mean(1, keepdims=True)
    return np.einsum("bmi,mj->bij", xc, ref).astype(np.float32)


B = 37  # not a multiple of any tile


@pytest.mark.parametrize("solver", ["quat", "svd"])
def test_rotation_solvers_match_jax(solver):
    C = _covariances(B, seed=0)
    R_t = getattr(tal, f"kabsch_rotations_{solver}")(torch.from_numpy(C))
    R_j = getattr(jal, f"kabsch_rotations_{solver}")(jnp.asarray(C))
    # f32 3x3 arithmetic in two libraries: the JAX package's QCP-vs-SVD bar
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=2e-5)


@pytest.mark.parametrize("method", ["quaternion", "svd", "cuda", "pallas"])
def test_align_frames_matches_jax(method):
    x, ref, idx = _frames(B, 10, 6, seed=1)
    out_t = tal.align_frames(torch.from_numpy(x), torch.from_numpy(ref),
                             torch.as_tensor(idx), method=method)
    # 'cuda' runs its plain version on CPU tensors; JAX's reference for it
    # is the QCP path its Pallas kernel shares
    jmethod = "quaternion" if method in ("cuda", "pallas") else method
    out_j = jal.align_frames(jnp.asarray(x), jnp.asarray(ref),
                             jnp.asarray(idx), method=jmethod)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)


def test_k1_plain_path_matches_jax_pallas_kernel():
    """kabsch_rotations_cuda on a CPU tensor is K1's plain version; the JAX
    Pallas kernel runs in interpret mode here, as in test_kabsch_pallas."""
    C = _covariances(B, seed=2)
    C[3] = 0.0  # degenerate frame
    _cuda.reset_launch_counts()
    R_t = kabsch_rotations_cuda(torch.from_numpy(C)).numpy()
    assert _cuda.LAUNCHES["kabsch_qcp"] == 0
    R_j = np.asarray(kabsch_rotations_pallas(jnp.asarray(C)))
    np.testing.assert_allclose(R_t, R_j, atol=2e-5)
    np.testing.assert_array_equal(R_t[3], np.eye(3, dtype=np.float32))


def test_fused_layer_plain_path_matches_jax():
    # random frames, as the JAX package's fused-kernel test uses: 2e-4 is
    # its bar (f32 QCP lands ~1e-4 apart on near-degenerate frames)
    rng = np.random.default_rng(3)
    m, N = 6, 10
    ref = rng.standard_normal((m, 3)).astype(np.float32)
    ref -= ref.mean(0)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    idx = np.asarray([0, 2, 3, 5, 7, 9])
    _cuda.reset_launch_counts()
    layer = FusedAlignmentLayer(ref, idx)
    out_t = layer(torch.from_numpy(x)).numpy()
    out_f = align_frames_fused_cuda(torch.from_numpy(x), torch.from_numpy(ref),
                                    idx).numpy()
    assert _cuda.LAUNCHES["fused_align"] == 0
    out_j = np.asarray(jal.align_frames(jnp.asarray(x), jnp.asarray(ref),
                                        jnp.asarray(idx), method="quaternion"))
    np.testing.assert_allclose(out_t, out_j, atol=2e-4)
    np.testing.assert_allclose(out_f, out_j, atol=2e-4)
    # a single frame
    np.testing.assert_allclose(layer(torch.from_numpy(x[0])).numpy(),
                               out_j[0], atol=2e-4)
    with pytest.raises(IndexError):
        layer(torch.zeros(2, 9, 3))


@pytest.mark.parametrize(
    "N,m,shape",
    [
        # staged: 32 frames per block of 128 threads, a frame at an odd
        # stride (3N | 1 floats), 13 rotation floats per frame, the
        # reference and the indices
        (1, 1, AlignShape(32, 128, 4 * (32 * 3 + 32 * 13 + 4))),
        (10, 10, AlignShape(32, 128, 4 * (32 * 31 + 32 * 13 + 40))),
        (22, 10, AlignShape(32, 128, 4 * (32 * 67 + 32 * 13 + 40))),
        # the largest frames whose tile fits one block's shared memory
        (580, 100, AlignShape(32, 128, 4 * (32 * 1741 + 32 * 13 + 400))),
        # past that the direct variant, one thread per frame
        (600, 100, AlignShape(0, 256, 0)),
        (5000, 100, AlignShape(0, 256, 0)),
    ],
)
def test_k2_launch_shape(N, m, shape):
    got = align_launch_shape(N, m)
    assert got == shape
    assert got.blocks(20000) == -(-20000 // (got.tile or 256))
    assert got.smem_bytes <= 232_448


@pytest.mark.parametrize("layer_cls", ["align", "fused"])
def test_degenerate_frames_give_identity(layer_cls):
    x, ref, idx = _frames(4, 8, 5, seed=4)
    x[:, idx] = x[:, idx[:1]]  # all align atoms coincide
    if layer_cls == "align":
        layer = tal.AlignmentLayer(ref, idx, method="quaternion")
    else:
        layer = FusedAlignmentLayer(ref, idx)
    out = layer(torch.from_numpy(x)).numpy()
    com = x[:, idx].mean(1, keepdims=True)
    np.testing.assert_allclose(out, x - com, atol=1e-6)
    assert np.isfinite(out).all()


def _jax_input_grad(x, ref, idx, coef, method):
    def f(xx):
        o = jal.align_frames(xx, jnp.asarray(ref), jnp.asarray(idx),
                             method=method)
        return (o**2 * coef).sum()

    return np.asarray(jax.grad(f)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def grad_case():
    """One JAX gradient through the QCP path (its 16 unrolled Newton steps
    take seconds to trace), shared by the two tests that compare with it."""
    x, ref, idx = _frames(6, 8, 5, seed=5)
    coef = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    return x, ref, idx, coef, _jax_input_grad(x, ref, idx, coef, "quaternion")


def _torch_input_grad(fn, x, coef):
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad((fn(xt) ** 2 * torch.from_numpy(coef)).sum(),
                               xt)
    return g.numpy()


# the JAX package's bar for alignment gradients (test_kabsch_pallas)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("method", ["quaternion", "svd"])
def test_input_gradients_match_jax(grad_case, method):
    x, ref, idx, coef, g_quat = grad_case
    g_j = g_quat if method == "quaternion" else _jax_input_grad(
        x, ref, idx, coef, method)
    g_t = _torch_input_grad(
        lambda xt: tal.align_frames(xt, torch.from_numpy(ref),
                                    torch.as_tensor(idx), method=method),
        x, coef,
    )
    np.testing.assert_allclose(g_t, g_j, **GRAD_TOL)


def test_fused_layer_gradient_matches_jax(grad_case):
    """K2's backward is autograd of the plain QCP alignment, as the JAX
    custom_vjp's is."""
    x, ref, idx, coef, g_j = grad_case
    g_t = _torch_input_grad(FusedAlignmentLayer(ref, idx), x, coef)
    np.testing.assert_allclose(g_t, g_j, **GRAD_TOL)


@pytest.mark.parametrize("diff_steps", [0, 2])
def test_quaternion_diff_steps_match_jax(diff_steps):
    """Rotation entries and their gradient w.r.t. the normalized covariance,
    fully unrolled (0) and implicit (2 differentiable Newton steps after a
    detached convergence), against the JAX function in the same mode."""
    C = _covariances(8, seed=10)
    C /= np.linalg.norm(C.reshape(8, 9), axis=1)[:, None, None]
    coef = np.random.default_rng(11).standard_normal((9, 8)).astype(np.float32)

    def scalar(lib, c, w9):
        c9 = tuple(c[:, i, j] for i in range(3) for j in range(3))
        q = lib.quaternion_from_covariance(c9, diff_steps=diff_steps)
        R = lib.quaternion_to_rotation_entries(*q)
        return sum((r * w).sum() for r, w in zip(R, w9))

    Ct = torch.from_numpy(C).requires_grad_()
    val_t = scalar(tal, Ct, torch.from_numpy(coef))
    (g_t,) = torch.autograd.grad(val_t, Ct)
    val_j, g_j = jax.value_and_grad(
        lambda c: scalar(jal, c, jnp.asarray(coef)))(jnp.asarray(C))
    # f32 QCP in two libraries: the QCP bar above and the gradient bar below
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD_TOL)


def test_weighted_alignment_layer_matches_jax():
    x, ref, idx = _frames(B, 9, 5, seed=8)
    aw = np.random.default_rng(9).uniform(1.0, 16.0, 5).astype(np.float32)
    lt = tal.AlignmentLayer(ref, idx, align_weights=aw)
    lj = jal.AlignmentLayer(ref, idx, align_weights=aw)
    np.testing.assert_allclose(lt(torch.from_numpy(x)).numpy(),
                               np.asarray(lj(jnp.asarray(x))), atol=2e-5)
    with pytest.raises(ValueError):
        tal.AlignmentLayer(ref, idx, method="bogus")


@pytest.fixture
def jax_float64():
    """The JAX package in float64 mode, float32 restored afterwards."""
    jconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")


def _f64_case(kind):
    """A float64 input of one K1 or K2 entry point: (JAX kernel, the JAX
    formulation its custom_vjp differentiates, port function, input, bar on
    the values)."""
    rng = np.random.default_rng(12)
    N, m = 8, 5
    base = rng.standard_normal((N, 3))
    x = base[None] + 0.3 * rng.standard_normal((B, N, 3))
    idx = np.asarray([0, 2, 3, 5, 7])
    ref = base[idx] - base[idx].mean(0)
    if kind == "kabsch":
        sel = x[:, idx] - x[:, idx].mean(1, keepdims=True)
        C = np.einsum("bmi,mj->bij", sel, ref)
        return (kabsch_rotations_pallas, jal.kabsch_rotations_svd,
                kabsch_rotations_cuda, C, 2e-5)

    def jax_align(method, r=ref):
        return lambda xx: jal.align_frames(xx, jnp.asarray(r),
                                           jnp.asarray(idx), method=method)

    if kind == "align_frames":
        return (jax_align("pallas"), jax_align("svd"),
                lambda xx: tal.align_frames(xx, torch.from_numpy(ref),
                                            torch.as_tensor(idx),
                                            method="cuda"),
                x, 2e-5)
    # K2's backward differentiates the QCP alignment at x, with the float32
    # reference the kernel saw
    plain = jax_align("quaternion", ref.astype(np.float32))
    if kind == "fused":
        return (lambda xx: align_frames_fused_pallas(xx, ref, idx), plain,
                lambda xx: align_frames_fused_cuda(xx, torch.from_numpy(ref),
                                                   idx),
                x, 2e-4)
    layer = FusedAlignmentLayer(ref, idx)
    return (JaxFused(ref, idx), plain,
            layer.double() if kind == "layer_float64" else layer, x, 2e-4)


@pytest.mark.parametrize(
    "kind", ["kabsch", "align_frames", "fused", "layer", "layer_float64"])
def test_float64_inputs_match_jax_kernels(jax_float64, kind):
    """Like the JAX kernels, K1 and K2 take float64 input and compute in
    float32; the port returns the input's dtype (torch does not promote
    across einsum). Their backward differentiates the plain formulation at
    the float64 input. The JAX custom_vjps mean the same, but raise under
    x64 (the float32 cotangent of their output meets the float64 input), so
    the JAX gradient is taken of the formulation they differentiate."""
    f_jax, f_jax_bwd, f_port, x, atol = _f64_case(kind)
    coef = np.random.default_rng(13).standard_normal(x.shape)
    _cuda.reset_launch_counts()
    xt = torch.from_numpy(x).requires_grad_()
    out_t = f_port(xt)
    (g_t,) = torch.autograd.grad((out_t ** 2 * torch.from_numpy(coef)).sum(),
                                 xt)
    assert _cuda.launch_counts() == {k: 0 for k in _cuda.LAUNCHES}
    assert out_t.dtype == g_t.dtype == torch.float64
    out_j = np.asarray(f_jax(jnp.asarray(x)))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=atol)
    g_j = np.asarray(jax.grad(
        lambda xx: (f_jax_bwd(xx) ** 2 * jnp.asarray(coef)).sum())(
            jnp.asarray(x)))
    assert g_j.dtype == np.float64
    np.testing.assert_allclose(g_t.numpy(), g_j, **GRAD_TOL)
