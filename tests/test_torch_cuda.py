"""PyTorch port on the card: CUDA kernels K1-K4 against their plain PyTorch
versions, K1's and K2's backward differentiated twice, training epochs
(transfer operator, generator, committor, the autoencoders) captured as CUDA
graphs against the same epochs run eagerly, the exported CV programs
running K1 and K2 against the live CV, replica sweeps (a captured sweep
epoch against the eager one, K2 per sweep epoch independent of the replica
count, the bf16 Gram form's vmap rule, bf16 sweeps keeping float32
parameters), and the streaming layout (streamed runs against resident runs
and captured streamed steps against eager ones, launches per streamed step,
pinned host buffers, the copies on their own stream, K1 and K2 streamed),
and the data mesh at one rank of an NCCL group (captured meshed epochs and
streamed steps against eager and unmeshed ones, NCCL's kernel in each
replayed step, a meshed sweep), the stacked heads' products split along
the batch (replays counting them, bit for bit equal to eager epochs), K5
(grouped pair distances) against its plain version, its backward, and a
captured distance epoch against eager epochs, and
the samplers (each report block a
captured graph bit for bit equal to eager blocks, one replay per block,
metadynamics through K2 against the quaternion layer, a failed capture).
Every test here needs an NVIDIA card and ``nvcc``: it
carries the ``cuda`` marker and skips where ``torch.cuda.is_available()`` is
false. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch (``-s`` shows the graph-against-eager gaps):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from colvarsfinder_tpu_torch import (
    AutoEncoder,
    AutoEncoderTask,
    ColvarModel,
    CommittorTask,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    RegAutoEncoder,
    RegAutoEncoderTask,
    WeightedTrajectory,
    export_colvar,
    load_colvar,
)
from colvarsfinder_tpu_torch.core.losses import _gram_quadratic_form
from colvarsfinder_tpu_torch.models import EigenFunctions, create_sequential_nn
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch import graphs, logging_utils
from colvarsfinder_tpu_torch.ops.alignment import (
    AlignmentLayer,
    align_frames,
    kabsch_rotations_quat,
    newton_diff_mode,
)
from colvarsfinder_tpu_torch.ops.features import Lambda
from colvarsfinder_tpu_torch.ops.fused_eigen import (
    _mlp_heads,
    bwd_launch_shape,
    bwd_resident_blocks,
    eigen_loss_from_stats,
    flatten_params,
    fwd_launch_shape,
    fwd_resident_blocks,
    params_t_of,
    stats_fwd_launch,
    transfer_stats,
    transfer_stats_reference,
)
from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
    KABSCH_TILE,
    KABSCH_TILES,
    AlignShape,
    FusedAlignmentLayer,
    align_launch_shape,
    align_resident_blocks,
    align_smem_bytes,
    fused_align_launch,
    kabsch_exact_launch,
    kabsch_qcp_launch,
    kabsch_resident_blocks,
    kabsch_rotations_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3)


def _frames(B, N, m, seed, noise=0.3):
    """Noisy, randomly rotated and shifted copies of one structure, the
    align atoms a subset of the N atoms."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((N, 3))
    R = _rotations(rng, B)
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


def _k6_covariances(B, seed):
    """B seeded covariances of noisy frames, then the cases K6 must solve
    as PyTorch does: zero and below the 1e-12 norm (the identity),
    reflected (det < 0), rank 2, a nearly or exactly double top singular
    value, and huge and tiny scales."""
    x, ref, idx = _frames(B, 10, 10, seed=seed)
    xc = x - x.mean(1, keepdims=True)
    main = np.einsum("bmi,mj->bij", xc, ref)
    rng = np.random.default_rng(seed + 1)
    U, V = (np.linalg.qr(rng.standard_normal((64, 3, 3)))[0]
            for _ in range(2))

    def usv(svals):
        s = np.asarray(svals)[np.arange(64) % len(svals)]
        return np.einsum("bij,bj,bkj->bik", U, s, V)

    cases = {
        "zero and below 1e-12": np.concatenate(
            [np.zeros((1, 3, 3)), 1e-13 * main[:8]]),
        "reflected": -main[:64],
        "rank 2": usv([(1.0, 0.5, 0.0), (2.0, 1e-3, 0.0)]),
        "double top": usv([(1.0, 1.0 - e, 0.3) for e in (1e-4, 1e-6, 0.0)]),
        "huge": 1e15 * main[:64],
        "tiny": 1e-10 * main[:64],
    }
    return main.astype(np.float32), {k: v.astype(np.float32)
                                     for k, v in cases.items()}


@pytest.mark.parametrize("diff_steps", [0, 2])
def test_k6_equals_the_plain_chain_bit_for_bit(dev, diff_steps):
    """K6 (no FMA contraction, the chain's order) against the plain chain
    run by PyTorch's kernels on the card: every bit, at B = 20,000 seeded
    frames, one frame, a ragged 37 and each case of _k6_covariances, with
    16 Newton steps plus the mode's extra ones; one launch a call, and
    none for no frames."""
    main, cases = _k6_covariances(20000, seed=6)
    cases = {"B = 20,000": main, "B = 1": main[:1], "B = 37": main[:37],
             **cases}
    for what, C in cases.items():
        C = torch.from_numpy(C).to(dev)
        _cuda.reset_launch_counts()
        got = kabsch_exact_launch(C, 16 + diff_steps)
        assert _cuda.LAUNCHES["kabsch_exact"] == 1
        with newton_diff_mode(diff_steps):
            want = kabsch_rotations_quat(C)
        torch.cuda.synchronize()
        assert torch.isfinite(want).all(), what
        bad = int((got != want).any(dim=(1, 2)).sum())
        assert bad == 0, f"{what}: {bad} of {C.shape[0]} frames differ"
    zero = kabsch_exact_launch(torch.zeros(1, 3, 3, device=dev), 16)
    assert torch.equal(zero[0], torch.eye(3, device=dev))
    _cuda.reset_launch_counts()
    none = kabsch_exact_launch(torch.empty(0, 3, 3, device=dev), 16)
    assert none.shape == (0, 3, 3) and _cuda.LAUNCHES["kabsch_exact"] == 0


@pytest.mark.parametrize("diff_steps", [0, 2])
def test_quaternion_layer_on_the_card_is_the_plain_chain(dev, diff_steps):
    """AlignmentLayer(method='quaternion') on float32 frames: one K6 launch
    a call, its values, input gradients and second derivatives (by the
    parameters after it, as the generator loss takes them) equal to the
    plain chain's (``align_frames``) bit for bit; float64 frames on the
    card take the plain chain, with no launch."""
    x, ref, idx = _frames(20000, 10, 10, seed=8)
    x = torch.from_numpy(x).to(dev)
    theta = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (10, 3)).astype(np.float32)).to(dev)
    layer = AlignmentLayer(ref, idx).to(dev)

    def plain(xx):
        return align_frames(xx, layer.ref_centered, layer.align_idx)

    with newton_diff_mode(diff_steps):
        logging_utils.reset_trace()
        _cuda.reset_launch_counts()
        out = layer(x)
        assert _cuda.launch_counts() == {**dict.fromkeys(_cuda.KERNELS, 0),
                                         "kabsch_exact": 1}
        assert logging_utils.counters()["cvf.align.quat_kernel"] == 20000
        assert torch.equal(out, plain(x))
        grads = []
        for f in (layer, plain):
            xt = x.clone().requires_grad_()
            (g,) = torch.autograd.grad((theta * torch.tanh(f(xt))).sum(), xt)
            grads.append(g)
        assert torch.equal(*grads)
        _cuda.reset_launch_counts()
        got = _second_order(layer, x, theta)
        assert _cuda.LAUNCHES["kabsch_exact"] == 1
        want = _second_order(plain, x, theta)
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)
        layer64 = AlignmentLayer(ref, idx).to(dev, torch.float64)
        _cuda.reset_launch_counts()
        out64 = layer64(x.double())
        assert sum(_cuda.launch_counts().values()) == 0
        assert logging_utils.counters()["cvf.align.quat_plain"] == 20000
        assert torch.equal(out64, align_frames(
            x.double(), layer64.ref_centered, layer64.align_idx))
    logging_utils.reset_trace()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("diff_steps", [0, 2])
def test_quaternion_layer_under_torch_func_is_k6(dev, diff_steps, weighted):
    """Under ``torch.func.vmap`` (the samplers' chains, a sweep's replicas)
    and ``jacrev`` the layer still solves float32 frames through K6, the
    mapped dimension folded into one launch, with the plain chain's bits:
    values, per-frame input Jacobians and their derivative by parameters
    after the layer; 22 atoms with 10 align indices, weighted or not."""
    x, ref, idx = _frames(4096, 22, 10, seed=14)
    w = (np.random.default_rng(15).uniform(0.5, 2.0, 10).astype(np.float32)
         if weighted else None)
    layer = AlignmentLayer(ref, idx, align_weights=w).to(dev)
    xs = torch.from_numpy(x).to(dev).reshape(8, 512, 22, 3)
    theta = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (22, 3)).astype(np.float32)).to(dev)

    def plain(xx):
        if xx.dim() == 2:
            return plain(xx[None])[0]
        return align_frames(xx, layer.ref_centered, layer.align_idx,
                            layer.align_weights)

    def jac(f, th):
        # per frame: d/dx sum th * tanh(f(x)), mapped over the frames
        return torch.func.vmap(torch.func.jacrev(
            lambda fr: (th * torch.tanh(f(fr))).sum()))(xs[0])

    with newton_diff_mode(diff_steps):
        logging_utils.reset_trace()
        _cuda.reset_launch_counts()
        out = torch.func.vmap(layer)(xs)
        assert _cuda.launch_counts() == {**dict.fromkeys(_cuda.KERNELS, 0),
                                         "kabsch_exact": 1}
        assert logging_utils.counters()["cvf.align.quat_kernel"] == 512
        assert torch.equal(out, torch.func.vmap(plain)(xs))
        _cuda.reset_launch_counts()
        got = jac(layer, theta)
        assert _cuda.LAUNCHES["kabsch_exact"] == 1
        want = jac(plain, theta)
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)
        th = theta.clone().requires_grad_()
        (g_got,) = torch.autograd.grad((jac(layer, th) ** 2).sum(), th)
        (g_want,) = torch.autograd.grad((jac(plain, th) ** 2).sum(), th)
        assert torch.equal(g_got, g_want)
    logging_utils.reset_trace()


def test_quaternion_layer_captured_equals_eager(dev):
    """The layer's K6 launch captured in a CUDA graph: each replay equals
    the eager call bit for bit, on new frames copied into the input."""
    x, ref, idx = _frames(20000, 10, 10, seed=10)
    layer = AlignmentLayer(ref, idx).to(dev)
    static = torch.from_numpy(x).to(dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        layer(static)  # warm-up: loads K6
        graph = torch.cuda.CUDAGraph()
        with graphs.held_counts() as held:
            with torch.cuda.graph(graph, stream=stream):
                out = layer(static)
    torch.cuda.current_stream().wait_stream(stream)
    assert held["kabsch_exact"] == 1
    assert held["cvf.align.quat_kernel"] == 20000
    for seed in (11, 12):
        static.copy_(torch.from_numpy(_frames(20000, 10, 10, seed)[0]))
        graphs.replay(graph, held)
        torch.cuda.synchronize()
        assert torch.equal(out, layer(static))
        assert torch.equal(out, align_frames(static, layer.ref_centered,
                                             layer.align_idx))


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


T = align_launch_shape(10, 10).tile
DIRECT = AlignShape(0, 256, 0)


def _k2_case(dev, B, N, m, order, seed):
    x, ref, idx = _frames(B, N, m, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if order == "unsorted":
        idx = rng.permutation(idx)
    elif order == "repeated":
        idx = np.concatenate([idx[: m - 2], idx[:2]])[rng.permutation(m)]
        ref = x[0, idx] - x[0, idx].mean(0)
    x[0, idx] = x[0, idx[0]]  # coincident align atoms: identity rotation
    return (torch.from_numpy(x).to(dev), torch.from_numpy(ref).to(dev),
            torch.as_tensor(idx, device=dev))


@pytest.mark.parametrize(
    "B,N,m,order",
    [(1, 10, 10, "sorted"), (37, 10, 10, "sorted"), (T - 1, 10, 10, "sorted"),
     (T, 10, 6, "sorted"), (T + 1, 10, 6, "sorted"),
     (20000, 10, 10, "sorted"), (20000, 10, 6, "sorted"),
     (257, 10, 8, "repeated"),
     # the dipeptide's atoms (examples/dipeptide/top.gro), 10 align atoms
     (2000, 22, 10, "unsorted"),
     # too large for a shared-memory tile: the direct variant
     (300, 5000, 100, "unsorted")],
)
def test_k2_variants_match_plain_and_repeat_bitwise(dev, B, N, m, order):
    x, ref, idx = _k2_case(dev, B, N, m, order, seed=B + N)
    idx32 = idx.to(torch.int32)
    shape = align_launch_shape(N, m)
    assert (shape.tile == 0) == (N == 5000)
    _cuda.reset_launch_counts()
    out = fused_align_launch(x, ref, idx32)
    again = fused_align_launch(x, ref, idx32)
    direct = fused_align_launch(x, ref, idx32, DIRECT)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fused_align"] == 3
    # no atomics, a fixed order: two calls agree bit for bit, and both
    # variants compute the same expressions in the same order
    assert torch.equal(out, again)
    assert torch.equal(out, direct)
    want = align_frames(x, ref, idx, method="quaternion")
    # the CPU tests' bar for the fused alignment
    torch.testing.assert_close(out, want, atol=2e-4, rtol=0)
    # the degenerate frame is the frame minus its centroid
    torch.testing.assert_close(out[0], x[0] - x[0, idx].mean(0), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("tile", [32, 64, 128])
def test_k2_tiles_and_an_unaligned_input_equal_the_direct_variant(dev, tile):
    B, N, m = 20000, 10, 10
    x, ref, idx = _k2_case(dev, B, N, m, "unsorted", seed=tile)
    idx32 = idx.to(torch.int32)
    # a view 4 bytes into its buffer: no tile starts 16-byte aligned
    buf = torch.empty(B * N * 3 + 1, device=dev)
    xv = buf[1:].view(B, N, 3)
    xv.copy_(x)
    assert xv.data_ptr() % 16 == 4
    shape = AlignShape(tile, 128, align_smem_bytes(N, m, tile))
    out = fused_align_launch(xv, ref, idx32, shape)
    want = fused_align_launch(x, ref, idx32, DIRECT)
    torch.cuda.synchronize()
    # the direct variant is held against the plain version above
    assert torch.equal(out, want)
    # the main path's launch shape keeps at least 8 warps on each SM
    assert align_resident_blocks(align_launch_shape(N, m)) * 4 >= 8


def _near_degenerate(n, seed):
    """Covariances U diag(s) V^T [n, 3, 3] (float64) with det > 0 and two
    singular values nearly or exactly equal, which f32 QCP solves to ~6e-7
    of the float64 SVD."""
    rng = np.random.default_rng(seed)
    svals = [(1.0, 1.0 - e, 0.3) for e in (1e-2, 1e-4, 1e-6, 0.0)]
    svals += [(1.0, 0.5, 0.5 - e) for e in (1e-2, 1e-4, 1e-6, 0.0)]
    s = np.asarray(svals)[rng.integers(len(svals), size=n)]
    U, V = _rotations(rng, n), _rotations(rng, n)
    return np.einsum("bij,bj,bkj->bik", U, s, V)


def _covariances(dev, B, seed):
    x, ref, idx = _frames(B, 10, 10, seed=seed)
    sel = torch.from_numpy(x).to(dev)
    C = torch.einsum("bmi,mj->bij", sel - sel.mean(1, keepdim=True),
                     torch.from_numpy(ref).to(dev))
    return C.contiguous()


@pytest.mark.parametrize("case", ["edge_tile", "unaligned", "near_degenerate"])
def test_k1_cases_match_plain(dev, case):
    if case == "near_degenerate":
        C = torch.from_numpy(_near_degenerate(4096, seed=7).astype(np.float32)
                             ).to(dev)
    else:
        # one frame past a multiple of the tile; a view 4 bytes into its
        # buffer, so no tile starts 16-byte aligned
        B = 4 * KABSCH_TILE + 1 if case == "edge_tile" else 20000
        C = _covariances(dev, B, seed=B)
    C[1] = 0.0
    if case == "unaligned":
        buf = torch.empty(C.numel() + 1, device=dev)
        view = buf[1:].view(C.shape)
        view.copy_(C)
        assert view.data_ptr() % 16 == 4
        C = view
    R = kabsch_qcp_launch(C)
    torch.cuda.synchronize()
    # the CPU tests' bar for the QCP paths
    torch.testing.assert_close(R, kabsch_rotations_quat(C), atol=2e-5, rtol=0)
    assert torch.equal(R[1], torch.eye(3, device=dev))


def test_k1_tiles_equal_bitwise(dev):
    C = _covariances(dev, 20000, seed=3)
    C[5] = 0.0
    want = kabsch_qcp_launch(C)
    for tile in KABSCH_TILES:
        assert torch.equal(kabsch_qcp_launch(C, tile), want), tile
    # the chosen tile fits the main path's 20,000 frames on the card's SMs
    # in one wave
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kabsch_resident_blocks() * KABSCH_TILE * sms >= 20000


@pytest.mark.parametrize("entry", ["kabsch", "align_frames", "fused_layer"])
def test_float64_input_launches_once(dev, entry):
    """Float64 input runs the f32 kernel once and comes back in float64,
    equal to the f32 call on the same values (align_frames forms the
    covariance in float64, so there the f32 call's bar)."""
    x, ref, idx = _frames(512, 10, 6, seed=21)
    x32 = torch.from_numpy(x).to(dev)
    x64 = x32.double()
    name = "fused_align" if entry == "fused_layer" else "kabsch_qcp"
    if entry == "kabsch":
        C32 = _covariances(dev, 512, seed=22)
        run, inputs = kabsch_rotations_cuda, (C32.double(), C32)
    elif entry == "align_frames":
        layers = {dt: AlignmentLayer(ref, idx, method="cuda").to(dev, dt)
                  for dt in (torch.float64, torch.float32)}
        run, inputs = (lambda t: layers[t.dtype](t)), (x64, x32)
    else:
        layer = FusedAlignmentLayer(ref, idx).to(dev)
        run, inputs = layer, (x64, x32)
    _cuda.reset_launch_counts()
    out64 = run(inputs[0])
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == 1
    assert out64.dtype == torch.float64
    want = run(inputs[1]).double()
    if entry == "align_frames":
        torch.testing.assert_close(out64, want, atol=2e-5, rtol=0)
    else:
        assert torch.equal(out64, want)
    if entry == "fused_layer":
        # a layer moved to float64 casts its reference back to float32
        assert torch.equal(layer.double()(x64), out64)


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
     # one sample past a multiple of K4's 64-sample tile (and of K3's 64-
     # or 32-sample tile)
     (4 * 64 + 1, 2, [30, 20, 20, 20, 1]),
     # past the JAX limits (k <= 9, k * hidden <= 256)
     (500, 12, [30, 32, 32, 1]), (2 * 64 + 1, 12, [30, 32, 32, 1]),
     # no hidden layer: K3's output layer reads the input tile itself
     (3 * 64 + 1, 2, [12, 1])],
)
def test_k3_k4_match_plain_and_repeat_bitwise(dev, B, k, dims):
    model, F, Fl, w, wl = _stats_inputs(dev, B, k, dims)
    eig_w = torch.linspace(1.0, 0.2, k, device=dev)
    assert fwd_launch_shape(dims, k).tile == 64
    assert bwd_launch_shape(dims, k).tile == 64

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


def test_k3_head_outputs_and_k4_occupancy(dev):
    """K3's head outputs against the plain heads, and the resident blocks
    of K3 and K4 on the card against the launch-shape helpers."""
    dims, k = (30, 20, 20, 20, 1), 2
    model, F, Fl, w, wl = _stats_inputs(dev, 20000, k, list(dims))
    pt = params_t_of(model)
    _, Y = stats_fwd_launch(flatten_params(pt).detach().contiguous(), F, Fl,
                            w, wl, dims, k)
    with torch.no_grad():
        want = torch.stack([_mlp_heads(pt, F).T, _mlp_heads(pt, Fl).T])
    # f32 FMA chains against cuBLAS: the CPU tests' model-forward bar, x10
    torch.testing.assert_close(Y, want, atol=1e-5, rtol=0)
    # the main path's model keeps at least 16 warps resident on each SM
    shape = bwd_launch_shape(dims, k)
    assert bwd_resident_blocks(dims, k) * shape.threads // 32 >= 16
    # K3: the helper's arithmetic takes the 80-register cap of the launch
    # bounds, so the card holds at least as many blocks; at the main path's
    # shapes B = 20,000 is one wave of them on the card's SMs
    fwd = fwd_launch_shape(dims, k)
    resident = fwd_resident_blocks(dims, k)
    assert resident >= fwd.blocks_per_sm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert resident * sms * fwd.tile >= 20000


# ---------------------------------------------------------------------------
# training epochs captured as CUDA graphs
# ---------------------------------------------------------------------------

# the main path's widths at a tenth of its batch: 5 steps of 2,000 lagged
# pairs and one test batch of 1,200 per epoch
G_FRAMES, G_BATCH, G_LAG, G_DT, G_K = 12_000, 2_000, 5, 0.002, 2
G_DIMS = [30, 20, 20, 20, 1]
G_TRAIN, G_TEST = 5, 1
# per-atom align weights of the K1 route (masses of 1 to 16, seeded)
G_ALIGN_W = np.random.default_rng(1).uniform(1.0, 16.0, 10)
# the training bar of the fused step against the plain one (PERF.md §2)
CURVE_RTOL = {"loss": 2e-3, "eig": 5e-3}
KINDS = ["fused", "plain", "k1", "precompute", "svd"]


def _graph_frames():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    traj = (ref[None] + 0.3 * rng.standard_normal((G_FRAMES, 10, 3))
            ).astype(np.float32)
    return rng, ref, traj


def _graph_task(path, kind, epochs, frames=None, **kw):
    """``fused``: FusedAlignmentLayer + fused_step (K2, K3, K4); ``plain``:
    AlignmentLayer('quaternion') (K6); ``k1``: weighted
    AlignmentLayer('cuda') + fused_step (K1, K3, K4); ``precompute``:
    features computed once, then fused_step (K3, K4); ``svd``:
    AlignmentLayer('svd') + fused_step (K3, K4). ``frames`` replaces the
    trajectory (an array of its shape)."""
    rng, ref, traj = _graph_frames()
    if frames is not None:
        traj = frames
    w = rng.uniform(0.5, 1.5, G_FRAMES).astype(np.float32)
    atoms = list(range(10))
    if kind == "fused":
        align = FusedAlignmentLayer(ref, atoms)
    else:
        method = {"k1": "cuda", "svd": "svd"}.get(kind, "quaternion")
        align = AlignmentLayer(
            ref, atoms, method=method,
            align_weights=G_ALIGN_W if kind == "k1" else None)
    pp = PreprocessingANN(align,
                          FeatureLayer([Feature("p", "position", atoms)]))
    args = dict(alpha=20.0, eig_weights=[1.0, 0.2], lag_tau=G_LAG * G_DT,
                learning_rate=0.002, save_model_every_step=0, k=G_K,
                batch_size=G_BATCH, num_epochs=epochs, test_ratio=0.1,
                verbose=False, tensorboard=False, seed=0, debug_mode=False,
                fused_step=kind != "plain",
                precompute_features=kind == "precompute",
                progress_interval=1)
    args.update(kw)
    traj_obj = WeightedTrajectory(trajectory=traj, weights=w, dt=G_DT,
                                  verbose=False)
    return EigenFunctionTask(traj_obj, pp, EigenFunctions(G_DIMS, G_K, seed=0),
                             str(path), **args)


def _schedule(kind, epochs):
    """Launches per wrapper over ``epochs``: every batch aligns X and X_l
    (K2, K1, or K6 on the plain route) and computes its stats (K3); every
    train step runs K4."""
    n = epochs * (G_TRAIN + G_TEST)
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    if kind != "plain":
        want.update(stats_fwd=n, stats_bwd=epochs * G_TRAIN)
    if kind == "fused":
        want["fused_align"] = 2 * n
    if kind == "k1":
        want["kabsch_qcp"] = 2 * n
    if kind == "plain":
        want["kabsch_exact"] = 2 * n
    return want


def _train(task, epochs=None):
    if epochs is not None:
        task.num_epochs = epochs
    _cuda.reset_launch_counts()
    task.train()
    torch.cuda.synchronize()
    return _cuda.launch_counts()


def _train_eager(task, epochs=None):
    """:func:`_train` with every graph run eagerly: the captured run's
    eager twin."""
    with graphs.eager():
        return _train(task, epochs)


def _rows(task):
    """Every batch's metric row of every epoch, train then test."""
    return np.stack([np.concatenate(epoch) for epoch in task.loss_list])


@pytest.mark.parametrize("kind", KINDS)
def test_captured_epochs_equal_eager_epochs(dev, tmp_path, kind):
    graph = _graph_task(tmp_path / "graph", kind, 5)
    eager = _graph_task(tmp_path / "eager", kind, 5)
    runs = []
    for epochs in (5, 2):
        # a second train() call replays the same graph
        before = graph._graphs.get("epoch")
        counts = _train(graph, epochs)
        assert counts == _schedule(kind, epochs) == _train_eager(eager,
                                                                 epochs)
        assert not eager._graphs
        if before is not None:
            assert graph._graphs["epoch"] is before
        runs.append((_rows(graph), _rows(eager)))
    held = graph._graphs["epoch"].launches
    assert {name: held[name] for name in _cuda.KERNELS} == {
        name: n // 5 for name, n in _schedule(kind, 5).items()}
    # each replay ran the step on new parameters: no epoch repeats the last
    rows = runs[0][0]
    assert all((rows[e] != rows[e - 1]).any() for e in range(1, 5))
    got, want = (np.concatenate(r) for r in zip(*runs))
    if kind in ("fused", "svd"):
        # the same kernels in the same order, launched from a graph (the
        # SVD is one-sided Jacobi in plain tensor ops, which a graph holds)
        np.testing.assert_array_equal(got, want)
        for a, b in zip(graph.model.parameters(), eager.model.parameters()):
            assert torch.equal(a, b)
    else:
        for name, cols in (("loss", slice(0, 1)), ("eig", slice(3, None))):
            gap = float(np.max(np.abs(got[:, cols] - want[:, cols])
                               / np.abs(want[:, cols])))
            print(f"{kind}: graph vs eager {name}: max relative gap {gap:.3e}"
                  f" over 7 epochs (bitwise equal: {np.array_equal(got, want)})")
            np.testing.assert_allclose(got[:, cols], want[:, cols],
                                       rtol=CURVE_RTOL[name])
    np.testing.assert_array_equal(graph._cvec, eager._cvec)


def test_resumed_run_equals_an_uninterrupted_one(dev, tmp_path):
    whole = _graph_task(tmp_path / "whole", "fused", 5)
    _train(whole)
    first = _graph_task(tmp_path / "first", "fused", 2)
    _train(first)
    state = str(tmp_path / "state.pt")
    first.save_training_state(1, state)
    # loading replaces the optimizer's state tensors: the graph goes
    first.load_training_state(state)
    assert not first._graphs
    resumed = _graph_task(tmp_path / "resumed", "fused", 3)
    assert resumed.load_training_state(state) == 1
    assert _train(resumed) == _schedule("fused", 3)
    assert "epoch" in resumed._graphs
    np.testing.assert_array_equal(_rows(resumed), _rows(whole)[2:])
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)
    st_a = resumed.optimizer.state_dict()["state"]
    st_b = whole.optimizer.state_dict()["state"]
    for i in st_b:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st_a[i][name], st_b[i][name]), (i, name)


def test_a_state_saved_on_the_cpu_resumes_on_the_card(dev, tmp_path):
    """A CPU optimizer state carries capturable=False and host step counts;
    loaded on the card it is made capturable, so the epoch can be captured."""
    cpu = _graph_task(tmp_path / "cpu", "plain", 1, device="cpu")
    cpu.train()
    state = str(tmp_path / "state.pt")
    cpu.save_training_state(0, state)
    card = _graph_task(tmp_path / "card", "plain", 2)
    assert card.load_training_state(state) == 0
    assert all(g["capturable"] for g in card.optimizer.param_groups)
    assert _train(card) == _schedule("plain", 2)
    assert "epoch" in card._graphs and np.isfinite(card.train_loss).all()


def test_release_device_data_frees_and_captures_again(dev, tmp_path):
    task = _graph_task(tmp_path, "fused", 2)
    _train(task)
    held = torch.cuda.memory_allocated()
    task.release_device_data()
    assert not task._graphs and task._prepared is None
    freed = held - torch.cuda.memory_allocated()
    # at least the gathered batches: 2 x 12,000 frames x 30 floats
    assert freed >= 2 * (G_TRAIN * G_BATCH + 1_200) * 30 * 4
    assert _train(task, 2) == _schedule("fused", 2)
    assert "epoch" in task._graphs and np.isfinite(task.train_loss).all()


def test_profile_dir_traces_the_replays(dev, tmp_path):
    task = _graph_task(tmp_path / "run", "fused", 3,
                       profile_dir=str(tmp_path / "prof"))
    assert _train(task) == _schedule("fused", 3)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    text = trace.read_text()
    for name in ("cudaGraphLaunch", "stats_fwd_kernel", "stats_bwd_kernel",
                 "fused_align"):
        assert name in text, name


def test_spans_of_captured_epochs(dev, tmp_path):
    """The recorder on the card: one ``cvf.graph.capture`` inside the first
    epoch's ``cvf.epoch.issue``, every later epoch a replaying issue,
    ``epoch_times`` the chunk spans'; a second call replays only, and a
    ``profile_dir`` trace of it holds its spans as ``user_annotation``
    events beside the device's kernels."""
    import json

    from colvarsfinder_tpu_torch import logging_utils

    task = _graph_task(tmp_path / "run", "fused", 3)
    logging_utils.reset_trace()
    assert _train(task) == _schedule("fused", 3)
    got = logging_utils.spans()
    names = [s.name for s in got]
    assert names.count("cvf.graph.capture") == 1
    issues = [s for s in got if s.name == "cvf.epoch.issue"]
    assert [s.attrs["replay"] for s in issues] == [False, True, True]
    capture, = [s for s in got if s.name == "cvf.graph.capture"]
    assert capture.parent == issues[0].id
    chunks = [s for s in got if s.name == "cvf.epoch.chunk"]
    assert task.epoch_times == [c.seconds for c in chunks]
    logging_utils.reset_trace()
    task.profile_dir = str(tmp_path / "prof")
    assert _train(task, 2) == _schedule("fused", 2)
    got = logging_utils.spans()
    assert "cvf.graph.capture" not in [s.name for s in got]
    assert all(s.profiled for s in got)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    marked = sorted(e["name"] for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("cvf."))
    assert marked == sorted(s.name for s in got)
    assert any(e.get("cat") == "kernel" for e in events)


def test_a_host_sync_in_the_step_fails_the_capture(dev, tmp_path):
    """Eager epochs may sync with the host; a captured one cannot, and
    train() raises instead of carrying on eagerly."""
    task = _graph_task(tmp_path, "plain", 3)
    task._pp_for_loss = Lambda(
        lambda x: task.preprocessing_layer(x) * float(x.abs().max() > 0))
    with pytest.raises(RuntimeError, match="CUDA graph"):
        _train(task)
    assert not task._graphs
    assert not hasattr(task, "train_loss")


# ---------------------------------------------------------------------------
# the Dirichlet form: the generator and the committor
def _second_order(layer, x, theta):
    """d(sum gx^2)/d theta with gx = d/dx sum theta * tanh(layer(x))."""
    xt = x.clone().requires_grad_()
    th = theta.clone().requires_grad_()
    (gx,) = torch.autograd.grad((th * torch.tanh(layer(xt))).sum(), xt,
                                create_graph=True)
    (g,) = torch.autograd.grad((gx**2).sum(), th)
    return g


@pytest.mark.parametrize("layer", ["fused", "cuda"])
def test_k1_k2_backward_is_twice_differentiable(dev, layer):
    """The kernel's forward, its plain-formulation backward recorded and
    differentiated again, against the plain layer throughout."""
    x, ref, idx = _frames(4096, 10, 10, seed=5)
    x = torch.from_numpy(x).to(dev)
    theta = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (10, 3)).astype(np.float32)).to(dev)
    plain = AlignmentLayer(ref, idx).to(dev)
    if layer == "fused":
        kern = FusedAlignmentLayer(ref, idx).to(dev)
    else:
        kern = AlignmentLayer(ref, idx, method="cuda").to(dev)
    _cuda.reset_launch_counts()
    got = _second_order(kern, x, theta)
    torch.cuda.synchronize()
    name = "fused_align" if layer == "fused" else "kabsch_qcp"
    assert _cuda.LAUNCHES[name] == 1  # the forward: nothing falls back
    want = _second_order(plain, x, theta)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_gram_quadratic_form_on_the_card(dev):
    """bf16 x bf16 -> f32 products against the upcast product the CPU
    takes, and its gradient against autograd of the upcast product."""
    rng = np.random.default_rng(7)
    G = torch.from_numpy(rng.standard_normal((2, 512, 30)).astype(
        np.float32)).to(dev).requires_grad_()
    A = rng.standard_normal((512, 30, 30)).astype(np.float32)
    M = torch.from_numpy(np.einsum("bid,bjd->bij", A, A) / 30).to(dev)
    Mb = M.to(torch.bfloat16)
    got = _gram_quadratic_form(G, Mb)
    assert got.dtype == torch.float32 and got.shape == (512, 2)
    G2 = G.detach().to(torch.bfloat16).float().requires_grad_()
    want = torch.einsum("kbi,bij,kbj->bk", G2, Mb.float(), G2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    (g,) = torch.autograd.grad(got.sum(), G)
    (g2,) = torch.autograd.grad(want.sum(), G2)
    torch.testing.assert_close(g, g2, rtol=1e-5, atol=1e-4)
    # against float32 M: the bar of the bf16 Gram mode
    torch.testing.assert_close(got, _gram_quadratic_form(G, M), rtol=2e-2,
                               atol=0)


# the Dirichlet runs: generator (Gram, vjp, bf16 Gram) and committor (Gram,
# vjp), all through FusedAlignmentLayer (K2) at the main path's widths
DIRICHLET = ["gen_gram", "gen_vjp", "gen_bf16", "com_gram", "com_vjp",
             "gen_vjp_k1"]
G_DIAG = np.random.default_rng(2).uniform(0.5, 2.0, 30)


def _dirichlet_task(path, kind, epochs, **kw):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    traj = (ref[None] + 0.3 * rng.standard_normal((G_FRAMES, 10, 3))
            ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, G_FRAMES).astype(np.float32)
    atoms = list(range(10))
    # gen_vjp_k1: K1's forward; its backward, the SVD Kabsch's vjp,
    # differentiated twice
    align = (AlignmentLayer(ref, atoms, method="cuda")
             if kind == "gen_vjp_k1" else FusedAlignmentLayer(ref, atoms))
    pp = PreprocessingANN(align,
                          FeatureLayer([Feature("p", "position", atoms)]))
    traj_obj = WeightedTrajectory(trajectory=traj, weights=w, dt=G_DT,
                                  verbose=False)
    args = dict(learning_rate=0.002, save_model_every_step=0,
                batch_size=G_BATCH, num_epochs=epochs, test_ratio=0.1,
                verbose=False, tensorboard=False, seed=0, debug_mode=False,
                progress_interval=1, diag_coeff=G_DIAG,
                gram_pp="vjp" not in kind)
    args.update(kw)
    if kind.startswith("gen"):
        return EigenFunctionTask(
            traj_obj, pp, EigenFunctions(G_DIMS, G_K, seed=0), str(path),
            alpha=20.0, eig_weights=[1.0, 0.2], lag_tau=0.0, k=G_K,
            gram_dtype="bfloat16" if kind == "gen_bf16" else None, **args)
    c = traj[:, 0, 0]
    return CommittorTask(
        traj_obj, pp, create_sequential_nn(G_DIMS, seed=0), str(path),
        region_a=c < np.quantile(c, 0.05), region_b=c > np.quantile(c, 0.95),
        alpha=20.0, **args)


def _dirichlet_schedule(kind, epochs, first_call):
    """K2 (K1 for gen_vjp_k1) per batch on the vjp path; on the Gram path
    once per batch in the precompute of a task's first train() call."""
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    if kind == "gen_vjp_k1":
        want["kabsch_qcp"] = epochs * (G_TRAIN + G_TEST)
    elif kind.endswith("vjp"):
        want["fused_align"] = epochs * (G_TRAIN + G_TEST)
    elif first_call:
        want["fused_align"] = G_TRAIN + G_TEST
    return want


@pytest.mark.parametrize("kind", DIRICHLET)
def test_dirichlet_captured_epochs_equal_eager_epochs(dev, tmp_path, kind):
    graph = _dirichlet_task(tmp_path / "graph", kind, 5)
    eager = _dirichlet_task(tmp_path / "eager", kind, 5)
    rows = []
    for epochs, first in ((5, True), (2, False)):
        before = graph._graphs.get("epoch")
        counts = _train(graph, epochs)
        want = _dirichlet_schedule(kind, epochs, first)
        assert counts == want == _train_eager(eager, epochs)
        assert not eager._graphs
        if before is not None:
            assert graph._graphs["epoch"] is before
        rows.append((_rows(graph), _rows(eager)))
    assert graph._gram is ("vjp" not in kind)
    assert np.isfinite(rows[0][0]).all()
    got, want = (np.concatenate(r) for r in zip(*rows))
    np.testing.assert_array_equal(got, want)
    for a, b in zip(graph.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)


def test_generator_resume_equals_an_uninterrupted_run(dev, tmp_path):
    whole = _dirichlet_task(tmp_path / "whole", "gen_gram", 4)
    _train(whole)
    first = _dirichlet_task(tmp_path / "first", "gen_gram", 2)
    _train(first)
    state = str(tmp_path / "state.pt")
    first.save_training_state(1, state)
    resumed = _dirichlet_task(tmp_path / "resumed", "gen_gram", 2)
    assert resumed.load_training_state(state) == 1
    _train(resumed)
    assert "epoch" in resumed._graphs
    np.testing.assert_array_equal(_rows(resumed), _rows(whole)[2:])
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)



def test_input_gradients_are_recorded_on_the_calling_thread(dev):
    """The Dirichlet losses' input-gradient passes run their backward on
    the calling thread, so the nodes they record are numbered in one
    sequence with the forward's, and a step's parameter gradient does not
    depend on what the process ran before."""
    import threading

    from colvarsfinder_tpu_torch.core.losses import _input_jacobian

    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(threading.get_ident())
            return g

    model = create_sequential_nn([6, 8, 1], seed=0).to(dev)
    X = torch.randn(32, 6, device=dev)
    y, jac = _input_jacobian(lambda Xb: model(Probe.apply(Xb)), X, 1)
    assert jac.shape == (1, 32, 6) and jac.requires_grad
    assert seen == [threading.get_ident()]


# ---------------------------------------------------------------------------
# the autoencoders, through FusedAlignmentLayer (K2) at the main path's
# widths: the AE, and the regularized AE with all six terms (transfer
# regularizer, generator regularizer on its Gram and vjp paths, and the
# transfer configuration with the encoder frozen)
AE_KINDS = ["reg_transfer", "reg_gram", "reg_vjp", "reg_freeze"]
AE_DIMS = ([30, 30, 30, 2], [2, 30, 30, 30])


def _ae_task(path, kind, epochs, **kw):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    traj = (ref[None] + 0.3 * rng.standard_normal((G_FRAMES, 10, 3))
            ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, G_FRAMES).astype(np.float32)
    atoms = list(range(10))
    pp = PreprocessingANN(FusedAlignmentLayer(ref, atoms),
                          FeatureLayer([Feature("p", "position", atoms)]))
    traj_obj = WeightedTrajectory(trajectory=traj, weights=w, dt=G_DT,
                                  verbose=False)
    args = dict(learning_rate=0.002, save_model_every_step=0,
                batch_size=G_BATCH, num_epochs=epochs, test_ratio=0.1,
                verbose=False, tensorboard=False, seed=0, debug_mode=False,
                progress_interval=1)
    args.update(kw)
    if kind == "ae":
        return AutoEncoderTask(traj_obj, pp, AutoEncoder(*AE_DIMS, seed=0),
                               str(path), **args)
    gen = kind in ("reg_gram", "reg_vjp")
    return RegAutoEncoderTask(
        traj_obj, pp, RegAutoEncoder(*AE_DIMS, [2, 20, 20, 1], G_K, seed=0),
        str(path), eig_weights=[1.0, 0.5], alpha=1.0, gamma=[0.7, 3.0],
        eta=[0.05, 0.1, 0.2], lag_tau_ae=G_LAG * G_DT,
        lag_tau_reg=0.0 if gen else G_LAG * G_DT,
        gram_pp=(kind == "reg_gram") if gen else None,
        freeze_encoder=kind == "reg_freeze", **args)


def test_ae_features_take_one_k2_launch(dev, tmp_path):
    """The whole trajectory's features at construction: one K2 launch, the
    plain layer's values within K2's bar; each step then runs on features."""
    _cuda.reset_launch_counts()
    task = _ae_task(tmp_path, "ae", 3)
    torch.cuda.synchronize()
    assert _cuda.launch_counts() == {**dict.fromkeys(_cuda.LAUNCHES, 0),
                                     "fused_align": 1}
    plain = PreprocessingANN(
        AlignmentLayer(task.preprocessing_layer.alignment_layer.ref_centered
                       .cpu().numpy(), list(range(10))),
        task.preprocessing_layer.feature_layer).to(dev)
    with torch.no_grad():
        want = plain(torch.from_numpy(np.asarray(
            task.traj_obj.trajectory)).to(dev))
    torch.testing.assert_close(task._feature_traj, want, atol=2e-4, rtol=0)
    assert _train(task) == dict.fromkeys(_cuda.LAUNCHES, 0)
    assert "epoch" in task._graphs and np.isfinite(task.train_loss).all()
    assert task.train_loss[-1, 0] < task.train_loss[0, 0]


def _ae_schedule(kind, epochs, first_call):
    """K2 per batch: the features of X and of X lagged, one pass for the
    reconstruction and the transfer regularizer, whose lags are equal; on
    the vjp path also the input-gradient pass. On the Gram path the step
    reads features: K2 twice per batch in the first call's precompute (the
    Gram pass and the lagged features)."""
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    batches = G_TRAIN + G_TEST
    if kind == "reg_gram":
        want["fused_align"] = 2 * batches if first_call else 0
    else:
        per_batch = 3 if kind == "reg_vjp" else 2
        want["fused_align"] = per_batch * epochs * batches
    return want


@pytest.mark.parametrize("kind", AE_KINDS)
def test_regae_captured_epochs_equal_eager_epochs(dev, tmp_path, kind):
    graph = _ae_task(tmp_path / "graph", kind, 4)
    eager = _ae_task(tmp_path / "eager", kind, 4)
    enc0 = [p.detach().clone() for p in graph.model.encoder.parameters()]
    rows = []
    for epochs, first in ((4, True), (2, False)):
        before = graph._graphs.get("epoch")
        counts = _train(graph, epochs)
        assert counts == _ae_schedule(kind, epochs, first) == _train_eager(
            eager, epochs)
        assert not eager._graphs
        if before is not None:
            assert graph._graphs["epoch"] is before
        rows.append((_rows(graph), _rows(eager)))
    assert graph._gram is (kind == "reg_gram")
    assert np.isfinite(rows[0][0]).all()
    got, want = (np.concatenate(r) for r in zip(*rows))
    np.testing.assert_array_equal(got, want)
    for a, b in zip(graph.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(graph._cvec, eager._cvec)
    enc = list(graph.model.encoder.parameters())
    if kind == "reg_freeze":
        # the encoder's bits, through six captured epochs
        assert all(torch.equal(a, b) for a, b in zip(enc, enc0))
        assert not torch.equal(graph.model.reg.weights[0],
                               _ae_task(tmp_path / "x", kind, 1)
                               .model.reg.weights[0].to(dev))
    else:
        assert not torch.equal(enc[0], enc0[0])


@pytest.mark.parametrize("kind", ["fused", "k1"])
def test_exported_cv_programs_run_their_kernel(dev, tmp_path, kind):
    """The CV's forward and gradient programs, traced on the CPU and loaded
    on the card, launch K2 (``fused``) or K1 (weighted
    ``AlignmentLayer('cuda')``) once per call; the forward program's values
    equal the live CV's bit for bit, the gradient program's within 2e-6,
    and its Jacobian within 1e-5 of the live autograd Jacobian's largest
    entry."""
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    traj = (ref[None] + 0.3 * rng.standard_normal((4000, 10, 3))
            ).astype(np.float32)
    atoms = list(range(10))
    align = (FusedAlignmentLayer(ref, atoms) if kind == "fused" else
             AlignmentLayer(ref, atoms, method="cuda",
                            align_weights=G_ALIGN_W))
    cv = ColvarModel(
        PreprocessingANN(align, FeatureLayer([Feature("p", "position",
                                                      atoms)])),
        EigenFunctions(G_DIMS, G_K, seed=0)).to(dev)
    export_colvar(cv, traj[:1], str(tmp_path))
    fwd = load_colvar(str(tmp_path))
    grad = load_colvar(str(tmp_path), with_grad=True)
    x = torch.from_numpy(traj).to(dev)
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    want["fused_align" if kind == "fused" else "kabsch_qcp"] = 1
    _cuda.reset_launch_counts()
    out = fwd(x)
    torch.cuda.synchronize()
    assert _cuda.launch_counts() == want
    _cuda.reset_launch_counts()
    val, jac = grad(x)
    torch.cuda.synchronize()
    assert _cuda.launch_counts() == want
    xt = x.clone().requires_grad_()
    live = cv(xt)
    live_jac = torch.stack([
        torch.autograd.grad(live[:, i].sum(), xt, retain_graph=True)[0]
        for i in range(G_K)], dim=1)
    assert out.device.type == jac.device.type == "cuda"
    assert jac.shape == (4000, G_K, 10, 3)
    assert torch.equal(out, live.detach())
    torch.testing.assert_close(val, live.detach(), atol=2e-6, rtol=0)
    err = float((jac - live_jac).abs().max())
    scale = float(live_jac.abs().max())
    print(f"{kind}: program Jacobian vs live autograd: {err:.3e} of "
          f"{scale:.3e}")
    assert err <= 1e-5 * scale


# ---------------------------------------------------------------------------
# replica sweeps (parallel/ensemble.py)
def _sweep_task(tmp_path, kind, epochs=3, batch_size=200):
    rng = np.random.default_rng(11)
    ref = rng.standard_normal((6, 3)).astype(np.float32)
    x = (ref[None] + 0.3 * rng.standard_normal((1200, 6, 3))).astype(
        np.float32)
    pp = PreprocessingANN(FusedAlignmentLayer(ref, list(range(6))),
                          FeatureLayer([Feature("p", "position",
                                                list(range(6)))]))
    if kind == "regae":
        return RegAutoEncoderTask(
            WeightedTrajectory(trajectory=x, dt=0.01, verbose=False), pp,
            RegAutoEncoder([18, 10, 2], [2, 10, 18], [2, 8, 1], K=2, seed=0),
            str(tmp_path), eig_weights=[1.0, 0.5], alpha=1.0,
            gamma=[0.5, 1.0], eta=[0.05, 0.1, 0.2], lag_tau_ae=0.02,
            lag_tau_reg=0.02, learning_rate=0.005, batch_size=200,
            num_epochs=epochs, test_ratio=0.2, verbose=False,
            tensorboard=False, save_model_every_step=0)
    return EigenFunctionTask(
        WeightedTrajectory(trajectory=x, dt=0.01, verbose=False), pp,
        EigenFunctions([18, 10, 1], 2, seed=0), str(tmp_path), alpha=10.0,
        eig_weights=[1.0, 0.5], lag_tau=0.02 if kind == "transfer" else 0.0,
        k=2, learning_rate=0.005, batch_size=batch_size, num_epochs=epochs,
        test_ratio=0.2, verbose=False, tensorboard=False,
        save_model_every_step=0, gram_pp=None if kind == "transfer" else True)


def _grid(R, kind="transfer"):
    grid = {"learning_rate": [0.002 * (r + 1) for r in range(R)]}
    if kind == "regae":
        grid["gamma"] = [[0.5 * (r + 1), 1.0] for r in range(R)]
    else:
        grid["alpha"] = [5.0 * (r + 1) for r in range(R)]
    return grid


@pytest.mark.parametrize("kind", ["transfer", "gen_gram", "regae"])
def test_captured_sweep_equals_eager_sweep(dev, tmp_path, kind):
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    task = _sweep_task(tmp_path, kind)
    grid = _grid(4, kind)
    ensemble.release_sweeps()
    cap = train_hyperparameter_sweep(task, grid)
    reps = next(reversed(ensemble._SWEEPS.values()))
    assert "epoch" in reps.graphs
    again = train_hyperparameter_sweep(task, grid)  # replays only
    with graphs.eager():
        eager = train_hyperparameter_sweep(task, grid)
    for a, b, c in zip(cap, again, eager):
        for x, y in ((a, b), (a, c)):
            assert np.array_equal(x.train_loss, y.train_loss)
            assert np.array_equal(x.test_loss, y.test_loss)
            assert all(torch.equal(x.model[n], y.model[n]) for n in x.model)
    ensemble.release_sweeps()


def test_k2_launches_per_sweep_epoch_do_not_depend_on_r(dev, tmp_path):
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    task = _sweep_task(tmp_path, "transfer")
    nb = sum(len(b) for b in task._prepare_data()[:2])
    per_epoch = []
    for R in (2, 8):
        ensemble.release_sweeps()
        _cuda.reset_launch_counts()
        train_hyperparameter_sweep(task, _grid(R))
        reps = next(reversed(ensemble._SWEEPS.values()))
        per_epoch.append(reps.graphs["epoch"].launches["fused_align"])
        assert _cuda.launch_counts()["fused_align"] == 2 * nb * 3
    assert per_epoch == [2 * nb, 2 * nb]
    ensemble.release_sweeps()


def test_sweep_spans_leave_out_the_capture(dev, tmp_path):
    """A captured sweep's ``cvf.sweep.run`` starts after its capture and
    gives ``last_run_seconds``; a repeated sweep captures nothing."""
    from colvarsfinder_tpu_torch import logging_utils
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    task = _sweep_task(tmp_path, "transfer")
    ensemble.release_sweeps()
    for captures in (1, 0):
        logging_utils.reset_trace()
        train_hyperparameter_sweep(task, _grid(4))
        got = logging_utils.spans()
        call, = [s for s in got if s.name == "cvf.sweep.call"]
        run, = [s for s in got if s.name == "cvf.sweep.run"]
        caps = [s for s in got if s.name == "cvf.graph.capture"]
        assert len(caps) == captures
        assert all(c.end_ns <= run.start_ns and c.call == call.id
                   for c in caps)
        assert run.attrs == {"epochs": task.num_epochs - captures}
        assert ensemble.last_run_seconds == run.seconds
    ensemble.release_sweeps()


@pytest.mark.parametrize("kind", ["gram", "plain", "sweep", "fused"])
def test_split_heads_replays_count_and_equal_eager_epochs(dev, tmp_path,
                                                          kind):
    """The stacked heads' layer products split along the batch axis on the
    card (batches of 2,000 rows in 7 chunks, padded; the sweep's 600 rows
    in 2): each replay of a captured epoch counts the split products the
    graph holds in ``cvf.heads.split``, and the replays equal eager epochs
    bit for bit. The fused step runs no product of the heads."""
    from colvarsfinder_tpu_torch import logging_utils
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    if kind == "sweep":
        task = _sweep_task(tmp_path, "transfer", batch_size=600)
        ensemble.release_sweeps()
        train_hyperparameter_sweep(task, _grid(4))  # captures
        logging_utils.reset_trace()
        got = train_hyperparameter_sweep(task, _grid(4))  # replays only
        counted = logging_utils.counters()
        held = next(reversed(
            ensemble._SWEEPS.values())).graphs["epoch"].launches
        with graphs.eager():
            want = train_hyperparameter_sweep(task, _grid(4))
        for a, b in zip(got, want):
            assert np.array_equal(a.train_loss, b.train_loss)
            assert np.array_equal(a.test_loss, b.test_loss)
            assert all(torch.equal(a.model[n], b.model[n]) for n in a.model)
        ensemble.release_sweeps()
        replays = task.num_epochs
    else:
        def make(path):
            if kind == "gram":
                return _dirichlet_task(path, "gen_gram", 3)
            return _graph_task(path, kind, 3)

        graph, eager = make(tmp_path / "graph"), make(tmp_path / "eager")
        _train(graph)
        _train_eager(eager)
        logging_utils.reset_trace()
        replays = 2
        _train(graph, replays)  # replays only
        counted = logging_utils.counters()
        held = graph._graphs["epoch"].launches
        _train_eager(eager, replays)
        np.testing.assert_array_equal(_rows(graph), _rows(eager))
        for a, b in zip(graph.model.parameters(), eager.model.parameters()):
            assert torch.equal(a, b)
    split = held.get("cvf.heads.split", 0)
    assert counted.get("cvf.heads.split", 0) == replays * split
    if kind == "fused":
        assert split == 0 and "cvf.heads.whole" not in held
    else:
        assert split > 0
    logging_utils.reset_trace()


def test_bf16_sweep_keeps_float32_parameters(dev, tmp_path):
    from colvarsfinder_tpu_torch import config
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    task = _sweep_task(tmp_path, "transfer")
    ensemble.release_sweeps()
    r32 = train_hyperparameter_sweep(task, _grid(2))
    r16 = train_hyperparameter_sweep(task, _grid(2), compute_dtype="bfloat16")
    assert config.compute_dtype_name() == "float32"
    reps = next(reversed(ensemble._SWEEPS.values()))
    assert all(p.dtype == torch.float32 for p in reps.params)
    assert all(p.grad.dtype == torch.float32 for p in reps.params)
    assert all(t.dtype == torch.float32 for t in reps.opt.state_tensors())
    for a, b in zip(r32, r16):
        assert all(v.dtype == torch.float32 for v in b.model.values())
        np.testing.assert_allclose(b.train_loss[:, 0], a.train_loss[:, 0],
                                   rtol=0.1, atol=0.05)
        assert not np.array_equal(a.train_loss, b.train_loss)
    ensemble.release_sweeps()


def test_bf16_gram_form_vmap_rule_on_the_card(dev):
    """The bf16 Gram form under vmap (replicas folded into the heads, M
    shared; or into the samples, M per replica) equals one call per
    replica, values and gradient."""
    from colvarsfinder_tpu_torch.core.losses import _Bf16QuadraticForm

    rng = np.random.default_rng(4)
    R, k, B, d = 3, 2, 300, 30
    G = torch.tensor(rng.standard_normal((R, k, B, d)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    M = torch.tensor(rng.standard_normal((R, B, d, d)),
                     device=dev).to(torch.bfloat16)
    apply = _Bf16QuadraticForm.apply
    for m_dim, Ms in ((None, M[0]), (0, M)):
        out = torch.func.vmap(lambda g, m: apply(g, m)[0],
                              in_dims=(0, m_dim))(G, Ms)
        want = torch.stack([apply(G[r], Ms if m_dim is None else Ms[r])[0]
                            for r in range(R)])
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
        gv, = torch.autograd.grad(out.sum(), G)
        gw, = torch.autograd.grad(want.sum(), G)
        torch.testing.assert_close(gv, gw, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_replica_adam_equals_capturable_torch_adam(dev, dtype):
    """The replica-stacked Adam on the card against one capturable
    torch.optim.Adam per replica (the solo task's optimizer there), over
    ten steps of seeded gradients: bit for bit."""
    from colvarsfinder_tpu_torch.parallel.ensemble import _ReplicaOptimizer

    rng = np.random.default_rng(0)
    R, lrs = 3, [1e-3, 1e-2, 2e-2]
    p0 = torch.tensor(rng.standard_normal((R, 4, 5)), dtype=dtype,
                      device=dev)
    stacked = p0.clone().requires_grad_()
    opt = _ReplicaOptimizer("adam", [stacked],
                            torch.tensor(lrs, dtype=torch.float64,
                                         device=dev))
    solo = [p0[r].clone().requires_grad_() for r in range(R)]
    torch_opts = [torch.optim.Adam([solo[r]], lr=lrs[r], capturable=True)
                  for r in range(R)]
    for s in range(10):
        g = torch.tensor(rng.standard_normal((R, 4, 5)) * 10.0 ** -(s % 4),
                         dtype=dtype, device=dev)
        stacked.grad = g.clone()
        opt.step()
        for r in range(R):
            solo[r].grad = g[r].clone()
            torch_opts[r].step()
    for r in range(R):
        assert torch.equal(stacked[r].detach(), solo[r].detach()), r


# ---------------------------------------------------------------------------
# the streaming layout
def _stream_pair(tmp_path, kind, epochs=3, **kw):
    resident = _graph_task(tmp_path / f"{kind}_r", kind, epochs, **kw)
    streamed = _graph_task(tmp_path / f"{kind}_s", kind, epochs,
                           streaming=True, **kw)
    return resident, streamed


@pytest.mark.parametrize("kind", ["fused", "plain"])
def test_streamed_runs_equal_resident_runs(dev, tmp_path, kind):
    """In-RAM frames keep the resident batches' order and gather: the
    streamed run (each step a replay of its captured step) equals the
    resident run (each epoch a replay) bit for bit, with the resident launch
    schedule: K2 twice, K3 once and K4 once per fused train step."""
    resident, streamed = _stream_pair(tmp_path, kind)
    assert _train(streamed) == _train(resident) == _schedule(kind, 3)
    np.testing.assert_array_equal(_rows(streamed), _rows(resident))
    for a, b in zip(streamed.model.parameters(), resident.model.parameters()):
        assert torch.equal(a, b)
    assert sorted(streamed._graphs) == ["test", "train"]
    if kind == "fused":
        assert streamed._graphs["train"].launches == {
            "kabsch_qcp": 0, "fused_align": 2, "stats_fwd": 1,
            "stats_bwd": 1, "pair_distances": 0, "kabsch_exact": 0}
        assert streamed._graphs["test"].launches == {
            "kabsch_qcp": 0, "fused_align": 2, "stats_fwd": 1,
            "stats_bwd": 0, "pair_distances": 0, "kabsch_exact": 0}
    # a second call replays the same step graphs
    held = dict(streamed._graphs)
    assert _train(streamed, 2) == _train(resident, 2) == _schedule(kind, 2)
    assert streamed._graphs == held
    np.testing.assert_array_equal(_rows(streamed), _rows(resident))


def test_captured_streamed_steps_equal_eager_streamed_steps(dev, tmp_path):
    graph = _graph_task(tmp_path / "graph", "fused", 4, streaming=True)
    eager = _graph_task(tmp_path / "eager", "fused", 4, streaming=True)
    assert _train(graph) == _train_eager(eager) == _schedule("fused", 4)
    assert not eager._graphs and sorted(graph._graphs) == ["test", "train"]
    np.testing.assert_array_equal(_rows(graph), _rows(eager))
    for a, b in zip(graph.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth,packed", [(0, True), (1, False), (2, True)])
def test_streamed_settings_equal_bitwise_on_the_card(dev, tmp_path, depth,
                                                     packed):
    ref = _graph_task(tmp_path / "ref", "fused", 2, streaming=True)
    _train(ref)
    task = _graph_task(tmp_path / "run", "fused", 2, streaming=True)
    task.stream_prefetch, task.stream_pack_transfers = depth, packed
    task.stream_inflight = 0  # clamped to 1: a wait after every step
    assert _train(task) == _schedule("fused", 2)
    np.testing.assert_array_equal(_rows(task), _rows(ref))


def test_streamed_host_buffers_are_pinned_and_copied_on_their_own_stream(
        dev, tmp_path):
    """The host ring is pinned, and a batch's copy to its device slot runs
    on the copy stream: it completes while a long kernel holds the compute
    stream."""
    import time

    task = _graph_task(tmp_path, "fused", 1, streaming=True)
    _train(task)
    ios = task._stream_io[1:]
    assert all(b.is_pinned() for io in ios for bufs in io.host for b in bufs)
    assert all(b.device.type == "cuda" for io in ios for b in io.inputs)
    io, compute = ios[0], torch.cuda.current_stream()
    assert io.copy_stream != compute
    io.gather(0, task._stream_pack(task._prepare_data()[2][0]))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second on the compute stream
    io.transfer(0)
    end = time.monotonic() + 0.5
    while not io._slot_full[0].query() and time.monotonic() < end:
        time.sleep(1e-3)
    assert io._slot_full[0].query() and not compute.query()
    torch.cuda.synchronize()
    assert torch.equal(io.slots[0][0].cpu(), io.host[0][0])


def test_streamed_memmap_and_wire_dtype_on_the_card(dev, tmp_path):
    """A memmap's sorted gathers stay within the training bar of the in-RAM
    run; a float16 wire equals the resident run on frames rounded to
    float16 bit for bit."""
    from numpy.lib.format import open_memmap

    traj = _graph_frames()[2]
    mm = open_memmap(str(tmp_path / "t.npy"), mode="w+", dtype=traj.dtype,
                     shape=traj.shape)
    mm[:] = traj
    mm.flush()
    del mm
    ram = _graph_task(tmp_path / "ram", "fused", 3, streaming=True)
    mapped = _graph_task(tmp_path / "mm", "fused", 3, streaming=True,
                         frames=np.load(str(tmp_path / "t.npy"),
                                        mmap_mode="r"))
    assert mapped._sorted_gather(mapped._traj_np)
    assert _train(mapped) == _train(ram) == _schedule("fused", 3)
    for name, cols in (("loss", slice(0, 1)), ("eig", slice(3, None))):
        np.testing.assert_allclose(mapped.train_loss[:, cols],
                                   ram.train_loss[:, cols],
                                   rtol=CURVE_RTOL[name])
    wire = _graph_task(tmp_path / "wire", "fused", 2, streaming=True)
    wire.stream_wire_dtype = "float16"
    rounded = _graph_task(tmp_path / "rounded", "fused", 2,
                          frames=traj.astype(np.float16).astype(np.float32))
    assert _train(wire) == _train(rounded) == _schedule("fused", 2)
    assert wire._stream_io[1].inputs[0].dtype == torch.float16
    np.testing.assert_array_equal(_rows(wire), _rows(rounded))


def test_streamed_k1_route(dev, tmp_path):
    """AlignmentLayer(method='cuda') streamed: K1 twice per batch, the
    resident run's schedule and curves."""
    resident, streamed = _stream_pair(tmp_path, "k1", 2)
    assert _train(streamed) == _train(resident) == _schedule("k1", 2)
    got, want = _rows(streamed), _rows(resident)
    print(f"k1 streamed vs resident: bitwise equal "
          f"{np.array_equal(got, want)}")
    for name, cols in (("loss", slice(0, 1)), ("eig", slice(3, None))):
        np.testing.assert_allclose(got[:, cols], want[:, cols],
                                   rtol=CURVE_RTOL[name])


def test_chunked_apply_runs_k2_once_per_chunk(dev):
    from colvarsfinder_tpu_torch.core.task import TrainingTask

    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    x = (ref[None] + 0.3 * rng.standard_normal((2_500, 10, 3))).astype(
        np.float32)
    atoms = list(range(10))
    layer = PreprocessingANN(FusedAlignmentLayer(ref, atoms),
                             FeatureLayer([Feature("p", "position", atoms)])
                             ).to(dev)
    _cuda.reset_launch_counts()
    got = TrainingTask._chunked_apply(layer, x, chunk=1_000)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["fused_align"] == 3
    with torch.no_grad():
        want = layer(torch.from_numpy(x).to(dev)).cpu().numpy()
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)


def test_a_streamed_failure_ends_the_threads_and_the_next_call_trains(
        dev, tmp_path):
    import threading

    task = _graph_task(tmp_path, "fused", 2, streaming=True)
    pack, calls = task._stream_pack, []

    def boom(rows):
        calls.append(1)
        if len(calls) == 9:
            raise RuntimeError("pack exploded")
        return pack(rows)

    task._stream_pack = boom
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="pack exploded"):
        task.train()
    for _ in range(1000):
        if threading.active_count() == before:
            break
        threading.Event().wait(0.01)
    assert threading.active_count() == before
    task._stream_pack = pack
    assert _train(task) == _schedule("fused", 2)
    assert np.isfinite(task.train_loss).all()


def test_streaming_task_rejects_a_sweep_on_the_card(dev, tmp_path):
    from colvarsfinder_tpu_torch.parallel import train_hyperparameter_sweep

    task = _graph_task(tmp_path, "plain", 1, streaming=True)
    with pytest.raises(ValueError, match="streaming"):
        train_hyperparameter_sweep(task, {"learning_rate": [1e-3, 2e-3]})


# ---------------------------------------------------------------------------
# the data mesh at one rank of an NCCL group (parallel/mesh.py)
@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A mesh over a one-rank NCCL group, destroyed after the test. One
    card holds one rank: NCCL puts no two ranks on one device."""
    import torch.distributed as dist

    from colvarsfinder_tpu_torch.parallel import make_data_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_data_mesh()
        assert mesh.device_type == "cuda" and mesh.size() == 1
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("streaming", [False, True])
def test_meshed_epochs_equal_eager_and_unmeshed_epochs(dev, nccl_mesh,
                                                       tmp_path, streaming):
    """The plain step through K2 on a mesh of one rank: the captured epochs
    (or streamed steps), which hold the gather and the gradient sum, equal
    the eager meshed ones and the unmeshed run bit for bit, with the same
    K2 launches."""
    kw = dict(fused_step=False, streaming=streaming)
    plain = _graph_task(tmp_path / "plain", "fused", 4, **kw)
    graph = _graph_task(tmp_path / "graph", "fused", 4, mesh=nccl_mesh, **kw)
    eager = _graph_task(tmp_path / "eager", "fused", 4, mesh=nccl_mesh, **kw)
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    want["fused_align"] = 2 * 4 * (G_TRAIN + G_TEST)
    assert _train(plain) == _train(graph) == _train_eager(eager) == want
    assert sorted(graph._graphs) == (["test", "train"] if streaming
                                     else ["epoch"])
    assert not eager._graphs
    for other in (graph, eager):
        np.testing.assert_array_equal(_rows(other), _rows(plain))
        for a, b in zip(other.model.parameters(), plain.model.parameters()):
            assert torch.equal(a, b)


def test_meshed_replay_runs_nccl_kernels(dev, nccl_mesh, tmp_path):
    """A replayed meshed epoch launches NCCL's reduce kernel for the gather
    of each batch and the gradient sum of each train step; the unmeshed
    epoch none."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for label, mesh in (("plain", None), ("mesh", nccl_mesh)):
        task = _graph_task(tmp_path / label, "fused", 2, fused_step=False,
                           mesh=mesh)
        _train(task)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _train(task, 1)
        counts[label] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ("nccl" in e.key.lower() or "onerank" in e.key.lower()))
    assert counts == {"plain": 0, "mesh": 2 * G_TRAIN + G_TEST}


def test_meshed_sweep_equals_unmeshed_sweep(dev, nccl_mesh, tmp_path):
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    task = _sweep_task(tmp_path, "transfer")
    ensemble.release_sweeps()
    plain = train_hyperparameter_sweep(task, _grid(4))
    meshed = train_hyperparameter_sweep(task, _grid(4), mesh=nccl_mesh)
    for a, b in zip(plain, meshed):
        assert np.array_equal(a.train_loss, b.train_loss)
        assert np.array_equal(a.test_loss, b.test_loss)
        assert all(torch.equal(a.model[n], b.model[n]) for n in a.model)
    ensemble.release_sweeps()


# ---------------------------------------------------------------------------
# the samplers (utils/sampling.py, utils/enhanced.py): each report or
# deposition block one captured graph, replayed
class _TripleWell:
    """examples/enhanced_sampling.py's TripleWellCircle."""

    dim, beta = 2, 8.0

    def V(self, x):
        theta = torch.atan2(x[1], x[0])
        r = torch.sqrt(x[0] ** 2 + x[1] ** 2)
        return 1.0 + torch.cos(3.0 * theta) + 8.0 * (r - 1.0) ** 2


def _angle(x):
    return torch.atan2(x[:, 1], x[:, 0])


def _sampler(kind, tmp_path, **over):
    """A short run of each sampler, four report (or deposition) blocks."""
    from colvarsfinder_tpu_torch import utils as u

    pot = _TripleWell()
    kw = dict(X0=[1.0, 0.0], seed=3, verbose=False, device="cuda")
    if kind == "overdamped":
        kw.update(n_steps=200, report_interval=50, n_chains=64, pre_steps=70)
        call = lambda: u.integrate_sde_overdamped(  # noqa: E731
            pot, sampling_output_path=str(tmp_path), **kw)
    elif kind == "baoab":
        kw.update(n_steps=200, report_interval=50, n_chains=64, pre_steps=70,
                  return_velocities=True)
        call = lambda: u.integrate_sde_langevin(  # noqa: E731
            pot, sampling_output_path=str(tmp_path), **kw)
    elif kind == "metad":
        kw.update(n_steps=200, deposit_interval=50, n_chains=8, pre_steps=70,
                  bias_factor=5.0, hill_width=0.3)
        call = lambda: u.integrate_sde_metadynamics(  # noqa: E731
            pot, _angle, **kw)
    elif kind == "umbrella":
        kw.update(n_steps=200, report_interval=50, pre_steps=70)
        call = lambda: u.integrate_sde_umbrella(  # noqa: E731
            pot, _angle, np.linspace(-1.0, 1.0, 6), 8.0, **kw)
    elif kind == "steered":
        kw.update(n_steps=200, report_interval=50, pre_steps=70,
                  n_realizations=6)
        call = lambda: u.integrate_sde_steered(  # noqa: E731
            pot, _angle, -1.0, 1.0, 20.0, **kw)
    else:
        kw.update(n_steps=200, report_interval=25, exchange_interval=50,
                  pre_steps=70)
        call = lambda: u.integrate_sde_remd(  # noqa: E731
            pot, [8.0, 6.0, 4.5, 3.0], **kw)
    kw.update(over)
    res = call()
    if isinstance(res, tuple):
        return list(res)
    return [v for v in vars(res).values() if isinstance(v, np.ndarray)]


@pytest.mark.parametrize("kind", ["overdamped", "baoab", "metad", "umbrella",
                                  "steered", "remd"])
def test_captured_sampler_blocks_equal_their_eager_twin(dev, tmp_path, kind):
    """Every block after the first of a kind is a graph replay; the run
    equals the same run with every block eager, bit for bit, the burn-in's
    partial last block included."""
    captured = _sampler(kind, tmp_path)
    with graphs.eager():
        eager = _sampler(kind, tmp_path)
    assert len(captured) == len(eager) > 1
    for a, b in zip(captured, eager):
        np.testing.assert_array_equal(a, b)


def test_sampler_blocks_replay_one_graph_each(dev, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    _sampler("overdamped", tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sampler("overdamped", tmp_path)
    replays = sum(e.count for e in prof.key_averages()
                  if e.key == "cudaGraphLaunch")
    # burn-in: one full block (captured), one partial (eager); reports:
    # four blocks, the first captured
    assert replays == 3


def test_metadynamics_through_k2_matches_the_quaternion_layer(dev):
    """K2 in every step, forward and backward, against the plain layer with
    the same heads, within chip_smoke phase 12 (c)'s bar."""
    from colvarsfinder_tpu_torch import (
        ColvarModel,
        Feature,
        FeatureLayer,
        PreprocessingANN,
    )
    from colvarsfinder_tpu_torch.utils import integrate_sde_metadynamics

    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    idx = list(range(10))
    head = EigenFunctions([30, 20, 20, 20, 1], 2, seed=0).cuda()

    def cv(layer):
        m = ColvarModel(PreprocessingANN(layer, FeatureLayer(
            [Feature("p", "position", idx)])), head).cuda()
        return lambda x: m(x.reshape(-1, 10, 3))

    class Well:
        dim, beta = 30, 1.0
        c = torch.as_tensor(ref.reshape(-1), device="cuda")

        def V(self, x):
            return 0.5 / 0.09 * torch.sum((x - self.c.to(x.device)) ** 2)

    x0 = ref.reshape(-1) + 0.3 * rng.standard_normal((64, 30))
    kw = dict(n_steps=200, deposit_interval=100, step_size=5e-3,
              hill_height=0.35, hill_width=0.05, bias_factor=10.0,
              n_chains=64, X0=x0, seed=1, verbose=False, device="cuda")
    _cuda.reset_launch_counts()
    fused = integrate_sde_metadynamics(Well(), cv(FusedAlignmentLayer(
        ref, idx)), **kw)
    assert _cuda.launch_counts()["fused_align"] >= 200
    quat, svd = (integrate_sde_metadynamics(Well(), cv(AlignmentLayer(
        ref, idx, method=m)), **kw) for m in ("quaternion", "svd"))

    def gap(a, b, name):
        a, b = getattr(a, name), getattr(b, name)
        return np.abs(a - b).max() / np.abs(b).max()

    # chip_smoke phase 12 (c)'s bar: twice the gap of two plain versions,
    # never below 8 float32 ulps
    for name in ("frames", "cv_values", "hill_heights"):
        bar = max(2 * gap(svd, quat, name), 1e-6)
        assert gap(fused, quat, name) <= bar, name


def test_a_failure_inside_a_sampler_block_raises_and_leaves_no_graph(
        dev, tmp_path):
    """A host sync inside a block: the first block runs eagerly, its capture
    fails and raises; no capture is left open, and the next call runs."""
    from colvarsfinder_tpu_torch.utils import integrate_sde_overdamped

    class Syncing(_TripleWell):
        def batched_V(self, x):
            v = torch.func.vmap(self.V)(x)
            return v * float(x.abs().max() > 0)

    with pytest.raises(RuntimeError, match="capturing a sampler block"):
        integrate_sde_overdamped(Syncing(), 200, str(tmp_path),
                                 X0=[1.0, 0.0], report_interval=50, seed=0,
                                 verbose=False, device="cuda")
    assert not torch.cuda.is_current_stream_capturing()
    frames, _ = integrate_sde_overdamped(
        _TripleWell(), 200, str(tmp_path), X0=[1.0, 0.0], report_interval=50,
        seed=0, verbose=False, device="cuda")
    assert np.isfinite(frames).all()


# ---------------------------------------------------------------------------
# K5: grouped pair distances


def _all_pairs(N):
    """[P, 2] int32, as a feature layer keeps a run of bonds."""
    i, j = torch.triu_indices(N, N, offset=1)
    return torch.stack([i, j], 1).to(torch.int32)


@pytest.mark.parametrize("B,N,dtype", [
    (20000, 93, torch.float32), (37, 93, torch.float32),
    (5, 1000, torch.float32), (3, 4200, torch.float32),
    (64, 93, torch.float64), (3, 4200, torch.float64)])
def test_k5_pair_distances_match_plain(dev, B, N, dtype):
    """K5 against the plain grouped version at the benchmark's shapes (B =
    20,000, CLN025's 93 atoms, 4,278 pairs), at a few frames, at larger
    frames, past the 48 KiB of shared memory a block takes without opting
    in to more (4,200 atoms), and in float64."""
    from colvarsfinder_tpu_torch.ops.features import pair_distances
    from colvarsfinder_tpu_torch.ops.pair_cuda import pair_distances_cuda

    g = torch.Generator(device=dev).manual_seed(B + N)
    x = (torch.randn(B, N, 3, device=dev, generator=g) * 2.0).to(dtype)
    pairs = _all_pairs(N).to(dev)
    if N > 200:  # a few thousand pairs of the larger frames
        pairs = pairs[torch.randperm(len(pairs), device=dev,
                                     generator=g)[:3000]]
    _cuda.reset_launch_counts()
    got = pair_distances_cuda(x, pairs, int(pairs.max()))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pair_distances"] == 1
    assert got.dtype == dtype
    plain = pair_distances(x, pairs)
    if dtype == torch.float64:
        # the same operations in the same order, rounded the same way
        torch.testing.assert_close(got, plain, rtol=1e-15, atol=0)
        return
    exact = pair_distances(x.double(), pairs)
    # every distance, in float32: within an ulp or two of float64's, as
    # the plain version is
    err = ((got.double() - exact).abs() / exact).max().item()
    err_plain = ((plain.double() - exact).abs() / exact).max().item()
    assert err <= max(2 * err_plain, 2.4e-7), (err, err_plain)
    torch.testing.assert_close(got, plain, rtol=3e-7, atol=1e-6)


def test_k5_refuses_what_it_cannot_take(dev):
    """Frames past the shared memory a block may opt in to, a dtype other
    than float32 or float64, and an index past the frame raise, on their
    own and through a feature layer; nothing falls back to the plain
    version on the card."""
    from colvarsfinder_tpu_torch.ops.pair_cuda import (
        max_atoms,
        pair_distances_cuda,
    )

    most = max_atoms(dev, torch.float32)
    assert most >= 4200 and max_atoms(dev, torch.float64) == most // 2
    pairs = torch.tensor([[0, most]], device=dev, dtype=torch.int32)
    _cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="at most"):
        pair_distances_cuda(torch.zeros(2, most + 1, 3, device=dev), pairs,
                            most)
    layer = FeatureLayer([Feature("a", "bond", (0, 1)),
                          Feature("b", "bond", (1, 2))]).to(dev)
    x = torch.randn(4, 3, 3, device=dev)
    with pytest.raises(TypeError, match="float32 or float64"):
        layer(x.to(torch.bfloat16))
    with pytest.raises(IndexError, match="out of range"):
        pair_distances_cuda(x, pairs, most)
    assert _cuda.LAUNCHES["pair_distances"] == 0
    layer(x)
    assert _cuda.LAUNCHES["pair_distances"] == 1


def test_k5_backward_is_the_plain_vjp(dev):
    """K5's backward: the plain version's vjp, recorded under
    ``create_graph`` so that it is differentiated once more."""
    from colvarsfinder_tpu_torch.ops.features import pair_distances
    from colvarsfinder_tpu_torch.ops.pair_cuda import pair_distances_cuda

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 20, 3, device=dev, generator=g).requires_grad_()
    pairs = _all_pairs(20).to(dev)
    cot = torch.randn(64, len(pairs), device=dev, generator=g)

    def derivatives(f):
        (d1,) = torch.autograd.grad((f(x, pairs) * cot).sum(), x,
                                    create_graph=True)
        (d2,) = torch.autograd.grad((d1 * d1).sum(), x)
        return d1, d2

    def k5(x, pairs):
        return pair_distances_cuda(x, pairs, int(pairs.max()))

    for a, b in zip(derivatives(k5), derivatives(pair_distances)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # in float64 through K5, gradcheck and gradgradcheck hold
    layer = FeatureLayer([Feature(f"d{i}", "bond", tuple(p))
                          for i, p in enumerate(pairs[:10].tolist())])
    xd = x.detach()[:2].double().requires_grad_()
    _cuda.reset_launch_counts()
    assert torch.autograd.gradcheck(layer.to(dev), (xd,))
    assert torch.autograd.gradgradcheck(layer.to(dev), (xd,))
    assert _cuda.LAUNCHES["pair_distances"] > 0


def _distance_task(path, epochs):
    """The default transfer-operator route from every pair distance of 12
    atoms (66 features, no alignment), [66, 16, 16, 16, 1] heads."""
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((12, 3))
    traj = (ref[None] + 0.3 * rng.standard_normal((G_FRAMES, 12, 3))
            ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, G_FRAMES).astype(np.float32)
    layer = FeatureLayer([
        Feature(f"d{i}_{j}", "bond", (i, j))
        for i in range(12) for j in range(i + 1, 12)])
    traj_obj = WeightedTrajectory(trajectory=traj, weights=w, dt=G_DT,
                                  verbose=False)
    return EigenFunctionTask(
        traj_obj, PreprocessingANN(None, layer),
        EigenFunctions([66, 16, 16, 16, 1], G_K, seed=0), str(path),
        alpha=20.0, eig_weights=[1.0, 0.2], lag_tau=G_LAG * G_DT,
        learning_rate=0.002, save_model_every_step=0, k=G_K,
        batch_size=G_BATCH, num_epochs=epochs, test_ratio=0.1, verbose=False,
        tensorboard=False, seed=0, debug_mode=False, progress_interval=1)


def test_distance_epochs_replay_k5_and_equal_eager_epochs(dev, tmp_path):
    """A captured epoch of a distance task launches K5 on X and X_l of
    every batch, holds the feature layer's pair counters, and each replay
    counts both; the replayed epochs equal eager ones bit for bit."""
    from colvarsfinder_tpu_torch import logging_utils

    graph = _distance_task(tmp_path / "graph", 3)
    eager = _distance_task(tmp_path / "eager", 3)
    _train(graph)
    _train_eager(eager)
    logging_utils.reset_trace()
    replays = 2
    counts = _train(graph, replays)  # replays only
    counted = logging_utils.counters()
    held = graph._graphs["epoch"].launches
    batches = G_TRAIN + G_TEST
    assert held["pair_distances"] == 2 * batches
    assert counts["pair_distances"] == replays * 2 * batches
    # 66 distances of every frame of X and X_l, train and test batches
    grouped = held["cvf.features.pairs_grouped"]
    assert grouped % (2 * 66) == 0
    assert grouped // (2 * 66) >= G_TRAIN * G_BATCH
    assert "cvf.features.pairs_single" not in held
    for name in ("cvf.features.pairs_grouped", "cvf.heads.split",
                 "cvf.heads.whole"):
        assert counted.get(name, 0) == replays * held.get(name, 0), name
    _train_eager(eager, replays)
    np.testing.assert_array_equal(_rows(graph), _rows(eager))
    for a, b in zip(graph.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    logging_utils.reset_trace()
