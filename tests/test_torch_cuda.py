"""PyTorch port on the card: CUDA kernels K1-K4 against their plain PyTorch
versions, K1's and K2's backward differentiated twice, and training epochs
(transfer operator, generator, committor, the autoencoders) captured as CUDA
graphs against the same epochs run eagerly. Every test here needs an NVIDIA card and ``nvcc``: it
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
    CommittorTask,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    RegAutoEncoder,
    RegAutoEncoderTask,
    WeightedTrajectory,
)
from colvarsfinder_tpu_torch.core.losses import _gram_quadratic_form
from colvarsfinder_tpu_torch.models import EigenFunctions, create_sequential_nn
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops.alignment import (
    AlignmentLayer,
    align_frames,
    kabsch_rotations_quat,
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
KINDS = ["fused", "plain", "k1", "precompute"]


def _graph_task(path, kind, epochs, **kw):
    """``fused``: FusedAlignmentLayer + fused_step (K2, K3, K4); ``plain``:
    AlignmentLayer('quaternion'), no kernel; ``k1``: weighted
    AlignmentLayer('cuda') + fused_step (K1, K3, K4); ``precompute``:
    features computed once, then fused_step (K3, K4)."""
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((10, 3)).astype(np.float32)
    traj = (ref[None] + 0.3 * rng.standard_normal((G_FRAMES, 10, 3))
            ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, G_FRAMES).astype(np.float32)
    atoms = list(range(10))
    if kind == "fused":
        align = FusedAlignmentLayer(ref, atoms)
    else:
        align = AlignmentLayer(
            ref, atoms, method="cuda" if kind == "k1" else "quaternion",
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
    (K2 or K1) and computes its stats (K3); every train step runs K4."""
    n = epochs * (G_TRAIN + G_TEST)
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    if kind != "plain":
        want.update(stats_fwd=n, stats_bwd=epochs * G_TRAIN)
    if kind == "fused":
        want["fused_align"] = 2 * n
    if kind == "k1":
        want["kabsch_qcp"] = 2 * n
    return want


def _train(task, epochs=None):
    if epochs is not None:
        task.num_epochs = epochs
    _cuda.reset_launch_counts()
    task.train()
    torch.cuda.synchronize()
    return _cuda.launch_counts()


def _rows(task):
    """Every batch's metric row of every epoch, train then test."""
    return np.stack([np.concatenate(epoch) for epoch in task.loss_list])


@pytest.mark.parametrize("kind", KINDS)
def test_captured_epochs_equal_eager_epochs(dev, tmp_path, kind):
    graph = _graph_task(tmp_path / "graph", kind, 5)
    eager = _graph_task(tmp_path / "eager", kind, 5)
    eager._eager_on_card = True
    runs = []
    for epochs in (5, 2):
        # a second train() call replays the same graph
        before = graph._graph
        counts = _train(graph, epochs)
        assert counts == _schedule(kind, epochs) == _train(eager, epochs)
        assert eager._graph is None
        if before is not None:
            assert graph._graph is before
        runs.append((_rows(graph), _rows(eager)))
    assert graph._graph.launches == {
        name: n // 5 for name, n in _schedule(kind, 5).items()}
    # each replay ran the step on new parameters: no epoch repeats the last
    rows = runs[0][0]
    assert all((rows[e] != rows[e - 1]).any() for e in range(1, 5))
    got, want = (np.concatenate(r) for r in zip(*runs))
    if kind == "fused":
        # the same kernels in the same order, launched from a graph
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
    assert first._graph is None
    resumed = _graph_task(tmp_path / "resumed", "fused", 3)
    assert resumed.load_training_state(state) == 1
    assert _train(resumed) == _schedule("fused", 3)
    assert resumed._graph is not None
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
    assert card._graph is not None and np.isfinite(card.train_loss).all()


def test_release_device_data_frees_and_captures_again(dev, tmp_path):
    task = _graph_task(tmp_path, "fused", 2)
    _train(task)
    held = torch.cuda.memory_allocated()
    task.release_device_data()
    assert task._graph is None and task._prepared is None
    freed = held - torch.cuda.memory_allocated()
    # at least the gathered batches: 2 x 12,000 frames x 30 floats
    assert freed >= 2 * (G_TRAIN * G_BATCH + 1_200) * 30 * 4
    assert _train(task, 2) == _schedule("fused", 2)
    assert task._graph is not None and np.isfinite(task.train_loss).all()


def test_profile_dir_traces_the_replays(dev, tmp_path):
    task = _graph_task(tmp_path / "run", "fused", 3,
                       profile_dir=str(tmp_path / "prof"))
    assert _train(task) == _schedule("fused", 3)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    text = trace.read_text()
    for name in ("cudaGraphLaunch", "stats_fwd_kernel", "stats_bwd_kernel",
                 "fused_align"):
        assert name in text, name


def test_a_host_sync_in_the_step_fails_the_capture(dev, tmp_path):
    """Eager epochs may sync with the host; a captured one cannot, and
    train() raises instead of carrying on eagerly."""
    task = _graph_task(tmp_path, "plain", 3)
    task._pp_for_loss = Lambda(
        lambda x: task.preprocessing_layer(x) * float(x.abs().max() > 0))
    with pytest.raises(RuntimeError, match="CUDA graph"):
        _train(task)
    assert task._graph is None
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
DIRICHLET = ["gen_gram", "gen_vjp", "gen_bf16", "com_gram", "com_vjp"]
G_DIAG = np.random.default_rng(2).uniform(0.5, 2.0, 30)


def _dirichlet_task(path, kind, epochs, **kw):
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
                progress_interval=1, diag_coeff=G_DIAG,
                gram_pp=not kind.endswith("vjp"))
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
    """K2 per batch on the vjp path; on the Gram path once per batch in the
    precompute of a task's first train() call."""
    want = dict.fromkeys(_cuda.LAUNCHES, 0)
    if kind.endswith("vjp"):
        want["fused_align"] = epochs * (G_TRAIN + G_TEST)
    elif first_call:
        want["fused_align"] = G_TRAIN + G_TEST
    return want


@pytest.mark.parametrize("kind", DIRICHLET)
def test_dirichlet_captured_epochs_equal_eager_epochs(dev, tmp_path, kind):
    graph = _dirichlet_task(tmp_path / "graph", kind, 5)
    eager = _dirichlet_task(tmp_path / "eager", kind, 5)
    eager._eager_on_card = True
    rows = []
    for epochs, first in ((5, True), (2, False)):
        before = graph._graph
        counts = _train(graph, epochs)
        want = _dirichlet_schedule(kind, epochs, first)
        assert counts == want == _train(eager, epochs)
        assert eager._graph is None
        if before is not None:
            assert graph._graph is before
        rows.append((_rows(graph), _rows(eager)))
    assert graph._gram is (not kind.endswith("vjp"))
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
    assert resumed._graph is not None
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
    assert task._graph is not None and np.isfinite(task.train_loss).all()
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
    eager._eager_on_card = True
    enc0 = [p.detach().clone() for p in graph.model.encoder.parameters()]
    rows = []
    for epochs, first in ((4, True), (2, False)):
        before = graph._graph
        counts = _train(graph, epochs)
        assert counts == _ae_schedule(kind, epochs, first) == _train(eager,
                                                                     epochs)
        assert eager._graph is None
        if before is not None:
            assert graph._graph is before
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
