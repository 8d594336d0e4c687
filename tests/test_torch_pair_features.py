"""A FeatureLayer's runs of consecutive ``bond`` features evaluated as one
pair list (``ops/features.py``): equal to evaluating every distance on its
own, in value and in first and second derivatives, with and without a box,
in mixed feature lists that keep their order; the recorder's pair counters;
a small CLN025-shaped transfer-operator task against the benchmark's plain
reference (``portbench/references/cln025_transfer.py``); the TorchScript CV
of a grouped layer; and the split rule of the stacked heads' products at
the wide first layer of a distance CV and at the dipeptide's shapes."""

import itertools

import numpy as np
import pytest
import torch

from colvarsfinder_tpu_torch import (
    ColvarModel,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    WeightedTrajectory,
    logging_utils,
)
from colvarsfinder_tpu_torch.deploy_torch import export_torchscript_cv
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.models.module import SPLIT_MIN_ROWS, split_count
from colvarsfinder_tpu_torch.ops import pair_distances

F64 = torch.float64


def bonds(n_atoms):
    return [Feature(f"d_{i}_{j}", "bond", (i, j))
            for i, j in itertools.combinations(range(n_atoms), 2)]


def one_by_one(features, x, box=None):
    """Every feature through a layer of its own: a lone bond is evaluated
    on its own, as every bond was before runs were grouped."""
    return torch.cat([FeatureLayer([f], box=box)(x) for f in features], 1)


def frames(B, N, seed=0, dtype=F64, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn(B, N, 3, generator=g, dtype=dtype)


MIXED = [
    Feature("a", "angle", (0, 1, 2)),
    Feature("d01", "bond", (0, 1)),
    Feature("d12", "bond", (1, 2)),
    Feature("d03", "bond", (0, 3)),
    Feature("phi", "dihedral", (0, 1, 2, 3)),
    Feature("lone", "bond", (2, 4)),
    Feature("c", "contact", (1, 4), params={"r0": 1.5}),
    Feature("d34", "bond", (3, 4)),
    Feature("d42", "bond", (4, 2)),
]


@pytest.mark.parametrize("case", ["all_pairs", "mixed", "lone", "box",
                                  "mixed_box"])
def test_grouped_bonds_equal_one_by_one(case):
    box = (2.5, 3.0, 2.0) if "box" in case else None
    if case in ("all_pairs", "box"):
        feats = bonds(6)
    elif case == "lone":
        feats = [Feature("d", "bond", (3, 1))]
    else:
        feats = MIXED
    layer = FeatureLayer(feats, box=box)
    x = frames(7, 6, scale=2.0 if box else 1.0).requires_grad_()
    got = layer(x)
    want = one_by_one(feats, x, box)
    assert got.shape == (7, layer.output_dimension)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14)
    # first and second derivatives through the grouped evaluation
    cot = torch.randn(got.shape, dtype=F64)

    def derivatives(out):
        (g,) = torch.autograd.grad((out * cot).sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad((g * g).sum(), x)
        return g, gg

    for a, b in zip(derivatives(got), derivatives(want)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    xs = x.detach()[:2].clone().requires_grad_()
    assert torch.autograd.gradcheck(layer, (xs,))
    assert torch.autograd.gradgradcheck(layer, (xs,))


def test_runs_keep_the_feature_order_and_info():
    layer = FeatureLayer(MIXED)
    # runs of two or more bonds are grouped; the lone bonds are not
    assert layer.pair_groups == ((1, 3), (7, 2))
    buffers = dict(layer.named_buffers())
    assert buffers["_pairs0"].tolist() == [[0, 1], [1, 2], [0, 3]]
    assert buffers["_pairs1"].tolist() == [[3, 4], [4, 2]]
    assert buffers["_pairs1"].dtype == torch.int32
    assert "_idx5" in buffers and "_idx1" not in buffers
    info = layer.get_feature_info()
    assert list(info["name"]) == [f.name for f in MIXED]
    assert layer.output_dimension == 10  # the dihedral gives two
    # a single state [N, 3] as well
    x = frames(3, 5)
    torch.testing.assert_close(layer(x[0]), layer(x)[0], rtol=0, atol=0)


def test_one_buffer_per_run_of_thousands():
    layer = FeatureLayer(bonds(93))
    assert layer.output_dimension == 4278
    assert layer.pair_groups == ((0, 4278),)
    assert len(list(layer.buffers())) == 1
    x = frames(4, 93, dtype=torch.float32)
    got = layer(x)
    i, j = torch.triu_indices(93, 93, offset=1)
    want = torch.linalg.vector_norm(x[:, j] - x[:, i], dim=-1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_pair_counters():
    layer = FeatureLayer(MIXED)
    logging_utils.reset_trace()
    layer(frames(11, 5))
    counted = logging_utils.counters()
    assert counted["cvf.features.pairs_grouped"] == 11 * (3 + 2)
    assert counted["cvf.features.pairs_single"] == 11
    logging_utils.reset_trace()


def test_plain_grouped_distances():
    x = frames(3, 4)
    pairs = torch.tensor([[0, 1], [3, 2], [1, 1]])
    d = pair_distances(x, pairs)
    torch.testing.assert_close(d[:, 0], (x[:, 1] - x[:, 0]).norm(dim=-1))
    torch.testing.assert_close(d[:, 1], (x[:, 2] - x[:, 3]).norm(dim=-1))
    assert (d[:, 2] == 0).all()
    with pytest.raises((IndexError, RuntimeError)):
        pair_distances(x, torch.tensor([[0, 4]]))


N_SMALL, DIMS_SMALL = 12, [66, 16, 16, 16, 1]


def small_cln025():
    """``(cfg, frames, weights, split, params)`` of a CLN025-shaped task at
    12 atoms (66 distances), 2,000 frames, batches of 400, lag 5."""
    rng = np.random.default_rng(7)
    ref = rng.standard_normal((N_SMALL, 3))
    x = np.empty((2000, N_SMALL, 3))
    z = rng.standard_normal((N_SMALL, 3))
    for t in range(2000):  # correlated frames
        z = 0.95 * z + np.sqrt(1 - 0.95 ** 2) * rng.standard_normal(z.shape)
        x[t] = ref + 0.3 * z
    w = rng.uniform(0.5, 1.5, 2000)
    perm = rng.permutation(2000 - 5)
    split = (perm[400:1600], perm[:400])  # 3 train batches
    g = torch.Generator().manual_seed(3)
    params = []
    for d_in, d_out in zip(DIMS_SMALL[:-1], DIMS_SMALL[1:]):
        b = 1.0 / np.sqrt(d_in)
        params.append((torch.empty(1, 2, d_out, d_in, dtype=F64).uniform_(
            -b, b, generator=g), torch.empty(1, 2, d_out, dtype=F64).uniform_(
            -b, b, generator=g)))
    cfg = {"eig_weights": [1.0, 0.2], "lag": 5, "dt_ns": 0.2}
    return cfg, x, w, split, params


@pytest.fixture
def float64():
    from colvarsfinder_tpu_torch import config

    config.set_default_dtype("float64")
    try:
        yield
    finally:
        config.set_default_dtype("float32")


def test_small_cln025_task_follows_the_reference(tmp_path, float64):
    """Three Adam steps of the program in float64 against the plain
    reference's, step for step: losses and the parameters after them."""
    from portbench.references import cln025_transfer as ref_mod

    cfg, x, w, split, params = small_cln025()
    layer = FeatureLayer(bonds(N_SMALL))
    # the reference's pair order is the layer's
    assert dict(layer.named_buffers())["_pairs0"].tolist() == \
        ref_mod.pairs(N_SMALL).tolist()
    model = EigenFunctions(DIMS_SMALL, 2, seed=0)
    with torch.no_grad():
        for i, (W, b) in enumerate(params):
            model.weights[i].copy_(W[0])
            model.biases[i].copy_(b[0])
    traj = WeightedTrajectory(trajectory=x.astype(np.float64),
                              weights=w.astype(np.float64), dt=0.2,
                              verbose=False)
    task = EigenFunctionTask(
        traj, PreprocessingANN(None, layer), model, str(tmp_path),
        alpha=20.0, eig_weights=cfg["eig_weights"], lag_tau=1.0,
        learning_rate=0.002, k=2, batch_size=400, test_ratio=0.2,
        num_epochs=1, save_model_every_step=0, verbose=False,
        debug_mode=False, tensorboard=False, export_cv=False, device="cpu",
        split_indices=split, progress_interval=1)
    task.train()
    got = task.loss_list[0][0][:, 0]
    assert len(got) == 3
    batches = [split[0][s * 400:(s + 1) * 400] for s in range(3)]
    losses, _, _, final = ref_mod.follow(
        cfg, torch.as_tensor(x), torch.as_tensor(w), None, params, batches,
        [0.002], [20.0])
    np.testing.assert_allclose(got, losses[:, 0].numpy(), rtol=1e-10)
    # every leaf but the heads' output bias, which the loss cannot see
    # (a head's shift): its gradient is round-off, and Adam moves it by
    # the round-off's sign
    leaves = [(model.weights[i], f"weights.{i}") for i in range(4)] + [
        (model.biases[i], f"biases.{i}") for i in range(3)]
    for p, name in leaves:
        torch.testing.assert_close(p.detach(), final[name][0], rtol=1e-9,
                                   atol=1e-12)
    torch.testing.assert_close(
        ref_mod.features(torch.as_tensor(x[:5])),
        layer(torch.as_tensor(x[:5])), rtol=1e-12, atol=1e-12)


def test_torchscript_cv_of_a_grouped_layer(tmp_path):
    layer = FeatureLayer(bonds(7)[:12] + MIXED[:2] + bonds(7)[12:])
    cv = ColvarModel(PreprocessingANN(None, layer),
                     EigenFunctions([layer.output_dimension, 8, 1], 2,
                                    seed=1))
    path = export_torchscript_cv(cv, str(tmp_path))
    scripted = torch.jit.load(path)
    x = frames(5, 7, dtype=torch.float32)
    with torch.no_grad():
        want = cv(x)
    torch.testing.assert_close(scripted(x), want, rtol=1e-5, atol=1e-6)


F32 = torch.float32


@pytest.mark.parametrize("case", [
    # (rows, k or R k, d_in, d_out, S): the dipeptide's layers keep the S
    # of the one-tile rule, at k = 2 and a sweep's R k = 128
    (20_000, 2, 30, 20, 78),
    (20_000, 2, 20, 20, 78),
    (20_000, 2, 20, 1, 78),
    (20_000, 128, 30, 20, 5),
    (20_000, 128, 20, 1, 5),
    # a distance CV: the 4,278-wide first layer fills the card whole, the
    # hidden layers split less than the dipeptide's
    (20_000, 2, 4278, 256, 1),
    (20_000, 2, 256, 256, 5),
    (20_000, 2, 256, 1, 33),
])
def test_split_count_counts_the_output_tiles(case):
    rows, batch, d_in, d_out, want = case
    sms = 132  # an H100 SXM
    s = split_count("cuda", True, rows, batch, F32, sms, d_out, d_in)
    assert s == want
    # the unsplit product's blocks, 32 x 32 tiles a head
    tiles = batch * -(-d_out // 32) * -(-d_in // 32)
    if s == 1:
        assert tiles >= 4 * sms
    else:
        # the least S that fills the card, unless the rows ran out first
        assert 4 * sms > tiles * (s - 1)
        assert tiles * s >= 4 * sms or s == rows // SPLIT_MIN_ROWS
        assert rows // s >= SPLIT_MIN_ROWS
    # within one tile, the widths do not matter
    if d_out <= 32 and d_in <= 32:
        assert split_count("cuda", True, rows, batch, F32, sms, 1, 1) == s
