"""The plain reference on small cases worked by hand: the transfer-operator
loss with its quirk, the generator loss, the alignment, the Gram matrices
and Adam."""

import math

import pytest
import torch

from portbench.references import eigen as ref

D = torch.float64


def t(rows):
    return torch.tensor(rows, dtype=D)


def test_transfer_loss_by_hand():
    # head 0: y = [0,1,0,1], y_l = [1,1,0,0]: num 0.5, var 0.25 + 0.25
    # head 1: y = [1,2,3,4], y_l = [3,2,4,4]: num 1.25, var 1.25 + 0.6875
    # eigenvalues [1, 0.64516...] sort to cvec [1, 0]
    y = t([[[0, 1, 0, 1], [1, 2, 3, 4]]])
    y_l = t([[[1, 1, 0, 0], [3, 2, 4, 4]]])
    w = torch.ones(4, dtype=D)
    loss, eig = ref.transfer_loss(y, y_l, w, w, 2.0, t([1.0, 0.2]), 1.0)
    # the quirk: unsorted numerators over sorted denominators
    objective = 1.0 * 0.5 / (1.25 + 0.6875) + 0.2 * 1.25 / 0.5
    penalty = (0.25 - 1) ** 2 + (1.25 - 1) ** 2 + (1.5 - 0.5 * 2.5) ** 2
    assert loss.item() == pytest.approx(objective + 2.0 * penalty, rel=1e-14)
    assert eig[0].tolist() == pytest.approx([1.25 / 1.9375, 1.0], rel=1e-14)


def test_generator_loss_by_hand():
    y = t([[[1, 2, 3, 4], [0, 1, 0, 1]]])
    grad_sq = t([[[1, 1, 1, 1], [2, 2, 2, 2]]])
    w = torch.ones(4, dtype=D)
    loss, eig = ref.generator_loss(y, grad_sq, w, 2.0, t([1.0, 0.2]), 1.0)
    # Dirichlet forms [1, 2] over variances [1.25, 0.25]: eigenvalues [0.8, 8]
    penalty = (1.25 - 1) ** 2 + (0.25 - 1) ** 2 + 0.25 ** 2
    assert loss.item() == pytest.approx(1.0 * 0.8 + 0.2 * 8 + 2 * penalty,
                                        rel=1e-14)
    assert eig[0].tolist() == pytest.approx([0.8, 8.0], rel=1e-14)


def rotation(g):
    q = torch.randn(4, generator=g, dtype=D)
    w, x, y, z = (q / q.norm()).tolist()
    return t([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
              [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
              [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def test_align_undoes_a_rigid_motion():
    g = torch.Generator().manual_seed(0)
    reference = torch.randn(10, 3, generator=g, dtype=D)
    frames = torch.stack([reference @ rotation(g) + torch.randn(3, generator=g,
                                                                dtype=D)
                          for _ in range(5)])
    out = ref.align(frames, reference)
    want = (reference - reference.mean(0)).expand(5, 10, 3)
    assert torch.allclose(out, want, atol=1e-12)


def test_gram_by_finite_differences():
    g = torch.Generator().manual_seed(1)
    reference = torch.randn(4, 3, generator=g, dtype=D)
    x = reference + 0.3 * torch.randn(3, 4, 3, generator=g, dtype=D)
    diag = torch.rand(12, generator=g, dtype=D) + 0.5
    H, M = ref.gram(x, reference, diag)
    h = 1e-6
    for b in range(3):
        J = torch.empty(12, 12, dtype=D)
        for d in range(12):
            e = torch.zeros(12, dtype=D)
            e[d] = h
            up = ref.features((x[b].reshape(-1) + e).reshape(1, 4, 3), reference)
            dn = ref.features((x[b].reshape(-1) - e).reshape(1, 4, 3), reference)
            J[:, d] = (up - dn)[0] / (2 * h)
        assert torch.allclose(M[b], J @ torch.diag(diag) @ J.T, atol=1e-7)
    assert torch.allclose(H, ref.features(x, reference))


def test_adam_is_torch_adam():
    g = torch.Generator().manual_seed(2)
    leaves = [torch.randn(2, 3, 4, generator=g, dtype=D) for _ in range(2)]
    grads = [[torch.randn(2, 3, 4, generator=g, dtype=D) for _ in range(2)]
             for _ in range(3)]
    mine = [p.clone() for p in leaves]
    opt = ref.Adam(mine, torch.tensor([0.01, 0.002], dtype=D))
    for step in grads:
        opt.step(step)
    for r, lr in enumerate((0.01, 0.002)):
        theirs = [torch.nn.Parameter(p[r].clone()) for p in leaves]
        topt = torch.optim.Adam(theirs, lr=lr)
        for step in grads:
            for p, gr in zip(theirs, step):
                p.grad = gr[r].clone()
            topt.step()
        for a, b in zip(mine, theirs):
            assert torch.allclose(a[r], b.detach(), rtol=0, atol=1e-15)


def test_follow_takes_the_same_batches_every_epoch():
    cfg = dict(loss="transfer", lag=1, dt_ns=1.0, eig_weights=[1.0, 0.2],
               d_r=6, beta=1.0)
    g = torch.Generator().manual_seed(3)
    frames = torch.randn(40, 2, 3, generator=g)
    weights = torch.rand(40, generator=g) + 0.5
    params = [(torch.randn(1, 2, 5, 6, generator=g) * 0.3,
               torch.randn(1, 2, 5, generator=g) * 0.3),
              (torch.randn(1, 2, 1, 5, generator=g) * 0.3,
               torch.randn(1, 2, 1, generator=g) * 0.3)]
    batch = torch.arange(8)
    losses, grad1, change, final = ref.follow(
        cfg, frames, weights, frames[0], params, [batch] * 2, [1e-3], [1.0])
    assert losses.shape == (2, 1) and all(math.isfinite(v)
                                          for v in losses.flatten().tolist())
    assert set(grad1) == set(change) == set(final) == set(ref.leaf_names(2))
    start = [W for W, _ in params] + [b for _, b in params]
    for name, p0 in zip(ref.leaf_names(2), start):
        torch.testing.assert_close(final[name], p0.double() + change[name],
                                   rtol=0, atol=1e-15)
