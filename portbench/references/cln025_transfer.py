"""Plain reference of the CLN025 transfer-operator training step: every
heavy-atom pair distance as a feature (no alignment), k tanh heads, the
transfer operator's loss with the orthonormality penalty, and Adam. Plain
PyTorch, in float64 unless told otherwise; it imports nothing of the
program. The loss and Adam are :mod:`.eigen`'s; the features and the heads
are written here, the heads with this module's own :data:`TF32` switch.
"""

from __future__ import annotations

import torch

from .eigen import Adam, leaf_names, transfer_loss

#: set by the caller for the control: every product's float32 operands are
#: rounded to TF32 (10 mantissa bits, as a tensor core reads them) and the
#: sums kept in float32
TF32 = False

#: frames per block of the distances (a [B, P] float64 block of 20,000
#: frames is 0.7 GB; the [B, P, 3] differences would be three times that)
BLOCK = 4096


def _p(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product: ``x``, or with :data:`TF32` set its float32
    values rounded to TF32 (to nearest, ties away from zero), the gradient
    passed through unchanged."""
    if not TF32 or x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach())


def pairs(n_atoms: int) -> torch.Tensor:
    """[P, 2]: every pair (i, j), i < j, in row-major order."""
    return torch.triu_indices(n_atoms, n_atoms, offset=1).T


def features(x: torch.Tensor, ref=None) -> torch.Tensor:
    """[B, P]: |r_j - r_i| of the frames ``x`` [B, N, 3] for every pair of
    :func:`pairs`, in blocks of :data:`BLOCK` frames. ``ref`` (the seeded
    reference structure) is not used: distances need no alignment."""
    ij = pairs(x.shape[1]).to(x.device)
    return torch.cat([
        torch.linalg.vector_norm(xb[:, ij[:, 1]] - xb[:, ij[:, 0]], dim=-1)
        for xb in x.split(BLOCK)])


def heads(params, h: torch.Tensor) -> torch.Tensor:
    """[R, k, B]: every replica's k heads on the features ``h`` [B, d];
    tanh after every layer but the last."""
    h = torch.einsum("bi,rkoi->rkbo", _p(h), _p(params[0][0]))
    h = h + params[0][1][:, :, None, :]
    for W, b in params[1:]:
        h = torch.tanh(h)
        h = torch.einsum("rkbi,rkoi->rkbo", _p(h), _p(W)) + b[:, :, None, :]
    return h[..., 0]


def follow(cfg: dict, frames, weights, ref, params, batches, lr, alpha,
           dtype=torch.float64, half: bool = False):
    """Train every replica from ``params`` (per layer (W [R, k, o, i], b [R,
    k, o])) through the train batches ``batches`` (index arrays of lagged
    pairs' starts), one Adam step each, and return ``(losses [steps, R],
    first gradient {name: [R, ...]}, the parameters' change over the steps
    {name: [R, ...]}, the parameters after them {name: [R, ...]})``, as
    :func:`.eigen.follow` does; ``half`` keeps the first half of each
    batch (a fault that a check must catch)."""
    dev = frames.device
    w_all = (weights.double() / weights.double().mean()).to(dtype)
    n = len(params)
    leaves = [t.detach().to(dtype).clone().requires_grad_()
              for t in [W for W, _ in params] + [b for _, b in params]]
    names = leaf_names(n)
    start = [p.detach().clone() for p in leaves]
    opt = Adam(leaves, torch.as_tensor(lr, dtype=dtype, device=dev))
    eig_w = torch.as_tensor(cfg["eig_weights"], dtype=dtype, device=dev)
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    lag = int(cfg["lag"])
    losses, grad1 = [], None
    for idx in batches:
        idx = torch.as_tensor(idx, device=dev)
        if half:
            idx = idx[: len(idx) // 2]
        il = idx + lag
        P = [(leaves[i], leaves[n + i]) for i in range(n)]
        y = heads(P, features(frames[idx].to(dtype)))
        y_l = heads(P, features(frames[il].to(dtype)))
        loss, _ = transfer_loss(y, y_l, w_all[idx], w_all[il], alpha, eig_w,
                                cfg["dt_ns"] * lag)
        grads = torch.autograd.grad(loss.sum(), leaves)
        if grad1 is None:
            grad1 = {nm: g.detach().clone() for nm, g in zip(names, grads)}
        opt.step(grads)
        losses.append(loss.detach())
    change = {nm: p.detach() - p0 for nm, p, p0 in zip(names, leaves, start)}
    final = {nm: p.detach() for nm, p in zip(names, leaves)}
    return torch.stack(losses), grad1, change, final
