"""Plain reference of the eigenfunction training step: rigid alignment by
the SVD Kabsch solution, position features, k tanh heads, the transfer
operator's or the generator's loss with the orthonormality penalty, and
Adam. Plain PyTorch, written from the published loss of colvars-finder
(``colvarsfinder/core.py``), in float64 unless told otherwise; it imports
nothing of the program.

All functions carry a leading replica axis R (1 for one model): the heads'
parameters are ``[R, k, d_out, d_in]`` / ``[R, k, d_out]``, and a batch of
R replicas' losses is their sum's backward, each replica's parameters
getting exactly its own gradient.

Two quirks of colvars-finder's transfer-operator loss are the loss users
train, and are kept: the variational objective pairs the numerator of the
unsorted head with the variances of the sorted one, and the penalty's
variance term runs over the unsorted heads.
"""

from __future__ import annotations

import math

import torch

BETAS, EPS = (0.9, 0.999), 1e-8

#: set by the caller for the control: every product's float32 operands are
#: rounded to TF32 (10 mantissa bits, as a tensor core reads them) and the
#: sums kept in float32
TF32 = False


def _p(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product: ``x``, or with :data:`TF32` set its float32
    values rounded to TF32 (to nearest, ties away from zero), the gradient
    passed through unchanged."""
    if not TF32 or x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach())


def align(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Frames ``x`` [B, N, 3] centred on their centroid and rotated onto
    ``ref`` [N, 3] (centred here) by the rotation R minimising
    ``|x_c R - ref_c|``: with ``x_c^T ref_c = U S V^T``,
    ``R = U diag(1, 1, det(U V^T)) V^T``."""
    ref_c = ref - ref.mean(dim=0)
    xc = x - x.mean(dim=1, keepdim=True)
    U, _, Vh = torch.linalg.svd(_p(xc.transpose(1, 2)) @ _p(ref_c))
    d = torch.linalg.det(U @ Vh)
    D = torch.ones(x.shape[0], 3, dtype=x.dtype, device=x.device)
    D = torch.cat([D[:, :2], d[:, None]], dim=1)
    return _p(xc) @ _p(U * D[:, None, :] @ Vh)


def features(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Position features [B, 3 N] of the aligned frames."""
    return align(x, ref).reshape(x.shape[0], -1)


def heads(params, h: torch.Tensor) -> torch.Tensor:
    """[R, k, B]: every replica's k heads on features ``h`` [B, d] (shared)
    or [R, B, d] (per replica); tanh after every layer but the last."""
    if h.dim() == 2:
        h = torch.einsum("bi,rkoi->rkbo", _p(h), _p(params[0][0]))
    else:
        h = torch.einsum("rbi,rkoi->rkbo", _p(h), _p(params[0][0]))
    h = h + params[0][1][:, :, None, :]
    for W, b in params[1:]:
        h = torch.tanh(h)
        h = torch.einsum("rkbi,rkoi->rkbo", _p(h), _p(W)) + b[:, :, None, :]
    return h[..., 0]


def _moments(y, w):
    tot = w.sum()
    mean = (y * w).sum(dim=-1) / tot
    var = (y * y * w).sum(dim=-1) / tot - mean * mean
    return tot, mean, var


def _penalty(y, w, tot, mean, var):
    """sum_i (var_i - 1)^2 + sum_{i<j} cov_ij^2, over unsorted heads."""
    pen = ((var - 1.0) ** 2).sum(dim=-1)
    k = y.shape[1]
    for i in range(k):
        for j in range(i + 1, k):
            cov = ((y[:, i] * y[:, j] * w).sum(dim=-1) / tot
                   - mean[:, i] * mean[:, j])
            pen = pen + cov * cov
    return pen


def transfer_loss(y, y_l, w, w_l, alpha, eig_w, tau):
    """Per replica ``(loss [R], sorted eigenvalues [R, k])`` of heads ``y``
    and lagged heads ``y_l`` [R, k, B]; ``alpha`` [R] or a float."""
    tot, mean, var = _moments(y, w)
    _, _, var_l = _moments(y_l, w_l)
    num = (((y_l - y) ** 2) * w).sum(dim=-1) / tot
    eig = (num / (var + var_l) / tau).detach()
    cvec = torch.argsort(eig, dim=-1, stable=True)
    denom = torch.gather(var, 1, cvec) + torch.gather(var_l, 1, cvec)
    objective = (eig_w * num / denom).sum(dim=-1) / tau
    loss = objective + alpha * _penalty(y, w, tot, mean, var)
    return loss, torch.gather(eig, 1, cvec)


def generator_loss(y, grad_sq, w, alpha, eig_w, beta):
    """Per replica ``(loss [R], sorted eigenvalues [R, k])`` of heads ``y``
    [R, k, B] with Dirichlet integrands ``grad_sq`` [R, k, B]."""
    tot, mean, var = _moments(y, w)
    dirichlet = (grad_sq * w).sum(dim=-1) / (tot * beta)
    eig = (dirichlet / var).detach()
    cvec = torch.argsort(eig, dim=-1, stable=True)
    objective = (eig_w * torch.gather(dirichlet, 1, cvec)
                 / torch.gather(var, 1, cvec)).sum(dim=-1)
    loss = objective + alpha * _penalty(y, w, tot, mean, var)
    return loss, torch.gather(eig, 1, cvec)


def gram(x: torch.Tensor, ref: torch.Tensor, diag: torch.Tensor):
    """``(H [B, d], M [B, d, d])``: the features of the frames ``x`` and
    ``M = J diag(c) J^T``, J the Jacobian of a frame's features by its
    flattened coordinates, one reverse pass per feature (the frames are
    independent, so the gradient of a feature's batch sum is every frame's
    gradient of it)."""
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        H = features(x, ref)
        rows = [torch.autograd.grad(H[:, i].sum(), x, retain_graph=True)[0]
                .reshape(x.shape[0], -1) for i in range(H.shape[1])]
    J = torch.stack(rows, dim=1)  # [B, d, 3 N]
    M = torch.einsum("bid,d,bjd->bij", _p(J), _p(diag), _p(J))
    return H.detach(), M


def dirichlet_integrand(params, H, M):
    """[R, k, B]: ``G M G^T`` per replica, head and frame, G the gradient of
    the head by the features (kept for the parameter gradient)."""
    R = params[0][0].shape[0]
    Hr = H.expand(R, *H.shape).clone().requires_grad_()
    y = heads(params, Hr)
    G = torch.stack([
        torch.autograd.grad(y[:, i].sum(), Hr, create_graph=True)[0]
        for i in range(y.shape[1])], dim=1)  # [R, k, B, d]
    return y, torch.einsum("rkbi,bij,rkbj->rkb", _p(G), _p(M), _p(G))


class Adam:
    """torch.optim.Adam's update (betas 0.9/0.999, eps 1e-8) on the leaves,
    with a learning rate per replica ``lr`` [R]."""

    def __init__(self, leaves, lr: torch.Tensor):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, grads):
        b1, b2 = BETAS
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            lr = self.lr.view(-1, *([1] * (p.dim() - 1)))
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + EPS))


def leaf_names(n_layers: int):
    """The heads' parameter names, in the program's order."""
    return ([f"weights.{i}" for i in range(n_layers)]
            + [f"biases.{i}" for i in range(n_layers)])


def follow(cfg: dict, frames, weights, ref, params, batches, lr, alpha,
           dtype=torch.float64, half: bool = False):
    """Train every replica from ``params`` (per layer (W [R, k, o, i], b [R,
    k, o])) through the train batches ``batches`` (index arrays of lagged
    pairs' starts), one Adam step each, and return ``(losses [steps, R],
    first gradient {name: [R, ...]}, the parameters' change over the
    steps {name: [R, ...]}, the parameters after them {name: [R, ...]})``.
    ``frames`` [n, N, 3] and ``weights`` [n]
    are the inputs as handed to the program (the weights normalised to
    mean 1 here, as a trajectory of the program does); ``half`` keeps the
    first half of each batch (a fault that a check must catch)."""
    dev = frames.device
    ref = ref.to(dtype)
    w_all = weights.double() / weights.double().mean()
    w_all = w_all.to(dtype)
    n = len(params)
    leaves = [t.detach().to(dtype).clone().requires_grad_()
              for t in [W for W, _ in params] + [b for _, b in params]]
    names = leaf_names(n)
    start = [p.detach().clone() for p in leaves]
    opt = Adam(leaves, torch.as_tensor(lr, dtype=dtype, device=dev))
    eig_w = torch.as_tensor(cfg["eig_weights"], dtype=dtype, device=dev)
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    lag = int(cfg["lag"])
    diag = torch.as_tensor(cfg.get("diag_coeff") or [1.0] * cfg["d_r"],
                           dtype=dtype, device=dev)
    losses, grad1 = [], None
    for idx in batches:
        idx = torch.as_tensor(idx, device=dev)
        if half:
            idx = idx[: len(idx) // 2]
        P = [(leaves[i], leaves[n + i]) for i in range(n)]
        x = frames[idx].to(dtype)
        w = w_all[idx]
        if cfg["loss"] == "transfer":
            il = idx + lag
            y = heads(P, features(x, ref))
            y_l = heads(P, features(frames[il].to(dtype), ref))
            loss, _ = transfer_loss(y, y_l, w, w_all[il], alpha, eig_w,
                                    cfg["dt_ns"] * lag)
        else:
            H, M = gram(x, ref, diag)
            y, grad_sq = dirichlet_integrand(P, H, M)
            loss, _ = generator_loss(y, grad_sq, w, alpha, eig_w,
                                     cfg["beta"])
        grads = torch.autograd.grad(loss.sum(), leaves)
        if grad1 is None:
            grad1 = {nm: g.detach().clone() for nm, g in zip(names, grads)}
        opt.step(grads)
        losses.append(loss.detach())
    change = {nm: p.detach() - p0 for nm, p, p0 in zip(names, leaves, start)}
    final = {nm: p.detach() for nm, p in zip(names, leaves)}
    return torch.stack(losses), grad1, change, final
