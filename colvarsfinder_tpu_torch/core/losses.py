r"""Loss functions (port of ``colvarsfinder_tpu/core/losses.py``): the
autoencoders' reconstruction losses, the eigenfunction loss of the
generator (``lag_idx == 0``) and of the transfer operator
(``lag_idx > 0``), the committor loss, and the regularized autoencoder's
encoder constraints and eigenfunction regularizer.

The generator and the committor need per-sample input gradients. Samples
are independent, so the gradient of the batch's sum of head ``i`` by the
input batch is the stack of every sample's gradient of head ``i``: k
reverse-mode passes (``torch.autograd.grad``) give them all, as the JAX
package's one ``jacrev`` of the batch's head sums does. In a training step
they are taken with ``create_graph=True``, so the parameter gradient
differentiates through them (double backprop). ``torch.func.vmap`` is not
used: the kernel layers' ``autograd.Function``\ s have no vmap rule.

With a precomputed Gram matrix ``pp_gram`` (the Gram path), the input is
the feature batch ``H = r(x)`` and the Dirichlet integrand
:math:`\sum_d c_d (\partial_d f_i)^2` is the quadratic form
:math:`G_i M G_i^T` in the model-only input Jacobian :math:`G`.

Two quirks of the reference are preserved on purpose, as in the JAX
package: (a) the transfer operator's variational objective has its
numerator indexed by the unsorted head and its denominator by the sorted
head; (b) the penalty's variance term runs over unsorted heads. Eigenvalue
estimates are detached.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "EigenAux",
    "committor_loss",
    "eigen_loss",
    "enc_grad_loss",
    "enc_norm_loss",
    "enc_orthogonality_loss",
    "reg_eigen_loss",
    "weighted_mse_lagged_loss",
    "weighted_mse_loss",
]


def weighted_mse_loss(model, X: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    r"""Weighted reconstruction loss of an autoencoder on a feature batch
    ``X`` [B, d] (``colvarsfinder_tpu/core/losses.py:62-70``):
    :math:`\sum_l w_l \|f(x_l) - x_l\|^2 / \sum_l w_l`."""
    out = model(X)
    return (weight * ((out - X) ** 2).sum(dim=1)).sum() / weight.sum()


def weighted_mse_lagged_loss(forward_ae: Callable, pp_layer: Callable,
                             X: torch.Tensor, X_lagged: torch.Tensor,
                             weight: torch.Tensor) -> torch.Tensor:
    r"""Time-lagged reconstruction loss (``losses.py:73-86``):
    :math:`\sum_l w_l \|f(r(x_l)) - r(x_{l+j})\|^2 / \sum_l w_l`."""
    out = forward_ae(pp_layer(X))
    target = pp_layer(X_lagged)
    return (weight * ((out - target) ** 2).sum(dim=1)).sum() / weight.sum()


class EigenAux(NamedTuple):
    """Aux outputs of the eigenfunction loss."""

    eig_vals: torch.Tensor  # [k] detached, sorted if requested
    non_penalty_loss: torch.Tensor  # scalar variational objective
    penalty: torch.Tensor  # scalar orthonormality penalty
    cvec: torch.Tensor  # [k] ordering of heads by eigenvalue


def _input_jacobian(f_batched: Callable, X: torch.Tensor, k: int):
    """``(y, jac)``: ``y = f_batched(X)`` [B, k] and the per-sample input
    gradients ``jac`` [k, B, prod(state)], one reverse pass per head of
    the batch's head sum (``losses.py:103-117``).

    With grad mode on (a training step) the gradients are recorded
    (``create_graph=True``) for the parameter gradient to differentiate
    through. With it off (the test batches) they are taken all the same,
    and nothing is recorded.

    The passes run on the calling thread, not on the autograd engine's
    device thread. The engine orders the nodes of a backward, and so the
    order in which it sums a tensor's gradients, by their sequence numbers,
    which each thread counts on its own. Nodes recorded on the device
    thread would then sort against the forward's by how much each thread
    had recorded before, and a step's parameter gradient would change in
    its last bits with what the process ran earlier."""
    create = torch.is_grad_enabled()
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        Xg = X.detach().requires_grad_()
        y = f_batched(Xg)
        jac = torch.stack([
            torch.autograd.grad(y[:, i].sum(), Xg, create_graph=create,
                                retain_graph=True)[0]
            for i in range(k)
        ])
    jac = jac.reshape(k, X.shape[0], -1)
    if not create:
        y = y.detach()
    return y, jac


def _grad_sq(jac: torch.Tensor, diag_coeff) -> torch.Tensor:
    """[B, k]: :math:`\\sum_d c_d (\\partial f_i/\\partial x_d)^2` from
    per-sample input gradients ``jac`` [k, B, D]."""
    sq = jac**2
    if diag_coeff is not None:
        sq = sq * diag_coeff
    return sq.sum(dim=-1).T


class _Bf16QuadraticForm(torch.autograd.Function):
    """``G_b M_b G_b^T`` per sample and head with G rounded to bfloat16 and
    M stored in bfloat16, contracted with float32 accumulation into a
    float32 result: the card's counterpart of ``jnp.einsum(..., Gb, M,
    Gb, preferred_element_type=jnp.float32)`` (``losses.py:223-228``). The
    bf16 x bf16 -> f32 product is ``torch.bmm(..., out_dtype=torch.float32)``
    (cuBLAS with float32 accumulation and output), which has no autograd
    formula; the backward here gives ``dL/dG = g (M + M^T) G_b`` in float32,
    as the rounding to bf16 passes the cotangent through."""

    @staticmethod
    def forward(ctx, G, M):
        Gb = G.to(torch.bfloat16).transpose(0, 1).contiguous()  # [B, k, d]
        GM = torch.bmm(Gb, M, out_dtype=torch.float32)
        GMt = torch.bmm(Gb, M.transpose(1, 2), out_dtype=torch.float32)
        ctx.save_for_backward(GM + GMt)
        return (GM * Gb.to(torch.float32)).sum(dim=-1)  # [B, k]

    @staticmethod
    def backward(ctx, g):
        (sym,) = ctx.saved_tensors
        return (g[:, :, None] * sym).transpose(0, 1), None


def _gram_quadratic_form(G: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """[B, k]: ``einsum('kbi,bij,kbj->bk', G, M, G)`` for the model-only
    input Jacobian G [k, B, d_r] and the per-sample Gram matrices M
    [B, d_r, d_r]. A bfloat16 M is upcast on the CPU, as the JAX package
    does there (``losses.py:214-222``), and contracted as bf16 x bf16 with
    float32 accumulation and a float32 result on the card."""
    if M.dtype == torch.bfloat16:
        if M.device.type == "cpu":
            M = M.to(G.dtype)
        else:
            return _Bf16QuadraticForm.apply(G, M)
    return torch.einsum("kbi,bij,kbj->bk", G, M, G)


def _weighted_moments(y: torch.Tensor, weight: torch.Tensor, tot_weight):
    """Weighted per-head means and variances: mean = sum w y / sum w,
    var = sum w y^2 / sum w - mean^2."""
    means = (y * weight[:, None]).sum(dim=0) / tot_weight
    variances = (y**2 * weight[:, None]).sum(dim=0) / tot_weight - means**2
    return means, variances


def _pairwise_cov_penalty(y, weight, tot_weight, means, k: int):
    """sum_{i<j} (weighted cov(y_i, y_j))^2."""
    penalty = torch.zeros((), dtype=y.dtype, device=y.device)
    for i in range(k):
        for j in range(i + 1, k):
            cov = (y[:, i] * y[:, j] * weight).sum() / tot_weight - (
                means[i] * means[j]
            )
            penalty = penalty + cov**2
    return penalty


def eigen_loss(
    model,
    pp_layer: Callable,
    X: torch.Tensor,
    weight: torch.Tensor,
    X_lagged: torch.Tensor | None,
    weight_lagged: torch.Tensor | None,
    *,
    k: int,
    alpha: float,
    eig_w,
    beta: float = 1.0,
    diag_coeff=None,
    lag_idx: int,
    traj_dt: float,
    sort_eigvals: bool,
    pp_gram: torch.Tensor | None = None,
):
    r"""Eigenfunction loss plus ``alpha`` times the orthonormality penalty
    (``colvarsfinder_tpu/core/losses.py:120-285``). Returns
    ``(loss, EigenAux)``.

    Generator (``lag_idx == 0``): Rayleigh quotients of the Dirichlet form
    :math:`\beta^{-1}\mathbf{E}_w[\sum_d c_d (\partial_d f_i)^2] /
    \mathrm{var}_w f_i`, with the per-sample input gradients taken through
    ``pp_layer`` and ``diag_coeff`` the diagonal :math:`c` (None: ones).
    With ``pp_gram`` [B, d_r, d_r] (float32, float64 or bfloat16), ``X``
    is the precomputed feature batch, ``pp_layer`` and ``diag_coeff`` are
    not used, and the integrand is the quadratic form in the model-only
    Jacobian. Transfer operator (``lag_idx > 0``): lagged
    square-difference quotients.
    """
    if pp_gram is not None:
        if lag_idx != 0:
            raise ValueError("pp_gram applies to the generator loss only")
        y, G = _input_jacobian(model, X, k)
        grad_sq = _gram_quadratic_form(G, pp_gram)
    elif lag_idx == 0:
        y, jac = _input_jacobian(lambda Xb: model(pp_layer(Xb)), X, k)
        grad_sq = _grad_sq(jac, diag_coeff)
    else:
        y = model(pp_layer(X))  # [B, k]
    tot_weight = weight.sum()
    means, variances = _weighted_moments(y, weight, tot_weight)

    if lag_idx == 0:
        dirichlet = (grad_sq * weight[:, None]).sum(dim=0)  # [k]
        quotients = dirichlet / (tot_weight * beta) / variances
    else:
        y_lagged = model(pp_layer(X_lagged))
        tot_weight_lagged = weight_lagged.sum()
        _, variances_lagged = _weighted_moments(
            y_lagged, weight_lagged, tot_weight_lagged
        )
        sq_diff = (((y_lagged - y) ** 2) * weight[:, None]).sum(dim=0)
        quot_unsorted_num = sq_diff / tot_weight
        quotients = (quot_unsorted_num / (variances + variances_lagged)) / (
            traj_dt * lag_idx
        )
    eig_vals = quotients.detach()

    if sort_eigvals:
        cvec = torch.argsort(eig_vals, stable=True)
        eig_vals = eig_vals[cvec]
    else:
        cvec = torch.arange(k, device=y.device)

    eig_w_t = torch.as_tensor(eig_w, dtype=y.dtype, device=y.device)
    if lag_idx == 0:
        # generator objective: sorted heads in numerator and denominator
        non_penalty_loss = (
            eig_w_t * dirichlet[cvec] / (tot_weight * beta) / variances[cvec]
        ).sum()
    else:
        # preserved quirk: unsorted numerator, sorted denominator
        denom = variances[cvec] + variances_lagged[cvec]
        non_penalty_loss = (eig_w_t * quot_unsorted_num / denom).sum() / (
            traj_dt * lag_idx
        )

    # penalty over unsorted heads + pairwise covariances
    penalty = ((variances - 1.0) ** 2).sum()
    penalty = penalty + _pairwise_cov_penalty(y, weight, tot_weight, means, k)

    loss = non_penalty_loss + alpha * penalty
    return loss, EigenAux(eig_vals, non_penalty_loss, penalty, cvec)


def committor_loss(model, pp_layer, X, weight, mask_a, mask_b, hyper,
                   diag_coeff=None, pp_gram=None):
    r"""Variational committor loss (``colvarsfinder_tpu/core/losses.py:
    410-483``): with :math:`q = \sigma(g(r(x)))`,

    .. math::
        \mathcal{L} = \frac{\mathbb{E}_w[\sum_d a_d (\partial_d q)^2]}{\beta}
        + \alpha\,\mathbb{E}_w[\mathbf{1}_A q^2]
        + \alpha\,\mathbb{E}_w[\mathbf{1}_B (1 - q)^2].

    Args:
        model: scalar-output network ``g`` ([B, d_r] -> [B, 1]).
        pp_layer: preprocessing ``r`` (the input gradients go through it).
        X: raw states [B, *state], or with ``pp_gram`` the feature batch.
        weight / mask_a / mask_b: [B] frame weights and float indicators
            of the sets A and B.
        hyper: ``(alpha, beta)``.
        diag_coeff: optional [prod(state)] diffusion diagonal ``a``.
        pp_gram: optional per-sample preprocessing Gram matrices
            [B, d_r, d_r], ``diag_coeff`` folded in; then
            :math:`\sum_d a_d (\partial_d q)^2 = \sigma'(z)^2\,G M G^T`
            with :math:`G = \partial z/\partial h`.

    Returns ``(loss, (dirichlet, penalty_a, penalty_b))``, all scalars.
    """
    alpha, beta = hyper
    tot_weight = weight.sum()
    if pp_gram is not None:
        z, G = _input_jacobian(model, X, 1)
        q = torch.sigmoid(z[:, 0])
        sp = q * (1.0 - q)  # sigma'(z)
        grad_sq_vec = sp**2 * torch.einsum("bi,bij,bj->b", G[0], pp_gram,
                                           G[0])
    else:
        q, jac = _input_jacobian(
            lambda Xb: torch.sigmoid(model(pp_layer(Xb))), X, 1)
        q = q[:, 0]
        grad_sq_vec = _grad_sq(jac, diag_coeff)[:, 0]
    dirichlet = (grad_sq_vec * weight).sum() / (beta * tot_weight)
    pen_a = (weight * mask_a * q**2).sum() / tot_weight
    pen_b = (weight * mask_b * (1.0 - q) ** 2).sum() / tot_weight
    loss = dirichlet + alpha * (pen_a + pen_b)
    return loss, (dirichlet, pen_a, pen_b)


# ---------------------------------------------------------------------------
# the regularized autoencoder's encoder constraints and regularizer
def enc_grad_loss(encoder, pp_layer, X, weight, k: int) -> torch.Tensor:
    r"""Weighted mean squared norm of the encoder's gradients by the
    features ``Y = r(X)``, not by the raw coordinates, summed over its k
    outputs (``losses.py:293-303``)."""
    _, jac = _input_jacobian(encoder, pp_layer(X), k)
    grad_sq = _grad_sq(jac, None)  # [B, k]
    return ((grad_sq * weight[:, None]).sum(dim=0) / weight.sum()).sum()


def enc_norm_loss(encoder, pp_layer, X, weight, k: int) -> torch.Tensor:
    r"""Penalty on the weighted variances of the encoder's outputs,
    :math:`\sum_i (\mathrm{var}_w\,e_i - 1)^2` (``losses.py:306-312``)."""
    enc = encoder(pp_layer(X))
    _, variances = _weighted_moments(enc, weight, weight.sum())
    return ((variances - 1.0) ** 2).sum()


def enc_orthogonality_loss(encoder, pp_layer, X, weight,
                           k: int) -> torch.Tensor:
    """Penalty on the pairwise weighted covariances of the encoder's
    outputs (``losses.py:315-321``)."""
    tot_weight = weight.sum()
    enc = encoder(pp_layer(X))
    means, _ = _weighted_moments(enc, weight, tot_weight)
    return _pairwise_cov_penalty(enc, weight, tot_weight, means, k)


def reg_eigen_loss(model, pp_layer, X, weight, X_lagged, weight_lagged, *,
                   num_reg: int, eig_w, beta: float, diag_coeff, lag_idx: int,
                   traj_dt: float, pp_gram: torch.Tensor | None = None):
    r"""The eigenfunction regularizer of a regularized autoencoder: the
    eigenfunction objective of :func:`eigen_loss` on its regularizer heads
    ``model.forward_reg`` (``losses.py:324-407``), always sorted by
    eigenvalue, with both preserved quirks. Returns ``(eig_vals,
    non_penalty, penalty, cvec)``; the weight of the penalty is the
    caller's."""
    _, aux = eigen_loss(
        model.forward_reg, pp_layer, X, weight, X_lagged, weight_lagged,
        k=num_reg, alpha=0.0, eig_w=eig_w, beta=beta, diag_coeff=diag_coeff,
        lag_idx=lag_idx, traj_dt=traj_dt, sort_eigvals=True, pp_gram=pp_gram,
    )
    return aux.eig_vals, aux.non_penalty_loss, aux.penalty, aux.cvec
