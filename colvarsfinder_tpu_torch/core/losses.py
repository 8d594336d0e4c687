r"""Loss functions (port of the transfer-operator branch of
``colvarsfinder_tpu/core/losses.py:120-285``).

Two quirks of the reference are preserved on purpose, as in the JAX
package: (a) the variational objective's numerator is indexed by the
unsorted head while its denominator uses the sorted head; (b) the
penalty's variance term runs over unsorted heads. Eigenvalue estimates are
detached.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["EigenAux", "eigen_loss"]


class EigenAux(NamedTuple):
    """Aux outputs of the eigenfunction loss."""

    eig_vals: torch.Tensor  # [k] detached, sorted if requested
    non_penalty_loss: torch.Tensor  # scalar variational objective
    penalty: torch.Tensor  # scalar orthonormality penalty
    cvec: torch.Tensor  # [k] ordering of heads by eigenvalue


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
):
    r"""Transfer-operator eigenfunction loss (``lag_idx > 0``): lagged
    square-difference quotients plus ``alpha`` times the orthonormality
    penalty. Returns ``(loss, EigenAux)``.

    ``beta`` and ``diag_coeff`` belong to the generator loss
    (``lag_idx == 0``), which is not ported yet.
    """
    if lag_idx == 0:
        raise NotImplementedError(
            "the generator loss (lag_idx == 0) is not ported yet: "
            "ROADMAP.md queue 1, item 8"
        )
    y = model(pp_layer(X))  # [B, k]
    tot_weight = weight.sum()
    means, variances = _weighted_moments(y, weight, tot_weight)

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
