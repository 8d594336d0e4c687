r"""Eigenfunction training task, generator and transfer operator (port of
``colvarsfinder_tpu/core/eigenfunction.py``).

The loss is trained with Adam or SGD over drop-last batches: of lagged
pairs ``(x_i, x_{i+lag})`` for the transfer operator (``lag_tau > 0``), of
frames for the generator (``lag_tau == 0``). Step implementations, as in
the JAX package:

* default: plain PyTorch through :func:`.losses.eigen_loss`; the
  generator's per-sample input gradients are k reverse passes recorded for
  double backprop;
* generator, ``gram_pp`` (default for a non-identity preprocessing layer):
  the preprocessing layer's per-sample Gram matrix
  :math:`M = J\,\mathrm{diag}(c)\,J^T` and the features are computed once
  per batch (:func:`gram_batch`), and each step differentiates only the
  model; ``gram_dtype='bfloat16'`` stores M in bfloat16;
* transfer operator, ``fused_step=True``: the loss forward and the
  parameter backward run as CUDA kernels K3/K4 (:mod:`..ops.fused_eigen`)
  on the card, and as their plain version on the CPU.

The batches are gathered onto the device once before the loop. An epoch is
one call of :meth:`.task.TrainingTask._epoch_body`, which the card
captures as a CUDA graph and replays (:meth:`.task.TrainingTask._run_epoch`),
the counterpart of the JAX package's ``_multi_epoch_fn`` with ``prebatch``
and ``unroll`` (``colvarsfinder_tpu/core/eigenfunction.py:193-291``).
Per-step metrics stay on the device and reach the host once per chunk of
epochs (the epochs up to the next checkpoint, plot or progress event).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype
from ..export import ColvarModel
from ..models.eigen import EigenFunctions
from ..ops.features import Identity, as_pp_layer
from ..ops.fused_eigen import (
    bwd_launch_shape,
    eigen_loss_from_stats,
    fwd_launch_shape,
    params_t_of,
    transfer_stats,
)
from .losses import eigen_loss
from .task import TrainingTask

__all__ = ["EigenFunctionTask", "gram_batch"]


#: frames in one reverse pass of :func:`gram_batch` (replicas of a batch);
#: the plain alignment's graph takes ~1.2 kB per frame
GRAM_PASS_FRAMES = 1 << 20


def gram_batch(pp, X: torch.Tensor, diag_coeff: torch.Tensor, d_r: int):
    r"""Features and the preprocessing Gram matrix of a batch of frames:
    ``(H [B, d_r], M [B, d_r, d_r])`` with
    :math:`M_b = J_b\,\mathrm{diag}(c)\,J_b^T`, :math:`J_b` the Jacobian of
    the flattened features by the flattened frame ``b`` and ``d_r`` the
    layer's features per frame (the JAX package's ``_gram_fn``,
    ``colvarsfinder_tpu/core/eigenfunction.py:43-74``).

    The JAX package pushes ``prod(state)`` tangents through the layer with
    ``jax.vmap`` of ``jax.jvp``, which its kernel layers (``custom_vjp``)
    refuse. Here row ``i`` of every :math:`J_b` is the reverse pass of the
    batch's feature sum ``sum_b H[b, i]`` (samples are independent), and
    the ``d_r`` rows are taken together: the batch is stacked ``d_r`` times
    (in groups of at most :data:`GRAM_PASS_FRAMES` frames) and copy ``i``
    is given the cotangent ``e_i``. One forward and one backward of the
    layer's own per group, so a layer whose forward is a CUDA kernel
    (``FusedAlignmentLayer``, ``AlignmentLayer(method='cuda')``) runs it
    once on the stacked frames."""
    B = X.shape[0]
    X = X.detach()
    group = max(1, min(d_r, GRAM_PASS_FRAMES // B))
    H, rows = None, []
    with torch.enable_grad():
        for i0 in range(0, d_r, group):
            n = min(group, d_r - i0)
            Xg = X.expand(n, *X.shape).reshape(n * B, *X.shape[1:])
            Xg.requires_grad_()
            Hg = pp(Xg).reshape(n, B, d_r)
            if H is None:
                H = Hg[0].detach()
            eye = torch.eye(d_r, dtype=Hg.dtype, device=Hg.device)
            cot = eye[i0:i0 + n, None, :].expand(n, B, d_r)
            rows.append(torch.autograd.grad(Hg, Xg, cot)[0].reshape(n, B, -1))
    J = torch.cat(rows)  # [d_r, B, prod(state)]
    M = torch.einsum("ibd,d,jbd->bij", J, diag_coeff.to(J.dtype), J)
    return H, M


class EigenFunctionTask(TrainingTask):
    r"""Learn eigenfunctions of the infinitesimal generator
    (``lag_tau == 0``) or the transfer operator (``lag_tau > 0``).

    Arguments are those of the JAX ``EigenFunctionTask``:

    * ``beta`` and ``diag_coeff`` (length ``prod(state)``, default ones)
      enter the generator's Dirichlet form;
    * ``gram_pp`` (generator only; default: on for a non-identity
      preprocessing layer) trains through the precomputed Gram matrices,
      unless they would exceed :attr:`GRAM_AUTO_LIMIT_BYTES` (then the
      vjp path, with a warning if ``gram_pp=True`` was explicit);
    * ``gram_dtype``: ``None`` or ``'float32'`` keeps M in the default
      dtype, ``'bfloat16'`` stores it in bfloat16;
    * ``fused_step=True`` (transfer operator only) runs each step through
      the fused stats kernels; it needs the 'tanh' activation, float32 and
      a model whose kernel blocks fit in shared memory
      (:func:`..ops.fused_eigen.fwd_launch_shape`,
      :func:`..ops.fused_eigen.bwd_launch_shape`);
    * ``precompute_features=True`` (transfer operator only) computes the
      features once for the whole trajectory.

    Attributes:
        train_loss / test_loss: per-epoch mean metrics [epochs, 3 + k] with
            columns :attr:`loss_names`
        train_loss_df / test_loss_df: the same as pandas DataFrames
    """

    def __init__(
        self,
        traj_obj,
        pp_layer,
        model,
        model_path,
        alpha: float,
        eig_weights,
        diag_coeff=None,
        beta: float = 1.0,
        lag_tau: float = 0,
        learning_rate: float = 0.01,
        load_model_filename=None,
        save_model_every_step: int = 10,
        sort_eigvals_in_training: bool = True,
        k: int = 1,
        batch_size: int = 1000,
        num_epochs: int = 10,
        test_ratio: float = 0.2,
        optimizer_name: str = "Adam",
        device=None,
        plot_class=None,
        plot_frequency: int = 0,
        verbose: bool = True,
        debug_mode: bool = True,
        precompute_features: bool = False,
        fused_step: bool = False,
        gram_pp: bool | None = None,
        gram_dtype=None,
        **kwargs,
    ):
        if not isinstance(model, EigenFunctions):
            raise TypeError("model must be an object of the class EigenFunctions")
        if k != model.k:
            raise ValueError(
                f"number of cv ({k}) must equal the number of eigenfunctions "
                f"({model.k})"
            )
        traj_dt = float(traj_obj.dt)
        lag_idx = lag_tau / traj_dt
        if abs(lag_idx - round(lag_idx)) >= 1e-6:
            raise ValueError(
                f"lag-time ({lag_tau}) not divisable by the timestep "
                f"{traj_dt} of the trajectory"
            )
        lag_idx = int(round(lag_idx))
        for flag, name in ((precompute_features, "precompute_features"),
                           (fused_step, "fused_step")):
            if flag and lag_idx == 0:
                raise ValueError(
                    f"{name} requires the transfer-operator loss "
                    "(lag_tau > 0); the generator loss differentiates "
                    "through the preprocessing layer"
                )
        if gram_pp and lag_idx > 0:
            raise ValueError(
                "gram_pp applies to the generator loss only (lag_tau == 0)"
            )
        super().__init__(
            traj_obj, as_pp_layer(pp_layer), model, model_path,
            learning_rate, load_model_filename, save_model_every_step, k,
            batch_size, num_epochs, test_ratio, optimizer_name, device,
            plot_class, plot_frequency, verbose, debug_mode, **kwargs,
        )
        self._alpha = float(alpha)
        self._sort_eigvals_in_training = bool(sort_eigvals_in_training)
        self._eig_w = list(eig_weights)
        self._beta = float(beta)
        self._cvec = None
        self.traj_dt = traj_dt
        self.lag_idx = lag_idx
        self.loss_names = ["loss", "eigen_non_penalty", "eigen_penalty"] + [
            "eig_%d" % (i + 1) for i in range(self.k)
        ]

        self.fused_step = bool(fused_step)
        if self.fused_step:
            if model.activation != "tanh":
                raise ValueError(
                    "fused_step kernels implement the 'tanh' activation (got "
                    f"'{model.activation}'); use the default step"
                )
            if default_dtype() != torch.float32:
                raise ValueError(
                    "fused_step computes in float32; with float64 use the "
                    "default step"
                )
            # each raises if the model's block is too large
            fwd_launch_shape(model.layer_dims, self.k)
            bwd_launch_shape(model.layer_dims, self.k)

        if self.verbose:
            print("\nEigenfunctions:\n", self.model, flush=True)
        self.init_model_and_optimizer()

        dt = default_dtype()
        self._traj = torch.as_tensor(
            np.asarray(traj_obj.trajectory), dtype=dt
        ).to(self.device)
        self._weights = torch.as_tensor(
            np.asarray(traj_obj.weights), dtype=dt
        ).to(self.device)
        self._eig_w_t = torch.as_tensor(self._eig_w, dtype=dt,
                                        device=self.device)

        self.precompute_features = bool(precompute_features)
        self._pp_for_loss = self.preprocessing_layer
        if self.precompute_features:
            # features once for the whole trajectory, as the JAX option
            with torch.no_grad():
                self._traj = torch.cat([
                    self.preprocessing_layer(chunk)
                    for chunk in torch.split(self._traj, 65536)
                ])
            self._pp_for_loss = Identity()

        self._diag_coeff = None
        if self.lag_idx == 0:
            self._diag_coeff = self._diag_coeff_tensor(diag_coeff)
        self._resolve_gram_request(gram_pp, self.lag_idx == 0)
        if gram_dtype is not None:
            name = (gram_dtype if gram_dtype == "bfloat16"
                    else np.dtype(gram_dtype).name)
            if name not in ("float32", "bfloat16"):
                raise ValueError(
                    f"gram_dtype must be 'float32' or 'bfloat16', got {name}"
                )
            gram_dtype = None if name == "float32" else name
        self._gram_dtype = gram_dtype

    # ------------------------------------------------------------------
    def get_reordered_eigenfunctions(self, model, cvec):
        """New EigenFunctions with heads permuted by ``cvec``."""
        return model.reordered(cvec)

    def colvar_model(self) -> ColvarModel:
        """CV model with heads ordered by the last training ``cvec``."""
        if self._cvec is None:
            self._cvec = np.arange(self.k)
        return ColvarModel(self.preprocessing_layer,
                           self.model.reordered(self._cvec))

    def reg_model(self):
        """None: the task has no regularizer model."""
        return None

    # ------------------------------------------------------------------
    def _prepare_data(self):
        """``(train, test, train_b, test_b, rows)``: per batch
        ``(X, X_l, w, w_l)`` (transfer operator), ``(X, w)`` (generator) or
        ``(H, M, w)`` (generator, Gram path); ``rows`` [nb_train + nb_test,
        3 + 2k], the cvec in the last k columns."""
        if self._prepared is not None:
            return self._prepared
        train_idx, test_idx = self._lagged_split(self.lag_idx)
        train_b = self._make_batches(train_idx, self.batch_size)
        test_b = self._make_batches(test_idx, self.batch_size)
        self._resolve_gram(train_b, test_b)
        m_dtype = (torch.bfloat16 if self._gram_dtype == "bfloat16"
                   else self._traj.dtype)

        def pack(rows):
            out = []
            for row in rows:
                i = torch.as_tensor(row, device=self.device)
                X, w = self._traj[i], self._weights[i]
                if self.lag_idx > 0:
                    il = i + self.lag_idx
                    out.append((X, self._traj[il], w, self._weights[il]))
                elif self._gram:
                    H, M = gram_batch(self._pp_for_loss, X, self._diag_coeff,
                                      self._d_r)
                    out.append((H, M.to(m_dtype), w))
                else:
                    out.append((X, w))
            return out

        rows = self._metric_rows(len(train_b) + len(test_b),
                                 len(self.loss_names) + self.k)
        self._prepared = (pack(train_b), pack(test_b), train_b, test_b, rows)
        return self._prepared

    def _graph_static(self):
        return ((self.fused_step, self._sort_eigvals_in_training, self._alpha,
                 self._beta, self.lag_idx, self.traj_dt, self._gram,
                 self._gram_dtype),
                (self.model, self._pp_for_loss, self._eig_w_t,
                 self._diag_coeff))

    def _chunk_fetched(self, train_cm):
        # cvec of the last train batch of the chunk's last epoch
        self._cvec = train_cm[-1, -1, len(self.loss_names):].astype(int)

    def _batch_metrics(self, *batch):
        """Loss and the metric row [loss, non_penalty, penalty, eig_vals,
        cvec] of one batch."""
        common = dict(k=self.k, alpha=self._alpha, eig_w=self._eig_w_t,
                      lag_idx=self.lag_idx, traj_dt=self.traj_dt,
                      sort_eigvals=self._sort_eigvals_in_training)
        if self.fused_step:
            X, X_l, w, w_l = batch
            F = self._pp_for_loss(X)
            F_l = self._pp_for_loss(X_l)
            F = F.reshape(F.shape[0], -1)
            F_l = F_l.reshape(F_l.shape[0], -1)
            stats = transfer_stats(params_t_of(self.model), F, F_l, w, w_l)
            loss, (eig_vals, non_pen, pen, cvec) = eigen_loss_from_stats(
                stats, **common)
        else:
            X_l = w_l = M = None
            if self.lag_idx > 0:
                X, X_l, w, w_l = batch
            elif self._gram:
                X, M, w = batch
            else:
                X, w = batch
            loss, aux = eigen_loss(
                self.model, self._pp_for_loss, X, w, X_l, w_l,
                beta=self._beta, diag_coeff=self._diag_coeff, pp_gram=M,
                **common,
            )
            eig_vals, non_pen, pen, cvec = (
                aux.eig_vals, aux.non_penalty_loss, aux.penalty, aux.cvec
            )
        metrics = torch.cat([
            torch.stack([loss, non_pen, pen]).detach(),
            eig_vals,
            cvec.to(loss.dtype),
        ])
        return loss, metrics
