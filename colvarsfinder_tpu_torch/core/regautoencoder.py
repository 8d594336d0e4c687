r"""Regularized autoencoder training task (port of
``colvarsfinder_tpu/core/regautoencoder.py``).

The loss is a weighted sum of six terms (``regautoencoder.py:68-140``):
the (time-lagged) reconstruction, weight ``alpha``; the eigenfunction
objective and the orthonormality penalty of the regularizer heads,
weights ``gamma``; the encoder's gradient, norm and orthogonality
constraints, weights ``eta``. A term whose weight is not above 1e-5 is not
computed (its metric is 0). The regularizer is the transfer operator's for
``lag_tau_reg > 0`` and the generator's for ``lag_tau_reg == 0``; the
generator takes the per-sample input gradients through the preprocessing
layer (the vjp path) or, by default for a non-identity layer, the
per-batch preprocessing Gram matrices of :func:`.eigenfunction.gram_batch`
(the Gram path), as :class:`.eigenfunction.EigenFunctionTask` does.

The preprocessing layer has no parameters, so one pass of it per batch
serves every term that reads the features (the JAX package writes one per
term; the values are the same), and the lagged frames of the
reconstruction and of the transfer regularizer share one gather and one
pass when their lags are equal. ``freeze_encoder`` zeroes the encoder's
gradients before each optimizer step, as the JAX package does
(``_zero_encoder_grads``, ``regautoencoder.py:143-153``): Adam's moments of
the encoder stay zero and its parameters do not move.

The batches are gathered onto the device once, and an epoch is one call
of :meth:`.task.TrainingTask._epoch_body`, captured as a CUDA graph on the
card. The term and head weights are Python floats that a captured epoch
bakes in, so the graph key holds them by value. In a replica sweep they
are tensors, one value per replica, while the gates stay decided by the
task's own values (``colvarsfinder_tpu/parallel/ensemble.py:920-938``);
the features are computed once per batch outside the replica map, as for
:class:`.eigenfunction.EigenFunctionTask`.

With ``streaming=True`` the trajectory stays on the host and each batch
``(X, X_ae, X_l, w, w_l)`` is gathered and copied to the card as the steps
need it (:meth:`.task.TrainingTask._stream_epochs`; JAX
``regautoencoder.py:308, 857-887``), the lagged frames of equal lags once;
the generator regularizer takes the vjp path there, and
``precompute_features`` runs over chunks on the card into host numpy.

On a mesh every term gathers its per-sample values (reconstruction errors,
encoder outputs and gradients, head outputs and integrands) where it
reduces them over the batch (:meth:`.task.TrainingTask._gather`), and a
frozen encoder's gradients are zeroed after their sum over the ranks. The
JAX package's ``prebatch`` layout is accepted and changes nothing
(:meth:`.task.TrainingTask._check_layout`); ``shard_trajectory`` is the
meshed layout itself (:mod:`.task`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype
from ..export import ColvarModel
from ..models.ae import RegAutoEncoder, RegModel
from ..ops.features import Identity, as_pp_layer
from .eigenfunction import _IDENTITY, gram_batch
from .losses import (
    enc_grad_loss,
    enc_norm_loss,
    enc_orthogonality_loss,
    input_jacobian,
    reg_eigen_loss,
    weighted_mse_lagged_loss,
)
from .task import TrainingTask, numpy_dtype

__all__ = ["RegAutoEncoderTask"]

#: a term is on when its weight is above this (``regautoencoder.py:41``)
_EPS = 1e-5


class RegAutoEncoderTask(TrainingTask):
    r"""Train a regularized autoencoder.

    Arguments are those of the JAX ``RegAutoEncoderTask``:

    * ``eig_weights``: one weight per regularizer head (K of them);
    * ``alpha``, ``gamma`` (2), ``eta`` (3): the term weights;
    * ``lag_tau_ae`` / ``lag_tau_reg``: the lag times of the reconstruction
      and of the regularizer, multiples of the trajectory's ``dt``;
    * ``beta``: the generator's inverse temperature;
    * ``freeze_encoder``: train everything but the encoder;
    * ``precompute_features=True``: the features once for the whole
      trajectory (not with the generator regularizer, which differentiates
      through the preprocessing layer);
    * ``gram_pp`` (generator regularizer only; default on for a
      non-identity preprocessing layer): train through the precomputed Gram
      matrices, unless they would exceed :attr:`GRAM_AUTO_LIMIT_BYTES` or
      the task streams;
    * ``streaming``: keep the trajectory on the host and stream the batches
      (True), keep it on the device (False), or stream when its device
      copies, one per active lag, would exceed
      :attr:`STREAMING_AUTO_LIMIT_BYTES` (None; JAX
      ``regautoencoder.py:451-460``);
    * ``prebatch``: the JAX package's batch layout, validated as there and
      otherwise without effect (:meth:`.task.TrainingTask._check_layout`).

    Attributes:
        train_loss / test_loss: per-epoch mean metrics [epochs, 7 + K] with
            columns :attr:`loss_names`: ``loss, ae_loss,
            eigen_non_penalty, eigen_penalty, eig_0 .. eig_{K-1},
            encoder_gradient, encoder_norm, encoder_orthogonality``
        train_loss_df / test_loss_df: the same as pandas DataFrames
    """

    _GATES = {
        "alpha": lambda v: float(v) > _EPS,
        "gamma": lambda v: float(np.sum(v)) > _EPS,
        "eta": lambda v: tuple(float(e) > _EPS for e in np.reshape(v, -1)),
    }

    def __init__(
        self,
        traj_obj,
        pp_layer,
        model,
        model_path,
        eig_weights=(),
        learning_rate: float = 0.01,
        load_model_filename=None,
        save_model_every_step: int = 10,
        batch_size: int = 1000,
        num_epochs: int = 10,
        test_ratio: float = 0.2,
        optimizer_name: str = "Adam",
        alpha: float = 1.0,
        gamma=(0.0, 0.0),
        eta=(0.0, 0.0, 0.0),
        lag_tau_ae: float = 0,
        lag_tau_reg: float = 0,
        beta: float = 1.0,
        device=None,
        plot_class=None,
        plot_frequency: int = 0,
        freeze_encoder: bool = False,
        verbose: bool = True,
        debug_mode: bool = True,
        precompute_features: bool = False,
        prebatch: bool | None = None,
        gram_pp: bool | None = None,
        streaming: bool | None = None,
        **kwargs,
    ):
        if not isinstance(model, RegAutoEncoder):
            raise TypeError(
                "model must be an object of the class RegAutoEncoder")
        if model.num_reg != len(eig_weights):
            raise ValueError("number of weights does not match the number of "
                             "eigenfunctions!")
        traj_dt = float(traj_obj.dt)
        lags = [tau / traj_dt for tau in (lag_tau_ae, lag_tau_reg)]
        if any(abs(lag - round(lag)) >= 1e-6 for lag in lags):
            raise ValueError(
                f"lag-times ({lag_tau_ae}, {lag_tau_reg}) not divisable by the "
                f"timestep {traj_dt} of the trajectory")
        gamma = [float(g) for g in gamma]
        gen_reg_on = sum(gamma) > _EPS and round(lags[1]) == 0
        if sum(gamma) > _EPS and model.num_reg == 0:
            raise ValueError("number of eigenfunctions must be positive!")
        if precompute_features and gen_reg_on:
            raise ValueError(
                "precompute_features is incompatible with the generator "
                "eigen regularizer (gamma > 0 with lag_tau_reg == 0), which "
                "differentiates through the preprocessing layer")
        if gram_pp and not gen_reg_on:
            raise ValueError(
                "gram_pp applies to the generator-type eigen regularizer "
                "only (gamma > 0 with lag_tau_reg == 0)")
        super().__init__(
            traj_obj, as_pp_layer(pp_layer), model, model_path,
            learning_rate, load_model_filename, save_model_every_step,
            model.encoded_dim, batch_size, num_epochs, test_ratio,
            optimizer_name, device, plot_class, plot_frequency, verbose,
            debug_mode, **kwargs,
        )
        self.init_model_and_optimizer()
        self.alpha = float(alpha)
        self.gamma = gamma
        self.eta = [float(e) for e in eta]
        self.num_reg = model.num_reg
        self._eig_w = list(eig_weights)
        self._beta = float(beta)
        self._cvec = None
        self.freeze_encoder = bool(freeze_encoder)
        self.traj_dt = traj_dt
        self.lag_ae_idx, self.lag_idx = (int(round(lag)) for lag in lags)
        self.loss_names = (
            ["loss", "ae_loss", "eigen_non_penalty", "eigen_penalty"]
            + ["eig_%d" % i for i in range(self.num_reg)]
            + ["encoder_gradient", "encoder_norm", "encoder_orthogonality"]
        )

        dt = default_dtype()
        raw = np.asanyarray(traj_obj.trajectory)
        n_copies = (1 + (self.alpha > _EPS and self.lag_ae_idx > 0)
                    + (sum(gamma) > _EPS and self.lag_idx > 0))
        self._streaming = self._resolve_streaming(
            streaming, n_copies * raw.size * dt.itemsize)
        self._check_layout(prebatch)
        self._traj = self._traj_np = None
        if self._streaming:
            self._traj_np = raw
            self._weights_np = np.asarray(traj_obj.weights,
                                          dtype=numpy_dtype())
        else:
            self._traj = torch.as_tensor(np.asarray(raw), dtype=dt).to(
                self.device)
            self._weights = torch.as_tensor(
                np.asarray(traj_obj.weights), dtype=dt).to(self.device)
        self.tot_dim = int(np.prod(raw.shape[1:]))
        self.precompute_features = bool(precompute_features)
        self._pp_for_loss = self.preprocessing_layer
        if self.precompute_features:
            if self._streaming:
                self._traj_np = self._chunked_apply(
                    self.preprocessing_layer, raw, device=self.device)
            else:
                with torch.no_grad():
                    self._traj = torch.cat([
                        self.preprocessing_layer(chunk)
                        for chunk in torch.split(self._traj, 65536)
                    ])
            self._pp_for_loss = Identity()
        self._diag_coeff = None
        if gen_reg_on:
            # the identity diffusion matrix, as in the reference
            self._diag_coeff = torch.ones(self.tot_dim, dtype=dt,
                                          device=self.device)
        self._resolve_gram_request(gram_pp, gen_reg_on)
        if self.verbose:
            data = self._traj_np if self._streaming else self._traj
            print("\nShape of trajectory data array:\n "
                  f"{tuple(data.shape)}", flush=True)

    # ------------------------------------------------------------------
    def _gates(self):
        """``(ae_on, eig_on, eta_on)``: which terms the step computes."""
        return (self.alpha > _EPS, sum(self.gamma) > _EPS,
                tuple(e > _EPS for e in self.eta))

    def _tensor(self, a):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=default_dtype(), device=self.device)

    def colvar_model(self) -> ColvarModel:
        """CV model: the preprocessing layer followed by the encoder."""
        return ColvarModel(self.preprocessing_layer, self.model.encoder)

    def reg_model(self) -> ColvarModel:
        """The preprocessing layer followed by the heads on the latent
        space, in the order of the last training ``cvec``."""
        if self._cvec is None:
            self._cvec = np.arange(self.num_reg)
        return ColvarModel(self.preprocessing_layer,
                           RegModel(self.model, self._cvec))

    # ------------------------------------------------------------------
    # the per-term losses of the reference, on raw (or precomputed) batches
    def weighted_MSE_loss(self, X, X_lagged, weight):
        """Time-lagged reconstruction loss."""
        return weighted_mse_lagged_loss(
            self.model.forward_ae, self._pp_for_loss, self._tensor(X),
            self._tensor(X_lagged), self._tensor(weight))

    def reg_enc_grad_loss(self, X, weight):
        """Squared norm of the encoder's gradients by the features."""
        return enc_grad_loss(self.model.encoder, self._pp_for_loss,
                             self._tensor(X), self._tensor(weight), self.k)

    def reg_enc_norm_loss(self, X, weight):
        """Penalty on the encoder's output variances."""
        return enc_norm_loss(self.model.encoder, self._pp_for_loss,
                             self._tensor(X), self._tensor(weight), self.k)

    def reg_enc_orthognal_loss(self, X, weight):
        """Penalty on the encoder's pairwise output covariances (the
        reference's spelling)."""
        return enc_orthogonality_loss(
            self.model.encoder, self._pp_for_loss, self._tensor(X),
            self._tensor(weight), self.k)

    def reg_eigen_loss(self, X, weight, X_lagged, weight_lagged):
        """Eigenfunction regularizer on the heads: ``(eig_vals,
        non_penalty, penalty, cvec)``."""
        return reg_eigen_loss(
            self.model, self._pp_for_loss, self._tensor(X),
            self._tensor(weight), self._tensor(X_lagged),
            self._tensor(weight_lagged), num_reg=self.num_reg,
            eig_w=self._eig_w, beta=self._beta, diag_coeff=self._diag_coeff,
            lag_idx=self.lag_idx, traj_dt=self.traj_dt)

    # ------------------------------------------------------------------
    def _prepare(self):
        """``(train, test, train_b, test_b, rows)``: per batch ``(X, X_ae,
        X_l, w, w_l)`` with ``X_ae`` (``X`` lagged by ``lag_tau_ae``) only
        for a lagged reconstruction and ``X_l``, ``w_l`` only for the
        transfer regularizer (None otherwise), or on the Gram path ``(H,
        H_ae, M, w)`` of features; ``rows`` [nb_train + nb_test,
        7 + 2K], the cvec in the last K columns
        (``regautoencoder.py:704-855``)."""
        train_idx, test_idx = self._lagged_split(max(self.lag_idx,
                                                     self.lag_ae_idx))
        train_b, test_b = self._rank_batches(
            self._make_batches(train_idx, self.batch_size),
            self._make_batches(test_idx, self.batch_size))
        self._resolve_gram(train_b, test_b)
        rows = self._metric_rows(len(train_b) + len(test_b),
                                 len(self.loss_names) + self.num_reg)
        if self._streaming:
            return None, None, train_b, test_b, rows
        ae_on, eig_on, _ = self._gates()
        ae_lag = ae_on and self.lag_ae_idx > 0
        eig_lag = eig_on and self.lag_idx > 0
        pp = self._pp_for_loss

        def pack(rows):
            out = []
            for row in rows:
                i = torch.as_tensor(row, device=self.device)
                X, w = self._traj[i], self._weights[i]
                X_ae = self._traj[i + self.lag_ae_idx] if ae_lag else None
                if self._gram:
                    H, M = gram_batch(pp, X, self._diag_coeff, self._d_r)
                    if X_ae is not None:
                        with torch.no_grad():
                            X_ae = pp(X_ae).reshape(H.shape)
                    out.append((H, X_ae, M, w))
                elif eig_lag:
                    il = i + self.lag_idx
                    X_l = (X_ae if X_ae is not None
                           and self.lag_idx == self.lag_ae_idx
                           else self._traj[il])
                    out.append((X, X_ae, X_l, w, self._weights[il]))
                else:
                    out.append((X, X_ae, None, w, None))
            return out

        return pack(train_b), pack(test_b), train_b, test_b, rows

    def _stream_pack(self, rows):
        """``(X, X_ae, X_l, w, w_l)`` of the frames ``rows`` as host
        gathers, None for an unused piece, the indices sorted for a memmap
        (JAX ``regautoencoder.py:857-887``). With equal lags ``X_l`` is the
        gather of ``X_ae``: one copy, one tensor, one pass of the layer."""
        ae_on, eig_on, _ = self._gates()
        i = np.asarray(rows, dtype=np.int64)
        if self._sorted_gather(self._traj_np):
            i = np.sort(i)
        traj, wts = self._traj_np, self._weights_np
        X_ae = ((traj, i + self.lag_ae_idx)
                if ae_on and self.lag_ae_idx > 0 else None)
        X_l = w_l = None
        if eig_on and self.lag_idx > 0:
            il = i + self.lag_idx
            X_l = (X_ae if X_ae is not None and self.lag_idx == self.lag_ae_idx
                   else (traj, il))
            w_l = (wts, il)
        return (traj, i), X_ae, X_l, (wts, i), w_l

    def _graph_static(self):
        return ((self.alpha, tuple(self.gamma), tuple(self.eta),
                 tuple(self._eig_w), self._beta, self.lag_ae_idx,
                 self.lag_idx, self.traj_dt, self.freeze_encoder, self._gram),
                (self.model, self._pp_for_loss, self._diag_coeff))

    def _chunk_fetched(self, train_cm):
        # cvec of the last train batch of the chunk's last epoch
        self._cvec = train_cm[-1, -1, len(self.loss_names):].astype(int)

    def _before_step(self):
        if self.freeze_encoder:
            torch._foreach_zero_([p.grad for p in
                                  self.model.encoder.parameters()])

    def _plot(self, epoch: int) -> None:
        self.plot_class.plot(self.colvar_model(), self.reg_model(),
                             epoch=epoch)

    # ------------------------------------------------------------------
    # replica sweeps
    def _static_config(self):
        return super()._static_config() + (
            self.k, self.num_reg, self._gates(), self.lag_ae_idx,
            self.lag_idx, self.traj_dt, self.freeze_encoder, self._gram,
            self.precompute_features)

    def _hyper(self):
        return {"alpha": self._hyper_tensor(self.alpha),
                "gamma": self._hyper_tensor(self.gamma),
                "eta": self._hyper_tensor(self.eta),
                "eig_weights": self._hyper_tensor(self._eig_w),
                "beta": self._hyper_tensor(self._beta)}

    def _frozen_prefix(self):
        return "encoder." if self.freeze_encoder else None

    def _replica_inputs(self, batch):
        """``(Y, Y_ae, Y_l, M, w, w_l)``: the features of the batch, of
        its frames lagged for the reconstruction and for the transfer
        regularizer (None where unused), and the Gram matrices of the
        generator regularizer (on its vjp path computed here, per step)."""
        if self._gram:
            H, H_ae, M, w = batch
            return H, H_ae, None, M, w, None
        X, X_ae, X_l, w, w_l = batch
        ae_on, eig_on, eta_on = self._gates()
        pp = self._pp_for_loss
        with torch.no_grad():
            M = None
            if eig_on and self.lag_idx == 0:
                Y, M = gram_batch(pp, X, self._diag_coeff,
                                  self.model.encoder.layer_dims[0])
            else:
                Y = pp(X)
            Y_ae = None if X_ae is None else pp(X_ae)
            Y_l = None
            if X_l is not None:
                Y_l = Y_ae if X_l is X_ae else pp(X_l)
        return Y, Y_ae, Y_l, M, w, w_l

    def _replica_loss(self, model, hyper, Y, Y_ae, Y_l, M, w, w_l):
        ae_on, eig_on, eta_on = self._gates()
        k, ident = self.k, _IDENTITY
        zero = w.new_zeros(())
        ae = e0 = e1 = e2 = g0 = g1 = zero
        if ae_on:
            ae = weighted_mse_lagged_loss(model.forward_ae, ident, Y,
                                          Y if Y_ae is None else Y_ae, w)
        if eta_on[0]:
            e0 = enc_grad_loss(model.encoder, ident, Y, w, k,
                               jac=input_jacobian)
        if eta_on[1]:
            e1 = enc_norm_loss(model.encoder, ident, Y, w, k)
        if eta_on[2]:
            e2 = enc_orthogonality_loss(model.encoder, ident, Y, w, k)
        if eig_on:
            common = dict(num_reg=self.num_reg, eig_w=hyper["eig_weights"],
                          beta=hyper["beta"], lag_idx=self.lag_idx,
                          traj_dt=self.traj_dt, diag_coeff=None,
                          jac=input_jacobian)
            if M is not None:
                out = reg_eigen_loss(model, None, Y, w, None, None,
                                     pp_gram=M, **common)
            else:
                out = reg_eigen_loss(model, ident, Y, w, Y_l, w_l, **common)
            eig_vals, g0, g1, cvec = out
        else:
            eig_vals = w.new_zeros(self.num_reg)
            cvec = torch.arange(self.num_reg, device=w.device)
        gamma, eta = hyper["gamma"], hyper["eta"]
        loss = (hyper["alpha"] * ae + gamma[0] * g0 + gamma[1] * g1
                + eta[0] * e0 + eta[1] * e1 + eta[2] * e2)
        return loss, torch.cat([
            torch.stack([loss, ae, g0, g1]).detach(),
            eig_vals,
            torch.stack([e0, e1, e2]).detach(),
            cvec.to(loss.dtype),
        ])

    def _batch_metrics(self, *batch):
        """Loss and the metric row [loss, ae, g0, g1, eig_vals, e0, e1, e2,
        cvec] of one batch (``regautoencoder.py:68-140``)."""
        ae_on, eig_on, eta_on = self._gates()
        model, k, ident, gather = self.model, self.k, _IDENTITY, self._gather
        if self._gram:
            X, Y_ae, M, w = batch
            Y = X
        else:
            X, X_ae, X_l, w, w_l = batch
            # the features of X for every term that reads them; the
            # generator's vjp path takes its own pass for its input
            # gradients
            pp = self._pp_for_loss
            reads_y = ae_on or any(eta_on) or (eig_on and self.lag_idx > 0)
            Y = pp(X) if reads_y else None
            Y_ae = None if X_ae is None else pp(X_ae)
        zero = w.new_zeros(())
        ae = e0 = e1 = e2 = g0 = g1 = zero
        if ae_on:
            ae = weighted_mse_lagged_loss(model.forward_ae, ident, Y,
                                          Y if Y_ae is None else Y_ae, w,
                                          gather=gather)
        if eta_on[0]:
            e0 = enc_grad_loss(model.encoder, ident, Y, w, k, gather=gather)
        if eta_on[1]:
            e1 = enc_norm_loss(model.encoder, ident, Y, w, k, gather=gather)
        if eta_on[2]:
            e2 = enc_orthogonality_loss(model.encoder, ident, Y, w, k,
                                        gather=gather)
        if eig_on:
            # the head weights as fills of Python floats, which a captured
            # step bakes in as the graph key's values do (a copy from the
            # host cannot be captured)
            eig_w = torch.stack([w.new_full((), float(v))
                                 for v in self._eig_w])
            common = dict(num_reg=self.num_reg, eig_w=eig_w,
                          beta=self._beta, lag_idx=self.lag_idx,
                          traj_dt=self.traj_dt, gather=gather)
            if self._gram:
                out = reg_eigen_loss(model, None, Y, w, None, None,
                                     diag_coeff=None, pp_gram=M, **common)
            elif self.lag_idx == 0:
                out = reg_eigen_loss(model, self._pp_for_loss, X, w, None,
                                     None, diag_coeff=self._diag_coeff,
                                     **common)
            else:
                Y_l = Y_ae if X_l is X_ae else self._pp_for_loss(X_l)
                out = reg_eigen_loss(model, ident, Y, w, Y_l, w_l,
                                     diag_coeff=None, **common)
            eig_vals, g0, g1, cvec = out
        else:
            eig_vals = w.new_zeros(self.num_reg)
            cvec = torch.arange(self.num_reg, device=w.device)
        gamma, eta = self.gamma, self.eta
        loss = (self.alpha * ae + gamma[0] * g0 + gamma[1] * g1
                + eta[0] * e0 + eta[1] * e1 + eta[2] * e2)
        metrics = torch.cat([
            torch.stack([loss, ae, g0, g1]).detach(),
            eig_vals,
            torch.stack([e0, e1, e2]).detach(),
            cvec.to(loss.dtype),
        ])
        return loss, metrics
