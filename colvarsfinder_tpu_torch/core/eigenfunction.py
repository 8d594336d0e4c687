r"""Eigenfunction training task, transfer operator (port of
``colvarsfinder_tpu/core/eigenfunction.py``).

The transfer-operator loss (``lag_tau > 0``) is trained with Adam or SGD
over drop-last batches of lagged pairs ``(x_i, x_{i+lag})``. Two step
implementations, as in the JAX package:

* default: plain PyTorch through :func:`.losses.eigen_loss`;
* ``fused_step=True``: the loss forward and the parameter backward run as
  CUDA kernels K3/K4 (:mod:`..ops.fused_eigen`) on the card, and as their
  plain version on the CPU.

The batches are gathered onto the device once before the loop. Per-step
metrics stay on the device and reach the host once per chunk of epochs
(the epochs up to the next checkpoint, plot or progress event). The
generator loss (``lag_tau == 0``) is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import default_dtype
from ..export import ColvarModel
from ..models.eigen import EigenFunctions
from ..ops.features import Identity, as_pp_layer
from ..ops.fused_eigen import (
    eigen_loss_from_stats,
    fused_tile,
    params_t_of,
    transfer_stats,
)
from .losses import eigen_loss
from .task import TrainingTask

__all__ = ["EigenFunctionTask"]


class EigenFunctionTask(TrainingTask):
    r"""Learn eigenfunctions of the transfer operator (``lag_tau > 0``).

    Arguments are those of the JAX ``EigenFunctionTask``; ``diag_coeff``
    and ``beta`` belong to the generator loss and are accepted but unused.
    ``fused_step=True`` runs each step through the fused stats kernels; it
    needs the 'tanh' activation, float32 and a model whose kernel blocks fit
    in shared memory (:func:`..ops.fused_eigen.fused_tile`).

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
        if int(round(lag_idx)) == 0:
            raise NotImplementedError(
                "the generator loss (lag_tau == 0) is not ported yet: "
                "ROADMAP.md queue 1, item 8"
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
        self.lag_idx = int(round(lag_idx))
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
            fused_tile(model.layer_dims, self.k)  # raises if too large

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

    # ------------------------------------------------------------------
    def _prepare_data(self):
        """Batches gathered onto the device once: per batch
        ``(X, X_l, w, w_l)``."""
        cached = getattr(self, "_prepared", None)
        if cached is not None:
            return cached
        train_idx, test_idx = self._lagged_split(self.lag_idx)
        train_b = self._make_batches(train_idx, self.batch_size)
        test_b = self._make_batches(test_idx, self.batch_size)

        def pack(rows):
            out = []
            for row in rows:
                i = torch.as_tensor(row, device=self.device)
                il = i + self.lag_idx
                out.append((self._traj[i], self._traj[il],
                            self._weights[i], self._weights[il]))
            return out

        self._prepared = (pack(train_b), pack(test_b), train_b, test_b)
        return self._prepared

    def _batch_metrics(self, X, X_l, w, w_l):
        """Loss and the metric row [loss, non_penalty, penalty, eig_vals,
        cvec] of one batch."""
        if self.fused_step:
            F = self._pp_for_loss(X)
            F_l = self._pp_for_loss(X_l)
            F = F.reshape(F.shape[0], -1)
            F_l = F_l.reshape(F_l.shape[0], -1)
            stats = transfer_stats(params_t_of(self.model), F, F_l, w, w_l)
            loss, (eig_vals, non_pen, pen, cvec) = eigen_loss_from_stats(
                stats, k=self.k, alpha=self._alpha, eig_w=self._eig_w_t,
                lag_idx=self.lag_idx, traj_dt=self.traj_dt,
                sort_eigvals=self._sort_eigvals_in_training,
            )
        else:
            loss, aux = eigen_loss(
                self.model, self._pp_for_loss, X, w, X_l, w_l,
                k=self.k, alpha=self._alpha, eig_w=self._eig_w_t,
                lag_idx=self.lag_idx, traj_dt=self.traj_dt,
                sort_eigvals=self._sort_eigvals_in_training,
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

    def _run_epoch(self, train_data, test_data):
        train_ms = []
        for X, X_l, w, w_l in train_data:
            loss, metrics = self._batch_metrics(X, X_l, w, w_l)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            train_ms.append(metrics)
        # test batches after the epoch's training (JAX eigenfunction.py:253)
        with torch.no_grad():
            test_ms = [self._batch_metrics(*batch)[1] for batch in test_data]
        return torch.stack(train_ms), torch.stack(test_ms)

    def train(self):
        """Train the model; fills :attr:`train_loss` / :attr:`test_loss`."""
        train_data, test_data, train_b, test_b = self._prepare_data()
        self._print_train_banner(train_b, test_b)
        n_metrics = len(self.loss_names)
        train_means, test_means = [], []
        self.loss_list = []
        self.epoch_times = []
        min_loss = float("inf")
        self.model.train()

        epoch = 0
        while epoch < self.num_epochs:
            chunk = self._next_chunk(epoch)
            t0 = time.perf_counter()
            chunk_tr, chunk_te = [], []
            for _ in range(chunk):
                tr, te = self._run_epoch(train_data, test_data)
                chunk_tr.append(tr)
                chunk_te.append(te)
            # one device->host fetch per chunk
            train_cm = torch.stack(chunk_tr).cpu().numpy()
            test_cm = torch.stack(chunk_te).cpu().numpy()
            chunk_time = (time.perf_counter() - t0) / chunk
            # cvec of the last train batch of the chunk's last epoch
            self._cvec = train_cm[-1, -1, n_metrics:].astype(int)

            for j in range(chunk):
                train_m = train_cm[j, :, :n_metrics]
                test_m = test_cm[j, :, :n_metrics]
                self.loss_list.append([train_m, test_m])
                train_means.append(train_m.mean(axis=0))
                test_means.append(test_m.mean(axis=0))
                self.writer.add_scalars_split(
                    self.loss_names, train_means[-1], test_means[-1],
                    epoch + j,
                )
                self.epoch_times.append(chunk_time)
            epoch += chunk
            e = epoch - 1
            self._print_progress(epoch, float(train_means[-1][0]), chunk_time)

            if (self.save_model_every_step > 0
                    and e % self.save_model_every_step
                    == self.save_model_every_step - 1):
                self.save_model(e)
                last_loss = float(train_cm[-1, -1, 0])
                if last_loss < min_loss:  # reference quirk: last-batch loss
                    min_loss = last_loss
                    self.save_model(e, "best")

            if (self.plot_frequency > 0
                    and e % self.plot_frequency == self.plot_frequency - 1
                    and self.plot_class is not None):
                self.plot_class.plot(self.colvar_model(), epoch=e)

        shape = (0, n_metrics)
        self.train_loss = np.stack(train_means) if train_means else np.zeros(shape)
        self.test_loss = np.stack(test_means) if test_means else np.zeros(shape)

    @property
    def train_loss_df(self):
        from ..logging_utils import losses_to_dataframe

        return losses_to_dataframe(list(self.train_loss), self.loss_names)

    @property
    def test_loss_df(self):
        from ..logging_utils import losses_to_dataframe

        return losses_to_dataframe(list(self.test_loss), self.loss_names)
