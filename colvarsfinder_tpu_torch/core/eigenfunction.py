r"""Eigenfunction training task, transfer operator (port of
``colvarsfinder_tpu/core/eigenfunction.py``).

The transfer-operator loss (``lag_tau > 0``) is trained with Adam or SGD
over drop-last batches of lagged pairs ``(x_i, x_{i+lag})``. Two step
implementations, as in the JAX package:

* default: plain PyTorch through :func:`.losses.eigen_loss`;
* ``fused_step=True``: the loss forward and the parameter backward run as
  CUDA kernels K3/K4 (:mod:`..ops.fused_eigen`) on the card, and as their
  plain version on the CPU.

The batches are gathered onto the device once before the loop. An epoch is
one call of :meth:`EigenFunctionTask._epoch_body`, which the card captures
as a CUDA graph and replays (:meth:`.task.TrainingTask._run_epoch`), the
counterpart of the JAX package's ``_multi_epoch_fn`` with ``prebatch`` and
``unroll`` (``colvarsfinder_tpu/core/eigenfunction.py:193-291``). Per-step
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
from ..logging_utils import profile_trace
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

__all__ = ["EigenFunctionTask"]


class EigenFunctionTask(TrainingTask):
    r"""Learn eigenfunctions of the transfer operator (``lag_tau > 0``).

    Arguments are those of the JAX ``EigenFunctionTask``; ``diag_coeff``
    and ``beta`` belong to the generator loss and are accepted but unused.
    ``fused_step=True`` runs each step through the fused stats kernels; it
    needs the 'tanh' activation, float32 and a model whose kernel blocks fit
    in shared memory (:func:`..ops.fused_eigen.fwd_launch_shape`,
    :func:`..ops.fused_eigen.bwd_launch_shape`).

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
        """Batches gathered onto the device once, and the buffer of an
        epoch's metric rows: ``(train, test, train_b, test_b, rows)`` with
        ``(X, X_l, w, w_l)`` per batch and ``rows`` [nb_train + nb_test,
        3 + 2k]. A captured epoch reads and writes them in place."""
        if self._prepared is not None:
            return self._prepared
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

        rows = torch.empty(
            (len(train_b) + len(test_b), len(self.loss_names) + self.k),
            dtype=self._weights.dtype, device=self.device,
        )
        self._prepared = (pack(train_b), pack(test_b), train_b, test_b, rows)
        return self._prepared

    def _graph_static(self):
        return ((self.fused_step, self._sort_eigvals_in_training, self._alpha,
                 self.lag_idx, self.traj_dt),
                (self.model, self._pp_for_loss, self._eig_w_t))

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

    def _epoch_body(self, train_data, test_data, rows):
        """One epoch: a step per train batch (forward, ``zero_grad``,
        backward, optimizer step), then the test batches under ``no_grad``
        (JAX ``eigenfunction.py:253``); every batch's metric row lands in
        ``rows``, train batches first. It syncs nothing with the host and
        reads the batches in place, so the card can capture it. With
        ``set_to_none=True`` each step's backward allocates its gradients
        (in a capture, from the graph's pool) where zeroing them in place
        would cost a memset per parameter."""
        ms = []
        for X, X_l, w, w_l in train_data:
            loss, metrics = self._batch_metrics(X, X_l, w, w_l)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            ms.append(metrics)
        with torch.no_grad():
            ms += [self._batch_metrics(*batch)[1] for batch in test_data]
        torch.stack(ms, out=rows)

    def train(self):
        """Train the model; fills :attr:`train_loss` / :attr:`test_loss`."""
        with profile_trace(self.profile_dir, self.device):
            self._train()

    def _train(self):
        train_data, test_data, train_b, test_b, rows = self._prepare_data()
        self._print_train_banner(train_b, test_b)
        n_metrics = len(self.loss_names)
        nb_train = len(train_b)
        train_means, test_means = [], []
        self.loss_list = []
        self.epoch_times = []
        min_loss = float("inf")
        self.model.train()

        def body():
            self._epoch_body(train_data, test_data, rows)

        epoch = 0
        while epoch < self.num_epochs:
            chunk = self._next_chunk(epoch)
            t0 = time.perf_counter()
            self._check_graph()
            chunk_rows = torch.empty((chunk,) + rows.shape, dtype=rows.dtype,
                                     device=rows.device)
            for j in range(chunk):
                self._run_epoch(body)
                chunk_rows[j].copy_(rows)
            # one device->host fetch per chunk
            cm = chunk_rows.cpu().numpy()
            train_cm, test_cm = cm[:, :nb_train], cm[:, nb_train:]
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
