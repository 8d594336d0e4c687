r"""Autoencoder training task (port of ``colvarsfinder_tpu/core/autoencoder.py``).

The preprocessing layer runs once, at construction, over the whole
trajectory (``colvarsfinder_tpu/core/autoencoder.py:221-240``): on the card
with ``FusedAlignmentLayer`` that is one K2 launch over every frame, and
each training step then runs on features only. An identity layer keeps the
trajectory itself. The batches are gathered onto the device once, and an
epoch is one call of :meth:`.task.TrainingTask._epoch_body`, captured as a
CUDA graph on the card, as in :class:`.eigenfunction.EigenFunctionTask`.
The JAX package's streaming layout is not ported (ROADMAP.md queue 1,
item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype
from ..export import ColvarModel
from ..models.ae import AutoEncoder
from ..ops.features import Identity, as_pp_layer
from .losses import weighted_mse_loss
from .task import TrainingTask

__all__ = ["AutoEncoderTask"]


class AutoEncoderTask(TrainingTask):
    r"""Train an autoencoder with the weighted reconstruction loss
    :func:`.losses.weighted_mse_loss` on the features of the trajectory.

    Arguments are those of the JAX ``AutoEncoderTask``; the number of CVs
    is the encoder's output dim.

    Attributes:
        train_loss / test_loss: per-epoch mean loss [epochs, 1] (column
            ``loss``)
        train_loss_df / test_loss_df: the same as pandas DataFrames
    """

    def __init__(
        self,
        traj_obj,
        pp_layer,
        model,
        model_path,
        learning_rate: float = 0.01,
        load_model_filename=None,
        save_model_every_step: int = 10,
        batch_size: int = 1000,
        num_epochs: int = 10,
        test_ratio: float = 0.2,
        optimizer_name: str = "Adam",
        device=None,
        plot_class=None,
        plot_frequency: int = 0,
        verbose: bool = True,
        debug_mode: bool = True,
        **kwargs,
    ):
        if not isinstance(model, AutoEncoder):
            raise TypeError("model must be an object of the class AutoEncoder")
        super().__init__(
            traj_obj, as_pp_layer(pp_layer), model, model_path,
            learning_rate, load_model_filename, save_model_every_step,
            model.encoded_dim, batch_size, num_epochs, test_ratio,
            optimizer_name, device, plot_class, plot_frequency, verbose,
            debug_mode, **kwargs,
        )
        self.loss_names = ["loss"]
        self.init_model_and_optimizer()

        dt = default_dtype()
        traj = torch.as_tensor(np.asarray(traj_obj.trajectory), dtype=dt)
        traj = traj.to(self.device)
        if isinstance(self.preprocessing_layer, Identity):
            self._feature_traj = traj
        else:
            with torch.no_grad():
                self._feature_traj = self.preprocessing_layer(traj)
        self._weights = torch.as_tensor(
            np.asarray(traj_obj.weights), dtype=dt).to(self.device)
        if self.verbose:
            print("\nShape of trajectory data array:\n "
                  f"{tuple(self._feature_traj.shape)}", flush=True)

    # ------------------------------------------------------------------
    def colvar_model(self) -> ColvarModel:
        """CV model: the preprocessing layer followed by the encoder."""
        return ColvarModel(self.preprocessing_layer, self.model.encoder)

    def reg_model(self):
        """None: the task has no regularizer model."""
        return None

    def weighted_MSE_loss(self, X, weight):
        """Reconstruction loss of the current model on a feature batch."""
        dt = default_dtype()
        return weighted_mse_loss(
            self.model,
            torch.as_tensor(np.asarray(X), dtype=dt, device=self.device),
            torch.as_tensor(np.asarray(weight), dtype=dt, device=self.device),
        )

    # ------------------------------------------------------------------
    def _prepare_data(self):
        """``(train, test, train_b, test_b, rows)`` with ``(X, w)`` per
        batch, ``X`` the batch's features; the batches are positions within
        the split (``autoencoder.py:288-300``); ``rows`` [nb_train +
        nb_test, 1]."""
        if self._prepared is not None:
            return self._prepared
        train_idx, test_idx = self._make_split(self._feature_traj.shape[0])
        train_b = train_idx[self._make_batches(np.arange(len(train_idx)),
                                               self.batch_size)]
        test_b = test_idx[self._make_batches(np.arange(len(test_idx)),
                                             self.batch_size)]

        def pack(rows):
            out = []
            for row in rows:
                i = torch.as_tensor(row, device=self.device)
                out.append((self._feature_traj[i], self._weights[i]))
            return out

        rows = self._metric_rows(len(train_b) + len(test_b), 1)
        self._prepared = (pack(train_b), pack(test_b), train_b, test_b, rows)
        return self._prepared

    def _graph_static(self):
        return (), (self.model,)

    def _batch_metrics(self, X, w):
        """Loss and the metric row [loss] of one batch."""
        loss = weighted_mse_loss(self.model, X, w)
        return loss, loss.detach()[None]
