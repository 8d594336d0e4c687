r"""Autoencoder training task (port of ``colvarsfinder_tpu/core/autoencoder.py``).

The preprocessing layer runs once, at construction, over the whole
trajectory (``colvarsfinder_tpu/core/autoencoder.py:221-240``): on the card
with ``FusedAlignmentLayer`` that is one K2 launch over every frame, and
each training step then runs on features only. An identity layer keeps the
trajectory itself. The batches are gathered onto the device once, and an
epoch is one call of :meth:`.task.TrainingTask._epoch_body`, captured as a
CUDA graph on the card, as in :class:`.eigenfunction.EigenFunctionTask`.
In a replica sweep the features are those computed at construction (one
K2 launch through ``FusedAlignmentLayer``), shared by every replica; the
learning rate is the only sweepable hyperparameter.

With ``streaming=True`` the features stay on the host: an identity layer
keeps the trajectory itself (a ``np.memmap`` stays one), any other layer
runs over 65,536-frame chunks on the card into host numpy
(:meth:`.task.TrainingTask._chunked_apply`, JAX ``autoencoder.py:219-234``),
and each batch ``(X, w)`` is gathered and copied to the card as the steps
need it (:meth:`.task.TrainingTask._stream_epochs`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import default_dtype
from ..export import ColvarModel
from ..models.ae import AutoEncoder
from ..ops.features import Identity, as_pp_layer
from .losses import weighted_mse_loss
from .task import TrainingTask, numpy_dtype

__all__ = ["AutoEncoderTask"]


class AutoEncoderTask(TrainingTask):
    r"""Train an autoencoder with the weighted reconstruction loss
    :func:`.losses.weighted_mse_loss` on the features of the trajectory.

    Arguments are those of the JAX ``AutoEncoderTask``; the number of CVs
    is the encoder's output dim. ``streaming``: keep the features on the
    host and stream the batches (True), keep them on the device (False), or
    stream when they would exceed :attr:`STREAMING_AUTO_LIMIT_BYTES` (None).

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
        streaming: bool | None = None,
        **kwargs,
    ):
        if not isinstance(model, AutoEncoder):
            raise TypeError("model must be an object of the class AutoEncoder")
        if kwargs.get("shard_trajectory"):
            # as the JAX package warns (autoencoder.py:179-190)
            warnings.warn(
                "AutoEncoderTask ignores shard_trajectory: features are "
                "precomputed and gathered into batches once, and each rank "
                "of a mesh keeps its share of every batch")
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
        raw = np.asanyarray(traj_obj.trajectory)
        identity = isinstance(self.preprocessing_layer, Identity)
        # the resident layout holds one copy of the features, as wide as
        # the encoder's input (JAX takes the width from jax.eval_shape)
        d_feat = self.model.encoder.layer_dims[0]
        self._streaming = self._resolve_streaming(
            streaming, raw.shape[0] * d_feat * dt.itemsize)
        if self._streaming:
            self._feature_traj = (raw if identity else self._chunked_apply(
                self.preprocessing_layer, raw, device=self.device))
            self._weights_np = np.asarray(traj_obj.weights,
                                          dtype=numpy_dtype())
        else:
            traj = torch.as_tensor(np.asarray(raw), dtype=dt).to(self.device)
            if identity:
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
    def _prepare(self):
        """``(train, test, train_b, test_b, rows)`` with ``(X, w)`` per
        batch, ``X`` the batch's features; the batches are positions within
        the split (``autoencoder.py:288-300``); ``rows`` [nb_train +
        nb_test, 1]."""
        train_idx, test_idx = self._make_split(self._feature_traj.shape[0])
        train_b = train_idx[self._make_batches(np.arange(len(train_idx)),
                                               self.batch_size)]
        test_b = test_idx[self._make_batches(np.arange(len(test_idx)),
                                             self.batch_size)]
        train_b, test_b = self._rank_batches(train_b, test_b)
        rows = self._metric_rows(len(train_b) + len(test_b), 1)
        if self._streaming:
            return None, None, train_b, test_b, rows

        def pack(rows):
            out = []
            for row in rows:
                i = torch.as_tensor(row, device=self.device)
                out.append((self._feature_traj[i], self._weights[i]))
            return out

        return pack(train_b), pack(test_b), train_b, test_b, rows

    def _stream_pack(self, rows):
        """``(X, w)`` of the frames ``rows`` as host gathers of the
        features, the indices sorted for a memmap. The port's batches hold
        frame indices, so the JAX ``_stream_pack_train`` /
        ``_stream_pack_test`` (``autoencoder.py:354-370``) are one method
        here."""
        i = np.asarray(rows, dtype=np.int64)
        if self._sorted_gather(self._feature_traj):
            i = np.sort(i)
        return (self._feature_traj, i), (self._weights_np, i)

    def _graph_static(self):
        return (), (self.model,)

    def _replica_loss(self, model, hyper, X, w):
        loss = weighted_mse_loss(model, X, w)
        return loss, loss.detach()[None]

    def _batch_metrics(self, X, w):
        """Loss and the metric row [loss] of one batch."""
        loss = weighted_mse_loss(self.model, X, w, gather=self._gather)
        return loss, loss.detach()[None]
