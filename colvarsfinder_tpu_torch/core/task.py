r"""Training task base class (port of ``colvarsfinder_tpu/core/task.py``).

The JAX package runs all epochs between two host-side events as one
compiled program. The port runs eagerly on the device, with the batches
gathered onto it once before the loop; per-step metrics stay in device
tensors and reach the host once per chunk of epochs, where the JAX package
fetches them (``core/eigenfunction.py:942``).

Not ported yet: streaming, the device mesh, ``shard_trajectory``, the
compile cache, the ``unroll``/``prebatch`` switches and the CV export
(ROADMAP.md queue 1, items 12, 13 and 15).
"""

from __future__ import annotations

import math
import os
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from .. import checkpoint
from ..config import resolve_device
from ..logging_utils import MetricsWriter

__all__ = ["TrainingTask", "train_test_split"]


def train_test_split(idx: np.ndarray, test_size: float, seed: int):
    """scikit-learn's ``train_test_split(idx, test_size=r,
    random_state=seed)`` without scikit-learn: ShuffleSplit takes
    ``n_test = ceil(r * n)`` (or ``r`` itself for an int), permutes with
    ``np.random.RandomState(seed)`` and puts the first ``n_test`` of the
    permutation in the test set."""
    idx = np.asarray(idx)
    n = idx.shape[0]
    if isinstance(test_size, (int, np.integer)):
        n_test = int(test_size)
    else:
        n_test = math.ceil(float(test_size) * n)
    n_train = n - n_test
    if n_test <= 0 or n_train <= 0:
        raise ValueError(
            f"test_size={test_size} leaves an empty split of {n} samples"
        )
    perm = np.random.RandomState(seed).permutation(n)
    return idx[perm[n_test:]], idx[perm[:n_test]]


class TrainingTask(ABC):
    r"""Abstract base class of training tasks.

    Args:
        traj_obj: :class:`colvarsfinder_tpu_torch.utils.WeightedTrajectory`
        pp_layer: preprocessing ``nn.Module`` mapping raw states
            [batch, ...] -> features [batch, d_r]
        model: model ``nn.Module`` to be trained
        model_path: directory for training outputs
        learning_rate: learning rate
        load_model_filename: state dict (.pt) to warm-start from
        save_model_every_step: checkpoint every N epochs (0 disables)
        k: number of collective variables
        batch_size: minibatch size
        num_epochs: number of epochs
        test_ratio: fraction of data held out for evaluation
        optimizer_name: 'Adam' or 'SGD' (case-insensitive)
        device: where training runs; None means ``cuda``, and a request for
            ``cuda`` without a card raises
        plot_class: object with a ``plot`` callback
        plot_frequency: epochs between plot callbacks (0 disables)
        verbose: print more information
        debug_mode: additionally snapshot a state dict per save epoch
        seed: seed of the train/test split (None draws one at construction)
        split_indices: optional (train_idx, test_idx) overriding the split
        export_cv: writing CV deployment artifacts is not ported yet; True
            raises
        tensorboard: log scalars when tensorboardX is installed
        progress_interval: print progress at least every N epochs
    """

    def __init__(
        self,
        traj_obj,
        pp_layer,
        model,
        model_path: str,
        learning_rate: float,
        load_model_filename: Optional[str],
        save_model_every_step: int,
        k: int,
        batch_size: int,
        num_epochs: int,
        test_ratio: float,
        optimizer_name: str,
        device=None,
        plot_class=None,
        plot_frequency: int = 0,
        verbose: bool = True,
        debug_mode: bool = True,
        *,
        seed: int | None = 0,
        split_indices=None,
        export_cv: bool = False,
        tensorboard: bool = True,
        progress_interval: int = 0,
    ):
        if export_cv:
            raise NotImplementedError(
                "CV export is not ported yet: ROADMAP.md queue 1, item 12"
            )
        self.device = resolve_device(device)
        self.traj_obj = traj_obj
        self.preprocessing_layer = pp_layer.to(self.device)
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.test_ratio = test_ratio
        self.k = k
        self.model = model.to(self.device)
        self.load_model_filename = load_model_filename
        self.save_model_every_step = save_model_every_step
        self.model_path = model_path
        self.optimizer_name = optimizer_name
        self.plot_class = plot_class
        self.plot_frequency = plot_frequency
        self.verbose = verbose
        self.debug_mode = debug_mode
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self.seed = seed
        self.split_indices = split_indices
        self.export_cv = export_cv
        self.progress_interval = int(progress_interval)
        self.epoch_times: list = []
        self.model_name = type(self).__name__

        if self.verbose:
            print(f"\n[Info] Log directory: {self.model_path}\n", flush=True)
        self.writer = MetricsWriter(self.model_path, enabled=tensorboard)

    # ------------------------------------------------------------------
    def init_model_and_optimizer(self):
        """Load :attr:`load_model_filename` when it exists, then build the
        optimizer."""
        if self.load_model_filename:
            if os.path.isfile(self.load_model_filename):
                state = torch.load(self.load_model_filename,
                                   map_location=self.device,
                                   weights_only=True)
                self.model.load_state_dict(state)
                if self.verbose:
                    print("model parameters loaded from: "
                          f"{self.load_model_filename}")
            elif self.verbose:
                print(f"model file not found: {self.load_model_filename}")
        self.optimizer = self.make_optimizer(
            self.optimizer_name, self.model.parameters(), self.learning_rate
        )

    @staticmethod
    def make_optimizer(name: str, params, learning_rate: float):
        """Adam with betas (0.9, 0.999) and eps 1e-8 (optax's and torch's
        defaults; ``colvarsfinder_tpu/core/task.py:304-316``), or SGD."""
        if name.lower() == "adam":
            return torch.optim.Adam(
                params, lr=float(learning_rate), betas=(0.9, 0.999), eps=1e-8
            )
        if name.lower() == "sgd":
            return torch.optim.SGD(params, lr=float(learning_rate))
        raise ValueError(f"unknown optimizer '{name}' (Adam or SGD)")

    # ------------------------------------------------------------------
    def _make_split(self, n: int, candidates=None):
        """Train/test split of range(n) or of ``candidates``, or the
        injected ``split_indices``."""
        if self.split_indices is not None:
            train_idx, test_idx = self.split_indices
            return np.asarray(train_idx), np.asarray(test_idx)
        idx = np.arange(n) if candidates is None else np.asarray(candidates)
        if idx.size < 2:
            raise ValueError(
                "not enough lagged-pair start frames to split "
                f"({idx.size}); segments shorter than lag_idx+1 frames "
                "contribute no pairs"
            )
        return train_test_split(idx, self.test_ratio, self.seed)

    def _lagged_split(self, lag_idx: int):
        """Split over valid lagged-pair start frames (segment-interior
        starts for a multi-trajectory dataset)."""
        n = self.traj_obj.n_frames
        if getattr(self.traj_obj, "segment_starts", None) is None:
            return self._make_split(n - lag_idx)
        return self._make_split(
            n - lag_idx, candidates=self.traj_obj.valid_lagged_starts(lag_idx)
        )

    @staticmethod
    def _make_batches(indices: np.ndarray, batch_size: int) -> np.ndarray:
        """[num_batches, batch] index matrix, drop_last=True, no shuffle."""
        if len(indices) == 0:
            raise ValueError(
                "empty data split — check test_ratio against the dataset size"
            )
        bs = min(batch_size, len(indices))
        nb = len(indices) // bs
        return np.asarray(indices[: nb * bs], dtype=np.int64).reshape(nb, bs)

    def _print_train_banner(self, train_b: np.ndarray, test_b: np.ndarray):
        if not self.verbose:
            return
        nb_tr, bs_tr = train_b.shape
        nb_te, bs_te = test_b.shape
        print(
            f"\n=== training: {self.num_epochs} epochs on {self.device} ===\n"
            f"  train split: {nb_tr * bs_tr} samples -> {nb_tr} batches of "
            f"{bs_tr} ({nb_tr * self.num_epochs} steps total)\n"
            f"  test split:  {nb_te * bs_te} samples -> {nb_te} batches of "
            f"{bs_te}",
            flush=True,
        )

    def _next_chunk(self, epoch: int) -> int:
        """Epochs until the next host-side event (checkpoint, plot hook or
        progress report), inclusive; metrics are fetched once per chunk."""
        remaining = self.num_epochs - epoch
        chunk = remaining
        for period in (self.save_model_every_step, self.plot_frequency,
                       self.progress_interval):
            if period and period > 0:
                chunk = min(chunk, period - (epoch % period))
        return max(1, chunk)

    def _print_progress(self, epoch_done: int, train_loss: float,
                        chunk_time: float) -> None:
        if not self.verbose:
            return
        remaining = self.num_epochs - epoch_done
        eta = f", eta {remaining * chunk_time:.1f} s" if remaining else ""
        print(
            f"[{self.model_name}] epoch {epoch_done}/{self.num_epochs}  "
            f"train loss {train_loss:.6g}  "
            f"({chunk_time * 1e3:.1f} ms/epoch{eta})",
            flush=True,
        )

    # ------------------------------------------------------------------
    def save_model(self, epoch: int, description: str = "latest"):
        """Write ``model.pt`` (state dict), the per-CV text dumps and
        ``train_state.pt`` under ``<model_path>/<description>``."""
        if self.verbose:
            print(f"\n\nEpoch={epoch}:")
        if self.debug_mode:
            snap_dir = f"{self.model_path}/models"
            os.makedirs(snap_dir, exist_ok=True)
            checkpoint.save_state_dict(self.model, f"{snap_dir}/model_{epoch}.pt")
        out_dir = f"{self.model_path}/{description}"
        os.makedirs(out_dir, exist_ok=True)
        model_filename = f"{out_dir}/model.pt"
        checkpoint.save_state_dict(self.model, model_filename)
        checkpoint.save_cv_text(self.model, self.k, out_dir)
        if self.verbose:
            print(f"  trained model saved at:\n\t{model_filename}")
        self.save_training_state(epoch, f"{out_dir}/train_state.pt")

    def save_training_state(self, epoch: int, filename: str) -> None:
        """Checkpoint model parameters, optimizer state and epoch."""
        checkpoint.save_training_state(filename, self.model, self.optimizer,
                                       epoch)

    def load_training_state(self, filename: str) -> int:
        """Restore model and optimizer state; returns the saved epoch."""
        return checkpoint.load_training_state(filename, self.model,
                                              self.optimizer)

    # ------------------------------------------------------------------
    @abstractmethod
    def train(self):
        """Train the model."""

    @abstractmethod
    def colvar_model(self):
        """The CV model built from the preprocessing layer and the model."""
