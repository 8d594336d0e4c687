r"""Training task base class (port of ``colvarsfinder_tpu/core/task.py``).

The JAX package runs all epochs between two host-side events as one
compiled program (``TrainingTask.compile_multi_epoch``, a ``lax.scan`` of
the epoch body under ``jit``). The port's counterpart is one captured CUDA
graph per epoch: the batches are gathered onto the device once, at fixed
addresses, and the epoch body writes its metric rows into a buffer
allocated once. On the card the first epoch of a ``train()`` call that has
no valid graph runs eagerly on the capture stream (it initialises Adam's
state, the cuBLAS handles and the kernel libraries), the capture follows,
and every later epoch is a replay (:meth:`TrainingTask._run_epoch`). A
chunk of epochs (those up to the next checkpoint, plot or progress event)
replays the graph once per epoch and copies the metric rows after each
replay; the host fetches them once per chunk, where the JAX package does
(``core/eigenfunction.py:942``). On the CPU the same epoch body runs
eagerly.

Not ported yet: streaming, the device mesh, ``shard_trajectory``, the
``unroll``/``prebatch`` switches and the compiled CV programs of
``export_cv=True`` (ROADMAP.md queue 1, items 12, 13 and 15).
"""

from __future__ import annotations

import math
import os
import time
import warnings
from abc import ABC, abstractmethod
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import checkpoint
from ..config import default_dtype, matmul_precision, resolve_device
from ..export import export_colvar
from ..logging_utils import MetricsWriter, profile_trace
from ..ops import _cuda
from ..ops.features import Identity

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


class CapturedEpoch(NamedTuple):
    """One training epoch captured as a CUDA graph.

    ``key`` is :meth:`TrainingTask._graph_key` at capture; ``held`` keeps
    alive every object whose ``id`` is in it, so no other object can take
    that ``id`` while the graph lives. ``launches`` counts the kernel
    launches the graph holds (:func:`..ops._cuda.capture_launches`)."""

    graph: object
    launches: dict
    key: tuple
    held: list


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
        export_cv: also write the JAX package's compiled CV programs; not
            ported yet, True raises. With False, ``save_model`` writes the
            same CV artifacts as the JAX package's with False
            (:func:`..export.export_colvar`)
        tensorboard: log scalars when tensorboardX is installed
        profile_dir: if set, wrap ``train()`` in a ``torch.profiler`` trace
            written to this directory (:func:`..logging_utils.profile_trace`)
        progress_interval: print progress at least every N epochs
    """

    #: the prepared batches (:meth:`_prepare_data`) and the captured epoch
    _prepared = None
    _graph: Optional[CapturedEpoch] = None
    #: run every epoch eagerly on the card too; nothing in the package sets
    #: it (a test compares a captured run with an eager one through it)
    _eager_on_card = False
    #: the Gram path stores one [B, d_r, d_r] tensor per batch; above this
    #: total it falls back to the vjp path (the JAX package's limit)
    GRAM_AUTO_LIMIT_BYTES = 4 << 30

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
        profile_dir: Optional[str] = None,
        progress_interval: int = 0,
    ):
        if export_cv:
            raise NotImplementedError(
                "the compiled CV programs of export_cv=True are not ported "
                "yet: ROADMAP.md queue 1, item 12"
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
        self.profile_dir = profile_dir
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
        self._drop_graph()
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
            self.optimizer_name, self.model.parameters(), self.learning_rate,
            capturable=self.device.type == "cuda",
        )

    @staticmethod
    def make_optimizer(name: str, params, learning_rate: float,
                       capturable: bool = False):
        """Adam with betas (0.9, 0.999) and eps 1e-8 (optax's and torch's
        defaults; ``colvarsfinder_tpu/core/task.py:304-316``), or SGD.
        ``capturable=True`` (the card) keeps Adam's step count on the device
        and computes its bias correction there, as optax does, so that a
        CUDA graph can hold the step."""
        if name.lower() == "adam":
            return torch.optim.Adam(
                params, lr=float(learning_rate), betas=(0.9, 0.999), eps=1e-8,
                capturable=capturable,
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
    # the Dirichlet form of the generator and the committor
    def _diag_coeff_tensor(self, diag_coeff) -> torch.Tensor:
        """The diffusion diagonal over the flattened state dims (default
        ones) on the device (``colvarsfinder_tpu/core/eigenfunction.py:
        556-568``)."""
        tot_dim = int(np.prod(np.shape(self.traj_obj.trajectory)[1:]))
        if diag_coeff is None:
            return torch.ones(tot_dim, dtype=default_dtype(),
                              device=self.device)
        dc = torch.as_tensor(np.asarray(diag_coeff), dtype=default_dtype())
        dc = dc.reshape(-1)
        if dc.shape[0] != tot_dim:
            raise ValueError(
                f"diag_coeff should be a 1d tensor of length {tot_dim}, "
                f"current shape: {tuple(dc.shape)}"
            )
        return dc.to(self.device)

    def _resolve_gram_request(self, gram_pp, applicable: bool) -> None:
        """The Gram path is requested by ``gram_pp``, or by default where it
        applies and the preprocessing layer is not the identity; the width
        of the features it needs is taken from one frame here."""
        self._gram_explicit = gram_pp is not None
        if gram_pp is None:
            gram_pp = applicable and not isinstance(self._pp_for_loss,
                                                    Identity)
        self._gram_requested = bool(gram_pp)
        self._gram = False  # resolved with the batches (_resolve_gram)
        if self._gram_requested:
            with torch.no_grad():
                feats = self._pp_for_loss(self._traj[:1])
            self._d_r = feats.reshape(1, -1).shape[1]

    def _resolve_gram(self, train_b, test_b) -> None:
        """Take the Gram path where requested and its [B, d_r, d_r] tensors
        fit in ``GRAM_AUTO_LIMIT_BYTES``; warn where an explicit
        ``gram_pp=True`` cannot be honoured
        (``colvarsfinder_tpu/core/eigenfunction.py:744-760, 857-865``)."""
        self._gram = self._gram_requested
        if self._gram:
            n_rows = train_b.size + test_b.size
            m_bytes = n_rows * self._d_r**2 * self._traj.element_size()
            if m_bytes > self.GRAM_AUTO_LIMIT_BYTES:
                self._gram = False
                if self.verbose:
                    print(f"gram_pp: per-batch Gram tensors would need "
                          f"{m_bytes / 2**30:.1f} GiB; falling back to the "
                          "vjp path", flush=True)
        if self._gram_requested and self._gram_explicit and not self._gram:
            warnings.warn(
                "gram_pp=True could not be honored (the Gram tensors exceed "
                "GRAM_AUTO_LIMIT_BYTES); training uses the vjp path"
            )

    # ------------------------------------------------------------------
    # the captured epoch (the counterpart of the JAX compile cache)
    def _graph_static(self):
        """``(values, objects)`` a captured epoch depends on beyond the
        prepared data and the optimizer: values it bakes in, and objects
        it reads by address. Tasks override it."""
        return (), ()

    def _graph_key(self):
        """``(key, held)``: what a captured epoch is valid for, as the JAX
        key ``(length, numerics_key(), lr) + static`` is
        (``colvarsfinder_tpu/core/eigenfunction.py:197``). Values compare
        by value: the optimizer's hyperparameters (lr among them), the
        matmul precision, the default dtype and the task's own
        (:meth:`_graph_static`). Objects compare by identity: the prepared
        data, the optimizer, its parameters and state tensors and the
        task's own; ``held`` holds them for the graph."""
        values, objects = self._graph_static()
        opt = self.optimizer
        held = [self._prepared, opt, *objects]
        held += [p for g in opt.param_groups for p in g["params"]]
        held += [t for state in opt.state.values() for t in state.values()
                 if torch.is_tensor(t)]
        hyper = tuple((k, repr(v)) for g in opt.param_groups
                      for k, v in sorted(g.items()) if k != "params")
        key = (hyper, matmul_precision(), default_dtype(), *values,
               tuple(map(id, held)))
        return key, held

    def _drop_graph(self) -> None:
        """Forget the captured epoch. Its memory pool is freed with the
        graph and the gradients the graph left on the parameters."""
        if self._graph is not None:
            self._graph = None
            self.model.zero_grad(set_to_none=True)

    def _check_graph(self) -> None:
        """Drop the captured epoch if anything it depends on has changed."""
        if self._graph is not None and self._graph.key != self._graph_key()[0]:
            self._drop_graph()

    def _run_epoch(self, body) -> None:
        """One epoch of ``body()``. The CPU runs it eagerly. The card
        replays its captured graph; without one, it runs ``body()`` eagerly
        on the capture stream (a real epoch, which also initialises Adam's
        state, the cuBLAS handles and the kernel libraries) and then
        captures it. A capture that fails raises: nothing falls back to
        eager on the card."""
        if self.device.type != "cuda" or self._eager_on_card:
            body()
        elif self._graph is not None:
            _cuda.replay(self._graph.graph, self._graph.launches)
        else:
            self._graph = self._eager_then_capture(body)

    def _eager_then_capture(self, body) -> CapturedEpoch:
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()
        key, held = self._graph_key()
        graph = torch.cuda.CUDAGraph()
        try:
            with _cuda.capture_launches() as launches, \
                    torch.cuda.graph(graph, stream=stream):
                body()
        except RuntimeError as err:
            raise RuntimeError(
                "capturing the training epoch as a CUDA graph failed (a host "
                "sync or a call that capture forbids inside the step?): "
                f"{err}"
            ) from err
        current.wait_stream(stream)
        return CapturedEpoch(graph, launches, key, held)

    def release_device_data(self) -> None:
        """Drop the prepared device batches and the captured epoch with its
        memory pool (``colvarsfinder_tpu/core/task.py:943-953``); the next
        ``train()`` prepares the data and captures again."""
        self._drop_graph()
        self._prepared = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def save_model(self, epoch: int, description: str = "latest"):
        """Write ``model.pt`` (state dict), the per-CV text dumps, the CV
        deployment artifacts and ``train_state.pt`` under
        ``<model_path>/<description>`` (``colvarsfinder_tpu/core/task.py:
        867-920``). The CV artifacts are those of
        :func:`..export.export_colvar`: ``cv_params.npz``, ``cv_spec.json``
        and, where the CV has a spec, ``cv_numpy_spec.json``,
        ``cv_numpy.npz``, ``cv_native.bin`` and ``scripted_cv_cpu.pt``."""
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
        example = np.asarray(self.traj_obj.trajectory[:1], dtype=np.float32)
        export_colvar(self.colvar_model(), example, out_dir,
                      write_stablehlo=self.export_cv)
        self.save_training_state(epoch, f"{out_dir}/train_state.pt")

    def save_training_state(self, epoch: int, filename: str) -> None:
        """Checkpoint model parameters, optimizer state and epoch."""
        checkpoint.save_training_state(filename, self.model, self.optimizer,
                                       epoch)

    def load_training_state(self, filename: str) -> int:
        """Restore model and optimizer state; returns the saved epoch. The
        optimizer's state tensors are replaced, so the captured epoch is
        dropped."""
        self._drop_graph()
        epoch = checkpoint.load_training_state(filename, self.model,
                                               self.optimizer)
        if self.device.type == "cuda":
            # a state saved on the CPU carries capturable=False and host
            # step counts
            for group in self.optimizer.param_groups:
                if "capturable" in group:
                    group["capturable"] = True
            for state in self.optimizer.state.values():
                if "step" in state:
                    state["step"] = state["step"].to(self.device,
                                                     torch.float32)
        return epoch

    # ------------------------------------------------------------------
    # the epoch loop shared by the tasks
    @abstractmethod
    def _prepare_data(self):
        """Batches gathered onto the device once, and the buffer of an
        epoch's metric rows: ``(train, test, train_b, test_b, rows)``, with
        a tuple of tensors per batch for :meth:`_batch_metrics` and
        ``rows`` [nb_train + nb_test, width]. A captured epoch reads and
        writes them in place."""

    @abstractmethod
    def _batch_metrics(self, *batch):
        """``(loss, row)`` of one batch: the scalar loss and its metric row,
        whose first ``len(self.loss_names)`` entries are the metrics."""

    def _metric_rows(self, nb: int, width: int) -> torch.Tensor:
        """The buffer of one epoch's metric rows."""
        return torch.empty((nb, width), dtype=self._weights.dtype,
                           device=self.device)

    def _chunk_fetched(self, train_cm: np.ndarray) -> None:
        """Called with a chunk's train rows [chunk, nb_train, width] once
        they reach the host."""

    def _before_step(self) -> None:
        """Called in each train step between the backward and the optimizer
        step, where a task may change the gradients in place."""

    def _epoch_body(self, train_data, test_data, rows):
        """One epoch: a step per train batch (forward, ``zero_grad``,
        backward, optimizer step), then the test batches under ``no_grad``
        (JAX ``eigenfunction.py:253``; a Dirichlet loss still takes its
        input gradients there, and records nothing); every batch's metric
        row lands in ``rows``, train batches first. It syncs nothing with
        the host and reads the batches in place, so the card can capture
        it. With ``set_to_none=True`` each step's backward allocates its
        gradients (in a capture, from the graph's pool) where zeroing them
        in place would cost a memset per parameter."""
        ms = []
        for batch in train_data:
            loss, metrics = self._batch_metrics(*batch)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self._before_step()
            self.optimizer.step()
            ms.append(metrics)
        with torch.no_grad():
            ms += [self._batch_metrics(*batch)[1] for batch in test_data]
        torch.stack(ms, out=rows)

    def train(self):
        """Train the model; fills :attr:`train_loss` / :attr:`test_loss`
        (per-epoch mean metrics with columns :attr:`loss_names`)."""
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
            self._chunk_fetched(train_cm)

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
                self._plot(e)

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

    def _plot(self, epoch: int) -> None:
        """The plot callback of epoch ``epoch``."""
        self.plot_class.plot(self.colvar_model(), epoch=epoch)

    @abstractmethod
    def colvar_model(self):
        """The CV model built from the preprocessing layer and the model."""

    @abstractmethod
    def reg_model(self):
        """The regularizer model built from the preprocessing layer and the
        model, or None (``colvarsfinder_tpu/core/task.py:966-968``)."""
