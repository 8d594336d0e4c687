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

Each task also describes itself to the replica sweeps of
:mod:`..parallel.ensemble` (the counterpart of the JAX ``_plan_for``,
``colvarsfinder_tpu/parallel/ensemble.py:201-271``): what must be equal
across replicas (:meth:`TrainingTask._static_config`), its sweepable
hyperparameters as tensors (:meth:`TrainingTask._hyper`), the inputs of a
batch that all replicas share (:meth:`TrainingTask._replica_inputs`) and
the loss of one replica on them (:meth:`TrainingTask._replica_loss`).

With ``streaming=True`` (or by default above
:attr:`TrainingTask.STREAMING_AUTO_LIMIT_BYTES`) the trajectory stays in host
memory, a ``np.memmap`` included, and each batch is gathered on the host,
copied to the card and trained on as it arrives
(:meth:`TrainingTask._stream_epochs`, the pipeline of :mod:`.streaming`);
the first train step and the first test batch of a call without valid
graphs run eagerly and are captured, and every later one is a replay of its
graph.

With ``mesh=`` (:func:`..parallel.mesh.make_data_mesh`, one process per
card) every rank keeps its contiguous share of each batch, train and test,
resident or streamed; the losses gather their per-sample tensors in batch
order (:func:`..parallel.collectives.gather_rows`), so that every rank
computes the loss of the whole batch, and each train step sums the
parameter gradients over the ranks once, before the optimizer step
(:func:`..parallel.collectives.all_reduce_grads`). Both collectives sit
inside the captured epoch, and at one rank the meshed run is bit for bit
the unmeshed one. Rank 0 broadcasts the model's parameters (and a drawn
seed) at construction, and only rank 0 writes checkpoints, TensorBoard
scalars, plots and progress. ``shard_trajectory`` is accepted as in the
JAX package; the port gathers the batches once, so each rank's prepared
slices already hold 1/W of them, and the two layouts coincide.

The JAX package's batch layouts, ``prebatch=`` and ``unroll_batches=``,
are accepted and validated as there (:meth:`TrainingTask._check_layout`)
and change nothing: the batches are always gathered once into the captured
epoch.
"""

from __future__ import annotations

import inspect
import math
import os
import time
import warnings
from abc import ABCMeta, abstractmethod
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import checkpoint, graphs
from ..config import default_dtype, numerics_key, resolve_device
from ..export import export_colvar
from ..logging_utils import MetricsWriter, profile_trace, span
from ..ops.features import Identity
from ..parallel.collectives import all_reduce_grads, gather_rows
from ..parallel.mesh import (
    mesh_coords,
    replicate,
    shard_batches,
    shared_seed,
)
from .streaming import GatherPool, StreamIO

__all__ = ["TrainingTask", "train_test_split"]


def numpy_dtype() -> np.dtype:
    """The numpy dtype of :func:`..config.default_dtype`."""
    return torch.empty((), dtype=default_dtype()).numpy().dtype


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


class _Traced(ABCMeta):
    """A task's whole construction, its subclass's included, is one
    ``cvf.task.init`` span."""

    def __call__(cls, *args, **kwargs):
        with span("cvf.task.init", task=cls.__name__):
            return super().__call__(*args, **kwargs)

    @property
    def __signature__(cls):
        # the constructor's, which ``inspect`` would take from __call__
        sig = inspect.signature(cls.__init__)
        return sig.replace(parameters=list(sig.parameters.values())[1:])


class TrainingTask(metaclass=_Traced):
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
        mesh: a 1-axis ``DeviceMesh`` (:func:`..parallel.mesh.make_data_mesh`)
            over which each batch is sharded, one process per rank; its
            device type must be the task's
        seed: seed of the train/test split (None draws one at construction,
            rank 0's on a mesh)
        split_indices: optional (train_idx, test_idx) overriding the split
        export_cv: also write the compiled CV programs
            (``cv_exported.bin``, ``cv_grad_exported.bin``), each traced
            once per task (:func:`..export.export_colvar`)
        tensorboard: log scalars when tensorboardX is installed
        profile_dir: if set, wrap ``train()`` in a ``torch.profiler`` trace
            written to this directory (:func:`..logging_utils.profile_trace`)
        shard_trajectory: with a mesh, the JAX package's frame-sharded
            trajectory; here the same layout as without it (see the module
            docstring), and no effect without a mesh
        progress_interval: print progress at least every N epochs

    The tasks take ``streaming=`` (True, False, or None for the size rule
    of :meth:`_resolve_streaming`). A streaming task reads these instance
    attributes when they are set, else the class defaults:

    * ``stream_prefetch`` (:attr:`STREAM_PREFETCH_DEPTH`): batches copied to
      the card ahead of the step that runs; 0 is the synchronous loop
      (gather, copy and step in turn, on the calling thread);
    * ``stream_transfer_workers`` (:attr:`STREAM_TRANSFER_WORKERS`): the
      threads that gather batches into the pinned host buffers. In the JAX
      package they issue transfers; here one copy stream carries every
      host-to-device copy, issued asynchronously by the calling thread,
      which one stream's copies saturate;
    * ``stream_inflight`` (:attr:`STREAM_INFLIGHT_STEPS`): every this many
      steps the calling thread waits for the step of as many steps earlier
      (clamped to at least 1);
    * ``stream_sorted_gather``: sort each batch's frame indices before the
      gather (default: for a ``np.memmap``, :meth:`_sorted_gather`);
    * ``stream_pack_transfers`` (:attr:`STREAM_PACK_TRANSFERS`): one host
      buffer, and one copy, per dtype and batch;
    * ``stream_wire_dtype``: None, ``'float16'`` or ``'bfloat16'``: the
      frames travel in that dtype and are upcast on the card; weights and
      masks keep the default dtype;
    * ``stream_timing``: with True, each streamed ``train()`` leaves the
      time of each stage in :attr:`stream_stats`.
    """

    #: the prepared batches (:meth:`_prepare_data`)
    _prepared = None
    #: the Gram path stores one [B, d_r, d_r] tensor per batch; above this
    #: total it falls back to the vjp path (the JAX package's limit)
    GRAM_AUTO_LIMIT_BYTES = 4 << 30

    #: above this estimate of the device-resident data, ``streaming=None``
    #: streams (the JAX package's limit, so the same inputs decide alike)
    STREAMING_AUTO_LIMIT_BYTES = 8 << 30
    #: class defaults of the instance overrides listed in the class docstring
    STREAM_PREFETCH_DEPTH = 2
    STREAM_INFLIGHT_STEPS = 32
    STREAM_TRANSFER_WORKERS = 4
    STREAM_PACK_TRANSFERS = True
    stream_timing = False
    _streaming = False

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
        mesh=None,
        seed: int | None = 0,
        split_indices=None,
        export_cv: bool = True,
        tensorboard: bool = True,
        profile_dir: Optional[str] = None,
        shard_trajectory: bool = False,
        progress_interval: int = 0,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.shard_trajectory = bool(shard_trajectory)
        self._rank, self._ranks, self._mesh_key = 0, 1, ()
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"the mesh is over '{mesh.device_type}' devices and the "
                    f"task trains on '{self.device.type}'")
            self._rank, self._ranks, group = mesh_coords(mesh)
            self._mesh_key = (self._ranks, dist.get_backend(group))
            verbose = verbose and self._rank == 0
            tensorboard = tensorboard and self._rank == 0
        self.traj_obj = traj_obj
        self.preprocessing_layer = pp_layer.to(self.device)
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.test_ratio = test_ratio
        self.k = k
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.load_model_filename = load_model_filename
        self.save_model_every_step = save_model_every_step
        self.model_path = model_path
        self.optimizer_name = optimizer_name
        self.plot_class = plot_class
        self.plot_frequency = plot_frequency
        self.verbose = verbose
        self.debug_mode = debug_mode
        # a drawn seed: on a mesh rank 0's, so every rank takes one split
        self.seed = shared_seed(seed, mesh, self.device)
        self.split_indices = split_indices
        self.export_cv = export_cv
        # the traced CV programs, kept across saves (export_colvar)
        self._export_cache: dict = {}
        self.profile_dir = profile_dir
        self.progress_interval = int(progress_interval)
        self.epoch_times: list = []
        self.model_name = type(self).__name__
        # the captured epoch ('epoch') or the streamed steps ('train',
        # 'test'), and the streaming layout's buffers (_stream_ios)
        self._graphs = graphs.Graphs(self.device, self._graph_key)
        self._stream_io = None

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

    def _rank_batches(self, train_b: np.ndarray, test_b: np.ndarray):
        """This rank's contiguous share of every train and test batch
        (:func:`..parallel.mesh.shard_batches`); without a mesh the batches
        themselves. The batch sizes are checked after :meth:`_make_batches`
        clamps them to the split: a test split smaller than ``batch_size``
        makes one batch of its own size, which must divide over the ranks
        as well (the JAX package checks ``batch_size`` alone, ``ADVICE.md``
        on ``colvarsfinder_tpu/core/task.py:474``)."""
        if self.mesh is None:
            return train_b, test_b
        for name, b in (("train", train_b), ("test", test_b)):
            if b.shape[1] % self._ranks:
                raise ValueError(
                    f"the {name} batches hold {b.shape[1]} samples "
                    f"(batch_size={self.batch_size}, clamped to the {name} "
                    f"split), which do not divide over the mesh's "
                    f"{self._ranks} ranks; choose batch_size and test_ratio "
                    f"so that every batch is a multiple of {self._ranks}")
        return shard_batches(train_b, self.mesh), shard_batches(test_b,
                                                                self.mesh)

    def _print_train_banner(self, train_b: np.ndarray, test_b: np.ndarray):
        """The split and batches of ``train()``; ``train_b`` and ``test_b``
        are this rank's shares."""
        if not self.verbose:
            return
        nb_tr, bs_tr = train_b.shape
        nb_te, bs_te = test_b.shape
        bs_tr, bs_te = bs_tr * self._ranks, bs_te * self._ranks
        on = (f"{self.device} x {self._ranks} ranks"
              if self.mesh is not None else f"{self.device}")
        print(
            f"\n=== training: {self.num_epochs} epochs on {on} ===\n"
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
        of the features it needs is taken from one frame here (not under
        streaming, which has no Gram path)."""
        self._gram_explicit = gram_pp is not None
        if gram_pp is None:
            gram_pp = applicable and not isinstance(self._pp_for_loss,
                                                    Identity)
        self._gram_requested = bool(gram_pp)
        self._gram = False  # resolved with the batches (_resolve_gram)
        if self._gram_requested and not self._streaming:
            with torch.no_grad():
                feats = self._pp_for_loss(self._traj[:1])
            self._d_r = feats.reshape(1, -1).shape[1]

    def _resolve_gram(self, train_b, test_b) -> None:
        """Take the Gram path where requested, not streaming, and its [B,
        d_r, d_r] tensors fit in ``GRAM_AUTO_LIMIT_BYTES``; warn where an
        explicit ``gram_pp=True`` cannot be honoured
        (``colvarsfinder_tpu/core/eigenfunction.py:718-724, 744-760,
        857-865``)."""
        self._gram = self._gram_requested and not self._streaming
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
                "GRAM_AUTO_LIMIT_BYTES, or streaming keeps the data on the "
                "host); training uses the vjp path"
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
        numerics (:func:`..config.numerics_key`: matmul precision, default
        dtype, compute dtype, bfloat16 style), the mesh's size and backend
        and the task's own (:meth:`_graph_static`). Objects compare by
        identity: the prepared data, the optimizer, its parameters and state
        tensors and the task's own; ``held`` holds them for the graph."""
        values, objects = self._graph_static()
        opt = self.optimizer
        held = [self._prepared, self._stream_io, opt, *objects]
        held += [p for g in opt.param_groups for p in g["params"]]
        held += [t for state in opt.state.values() for t in state.values()
                 if torch.is_tensor(t)]
        hyper = tuple((k, repr(v)) for g in opt.param_groups
                      for k, v in sorted(g.items()) if k != "params")
        key = (hyper, numerics_key(), self._mesh_key, *values,
               tuple(map(id, held)))
        return key, held

    def _drop_graph(self) -> None:
        """Forget the captured epoch (or streamed steps). Its memory pool is
        freed with the graph and the gradients the graph left on the
        parameters."""
        if self._graphs.drop():
            self.model.zero_grad(set_to_none=True)

    def _check_graph(self) -> None:
        """Drop the captured epoch (or streamed steps) if anything it
        depends on has changed."""
        if self._graphs.check():
            self.model.zero_grad(set_to_none=True)

    def _run_epoch(self, body, epoch: int) -> None:
        """Epoch ``epoch`` of ``body()``, run eagerly, replayed or captured
        (:meth:`..graphs.Graphs.run`): one ``cvf.epoch.issue`` span, with
        ``replay=True`` for a replay."""
        replay = self._graphs.mode("epoch") == "replay"
        with span("cvf.epoch.issue", epoch=epoch, replay=replay):
            self._graphs.run("epoch", body)

    def release_device_data(self) -> None:
        """Drop the prepared device batches and the captured epoch with its
        memory pool (``colvarsfinder_tpu/core/task.py:943-953``); the next
        ``train()`` prepares the data and captures again."""
        self._drop_graph()
        self._prepared = None
        self._stream_io = None
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
        ``cv_numpy.npz``, ``cv_native.bin`` and ``scripted_cv_cpu.pt``, and
        with :attr:`export_cv` the programs ``cv_exported.bin`` and
        ``cv_grad_exported.bin``. On a mesh only rank 0 writes."""
        if self._rank != 0:
            return
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
                      write_stablehlo=self.export_cv,
                      _exported_cache=self._export_cache)
        if self.verbose and self.export_cv:
            print(f"  exported CV program saved at:\n\t{out_dir}/"
                  "cv_exported.bin\n", flush=True)
        self.save_training_state(epoch, f"{out_dir}/train_state.pt")

    def save_training_state(self, epoch: int, filename: str) -> None:
        """Checkpoint model parameters, optimizer state and epoch (on a
        mesh, rank 0 only)."""
        if self._rank != 0:
            return
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
    def _prepare_data(self):
        """Batches gathered onto the device once, and the buffer of an
        epoch's metric rows: ``(train, test, train_b, test_b, rows)``, with
        a tuple of tensors per batch for :meth:`_batch_metrics` and
        ``rows`` [nb_train + nb_test, width]. A captured epoch reads and
        writes them in place. They are prepared by :meth:`_prepare`, in a
        ``cvf.task.prepare`` span, once, and kept until
        :meth:`release_device_data`."""
        if self._prepared is None:
            with span("cvf.task.prepare", task=self.model_name):
                self._prepared = self._prepare()
        return self._prepared

    @abstractmethod
    def _prepare(self):
        """What :meth:`_prepare_data` returns, prepared anew."""

    @abstractmethod
    def _batch_metrics(self, *batch):
        """``(loss, row)`` of one batch: the scalar loss and its metric row,
        whose first ``len(self.loss_names)`` entries are the metrics."""

    def _metric_rows(self, nb: int, width: int) -> torch.Tensor:
        """The buffer of one epoch's metric rows."""
        return torch.empty((nb, width), dtype=default_dtype(),
                           device=self.device)

    def _chunk_fetched(self, train_cm: np.ndarray) -> None:
        """Called with a chunk's train rows [chunk, nb_train, width] once
        they reach the host."""

    def _before_step(self) -> None:
        """Called in each train step between the backward and the optimizer
        step, where a task may change the gradients in place."""

    def _gather(self, *tensors):
        """The per-sample tensors of the whole batch from this rank's share
        of them (:func:`..parallel.collectives.gather_rows`; without a mesh
        the tensors themselves): every loss gathers where it reduces over
        the batch."""
        if self.mesh is None:
            return tensors
        return gather_rows(self.mesh, *tensors)

    def _train_step(self, batch):
        """One train step on ``batch`` (forward, ``zero_grad``, backward,
        on a mesh the sum of the gradients over the ranks, optimizer step);
        returns its metric row. With ``set_to_none=True`` the backward
        allocates the gradients (in a capture, from the graph's pool) where
        zeroing them in place would cost a memset per parameter."""
        loss, metrics = self._batch_metrics(*batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            all_reduce_grads([p for g in self.optimizer.param_groups
                              for p in g["params"]], self.mesh)
        self._before_step()
        self.optimizer.step()
        return metrics

    def _epoch_body(self, train_data, test_data, rows):
        """One epoch: a step per train batch, then the test batches under
        ``no_grad`` (JAX ``eigenfunction.py:253``; a Dirichlet loss still
        takes its input gradients there, and records nothing); every batch's
        metric row lands in ``rows``, train batches first. It syncs nothing
        with the host and reads the batches in place, so the card can
        capture it."""
        ms = [self._train_step(batch) for batch in train_data]
        with torch.no_grad():
            ms += [self._batch_metrics(*batch)[1] for batch in test_data]
        torch.stack(ms, out=rows)

    # ------------------------------------------------------------------
    # the streaming layout (colvarsfinder_tpu/core/task.py:440-851)
    def _resolve_streaming(self, streaming, device_bytes: int) -> bool:
        """Decide the layout as the JAX package does
        (``colvarsfinder_tpu/core/task.py:447-480``): an explicit
        ``streaming=`` wins; None streams when the device-resident data
        would exceed :attr:`STREAMING_AUTO_LIMIT_BYTES` and neither a mesh
        nor ``shard_trajectory`` is set. ``streaming=True`` with
        ``shard_trajectory`` raises ``ValueError`` (the JAX package
        asserts); with a mesh each rank streams its share of every batch."""
        if streaming is None:
            streaming = (device_bytes > self.STREAMING_AUTO_LIMIT_BYTES
                         and self.mesh is None and not self.shard_trajectory)
        streaming = bool(streaming)
        if streaming and self.shard_trajectory:
            raise ValueError(
                "streaming=True keeps the trajectory on the host; it cannot "
                "combine with shard_trajectory (device-resident frame "
                "sharding)")
        return streaming

    def _check_layout(self, prebatch) -> None:
        """Validate the JAX package's batch-layout switch ``prebatch=`` as
        it does (``colvarsfinder_tpu/core/eigenfunction.py:484-506``):
        ``prebatch=False`` (per-step gathers on the device) cannot stream,
        and ``prebatch=True`` cannot take a frame-sharded trajectory. The
        port always gathers the batches once into the captured epoch (or
        streams them), so ``prebatch=`` and ``unroll_batches=`` (the JAX
        epoch body's layouts, whose loss trajectories are the same,
        ``colvarsfinder_tpu/core/task.py:488-497``) change no result."""
        if self._streaming and prebatch is False:
            raise ValueError(
                "streaming=True gathers batches on the host (the prebatch "
                "tuple format); prebatch=False selects the on-device gather "
                "layout, which requires device-resident data")
        if prebatch and not self._streaming and self.shard_trajectory:
            raise ValueError(
                "prebatch=True is incompatible with shard_trajectory: the "
                "frame-sharded layout requires per-step gathers")

    @staticmethod
    def _chunked_apply(fn, arr, chunk: int = 65536, device=None) -> np.ndarray:
        """``fn`` over axis 0 of the host array ``arr`` in chunks of
        ``chunk`` rows, each cast to the default dtype and run on
        ``device`` (None: the card) under ``no_grad``; returns host numpy
        (``colvarsfinder_tpu/core/task.py:503``): the streaming layout's
        feature pass over a trajectory that stays on the host."""
        device = resolve_device(device)
        outs = []
        with torch.no_grad():
            for s in range(0, arr.shape[0], chunk):
                x = torch.from_numpy(np.array(arr[s:s + chunk],
                                              dtype=numpy_dtype()))
                outs.append(fn(x.to(device)).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _sorted_gather(self, arr) -> bool:
        """Sort a streamed batch's frame indices before the gather? The
        batch losses are weighted means, so the order within a batch is
        free (within rounding): for a ``np.memmap`` sorted indices make one
        quasi-sequential sweep of the file; an in-RAM array keeps the
        resident order, so that streaming stays bitwise equal to the
        resident layout. The ``stream_sorted_gather`` attribute overrides it
        (``colvarsfinder_tpu/core/task.py:535-555``)."""
        ov = getattr(self, "stream_sorted_gather", None)
        if ov is not None:
            return bool(ov)
        seen = 0
        while isinstance(arr, np.ndarray) and seen < 8:
            if isinstance(arr, np.memmap):
                return True
            arr = arr.base
            seen += 1
        return False

    def _stream_pack(self, rows):
        """One streamed batch of the frame indices ``rows``: its leaves,
        each None or a gather ``(host array, indices)`` (:mod:`.streaming`),
        in the order of :meth:`_batch_metrics`' arguments. Streaming tasks
        override it."""
        raise NotImplementedError(f"{type(self).__name__} does not stream")

    def _stream_config(self) -> tuple:
        """``(depth, workers, packed, wire)`` from the instance overrides
        and the class defaults."""
        depth = max(0, int(getattr(self, "stream_prefetch",
                                   self.STREAM_PREFETCH_DEPTH)))
        workers = max(1, int(getattr(self, "stream_transfer_workers",
                                     self.STREAM_TRANSFER_WORKERS)))
        packed = bool(getattr(self, "stream_pack_transfers",
                              self.STREAM_PACK_TRANSFERS))
        wire = getattr(self, "stream_wire_dtype", None)
        if wire is not None:
            name = str(wire).replace("torch.", "")
            if name not in ("float16", "bfloat16"):
                raise ValueError("stream_wire_dtype must be None, 'float16' "
                                 f"or 'bfloat16', got {wire!r}")
            if self.mesh is not None:
                # the JAX package's wire needs its packed transfers, which a
                # mesh turns off (colvarsfinder_tpu/core/task.py:636-644)
                raise ValueError("stream_wire_dtype does not combine with a "
                                 "mesh")
            wire = getattr(torch, name)
        return depth, workers if depth else 0, packed, wire

    def _stream_ios(self, train_b, test_b, width: int):
        """The :class:`.streaming.StreamIO` of the train and of the test
        batches, built for the current configuration (a changed one
        rebuilds them and drops the step graphs): host rings of ``depth +
        workers`` buffers, ``depth + 1`` device slots, one copy stream."""
        depth, workers, packed, wire = self._stream_config()
        key = (depth, workers, packed, wire, width)
        if self._stream_io is None or self._stream_io[0] != key:
            self._drop_graph()
            copy_stream = (torch.cuda.Stream(self.device)
                           if self.device.type == "cuda" else None)
            ios = tuple(
                StreamIO(self._stream_pack(b[0]), device=self.device,
                         dtype=default_dtype(), wire=wire, packed=packed,
                         n_host=depth + max(workers, 1), n_slots=depth + 1,
                         width=width, copy_stream=copy_stream)
                for b in (train_b, test_b))
            self._stream_io = (key,) + ios
        return self._stream_io[1:]

    def _stream_step(self, io, train: bool) -> None:
        """One streamed step on ``io``'s inputs, its metric row in
        ``io.row``, run eagerly, replayed or captured by its kind
        (:meth:`..graphs.Graphs.run`)."""
        def body():
            batch = io.batch()
            if train:
                io.row.copy_(self._train_step(batch))
            else:
                with torch.no_grad():
                    io.row.copy_(self._batch_metrics(*batch)[1])

        self._graphs.run("train" if train else "test", body)

    def _stream_epochs(self, chunk: int, train_b, test_b, rows):
        """Run ``chunk`` epochs with the data on the host: the counterpart
        of ``TrainingTask._stream_epochs``
        (``colvarsfinder_tpu/core/task.py:566-851``). Returns the metric
        rows [chunk, nb_train + nb_test, width] on the device, as the
        resident epochs leave them.

        A pipeline of three stages: ``stream_transfer_workers`` threads
        gather batches into a ring of (pinned) host buffers, up to ``depth +
        workers`` batches ahead; the calling thread issues each batch's copy
        into a device slot on the copy stream, ``depth`` batches ahead of
        the step, and runs the steps on the current stream, each after its
        slot's copy. A host buffer is refilled only after its copy has
        completed, and a slot only after its step has taken it in. With
        ``stream_prefetch=0`` the calling thread gathers, copies and steps
        in turn. The batch order is the resident one, so in-RAM data trains
        bit for bit as the resident layout does."""
        train_io, test_io = self._stream_ios(train_b, test_b, rows.shape[1])
        self._check_graph()
        depth, workers, _, _ = self._stream_config()
        window = max(1, int(getattr(self, "stream_inflight",
                                    self.STREAM_INFLIGHT_STEPS)))
        cuda = self.device.type == "cuda"
        nb_train, nb = len(train_b), len(train_b) + len(test_b)
        total = chunk * nb
        stats = None
        if self.stream_timing:
            stats = dict(gather_s=[], wait_gather_s=0.0, wait_host_s=0.0,
                         copy_s=0.0, step_s=0.0, h2d=[], step=[])
            t_start = time.perf_counter()

        def where(s):
            """(io, use count, frame indices) of sequence number s"""
            j, i = divmod(s, nb)
            if i < nb_train:
                return train_io, j * nb_train + i, train_b[i]
            i -= nb_train
            return test_io, j * (nb - nb_train) + i, test_b[i]

        def gather(s):
            t0 = time.perf_counter()
            io, c, r = where(s)
            io.gather(c, self._stream_pack(r))
            if stats is not None:
                stats["gather_s"].append(time.perf_counter() - t0)

        out = torch.empty((chunk,) + tuple(rows.shape), dtype=rows.dtype,
                          device=self.device)
        h2d = step_start = None
        if stats is not None and cuda:
            h2d, step_start = stats["h2d"], []
        pool = GatherPool(workers, gather) if workers else None
        inflight: deque = deque()
        issued = moved = 0
        try:
            for s in range(total):
                while issued < min(total, s + train_io.n_host):
                    io, c, _ = where(issued)
                    t0 = time.perf_counter()
                    io.wait_host(c)
                    if stats is not None:
                        stats["wait_host_s"] += time.perf_counter() - t0
                    if pool is not None:
                        pool.submit(issued)
                    else:
                        gather(issued)
                    issued += 1
                while moved < min(total, s + depth + 1):
                    if pool is not None:
                        t0 = time.perf_counter()
                        pool.wait(moved)
                        if stats is not None:
                            stats["wait_gather_s"] += time.perf_counter() - t0
                    io, c, _ = where(moved)
                    t0 = time.perf_counter()
                    io.transfer(c, h2d)
                    moved += 1
                    if stats is not None:
                        stats["copy_s"] += time.perf_counter() - t0
                io, c, _ = where(s)
                t0 = time.perf_counter()
                io.consume(c, step_start)
                t1 = time.perf_counter()
                self._stream_step(io, io is train_io)
                j, i = divmod(s, nb)
                out[j, i].copy_(io.row)
                if stats is not None:
                    t2 = time.perf_counter()
                    stats["copy_s"] += t1 - t0
                    stats["step_s"] += t2 - t1
                if step_start is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    stats["step"].append((step_start[-1], end))
                if cuda and (s + 1) % window == 0:
                    # at most ~window dispatched but unfinished steps
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append(ev)
                    if len(inflight) > 1:
                        inflight.popleft().synchronize()
        finally:
            if pool is not None:
                pool.close()
            if cuda:
                # every copy and step of this call has run before a later
                # call refills a buffer or slot (also after a failure); the
                # chunk's fetch would wait for them anyway
                torch.cuda.synchronize(self.device)
        if stats is not None:
            self._stream_summary(stats, t_start, train_io, test_io)
        return out

    def _stream_summary(self, stats, t_start, train_io, test_io) -> None:
        """Fill :attr:`stream_stats` from one :meth:`_stream_epochs` call:
        per batch the gather's host seconds (on its thread), the copy's
        device ms and bytes and the step's device ms (from its slot's
        arrival to its metric row, CUDA events; the card only); the calling
        thread's seconds waiting for gathers and for host buffers, issuing
        the copies and running the steps (a capture included); the wall
        seconds and the host buffers' bytes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stream_stats = {
            "wall_s": time.perf_counter() - t_start,
            "gather_s": np.asarray(stats["gather_s"]),
            "wait_gather_s": stats["wait_gather_s"],
            "wait_host_s": stats["wait_host_s"],
            "copy_s": stats["copy_s"],
            "step_s": stats["step_s"],
            "h2d_ms": np.asarray([a.elapsed_time(b)
                                  for a, b, _ in stats["h2d"]]),
            "h2d_bytes": np.asarray([n for _, _, n in stats["h2d"]]),
            "step_ms": np.asarray([a.elapsed_time(b)
                                   for a, b in stats["step"]]),
            "host_bytes": train_io.host_bytes + test_io.host_bytes,
        }

    # ------------------------------------------------------------------
    # what the replica sweeps need (parallel/ensemble.py)
    #: hyperparameter name -> its on/off gate, which a sweep may not
    #: toggle (the RegAE's term gates)
    _GATES: dict = {}

    def _static_config(self) -> tuple:
        """What must be equal across the replicas of one sweep or ensemble
        (valid after :meth:`_prepare_data`); tasks extend it."""
        return (type(self).__name__, self.optimizer_name.lower(),
                tuple(self.traj_obj.trajectory.shape[1:]))

    def _hyper(self) -> dict:
        """The sweepable hyperparameters, name -> tensor of the default
        dtype on the device, in the JAX order (``_EIG_HYPER_IX`` etc.,
        ``colvarsfinder_tpu/parallel/ensemble.py:490-494``)."""
        return {}

    def _hyper_tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value, dtype=np.float64),
                               dtype=default_dtype(), device=self.device)

    def _replica_inputs(self, batch) -> tuple:
        """The tensors of one prepared batch that every replica reads,
        computed once per batch outside the replica map; nothing
        differentiates through them. Tasks override it."""
        return tuple(batch)

    @abstractmethod
    def _replica_loss(self, model, hyper: dict, *inputs):
        """``(loss, row)`` of one replica on :meth:`_replica_inputs`: the
        functional counterpart of :meth:`_batch_metrics`, with ``model``
        the replica's module (its parameters bound by
        ``torch.func.functional_call``) and ``hyper`` its
        :meth:`_hyper` values."""

    def _frozen_prefix(self):
        """The parameter-name prefix whose gradients each replica step
        zeroes (:meth:`_before_step`'s counterpart), or None."""
        return None

    def train(self):
        """Train the model; fills :attr:`train_loss` / :attr:`test_loss`
        (per-epoch mean metrics with columns :attr:`loss_names`). The call
        is one ``cvf.task.train`` span; each chunk of epochs between two
        host events is a ``cvf.epoch.chunk`` span holding each epoch's
        ``cvf.epoch.issue`` and the chunk's ``cvf.epoch.fetch``, and a
        ``cvf.epoch.record`` span follows it (the host's bookkeeping:
        losses, scalars, progress, checkpoints, plots).
        :attr:`epoch_times` holds each epoch's share of its chunk span."""
        with profile_trace(self.profile_dir, self.device), \
                span("cvf.task.train", task=self.model_name):
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
            with span("cvf.epoch.chunk", epochs=chunk) as timed:
                self._check_graph()
                if self._streaming:
                    chunk_rows = self._stream_epochs(chunk, train_b, test_b,
                                                     rows)
                else:
                    chunk_rows = torch.empty((chunk,) + rows.shape,
                                             dtype=rows.dtype,
                                             device=rows.device)
                    for j in range(chunk):
                        self._run_epoch(body, epoch + j)
                        chunk_rows[j].copy_(rows)
                # one device->host fetch per chunk
                with span("cvf.epoch.fetch"):
                    cm = chunk_rows.cpu().numpy()
            chunk_time = timed.seconds / chunk
            with span("cvf.epoch.record", epochs=chunk):
                train_cm, test_cm = cm[:, :nb_train], cm[:, nb_train:]
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
                self._print_progress(epoch, float(train_means[-1][0]),
                                     chunk_time)

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
                        and self.plot_class is not None and self._rank == 0):
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
