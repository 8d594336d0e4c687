r"""Replica sweeps: R variants of one task trained as one program (port of
``colvarsfinder_tpu/parallel/ensemble.py``).

The JAX package stacks the R replicas' parameters, optimizer states and
hyperparameters along a leading axis and ``jax.vmap``\ s its compiled
multi-epoch program over them. Here the replicas' parameters are stacked
``[R, ...]`` and each step maps one replica's loss over them with
``torch.func.vmap`` of ``torch.func.functional_call``
(:meth:`..core.task.TrainingTask._replica_loss`); the gradients come from
one ordinary backward of the summed replica losses outside the map (the
replicas' parameters are disjoint, so each gets exactly its own gradient),
and a replica-stacked Adam or SGD (:class:`_ReplicaOptimizer`) steps them
with a learning rate per replica. Every matmul of the model is batched
R-fold. On the card each epoch is one captured CUDA graph, as a solo task's
is (:class:`..graphs.Graphs`); the metric rows, parameters and
optimizer state reach the host in one transfer per call.

What the replicas share is computed once per batch, outside the map
(:meth:`..core.task.TrainingTask._replica_inputs`): the preprocessing
layer's features, or its Gram matrices. In
:func:`train_hyperparameter_sweep` the batches are the task's own, so
``FusedAlignmentLayer`` launches K2 twice per transfer-operator step at any
R; in :func:`train_replica_ensemble` every task brings its own data and
preprocessing constants, so each replica's features are computed with its
own layer (R launches per batch input). K3 and K4 (``fused_step``) take one
model and are refused, as in the JAX package.

Usage::

    results = train_hyperparameter_sweep(
        task, {"learning_rate": [3e-3, 1e-2], "alpha": [10.0, 40.0]})
    best = int(np.argmax(sweep_vamp_scores(task, results)))
    adopt_sweep_result(task, results[best])
    task.train()  # continues from the adopted replica

With ``mesh=`` (:func:`.mesh.make_data_mesh`, one process per rank) the
replica axis is sharded over the ranks, as the JAX package's
``_shard_replica_axis`` does (``colvarsfinder_tpu/parallel/ensemble.py:
169-191``): rank r trains replicas ``[r R/W, (r+1) R/W)`` with the same
captured sweep epoch, with no collective during training, and then every
rank gathers every replica's result (metric rows, parameters, optimizer
state) in replica order. A task that itself trains on a mesh cannot be a
replica: its batches are one rank's share.

Not ported: the JAX package's relayout of wide generator sweeps
(``_maybe_relayout_for_width``): the port has one batch layout.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import inspect
import types
from collections import OrderedDict
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, vmap

from .. import config as _cfg
from ..config import default_dtype, numerics_key
from ..graphs import Graphs
from ..logging_utils import losses_to_dataframe, span
from .mesh import mesh_coords

__all__ = [
    "ExploreResult",
    "Incompatible",
    "SweepResult",
    "adopt_sweep_result",
    "explore_then_finetune",
    "last_run_seconds",
    "release_sweeps",
    "sweep_committor_checks",
    "sweep_vamp_scores",
    "train_architecture_ensemble",
    "train_hyperparameter_sweep",
    "train_replica_ensemble",
]

#: wall-clock seconds of the last sweep or ensemble call's replayed epochs
#: (all its epochs on the CPU or when run eagerly), up to and including
#: the one host fetch of its results: its ``cvf.sweep.run`` span (nan while
#: tracing is off, :func:`..logging_utils.set_tracing`)
last_run_seconds: float = 0.0

#: captured sweeps kept across calls, so that a repeated sweep, or every
#: chunk of a chunked one, replays instead of capturing again; each holds
#: its task, its prepared batches and its graph's memory pool
_SWEEPS: OrderedDict = OrderedDict()
_SWEEPS_MAX = 4


class Incompatible(ValueError):
    """Replicas that cannot run as one ensemble."""


def _rank_share(mesh, R: int) -> slice:
    """The replicas of this rank of ``mesh`` among R; raises
    :class:`Incompatible` when R does not divide over the ranks (the JAX
    package's ``_shard_replica_axis`` asserts)."""
    rank, size, _ = mesh_coords(mesh)
    if R % size:
        raise Incompatible(
            f"{R} replicas do not divide over the mesh's {size} ranks; the "
            "replica count (or chunk_size) must be a multiple of the mesh "
            "size")
    share = R // size
    return slice(rank * share, (rank + 1) * share)


def _gather_replicas(mesh, flat: torch.Tensor) -> list:
    """Every rank's ``flat`` (one buffer on the mesh's device), in rank
    order, through one all-gather."""
    _, size, group = mesh_coords(mesh)
    every = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(every, flat, group=group)
    return every


@contextlib.contextmanager
def _numerics(compute_dtype, bf16_style):
    """The compute dtype and bfloat16 style for one call, restored after
    it whatever happens."""
    prev = (_cfg.compute_dtype_name(), _cfg.bf16_style())
    try:
        if compute_dtype is not None:
            _cfg.set_compute_dtype(compute_dtype)
        if bf16_style is not None:
            _cfg.set_bf16_style(bf16_style)
        yield
    finally:
        _cfg.set_compute_dtype(prev[0])
        _cfg.set_bf16_style(prev[1])


class _Bound:
    """A module with its parameters replaced by one replica's (``params``,
    by name): calling it is ``functional_call``; a submodule is bound to
    its share of the names, and a method runs with this object as
    ``self`` (``RegAutoEncoder.forward_ae`` reaches the bound encoder and
    decoder)."""

    def __init__(self, module: nn.Module, params: dict):
        self._module = module
        self._params = params

    def __call__(self, *args):
        return functional_call(self._module, self._params, args)

    def __getattr__(self, name):
        attr = getattr(self._module, name)
        if isinstance(attr, nn.Module):
            pre = name + "."
            return _Bound(attr, {k[len(pre):]: v
                                 for k, v in self._params.items()
                                 if k.startswith(pre)})
        if inspect.ismethod(attr):
            return types.MethodType(attr.__func__, self)
        return attr


def _per_replica(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` [R] viewed to broadcast over ``like`` [R, ...]."""
    return t.view(-1, *([1] * (like.dim() - 1)))


class _ReplicaOptimizer:
    """Adam (betas 0.9/0.999, eps 1e-8, as
    :meth:`..core.task.TrainingTask.make_optimizer`) or SGD over parameters
    stacked ``[R, ...]``, with a learning rate ``lr`` [R] (float64, as the
    Python floats of a solo optimizer) and Adam's step counts [R] on the
    device: the counterpart of
    ``optax.inject_hyperparams``. ``torch.optim.Adam`` takes one learning
    rate per parameter group, so the update is written out here, in the
    arithmetic of its ``capturable`` foreach path (the card's solo
    optimizer), with nothing read on the host. A replica's state converts
    to and from ``torch.optim``'s state dict."""

    BETAS, EPS = (0.9, 0.999), 1e-8

    def __init__(self, name: str, params: list, lr: torch.Tensor):
        self.name = name.lower()
        if self.name not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer '{name}' (Adam or SGD)")
        self.params, self.lr = params, lr
        if self.name == "adam":
            # the solo optimizer's step counts: float32 on the card
            # (torch's capturable Adam), Python floats on the CPU
            self.steps = torch.zeros_like(
                lr, dtype=torch.float32 if lr.is_cuda else torch.float64)
            self.exp_avg = [torch.zeros_like(p) for p in params]
            self.exp_avg_sq = [torch.zeros_like(p) for p in params]

    def state_tensors(self) -> list:
        if self.name == "sgd":
            return []
        return [self.steps, *self.exp_avg, *self.exp_avg_sq]

    @torch.no_grad()
    def reset(self) -> None:
        for t in self.state_tensors():
            t.zero_()

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if self.name == "sgd":
            for p, g in zip(self.params, grads):
                p.addcmul_(g, _per_replica(self.lr.to(p.dtype), p),
                           value=-1.0)
            return
        b1, b2 = self.BETAS
        self.steps.add_(1.0)
        # the bias corrections of torch's capturable Adam, in its foreach
        # calls, on the step counts of every replica at once:
        # step = lr / (b1^t - 1) (negative), bc2 = sqrt(1 - b2^t); its
        # division by the Python float lr is a product with 1 / lr taken
        # in double precision
        bc1 = torch._foreach_pow(b1, [self.steps])
        bc2 = torch._foreach_pow(b2, [self.steps])
        torch._foreach_sub_(bc1, 1)
        torch._foreach_sub_(bc2, 1)
        torch._foreach_neg_(bc2)
        torch._foreach_mul_(bc1,
                            [self.lr.reciprocal().to(self.steps.dtype)])
        torch._foreach_reciprocal_(bc1)
        torch._foreach_sqrt_(bc2)
        step, bc2 = bc1[0], bc2[0]
        # the moments and the update in the same foreach calls, so that
        # each element takes the same arithmetic:
        # p += m / ((sqrt(v) / bc2 + eps) / step)
        torch._foreach_lerp_(self.exp_avg, grads, 1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1.0 - b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, [_per_replica(bc2, p)
                                    for p in self.params])
        torch._foreach_add_(denom, self.EPS)
        torch._foreach_div_(denom, [_per_replica(step, p)
                                    for p in self.params])
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom)

    def load_replica(self, r: int, state_dict: dict) -> None:
        """Replica ``r``'s state from a ``torch.optim`` state dict of the
        same parameters (a task's fresh optimizer has none: zeros)."""
        if self.name == "sgd":
            return
        with torch.no_grad():
            for i in range(len(self.params)):
                st = state_dict["state"].get(i)
                if st is None:
                    self.exp_avg[i][r].zero_()
                    self.exp_avg_sq[i][r].zero_()
                    continue
                self.exp_avg[i][r].copy_(st["exp_avg"])
                self.exp_avg_sq[i][r].copy_(st["exp_avg_sq"])
                self.steps[r] = float(st["step"])

    def replica_state_dict(self, host: dict, r: int, lr: float,
                           template: dict) -> dict:
        """Replica ``r``'s state as a ``torch.optim`` state dict with the
        param groups of ``template`` (the task's own optimizer's) and
        learning rate ``lr``, from the host copies ``host`` of
        :meth:`state_tensors`."""
        groups = [dict(g, lr=lr) for g in template["param_groups"]]
        if self.name == "sgd":
            return {"state": {}, "param_groups": groups}
        n = len(self.params)
        steps, m, v = host[0], host[1:1 + n], host[1 + n:]
        step = torch.tensor(float(steps[r]), dtype=torch.float32)
        state = {i: {"step": step.clone(), "exp_avg": m[i][r].clone(),
                     "exp_avg_sq": v[i][r].clone()} for i in range(n)}
        return {"state": state, "param_groups": groups}


class _Replicas:
    """R replicas of one task family: stacked parameters, optimizer and
    hyperparameters, the prepared batches of each task (one task: shared
    by every replica), the metric rows ``[R, nb, width]`` of an epoch, and
    the epoch over them, captured on the card."""

    def __init__(self, tasks: list, R: int):
        t0 = tasks[0]
        self.task, self.tasks = t0, tasks
        self.shared = len(tasks) == 1
        self.device = t0.device
        prepared = [t._prepare_data() for t in tasks]
        self.train = [p[0] for p in prepared]
        self.test = [p[1] for p in prepared]
        self.nb_train = len(prepared[0][2])
        self.names = [n for n, _ in t0.model.named_parameters()]
        dt = default_dtype()
        self.params = [
            torch.zeros((R,) + p.shape, dtype=p.dtype, device=self.device,
                        requires_grad=True)
            for p in t0.model.parameters()
        ]
        self.hyper = {name: torch.zeros((R,) + v.shape, dtype=dt,
                                        device=self.device)
                      for name, v in t0._hyper().items()}
        self.lr = torch.zeros(R, dtype=torch.float64, device=self.device)
        self.opt = _ReplicaOptimizer(t0.optimizer_name, self.params, self.lr)
        rows = prepared[0][4]
        self.rows = torch.empty((R,) + tuple(rows.shape), dtype=rows.dtype,
                                device=self.device)
        frozen = t0._frozen_prefix()
        self.frozen = [p for n, p in zip(self.names, self.params)
                       if frozen and n.startswith(frozen)]
        self.graphs = Graphs(self.device)

    def loss(self, inputs):
        """Every replica's ``(loss, row)`` on the shared ``inputs``."""
        task, names = self.task, self.names

        def one(params, hyper, inputs):
            model = _Bound(task.model, dict(zip(names, params)))
            return task._replica_loss(model, hyper, *inputs)

        return vmap(one, in_dims=(0, 0, None if self.shared else 0))(
            self.params, self.hyper, inputs)

    def _inputs(self, data, j: int) -> tuple:
        if self.shared:
            return self.task._replica_inputs(data[0][j])
        per = [t._replica_inputs(d[j]) for t, d in zip(self.tasks, data)]
        return tuple(None if parts[0] is None else torch.stack(parts)
                     for parts in zip(*per))

    def load(self, models: list, hypers: dict, lrs) -> None:
        """Every replica's initial parameters (``models``, modules of the
        task's architecture), hyperparameters ([R, ...] per name) and
        learning rates, copied into the stacked tensors in place, and a
        fresh optimizer state."""
        with torch.no_grad():
            for i, name in enumerate(self.names):
                self.params[i].copy_(torch.stack(
                    [dict(m.named_parameters())[name].detach()
                     for m in models]))
            for name, t in self.hyper.items():
                t.copy_(hypers[name])
            self.lr.copy_(torch.as_tensor(np.asarray(lrs, np.float64),
                                          dtype=self.lr.dtype))
        self.opt.reset()

    def epoch(self) -> None:
        """One epoch of every replica: per train batch the shared inputs,
        the mapped losses, one backward of their sum, the optimizer step;
        then the test batches under ``no_grad``; every batch's metric rows
        land in :attr:`rows`. It reads and writes everything in place and
        syncs nothing with the host, so the card can capture it."""
        ms = []
        for j in range(self.nb_train):
            losses, rows = self.loss(self._inputs(self.train, j))
            for p in self.params:
                p.grad = None
            losses.sum().backward()
            for p in self.frozen:
                p.grad.zero_()
            self.opt.step()
            ms.append(rows)
        with torch.no_grad():
            ms += [self.loss(self._inputs(self.test, j))[1]
                   for j in range(len(self.test[0]))]
        torch.stack(ms, dim=1, out=self.rows)

    def run(self, epochs: int, mesh=None):
        """``epochs`` epochs; returns the host copies of the metric rows
        [epochs, R, nb, width], the parameters and the optimizer state
        (:meth:`_ReplicaOptimizer.state_tensors`), fetched in one
        transfer. The epochs after a capturing one and the fetch are one
        ``cvf.sweep.run`` span, whose seconds :data:`last_run_seconds`
        takes. With ``mesh``, every rank's replicas, gathered in one flat
        buffer and concatenated along the replica axis in rank order:
        [epochs, W R, nb, width] etc."""
        global last_run_seconds
        all_rows = torch.empty((epochs,) + tuple(self.rows.shape),
                               dtype=self.rows.dtype, device=self.device)
        first = 0
        if epochs and self.graphs.mode("epoch") == "capture":
            self.graphs.run("epoch", self.epoch)
            all_rows[0].copy_(self.rows)
            first = 1
        with span("cvf.sweep.run", epochs=epochs - first) as timed:
            for e in range(first, epochs):
                self.graphs.run("epoch", self.epoch)
                all_rows[e].copy_(self.rows)
            tensors = [all_rows, *self.params, *self.opt.state_tensors()]
            with torch.no_grad():  # step counts are exact in either dtype
                flat = torch.cat([t.reshape(-1).to(all_rows.dtype)
                                  for t in tensors])
                every = [flat] if mesh is None else _gather_replicas(mesh,
                                                                     flat)
                every = torch.stack(every).cpu()  # one fetch
        last_run_seconds = timed.seconds
        out, off = [], 0
        for i, t in enumerate(tensors):
            parts = every[:, off:off + t.numel()].view(-1, *t.shape)
            # the replica axis: 1 of the rows, 0 of the rest
            out.append(torch.cat(list(parts), dim=int(i == 0)).to(t.dtype))
            off += t.numel()
        n = len(self.params)
        return out[0].numpy(), out[1:1 + n], out[1 + n:]


def _check_family(task) -> None:
    if task.mesh is not None:
        # the JAX package refuses it with an ensemble mesh
        # (ensemble.py:433-436,991-994); without one its replicas would
        # train on one rank's share of each batch here
        raise Incompatible(
            "a replica sweep or ensemble takes tasks without their own data "
            "mesh; pass the mesh to the sweep instead (ensemble "
            "parallelism)")
    if task._streaming:
        # the JAX sweep reads the streaming task's None batches and fails
        # without saying why (colvarsfinder_tpu/parallel/ensemble.py:229)
        raise Incompatible(
            "replica sweeps and ensembles train on the task's batches "
            "gathered on the device; a streaming task keeps its trajectory "
            "on the host. Construct the task with streaming=False to sweep "
            "it"
        )
    if getattr(task, "fused_step", False):
        raise Incompatible(
            "replica-ensemble training does not support fused_step tasks "
            "(the fused kernels cannot be vmapped over the replica axis); "
            "construct the replicas with the default step"
        )


def _curves(task, rows: np.ndarray, nb_train: int):
    """Per-epoch mean train and test metrics and the train rows [epochs,
    nb_train, width] of one replica's rows [epochs, nb, width]."""
    n = len(task.loss_names)
    train_cm = rows[:, :nb_train]
    return (train_cm[:, :, :n].mean(axis=1),
            rows[:, nb_train:, :n].mean(axis=1), train_cm)


# ---------------------------------------------------------------------------
# R tasks, each with its own data
# ---------------------------------------------------------------------------


def train_replica_ensemble(tasks: Sequence, mesh=None,
                           compute_dtype: str | None = None,
                           bf16_style: str | None = None) -> None:
    """Train R tasks of one family as one replica program
    (``colvarsfinder_tpu/parallel/ensemble.py:299-465``).

    The tasks must be of the same type and share the static configuration
    (:meth:`..core.task.TrainingTask._static_config`: lags, optimizer,
    gates, batch layout), the epochs, batch size, test ratio, model
    architecture and data shapes. Their data, splits, models,
    preprocessing constants, learning rates and loss hyperparameters may
    differ. Each replica continues from its task's model and optimizer
    state, and each task ends as ``train()`` would leave it (model,
    optimizer state, ``train_loss`` / ``test_loss``, ``loss_list``, the
    head order), without checkpoint or plot hooks.

    Args:
        tasks: the R tasks (on a mesh, the same R tasks on every rank).
        mesh: a :func:`.mesh.make_data_mesh` mesh over which the replicas
            are sharded: rank r trains tasks ``[r R/W, (r+1) R/W)`` and every
            rank ends with every task trained; R must divide by its size.
        compute_dtype / bf16_style: the numerics of this call
            (:func:`..config.set_compute_dtype`,
            :func:`..config.set_bf16_style`), restored after it.

    Raises:
        Incompatible: tasks that cannot run as one ensemble.
    """
    tasks = list(tasks)
    if not tasks:
        raise ValueError("no tasks")
    mine = (slice(0, len(tasks)) if mesh is None
            else _rank_share(mesh, len(tasks)))
    t0 = tasks[0]
    if any(type(t) is not type(t0) for t in tasks):
        raise Incompatible(
            "all replicas must be the same task type; got "
            f"{sorted({type(t).__name__ for t in tasks})}")
    with _numerics(compute_dtype, bf16_style):
        for t in tasks:
            _check_family(t)
            t._prepare_data()
        static = t0._static_config()
        shapes0 = _replica_shapes(t0)
        for r, t in enumerate(tasks[1:], start=1):
            if t._static_config() != static:
                raise Incompatible(
                    "all replicas must share the same static configuration; "
                    f"replica {r} has {t._static_config()} vs {static}")
            for what in ("num_epochs", "batch_size", "test_ratio",
                         "device"):
                if getattr(t, what) != getattr(t0, what):
                    raise Incompatible(
                        f"replica {r} has {what} {getattr(t, what)} vs "
                        f"{getattr(t0, what)}")
            if _replica_shapes(t) != shapes0:
                raise Incompatible(
                    f"replica {r} has parameter or batch shapes "
                    f"{_replica_shapes(t)} vs replica 0's {shapes0}; all "
                    "replicas must have one architecture and data shape")
        local = tasks[mine]
        reps = _Replicas(local, len(local))
        each = [t._hyper() for t in local]
        hypers = {name: torch.stack([h[name] for h in each])
                  for name in reps.hyper}
        reps.load([t.model for t in local], hypers,
                  [float(t.learning_rate) for t in local])
        for r, t in enumerate(local):
            reps.opt.load_replica(r, t.optimizer.state_dict())
        rows, params, state = reps.run(t0.num_epochs, mesh=mesh)
    per_epoch = last_run_seconds / t0.num_epochs
    for r, t in enumerate(tasks):
        t._drop_graph()
        with torch.no_grad():
            for p, host in zip(t.model.parameters(), params):
                p.copy_(host[r])
        t.optimizer.load_state_dict(reps.opt.replica_state_dict(
            state, r, float(t.learning_rate), t.optimizer.state_dict()))
        train_m, test_m, train_cm = _curves(t, rows[:, r], reps.nb_train)
        n = len(t.loss_names)
        t.loss_list = [[rows[e, r, :reps.nb_train, :n],
                        rows[e, r, reps.nb_train:, :n]]
                       for e in range(t.num_epochs)]
        t.train_loss, t.test_loss = train_m, test_m
        t.epoch_times = [per_epoch] * t.num_epochs
        t._chunk_fetched(train_cm)


def _param_shapes(task) -> tuple:
    return tuple((n, tuple(p.shape))
                 for n, p in task.model.named_parameters())


def _replica_shapes(task) -> tuple:
    """The parameter shapes and the shapes of the first train batch's
    tensors: what must agree for stacking."""
    train = task._prepare_data()[0]
    return (_param_shapes(task),
            tuple(None if x is None else tuple(x.shape) for x in train[0]),
            len(train), len(task._prepare_data()[1]))


# ---------------------------------------------------------------------------
# R hyperparameter variants of one task, on its data
# ---------------------------------------------------------------------------


class SweepResult(NamedTuple):
    """One replica of :func:`train_hyperparameter_sweep`.

    ``model`` is the replica's state dict and ``opt_state`` its
    ``torch.optim`` state dict, both of host tensors; ``train_loss`` /
    ``test_loss`` are its per-epoch mean metrics [epochs, n] with columns
    ``loss_names``; ``cvec`` is its head order (eigenfunction and RegAE
    tasks) or None."""

    hyperparams: dict
    model: dict
    opt_state: dict
    train_loss: np.ndarray
    test_loss: np.ndarray
    loss_names: list
    cvec: np.ndarray | None

    @property
    def train_loss_df(self):
        return losses_to_dataframe(list(self.train_loss), self.loss_names)

    @property
    def test_loss_df(self):
        return losses_to_dataframe(list(self.test_loss), self.loss_names)


def _sweep_values(task, grid: dict, R: int) -> dict:
    """Each hyperparameter [R, ...]: the task's own value, overridden per
    replica by ``grid``; gate toggles of the RegAE are refused."""
    base = task._hyper()
    for name in grid:
        if name != "learning_rate" and name not in base:
            raise ValueError(
                f"hyperparameter '{name}' is not sweepable for "
                f"{type(task).__name__}; supported: "
                f"{['learning_rate', *sorted(base)]}")
    for name, gate in task._GATES.items():
        if name in grid:
            want = gate(base[name].cpu().numpy())
            for v in grid[name]:
                if gate(np.asarray(v, np.float64)) != want:
                    raise ValueError(
                        f"sweep value {v!r} for '{name}' toggles its on/off "
                        "gate relative to the task's value; gates are static "
                        "— construct a separate task/sweep for that regime")
    out = {}
    for name, b in base.items():
        if name not in grid:
            out[name] = b.expand(R, *b.shape)
            continue
        vals = torch.as_tensor(np.asarray([np.asarray(v, np.float64)
                                           for v in grid[name]]),
                               dtype=b.dtype)
        if vals.shape[1:] != b.shape:
            raise ValueError(
                f"'{name}' sweep values have shape {tuple(vals.shape[1:])}, "
                f"expected {tuple(b.shape)}")
        out[name] = vals.to(b.device)
    return out


def _sweep_replicas(task, R: int) -> _Replicas:
    """The replicas of a sweep of ``task`` at width R: the one kept from an
    earlier call with the same task, prepared data, numerics and static
    configuration (its graph replays), else new ones."""
    objects = [task, task._prepared, task.model,
               getattr(task, "_pp_for_loss", None),
               getattr(task, "_diag_coeff", None)]
    key = ("sweep", type(task).__name__, R, numerics_key(),
           task._static_config(), tuple(map(id, objects)))
    reps = _SWEEPS.pop(key, None)
    if reps is None:
        reps = _Replicas([task], R)
        while len(_SWEEPS) >= _SWEEPS_MAX:
            _SWEEPS.popitem(last=False)
    _SWEEPS[key] = reps
    return reps


def release_sweeps() -> None:
    """Forget the sweeps kept for replay, with their graphs' memory."""
    _SWEEPS.clear()
    gc.collect()


def train_hyperparameter_sweep(
    task, grid: dict, models=None, chunk_size: int | None = None, mesh=None,
    compute_dtype: str | None = None, bf16_style: str | None = None,
) -> list:
    """Train R hyperparameter variants of ``task`` as one replica program
    on the task's own batches, shared by every replica
    (``colvarsfinder_tpu/parallel/ensemble.py:776-1066``).

    Args:
        task: a constructed task of any of the four families; its data,
            split and static configuration serve every replica, and its own
            hyperparameter values are the defaults a grid entry overrides.
        grid: hyperparameter name -> length-R sequence of values:
            ``learning_rate`` (every task); ``alpha``, ``eig_weights``,
            ``beta`` (EigenFunctionTask); ``alpha``, ``gamma``, ``eta``,
            ``eig_weights``, ``beta`` (RegAutoEncoderTask, without toggling
            a term's on/off gate); ``alpha``, ``beta`` (CommittorTask).
        models: optional R modules of the task's architecture, each
            replica's initial parameters (default: the task's model).
        chunk_size: at most this many replicas per program; the grid runs
            in chunks of this width, the last padded with its final entry,
            all replaying one captured epoch.
        mesh: a :func:`.mesh.make_data_mesh` mesh over which each
            program's replicas are sharded (rank r trains replicas ``[r
            R/W, (r+1) R/W)`` of it, no collective during training) and
            whose ranks then all gather every result; the program's width
            (R, or ``chunk_size`` below R) must divide by its size, and the
            task must have no mesh of its own.
        compute_dtype / bf16_style: the numerics of this call, restored
            after it (:func:`..config.set_compute_dtype`,
            :func:`..config.set_bf16_style`).

    Returns:
        R :class:`SweepResult` in grid order. The task is not mutated: its
        model, optimizer and hyperparameter attributes are only read. A
        sweep leaves on it what ``train()`` would too: its prepared
        batches, if it had none.
    """
    if not grid:
        raise ValueError("grid must name at least one hyperparameter")
    lengths = {name: len(vals) for name, vals in grid.items()}
    R = next(iter(lengths.values()))
    if any(n != R for n in lengths.values()):
        raise ValueError(
            f"all grid value lists must have equal length, got {lengths}")
    if models is not None and len(models) != R:
        raise ValueError(f"models must have length {R}")
    _check_family(task)
    cs = R if chunk_size is None else int(chunk_size)
    if cs <= 0:
        raise ValueError("chunk_size must be positive")
    width = min(cs, R)
    mine = slice(0, width) if mesh is None else _rank_share(mesh, width)
    with span("cvf.sweep.call", replicas=R), \
            _numerics(compute_dtype, bf16_style):
        out = []
        for lo in range(0, R, cs):
            hi = min(lo + cs, R)
            idx = list(range(lo, hi)) + [hi - 1] * (width - (hi - lo))
            sub = {k: [list(v)[i] for i in idx] for k, v in grid.items()}
            subm = None if models is None else [models[i] for i in idx]
            out += _sweep(task, sub, subm, mesh, mine)[:hi - lo]
        return out


def _sweep(task, grid: dict, models, mesh, mine: slice) -> list:
    """The R results of ``grid``; this rank trains the replicas ``mine``
    of them (all of them without a mesh). Stacking the replicas is one
    ``cvf.sweep.load`` span, building the R results one
    ``cvf.sweep.unpack`` span."""
    R = len(next(iter(grid.values())))
    with span("cvf.sweep.load", replicas=R):
        task._prepare_data()
        hypers = _sweep_values(task, grid, R)
        lrs = [float(v) for v in grid.get("learning_rate",
                                          [task.learning_rate] * R)]
        shapes = [(n, p.shape) for n, p in task.model.named_parameters()]
        for m in models or ():
            if [(n, p.shape) for n, p in m.named_parameters()] != shapes:
                raise ValueError("models must share the task model's "
                                 "architecture")
        local = range(R)[mine]
        reps = _sweep_replicas(task, len(local))
        reps.load((models or [task.model] * R)[mine],
                  {name: v[mine] for name, v in hypers.items()}, lrs[mine])
    rows, params, state = reps.run(task.num_epochs, mesh)
    with span("cvf.sweep.unpack", replicas=R):
        template = task.optimizer.state_dict()
        n = len(task.loss_names)
        results = []
        for r in range(R):
            train_m, test_m, train_cm = _curves(task, rows[:, r],
                                                reps.nb_train)
            width = train_cm.shape[-1]
            results.append(SweepResult(
                hyperparams={name: vals[r] for name, vals in grid.items()},
                model={name: p[r].clone()
                       for name, p in zip(reps.names, params)},
                opt_state=reps.opt.replica_state_dict(state, r, lrs[r],
                                                      template),
                train_loss=train_m, test_loss=test_m,
                loss_names=list(task.loss_names),
                cvec=(train_cm[-1, -1, n:].astype(int) if width > n
                      else None),
            ))
    return results


def adopt_sweep_result(task, result: SweepResult):
    """Load one sweep replica into ``task`` so that its surface
    (``colvar_model``, ``save_model``, a continued ``train()``) works on
    it: the model parameters, the optimizer state, the head order and the
    task's hyperparameter attributes (``learning_rate``; ``_alpha``,
    ``_eig_w``, ``_beta`` of an EigenFunctionTask; ``alpha``, ``gamma``,
    ``eta``, ``_eig_w``, ``_beta`` of a RegAutoEncoderTask; ``alpha``,
    ``beta`` of a CommittorTask) (``colvarsfinder_tpu/parallel/
    ensemble.py:497-535``). Drops the task's captured epoch. Returns the
    task."""
    task._drop_graph()
    task.model.load_state_dict(result.model)
    task.optimizer.load_state_dict(result.opt_state)
    if result.cvec is not None:
        task._cvec = np.asarray(result.cvec)
    attr_of = {
        "learning_rate": ("learning_rate",),
        "eig_weights": ("_eig_w",),
        "beta": ("_beta", "beta"),
        # RegAE and committor keep plain `alpha`, the eigen task `_alpha`
        "alpha": ("alpha",) if hasattr(task, "gamma") else ("_alpha",
                                                              "alpha"),
        "gamma": ("gamma",),
        "eta": ("eta",),
    }
    for name, value in result.hyperparams.items():
        attr = next((a for a in attr_of.get(name, ()) if hasattr(task, a)),
                    None)
        if attr is None:
            continue
        old = getattr(task, attr)
        if isinstance(old, list):
            value = [type(old[0])(v) if old else float(v)
                     for v in np.asarray(value).reshape(-1)]
        elif isinstance(old, float):
            value = float(value)
        setattr(task, attr, value)
    if "eig_weights" in result.hyperparams and hasattr(task, "_eig_w_t"):
        task._eig_w_t = torch.as_tensor(task._eig_w, dtype=default_dtype(),
                                        device=task.device)
    return task


# ---------------------------------------------------------------------------
# ranking replicas by their CVs
# ---------------------------------------------------------------------------


def _replica_cvs(task, results, frames, batch_size: int):
    """Each replica's CV on ``frames`` [n, ...], frame-ordered, as numpy
    [n, k]: the frames are placed on the task's device once, in chunks,
    and each replica's parameters are loaded into one copy of the model,
    so the task itself is not touched."""
    if isinstance(results, SweepResult):
        results = [results]
    proxy = copy.copy(task)
    proxy.model = copy.deepcopy(task.model)
    frames = np.asarray(frames)
    chunks = [torch.as_tensor(frames[s:s + batch_size], dtype=default_dtype(),
                              device=task.device)
              for s in range(0, frames.shape[0], batch_size)]
    for res in results:
        proxy.model.load_state_dict(res.model)
        proxy._cvec = None if res.cvec is None else np.asarray(res.cvec)
        cv = proxy.colvar_model()
        with torch.no_grad():
            yield np.concatenate([cv(c).cpu().numpy() for c in chunks])


def _default_frames(task, frames, weights, segment_starts):
    if frames is None:
        frames = task.traj_obj.trajectory
        if weights is None:
            weights = task.traj_obj.weights
        if segment_starts is None:
            segment_starts = getattr(task.traj_obj, "segment_starts", None)
    return frames, weights, segment_starts


def sweep_vamp_scores(task, results, lag: int | None = None, frames=None,
                      weights=None, method: str = "VAMP-2",
                      batch_size: int = 65536,
                      segment_starts=None) -> np.ndarray:
    """Rank sweep replicas by the VAMP score of their CVs
    (:func:`..analysis.vamp_score`), which compares CVs across loss
    hyperparameters where the losses do not
    (``colvarsfinder_tpu/parallel/ensemble.py:538-616``).

    Args:
        task: the task the sweep ran on (not mutated).
        results: the :class:`SweepResult` list (or one result).
        lag: the VAMP lag in frames; default the task's training lag.
        frames / weights / segment_starts: frame-ordered states to score
            on (e.g. held out) with their weights and source offsets;
            default the task's trajectory.
        method: 'VAMP-1' or 'VAMP-2'.
        batch_size: frames per CV evaluation.

    Returns:
        [R] scores in ``results`` order; adopt the argmax.
    """
    from ..analysis import vamp_score

    if lag is None:
        lag = getattr(task, "lag_idx", 0)
        if not lag:
            raise ValueError(
                "task has no positive training lag; pass lag= (in frames)")
    frames, weights, segment_starts = _default_frames(task, frames, weights,
                                                      segment_starts)
    return np.asarray([
        vamp_score(y, lag, weights=weights, method=method,
                   segment_starts=segment_starts)
        for y in _replica_cvs(task, results, frames, batch_size)
    ])


def sweep_committor_checks(task, results, lag: int, frames=None,
                           weights=None, in_a=None, in_b=None,
                           n_bins: int = 20, batch_size: int = 65536,
                           segment_starts=None) -> np.ndarray:
    """Rank committor-sweep replicas by the largest of the MSM
    self-consistency deviation (:func:`..analysis.committor_self_consistency`)
    and the weighted boundary violations ``E[q | A]`` and ``E[1-q | B]``;
    lower is better (``colvarsfinder_tpu/parallel/ensemble.py:619-714``).

    Args:
        task: the :class:`..core.CommittorTask` the sweep ran on.
        results: the :class:`SweepResult` list (or one result).
        lag: MSM lag in frames.
        frames / weights / segment_starts: held-out frame-ordered states;
            default the task's trajectory.
        in_a / in_b: boolean masks of A and B for ``frames`` (required
            with ``frames``; the task's own regions otherwise).
        n_bins: interior committor bins.
        batch_size: frames per CV evaluation.

    Returns:
        [R] scores in ``results`` order (nan where a replica's committor
        leaves every interior bin empty).
    """
    from ..analysis import committor_self_consistency
    from ..core.committor import CommittorTask

    if not isinstance(task, CommittorTask):
        raise TypeError(
            "sweep_committor_checks needs a CommittorTask (its region masks "
            f"define the boundary states); got {type(task).__name__}")
    if frames is None:
        in_a, in_b = task._mask_a, task._mask_b
    elif in_a is None or in_b is None:
        raise ValueError(
            "pass in_a and in_b boolean masks along with held-out frames")
    frames, weights, segment_starts = _default_frames(task, frames, weights,
                                                      segment_starts)
    in_a = np.asarray(in_a, bool)
    in_b = np.asarray(in_b, bool)
    devs = []
    for logits in _replica_cvs(task, results, frames, batch_size):
        q = 1.0 / (1.0 + np.exp(-logits[:, 0].astype(np.float64)))
        chk = committor_self_consistency(
            q, in_a, in_b, lag=lag, n_bins=n_bins, weights=weights,
            segment_starts=segment_starts)
        w = (np.ones(len(q)) if weights is None
             else np.asarray(weights, float))
        bnd_a = float(np.average(q[in_a], weights=w[in_a]))
        bnd_b = float(np.average(1.0 - q[in_b], weights=w[in_b]))
        devs.append(max(chk.max_deviation, bnd_a, bnd_b))
    return np.asarray(devs)


# ---------------------------------------------------------------------------
# explore (bf16 sweep) -> adopt the winner -> fine-tune (f32)
# ---------------------------------------------------------------------------


class ExploreResult(NamedTuple):
    """Outcome of :func:`explore_then_finetune`: the whole sweep (grid
    order), the index of the replica adopted and fine-tuned, and its grid
    point. The task itself holds the fine-tuned model."""

    results: list
    best_index: int
    best_hyperparams: dict


def explore_then_finetune(
    task, grid: dict, *, models=None, metric: str = "train",
    metric_lag: int | None = None, finetune_epochs: int | None = None,
    compute_dtype: str = "bfloat16", bf16_style: str | None = None,
    chunk_size: int | None = None, mesh=None,
) -> ExploreResult:
    """Sweep ``grid`` under ``compute_dtype`` (bfloat16 by default), adopt
    the best replica into ``task`` and continue training it in float32
    (``colvarsfinder_tpu/parallel/ensemble.py:1090-1186``).

    Args:
        task: the task to sweep and fine-tune; it ends holding the
            fine-tuned winner.
        grid / models / chunk_size / mesh: as for
            :func:`train_hyperparameter_sweep`.
        metric: what ranks the replicas: 'train' or 'test' (the lowest
            final loss; 'test' falls back to 'train' without a test
            split), 'vamp' (the highest :func:`sweep_vamp_scores` at the
            task's lag) or 'committor' (the lowest
            :func:`sweep_committor_checks` at ``metric_lag`` frames).
        metric_lag: the MSM lag of ``metric='committor'``.
        finetune_epochs: epochs of the float32 fine-tune (default the
            task's ``num_epochs``).
        compute_dtype / bf16_style: the sweep's numerics.
    """
    if metric not in ("train", "test", "vamp", "committor"):
        raise ValueError("metric must be 'train', 'test', 'vamp', or "
                         f"'committor'; got {metric!r}")
    if metric == "committor" and metric_lag is None:
        raise ValueError("metric='committor' needs metric_lag= (frames)")
    results = train_hyperparameter_sweep(
        task, grid, models=models, chunk_size=chunk_size, mesh=mesh,
        compute_dtype=compute_dtype, bf16_style=bf16_style)
    if metric == "vamp":
        best = int(np.argmax(sweep_vamp_scores(task, results)))
    elif metric == "committor":
        best = int(np.argmin(sweep_committor_checks(
            task, results, lag=int(metric_lag))))
    else:
        finals = []
        for r in results:
            curve = r.test_loss if metric == "test" else r.train_loss
            if len(curve) == 0:
                curve = r.train_loss
            finals.append(float(curve[-1, 0]))
        best = int(np.argmin(finals))
    adopt_sweep_result(task, results[best])
    prev_epochs = task.num_epochs
    if finetune_epochs is not None:
        task.num_epochs = int(finetune_epochs)
    try:
        with _numerics("float32", None):
            task.train()  # continues from the adopted model and state
    finally:
        task.num_epochs = prev_epochs
    return ExploreResult(results, best, dict(results[best].hyperparams))


# ---------------------------------------------------------------------------
# architecture sweeps: group the tasks that can run as one ensemble
# ---------------------------------------------------------------------------


def _arch_group_key(task) -> tuple:
    """Tasks with equal keys are candidates for one ensemble; the
    ensemble's own checks decide (``ensemble.py:1194-1208``)."""
    return (type(task).__name__, task._static_config(), task.num_epochs,
            task.batch_size, task.test_ratio, _param_shapes(task))


def train_architecture_ensemble(
    tasks: Sequence, *, mesh=None, compute_dtype: str | None = None,
    bf16_style: str | None = None, verbose: bool = False,
) -> list:
    """Train tasks of varying architectures: the tasks are grouped by
    family, static configuration and parameter shapes, each group of more
    than one runs as one :func:`train_replica_ensemble`, and single tasks,
    or groups the ensemble refuses (different data shapes, say), train
    alone with ``task.train()`` (``ensemble.py:1211-1291``). Every task
    ends as ``train()`` would leave it. ``mesh`` shards the ensembles of the
    groups whose size divides over its ranks; the others run unsharded, as
    in the JAX package (``ensemble.py:1275``). Returns the tasks."""
    size = None if mesh is None else mesh_coords(mesh)[1]
    with _numerics(compute_dtype, bf16_style):
        groups: dict = {}
        for i, t in enumerate(tasks):
            groups.setdefault(_arch_group_key(t), []).append(i)
        for key, idxs in groups.items():
            group = [tasks[i] for i in idxs]
            label = f"{key[0]} group of {len(group)}"
            if len(group) == 1:
                if verbose:
                    print(f"[arch-sweep] {label}: solo train()")
                group[0].train()
                continue
            gmesh = mesh if size and len(group) % size == 0 else None
            try:
                train_replica_ensemble(group, mesh=gmesh)
                if verbose:
                    print(f"[arch-sweep] {label}: one replica ensemble")
            except Incompatible as err:
                if verbose:
                    print(f"[arch-sweep] {label}: fell back to solo ({err})")
                for t in group:
                    t.train()
    return list(tasks)
