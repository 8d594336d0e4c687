r"""Committor training task (port of ``colvarsfinder_tpu/core/committor.py``).

Learns the committor :math:`q(x) = P(\text{reach } B \text{ before } A
\mid X_0 = x)` between two metastable sets from weighted trajectory data,
by minimizing the Dirichlet form with soft boundary penalties
(:func:`.losses.committor_loss`). The per-sample input gradients are the
generator eigenfunction path's, and so is the Gram path: the
preprocessing layer's per-sample Gram matrix computed once per batch
(:func:`.eigenfunction.gram_batch`).

The batches are gathered onto the device once, and an epoch is one call of
:meth:`.task.TrainingTask._epoch_body`, captured as a CUDA graph on the
card, as in :class:`.eigenfunction.EigenFunctionTask`. The CV of
:meth:`CommittorTask.colvar_model` is the logit :math:`g(r(x))`, a
monotone transform of :math:`q` with the same level sets; the committor
itself comes from :meth:`CommittorTask.committor_values` or
:meth:`CommittorTask.committor_fn`. The JAX package's streaming layout is
not ported (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype
from ..export import ColvarModel
from ..ops.features import as_pp_layer
from .eigenfunction import gram_batch
from .losses import committor_loss
from .task import TrainingTask

__all__ = ["CommittorTask"]


class CommittorTask(TrainingTask):
    r"""Learn the committor between metastable sets A and B.

    Args:
        traj_obj: a :class:`~colvarsfinder_tpu_torch.utils.WeightedTrajectory`
            that visits both sets.
        pp_layer: preprocessing layer ``r`` (the input gradients go
            through it).
        model: scalar-output network ``g`` (e.g.
            ``create_sequential_nn([d_r, 20, 20, 1])``); the committor is
            ``sigmoid(g(r(x)))``.
        model_path: checkpoint and metrics directory.
        region_a / region_b: the sets, as boolean arrays over the frames or
            callables mapping the frame array [n, *state] (numpy) to [n]
            booleans, evaluated once. Both non-empty and disjoint.
        alpha: boundary-penalty strength.
        beta: inverse temperature.
        diag_coeff: optional diffusion diagonal over the flattened state
            dims (default ones).
        gram_pp: train through the preprocessing layer's per-batch Gram
            matrices (default: on for a non-identity preprocessing layer,
            unless they would exceed :attr:`GRAM_AUTO_LIMIT_BYTES`).
        (remaining arguments as in the other tasks)

    Attributes:
        train_loss / test_loss: per-epoch mean metrics with columns
            ``loss, dirichlet, boundary_a, boundary_b``
        train_loss_df / test_loss_df: the same as pandas DataFrames
    """

    def __init__(
        self,
        traj_obj,
        pp_layer,
        model,
        model_path,
        region_a,
        region_b,
        alpha: float = 100.0,
        beta: float = 1.0,
        diag_coeff=None,
        gram_pp: bool | None = None,
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
        super().__init__(
            traj_obj, as_pp_layer(pp_layer), model, model_path,
            learning_rate, load_model_filename, save_model_every_step, 1,
            batch_size, num_epochs, test_ratio, optimizer_name, device,
            plot_class, plot_frequency, verbose, debug_mode, **kwargs,
        )
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.loss_names = ["loss", "dirichlet", "boundary_a", "boundary_b"]

        raw = np.asarray(traj_obj.trajectory)
        dt = default_dtype()
        self._traj = torch.as_tensor(raw, dtype=dt).to(self.device)
        self._weights = torch.as_tensor(
            np.asarray(traj_obj.weights), dtype=dt).to(self.device)
        self._pp_for_loss = self.preprocessing_layer
        n = raw.shape[0]

        with torch.no_grad():
            out = self.model(self.preprocessing_layer(self._traj[:1]))
        if out.dim() != 2 or out.shape[1] != 1:
            raise ValueError(
                "committor model must map [B, d_r] -> [B, 1], got output "
                f"shape {tuple(out.shape)}"
            )
        self.init_model_and_optimizer()
        self._diag_coeff = self._diag_coeff_tensor(diag_coeff)
        self._resolve_gram_request(gram_pp, True)

        self._mask_a = self._resolve_region(region_a, raw, "region_a")
        self._mask_b = self._resolve_region(region_b, raw, "region_b")
        if (self._mask_a & self._mask_b).any():
            raise ValueError("region_a and region_b overlap")
        if self.verbose:
            print(f"\ncommittor task: {n} frames, {int(self._mask_a.sum())} "
                  f"in A, {int(self._mask_b.sum())} in B\n", flush=True)

    @staticmethod
    def _resolve_region(region, raw: np.ndarray, name: str) -> np.ndarray:
        n = raw.shape[0]
        mask = np.asarray(region(raw) if callable(region) else region)
        mask = mask.reshape(-1)
        if mask.shape[0] != n:
            raise ValueError(
                f"{name} yields {mask.shape[0]} values for {n} frames"
            )
        mask = mask.astype(bool)
        if not mask.any():
            raise ValueError(
                f"{name} matches no trajectory frame — the committor "
                "boundary condition cannot be imposed"
            )
        return mask

    # ------------------------------------------------------------------
    def colvar_model(self) -> ColvarModel:
        r"""The logit-committor CV ``g(r(x))``."""
        return ColvarModel(self.preprocessing_layer, self.model)

    def reg_model(self):
        """None: the task has no regularizer model."""
        return None

    def committor_fn(self):
        """Callable ``q(X) = sigmoid(g(r(X)))`` on raw state batches [n]."""
        cv = self.colvar_model()

        def q(X):
            return torch.sigmoid(cv(X))[:, 0]

        return q

    def committor_values(self, X) -> np.ndarray:
        """Committor probabilities of raw states [n, *state] -> [n]."""
        X = torch.as_tensor(np.asarray(X), dtype=default_dtype(),
                            device=self.device)
        with torch.no_grad():
            return self.committor_fn()(X).cpu().numpy()

    # ------------------------------------------------------------------
    def _prepare_data(self):
        """``(train, test, train_b, test_b, rows)`` with ``(X, w, a, b)``
        per batch, or ``(H, M, w, a, b)`` on the Gram path; ``rows``
        [nb_train + nb_test, 4]."""
        if self._prepared is not None:
            return self._prepared
        train_idx, test_idx = self._make_split(self._traj.shape[0])
        train_b = train_idx[self._make_batches(np.arange(len(train_idx)),
                                               self.batch_size)]
        test_b = test_idx[self._make_batches(np.arange(len(test_idx)),
                                             self.batch_size)]
        # both boundary sets must reach the training batches: without A (or
        # B) frames that penalty is zero and the loss minimizes to a wrong
        # committor
        for name, mask in (("region_a", self._mask_a),
                           ("region_b", self._mask_b)):
            if not mask[train_b.reshape(-1)].any():
                raise ValueError(
                    f"no {name} frame lands in the training batches "
                    "(test_ratio/batch_size ate them all) — enlarge the "
                    "region, lower test_ratio, or add boundary samples"
                )
        self._resolve_gram(train_b, test_b)
        dt = self._weights.dtype
        mask_a = torch.as_tensor(self._mask_a, dtype=dt, device=self.device)
        mask_b = torch.as_tensor(self._mask_b, dtype=dt, device=self.device)

        def pack(rows):
            out = []
            for row in rows:
                i = torch.as_tensor(row, device=self.device)
                X = self._traj[i]
                rest = (self._weights[i], mask_a[i], mask_b[i])
                if self._gram:
                    out.append(gram_batch(self._pp_for_loss, X,
                                          self._diag_coeff, self._d_r) + rest)
                else:
                    out.append((X,) + rest)
            return out

        rows = self._metric_rows(len(train_b) + len(test_b),
                                 len(self.loss_names))
        self._prepared = (pack(train_b), pack(test_b), train_b, test_b, rows)
        return self._prepared

    def _graph_static(self):
        return ((self.alpha, self.beta, self._gram),
                (self.model, self._pp_for_loss, self._diag_coeff))

    def _batch_metrics(self, *batch):
        """Loss and the metric row [loss, dirichlet, boundary_a,
        boundary_b] of one batch."""
        hyper = (self.alpha, self.beta)
        if self._gram:
            H, M, w, a, b = batch
            loss, parts = committor_loss(self.model, None, H, w, a, b, hyper,
                                         pp_gram=M)
        else:
            X, w, a, b = batch
            loss, parts = committor_loss(self.model, self._pp_for_loss, X, w,
                                         a, b, hyper, self._diag_coeff)
        return loss, torch.stack([loss, *parts]).detach()
