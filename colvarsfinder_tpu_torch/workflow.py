r"""Adaptive CV discovery: the sample → train → bias → reweight → retrain loop.

The reference ecosystem's intended workflow is iterative (its deployment
artifact exists to hand a half-trained CV back to a biased MD engine:
reference colvarsfinder/core.py:212-227 TorchScript export +
utils.py:220-223 PLUMED bias, then utils.py:354-417 ``calc_weights``
re-entry), but nothing orchestrates the loop — every round is manual
notebook code. This module packages it: starting from an unbiased run
that is typically trapped in one metastable state, each round trains a
CV on all data so far, runs well-tempered metadynamics ALONG that CV
(each deposition block one captured CUDA graph on the card), converts the biased frames to
unbiased-ensemble weights, pools them with everything previous
(boundary-aware lagged pairs via ``segment_starts``), and retrains.

Each piece exists on its own (:func:`~colvarsfinder_tpu_torch.utils.sampling.
integrate_sde_overdamped`, :func:`~colvarsfinder_tpu_torch.utils.enhanced.
integrate_sde_metadynamics`, ``MetadynamicsResult.frame_weights``,
:func:`~colvarsfinder_tpu_torch.utils.trajectory.concatenate_trajectories`);
this is the driver that composes them, with the bookkeeping (consistent
frame spacing, per-round artifacts, convergence signal) handled once.

See ``examples/enhanced_sampling.py`` for the manual single-round
version of the same loop with commentary.

The port (``colvarsfinder_tpu/workflow.py``), on the port's samplers,
:class:`.utils.WeightedTrajectory` and
:func:`.utils.concatenate_trajectories`, on the card unless
``device='cpu'``. Where it differs from the JAX module:

* the port's samplers call the CV on the chain batch ``[c, dim]``, so the
  first head is taken per row, ``cv(x).reshape(c, -1)[:, :1]`` (the JAX
  module takes ``[:1]`` of one state's CV under ``vmap``);
* a CV of numpy frames (the hill width, :meth:`AdaptiveResult.
  cv_range_per_round`) is evaluated on its device in chunks
  (``analysis._cv_on_numpy``);
* ``warm_start`` copies the previous round's parameters into the new
  task's own tensors (``load_state_dict``) and clears its optimizer
  state before ``train()``, so a captured epoch and the capturable Adam
  keep pointing at the task's tensors;
* the progress line reads the loss from ``task.train_loss``, without
  pandas;
* round r seeds its sampler with ``seed + r`` as the JAX module does, but
  the port's draws come from its own generator, so a seed gives other
  samples than the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, List, Optional

import numpy as np

from .analysis import _cv_on_numpy
from .tune import _final_loss
from .utils.enhanced import (
    MetadynamicsResult,
    _module_dtype,
    integrate_sde_metadynamics,
)
from .utils.sampling import integrate_sde_overdamped
from .utils.trajectory import WeightedTrajectory, concatenate_trajectories

__all__ = ["AdaptiveRound", "AdaptiveResult", "adaptive_cv_discovery"]


@dataclasses.dataclass
class AdaptiveRound:
    """Artifacts of one adaptive round.

    Attributes:
        index: round number (0 = unbiased bootstrap round).
        segment: this round's NEW data as a mean-one-weighted trajectory
            (uniform weights for round 0; metadynamics reweighting after).
        metad: the biased run that produced the segment (None for round 0).
        task: the task trained on the pooled data up to and including
            this round (as returned by ``make_task``, after ``train()``).
        cv_model: ``task.colvar_model()`` — the CV that drives the NEXT
            round's bias.
    """

    index: int
    segment: WeightedTrajectory
    metad: Optional[MetadynamicsResult]
    task: object
    cv_model: Callable


@dataclasses.dataclass
class AdaptiveResult:
    """Outcome of :func:`adaptive_cv_discovery`.

    Attributes:
        rounds: per-round artifacts, in order.
        pooled: the final pooled dataset (all segments,
            ``segment_starts`` marking round boundaries).
    """

    rounds: List[AdaptiveRound]
    pooled: WeightedTrajectory

    @property
    def cv_model(self) -> Callable:
        """The final trained CV."""
        return self.rounds[-1].cv_model

    @property
    def task(self):
        """The final trained task."""
        return self.rounds[-1].task

    def cv_range_per_round(self) -> np.ndarray:
        """[n_rounds, k] span (max - min) of each CV head over each
        round's new frames, evaluated with the FINAL CV — a cheap
        exploration signal: the range grows while biasing still
        discovers new states and plateaus once the landscape is
        covered."""
        cv = self.cv_model
        out = []
        for r in self.rounds:
            vals = _cv_on_numpy(cv, r.segment.trajectory)
            vals = vals.reshape(len(vals), -1)
            out.append(vals.max(axis=0) - vals.min(axis=0))
        return np.asarray(out)


def adaptive_cv_discovery(
    pot_obj,
    make_task: Callable,
    n_rounds: int = 3,
    X0: Optional[np.ndarray] = None,
    unbiased_steps: int = 100_000,
    metad_steps: int = 100_000,
    step_size: float = 0.01,
    frame_interval: int = 100,
    pre_steps: int = 0,
    hill_height: float = 0.3,
    hill_width: Optional[float] = None,
    bias_factor: Optional[float] = 10.0,
    reweight_method: str = "tiwary",
    pool_rounds: bool = True,
    warm_start: bool = False,
    bootstrap: str = "unbiased",
    remd_betas=None,
    output_path: Optional[str] = None,
    seed: int = 0,
    verbose: bool = True,
    device=None,
) -> AdaptiveResult:
    """Run the full adaptive sample/train/bias/retrain loop.

    Args:
        pot_obj: potential with the package SDE contract (``dim`` /
            ``beta`` / ``V``, optional ``gradV``), written in torch.
        make_task: ``make_task(traj, round_idx) -> task`` building a
            FRESH training task on the pooled data (any of the three
            task families). Called once per round; the task's
            ``lag_tau`` should equal a multiple of the pooled ``dt``
            (``step_size * frame_interval``).
        n_rounds: total rounds, including the unbiased bootstrap round
            (so ``n_rounds=1`` is plain train-on-unbiased-data).
        X0: initial state (defaults to a standard-normal draw).
        unbiased_steps: integrator steps of the round-0 unbiased run.
        metad_steps: integrator steps of each biased round.
        step_size: Euler–Maruyama step.
        frame_interval: steps between recorded frames AND between hill
            depositions — one value so every segment shares the same
            ``dt`` and the segments can be pooled.
        pre_steps: burn-in steps before the unbiased run.
        hill_height: metadynamics hill height (energy units of ``V``).
        hill_width: Gaussian hill width in CV units. Default: 0.35x the
            CV's standard deviation over the current pooled data,
            re-estimated each round (hills must be narrow relative to
            the CV's range to resolve basins).
        bias_factor: well-tempered gamma (> 1), or None for standard
            (non-tempered) metadynamics.
        reweight_method: ``'tiwary'`` (default) or ``'final-bias'`` —
            see :meth:`MetadynamicsResult.frame_weights`.
        pool_rounds: train round i on ALL segments 0..i (default).
            False trains each round only on its newest segment (the
            bootstrap segment for round 0).
        warm_start: initialize each round's model from the previous
            round's trained weights instead of ``make_task``'s fresh
            init (requires ``make_task`` to build the same architecture
            every round). The optimizer state always starts fresh.
        bootstrap: round-0 sampling strategy — ``'unbiased'`` (default:
            one chain at the target temperature) or ``'remd'`` (replica
            exchange: ``unbiased_steps`` per temperature slot, pooled
            with temperature-MBAR weights targeting ``pot_obj.beta``).
            Use ``'remd'`` when the target temperature cannot cross its
            own barriers — the round-0 CV then already sees every basin
            instead of relying on the metadynamics rounds to discover
            them.
        remd_betas: the ladder for ``bootstrap='remd'`` (default: four
            geometric rungs from ``pot_obj.beta`` down to
            ``pot_obj.beta / 8``).
        output_path: directory for sampler text outputs and per-round
            task model dirs your ``make_task`` may use; a temporary
            directory when omitted.
        seed: base seed; round r uses ``seed + r`` for its sampler.
        verbose: per-round progress lines.
        device: where the samplers run (port only): the card unless
            ``'cpu'``; ``make_task`` places its tasks itself, on the same
            device.

    Returns:
        :class:`AdaptiveResult` — final CV/task plus every per-round
        artifact.

    Biasing uses the FIRST CV head (multi-head models: the slowest
    mode under eigenvalue sorting). Retraining weights make the
    *stationary* statistics unbiased; time-lagged objectives over
    biased segments additionally assume the bias is quasi-static at
    the training lag (the standard well-tempered-reweighting caveat —
    prefer generator/AE objectives, a lag well under the deposition
    pace, or a final unbiased round when that matters).
    """
    if n_rounds < 1:
        raise ValueError("n_rounds must be >= 1")
    if output_path is None:
        output_path = tempfile.mkdtemp(prefix="cvf_adaptive_")
    os.makedirs(output_path, exist_ok=True)
    dt = step_size * frame_interval

    if bootstrap == "remd":
        from .utils.enhanced import integrate_sde_remd

        betas = (
            np.geomspace(pot_obj.beta, pot_obj.beta / 8.0, 4)
            if remd_betas is None
            else np.asarray(remd_betas, dtype=np.float64).reshape(-1)
        )
        if verbose:
            print(
                f"[adaptive] round 0: replica-exchange bootstrap "
                f"({len(betas)} slots x {unbiased_steps} steps, "
                f"betas {np.round(betas, 3)})"
            )
        res = integrate_sde_remd(
            pot_obj,
            betas,
            unbiased_steps,
            os.path.join(output_path, "round0"),
            X0=X0,
            pre_steps=pre_steps,
            step_size=step_size,
            report_interval=frame_interval,
            exchange_interval=10 * frame_interval,
            seed=seed,
            verbose=False,
            device=device,
        )
        if verbose:
            print(
                "[adaptive] round 0: pair acceptance "
                f"{np.round(res.pair_acceptance, 3)}"
            )
        segment = res.to_weighted_trajectory(sys_beta=float(pot_obj.beta))
        # restart point for the first biased round: the final frame of
        # the slot CLOSEST TO THE TARGET beta — the pooled segment is
        # slot-major, so its last frame belongs to the hottest slot (an
        # 8x-hotter configuration by default, a bad metadynamics start)
        cold = int(np.argmin(np.abs(betas - float(pot_obj.beta))))
        bootstrap_restart = np.asarray(res.frames[cold, -1], np.float64)
    elif bootstrap == "unbiased":
        if verbose:
            print(
                f"[adaptive] round 0: unbiased sampling "
                f"({unbiased_steps} steps)"
            )
        frames, _energies = integrate_sde_overdamped(
            pot_obj,
            unbiased_steps,
            os.path.join(output_path, "round0"),
            X0=X0,
            pre_steps=pre_steps,
            step_size=step_size,
            report_interval=frame_interval,
            seed=seed,
            verbose=False,
            device=device,
        )
        segment = WeightedTrajectory(
            trajectory=np.asarray(frames, dtype=np.float32),
            dt=dt,
            verbose=False,
        )
        bootstrap_restart = None
    else:
        raise ValueError(
            f"bootstrap must be 'unbiased' or 'remd', got {bootstrap!r}"
        )

    rounds: List[AdaptiveRound] = []
    segments: List[WeightedTrajectory] = [segment]
    metad: Optional[MetadynamicsResult] = None
    pooled = segment  # all segments so far, rebuilt once per append

    for r in range(n_rounds):
        if r > 0:
            cv_prev = rounds[-1].cv_model
            if hill_width is None:
                cv_vals = np.concatenate(
                    [
                        _cv_on_numpy(cv_prev, s.trajectory).reshape(
                            s.n_frames, -1
                        )[:, 0]
                        for s in segments
                    ]
                )
                width = max(0.35 * float(np.std(cv_vals)), 1e-3)
            else:
                width = hill_width
            if verbose:
                print(
                    f"[adaptive] round {r}: metadynamics along CV 1 "
                    f"({metad_steps} steps, hill width {width:.4g})"
                )

            def cv_head0(x, cv_prev=cv_prev,
                         dtype=_module_dtype(cv_prev)):
                # the chain batch [c, dim]: each row's first head, the
                # float32 chains in the CV's dtype
                xin = x if dtype is None else x.to(dtype)
                return cv_prev(xin).reshape(x.shape[0], -1)[:, :1]

            if r == 1 and bootstrap_restart is not None:
                start = bootstrap_restart
            else:
                start = segments[-1].trajectory[-1]
            metad = integrate_sde_metadynamics(
                pot_obj,
                cv_head0,
                n_steps=metad_steps,
                sampling_output_path=os.path.join(output_path, f"round{r}"),
                X0=np.asarray(start, dtype=np.float64),
                step_size=step_size,
                deposit_interval=frame_interval,
                hill_height=hill_height,
                hill_width=width,
                bias_factor=bias_factor,
                seed=seed + r,
                verbose=False,
                device=device,
            )
            w = metad.frame_weights(method=reweight_method)
            segment = WeightedTrajectory(
                trajectory=metad.frames.astype(np.float32),
                weights=w,
                dt=dt,
                verbose=False,
            )
            segments.append(segment)
            pooled = concatenate_trajectories(segments)

        data = pooled if pool_rounds else segments[-1]
        task = make_task(data, r)
        if warm_start and r > 0:
            # into the task's own tensors, with a fresh optimizer state
            task.model.load_state_dict(rounds[-1].task.model.state_dict())
            task.optimizer.state.clear()
        task.train()
        cv_model = task.colvar_model()
        if verbose:
            loss = _final_loss(task)
            print(
                f"[adaptive] round {r}: trained on {data.n_frames} frames "
                f"({len(segments)} segment(s)), final loss {loss:.5f}"
            )
        rounds.append(
            AdaptiveRound(
                index=r,
                segment=segments[-1],
                metad=metad if r > 0 else None,
                task=task,
                cv_model=cv_model,
            )
        )

    return AdaptiveResult(rounds=rounds, pooled=pooled)
