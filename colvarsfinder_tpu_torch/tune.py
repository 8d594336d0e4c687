"""Per-workload autotuning of the framework's performance knobs.

The optimal configuration (matmul precision, activation compute dtype,
data layout, Gram generator path, fused kernels) depends on the model
width, batch size, loss family, and the host<->device link — the
defaults encode the best configuration for the headline dipeptide-scale
workload, but a user's workload may sit elsewhere on the
latency/bandwidth/FLOP tradeoff. ``autotune`` measures candidate
configurations ON the user's actual task and reports the ranking.

Methodology (see docs/performance.md "remote backends"): every variant
is compiled and warmed first, then the timed repetitions are
*interleaved round-robin in one process* — sequential per-variant
timing is unreliable on tunneled/shared backends where throughput
drifts between runs. The best (minimum) wall time per variant over
``reps`` repetitions is used.

Usage::

    from colvarsfinder_tpu_torch.tune import autotune

    def factory(**overrides):
        return EigenFunctionTask(traj, pp, model_init(), path,
                                 num_epochs=12, verbose=False,
                                 save_model_every_step=0, **overrides)

    results = autotune(factory)        # default knob grid
    best = results[0]
    best.apply_config()                # set config knobs for the winner
    task = factory(**best.ctor_overrides)

The factory MUST build a fresh task (and fresh model) per call: tasks
cache prepared device data and trained state. Config-level knobs
('matmul_precision', 'compute_dtype') are applied around BOTH
construction and every ``train()`` call, because they are read at trace
time and are part of the compiled-program cache keys.

The port (``colvarsfinder_tpu/tune.py``): the config-level knobs are the
port's :mod:`.config` — ``matmul_precision`` switches cuBLAS's and
cuDNN's TF32 (``'default'`` allows it, ``'highest'`` keeps full float32),
``compute_dtype`` and ``bf16_style`` the networks' bfloat16 mode. The
kernels are chosen through the factory: ``fused_step=True`` runs K2's
alignment, K3 and K4 (with a ``FusedAlignmentLayer``), an
``AlignmentLayer(method='cuda')`` K1. A task on a card is timed after
``torch.cuda.synchronize``. The final loss is read from
``task.train_loss`` at the column ``'loss'`` of ``task.loss_names``, so
no pandas is needed. A variant that raises is skipped and its exception
logged in full, as in the JAX module; nothing swaps in a plain version for
a kernel that fails to build or launch. Each variant's knobs are applied
over the caller's settings, so none carries over into the next variant
(the JAX loop leaves an earlier variant's knob set for the later ones).
"""

from __future__ import annotations

import time
import traceback
from typing import NamedTuple, Sequence

import torch

from . import config

__all__ = ["autotune", "TuneResult", "DEFAULT_VARIANTS"]

#: config-level override keys (everything else goes to the factory)
_CONFIG_KEYS = ("matmul_precision", "compute_dtype", "bf16_style")

#: the standard knob grid: baseline, fast matmuls, bf16 activations,
#: and both combined. Constructor-level knobs (prebatch, gram_pp,
#: fused_step) default to auto/measured-best already; add them to
#: ``variants`` explicitly when tuning an unusual workload.
DEFAULT_VARIANTS: tuple = (
    {},
    {"matmul_precision": "default"},
    {"compute_dtype": "bfloat16"},
    {"matmul_precision": "default", "compute_dtype": "bfloat16"},
)


class TuneResult(NamedTuple):
    """One variant's outcome, in ranking order (fastest first)."""

    overrides: dict          #: the full variant dict as given
    ctor_overrides: dict     #: the subset to pass to the task factory
    config_overrides: dict   #: the subset applied via ``config``
    best_seconds: float      #: min wall time of one ``train()`` call
    speedup: float           #: baseline variant time / this time
    final_train_loss: float  #: last train loss (numerics sanity signal)

    def apply_config(self) -> None:
        """Apply this variant's config-level knobs globally."""
        _apply_config(self.config_overrides)


def _split(overrides: dict) -> tuple[dict, dict]:
    cfg = {k: v for k, v in overrides.items() if k in _CONFIG_KEYS}
    ctor = {k: v for k, v in overrides.items() if k not in _CONFIG_KEYS}
    return cfg, ctor


def _apply_config(cfg: dict) -> None:
    if "matmul_precision" in cfg:
        config.set_matmul_precision(cfg["matmul_precision"])
    if "compute_dtype" in cfg:
        config.set_compute_dtype(cfg["compute_dtype"])
    if "bf16_style" in cfg:
        config.set_bf16_style(cfg["bf16_style"])


def _train_seconds(task) -> float:
    """Wall seconds of one ``task.train()``, to the end of the card's work
    when the task trains on a card."""
    dev = getattr(task, "device", None)
    on_card = isinstance(dev, torch.device) and dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    task.train()
    if on_card:
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _final_loss(task) -> float:
    """The last epoch's mean train loss, from the task's arrays."""
    return float(task.train_loss[-1, list(task.loss_names).index("loss")])


def autotune(
    task_factory,
    variants: Sequence[dict] = DEFAULT_VARIANTS,
    *,
    reps: int = 3,
    verbose: bool = True,
) -> list[TuneResult]:
    """Measure ``variants`` on the user's task; return the ranking.

    Args:
        task_factory: callable building a FRESH task; called once per
            variant with that variant's constructor-level overrides.
        variants: dicts mixing config-level knobs ('matmul_precision',
            'compute_dtype') and task constructor overrides (e.g.
            ``prebatch``, ``gram_pp``, ``fused_step``). The FIRST
            variant is the speedup baseline.
        reps: timed repetitions per variant (interleaved round-robin;
            min is reported). One extra warmup/compile call per variant
            is excluded from timing.
        verbose: print a one-line result per measurement.

    Returns:
        ``TuneResult`` list sorted fastest-first. Each ``train()`` call
        runs the task's full ``num_epochs`` — keep it modest (e.g. 12)
        in the factory; ranking, not absolute throughput, is the goal.
    """
    variants = [dict(v) for v in variants]
    # the caller's settings: every variant starts from them, so no knob of
    # one variant carries over into the next (the JAX loop lets it: after
    # {"compute_dtype": "bfloat16"} its later variants, and the baseline's
    # timed calls, ran in bf16)
    caller = {"matmul_precision": config.matmul_precision(),
              "compute_dtype": config.compute_dtype_name(),
              "bf16_style": config.bf16_style()}

    def _use(cfg):
        _apply_config({**caller, **cfg})

    def _log(*a):
        if verbose:
            print("[autotune]", *a, flush=True)

    entries = []  # (overrides, cfg, ctor, task, best_s, last_loss)
    try:
        for i, ov in enumerate(variants):
            cfg, ctor = _split(ov)
            _use(cfg)
            try:
                task = task_factory(**ctor)
                # build, capture and warm up (excluded from timing)
                warm_s = _train_seconds(task)
            except Exception as e:  # noqa: BLE001 — a variant may be
                # unsupported for this workload (e.g. fused_step's shape
                # caps); skip it rather than losing the whole tune. The
                # baseline variant must work: it defines the speedup
                # reference and a broken baseline means the factory
                # itself is broken.
                if i == 0:
                    raise
                _log(f"{ov}: SKIPPED ({type(e).__name__}: {e})")
                _log("".join(traceback.format_exception(e)))
                continue
            _log(f"{ov or '{baseline}'}: compiled+warm in {warm_s:.1f}s")
            entries.append([ov, cfg, ctor, task, float("inf"), float("nan")])

        for rep in range(reps):
            for e in entries:
                ov, cfg, _, task, best, _ = e
                # re-apply per call: the knobs are trace-time state and
                # part of the captured epochs' keys
                _use(cfg)
                dt = _train_seconds(task)
                e[4] = min(best, dt)
                e[5] = _final_loss(task)
                _log(f"rep{rep} {ov or '{baseline}'}: {dt:.3f}s "
                     f"(loss {e[5]:.6f})")
    finally:
        _apply_config(caller)

    base_s = entries[0][4]
    results = [
        TuneResult(
            overrides=ov, ctor_overrides=ctor, config_overrides=cfg,
            best_seconds=best, speedup=base_s / best,
            final_train_loss=loss,
        )
        for ov, cfg, ctor, _, best, loss in entries
    ]
    results.sort(key=lambda r: r.best_seconds)
    if verbose:
        for r in results:
            print(f"[autotune] {r.speedup:5.2f}x  {r.best_seconds:.3f}s  "
                  f"loss {r.final_train_loss:.6f}  {r.overrides or '{baseline}'}",
                  flush=True)
    return results
