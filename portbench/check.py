"""The comparison that decides ``correct`` for a training cell.

The reference follows the program from the same seeded inputs (frames,
weights, split, initial parameters) and the numbers compared are, each the
worst judged replica's:

* ``loss``: the largest relative gap of a step's loss, over every step of
  every sequence the program reported (a solo cell: the eager first epoch
  and the replayed epochs, both from the seed), or of an epoch's mean train
  loss (a sweep);
* ``grad`` (solo cells): the worst leaf's gap between the norms of the
  program's and the reference's first gradient, over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
* ``change``: the median leaf's gap of the same kind for the parameters'
  change over the checked steps. Adam moves each element by about its
  learning rate whatever the size of its gradient, so the few elements
  whose gradient is near nought move as the rounding of that gradient
  decides, and one small leaf (the last hidden layer's bias) read 28 times
  the other seeds' worst on one seed of twelve;
* ``cv``: the trained CV as the program computes it (its preprocessing
  layer and heads, at the parameters it ended the checked steps with) on
  the first test batch, against the reference's CV at those same
  parameters in float64: the largest gap over frames and heads, over the
  reference's standard deviation of that head on the batch. Every other
  number is a mean over a batch of 20,000 frames, in which TF32's rounding
  averages away below float32's own error; this one is read frame by
  frame.

Both leave out leaves whose reference gradient is under a thousandth of the
median leaf's: a head's output bias, which the loss cannot see (it is
invariant to a shift of a head), has a gradient of round-off alone, and
moves under Adam by round-off alone.

A sweep judges ``loss`` and ``change`` on every replica but those on which
the reference itself, computed in float32 with TF32 off, parts from the
float64 reference by more than the workload's ``chaos`` level on a number:
there float32 rounding alone decides the trajectory, and no float32
program can follow float64 (``cv`` is judged at the program's own
parameters, on every replica).
How many were left out is compared too (``left_out``), so that the rule
cannot empty the check.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import numpy as np
import torch

#: a leaf whose first reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of ``grad`` and ``change``
STILL_LEAF = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep=None) -> torch.Tensor:
    """[L, R]: per leaf in ``keep`` (all by default) and replica,
    |‖p‖ - ‖r‖| / max(‖r‖, that replica's median leaf ‖r‖)."""
    names = [n for n in ref if keep is None or n in keep]
    rn = torch.stack([ref[n].flatten(1).norm(dim=1) for n in names])  # [L, R]
    pn = torch.stack([prog[n].reshape(rn.shape[1], -1).norm(dim=1)
                      for n in names])
    med = rn.median(dim=0).values
    return (pn - rn).abs() / torch.maximum(rn, med)


def still_leaves(grad1: dict) -> set:
    norms = {n: g.flatten(1).norm(dim=1) for n, g in grad1.items()}
    med = torch.stack(list(norms.values())).median(dim=0).values
    return {n for n, v in norms.items() if bool((v < STILL_LEAF * med).all())}


def follow_reference(cfg: dict, inputs, steps: int, lrs, alphas, device,
                     dtype=torch.float64, tf32: bool = False,
                     half: bool = False):
    """The reference's first ``steps`` steps from the seed, one replica per
    stack of heads in ``inputs``, with each replica's learning rate and
    alpha; ``tf32`` computes its float32 products in TF32 (the control)."""
    ref_mod = importlib.import_module(
        f"portbench.references.{cfg['reference']}")
    B = cfg["batch_size"]
    nb = len(inputs.train_idx) // B
    epoch = inputs.train_idx[: nb * B].reshape(nb, B)
    # every epoch takes its batches in the same order
    batches = [epoch[s % nb] for s in range(steps)]
    frames = torch.as_tensor(inputs.frames, device=device)
    weights = torch.as_tensor(inputs.weights, device=device)
    with _precision(ref_mod, tf32):
        return ref_mod.follow(cfg, frames, weights, inputs.ref, inputs.params,
                              batches, lrs, alphas, dtype=dtype, half=half)


@contextlib.contextmanager
def _precision(ref_mod, tf32: bool):
    """The reference's float32 products in TF32 (its operands rounded, the
    sums in float32) or in float32 within the block; torch's own TF32,
    which cuBLAS may or may not use for a given shape, stays off."""
    prev, prev_tf32 = torch.get_float32_matmul_precision(), ref_mod.TF32
    torch.set_float32_matmul_precision("highest")
    ref_mod.TF32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        ref_mod.TF32 = prev_tf32


def cv_frames(cfg: dict, inputs):
    """The frames the CV is read on: the first test batch."""
    return inputs.frames[inputs.test_idx[: cfg["batch_size"]]]


def reference_cv(cfg: dict, inputs, params: dict, device,
                 dtype=torch.float64, tf32: bool = False) -> torch.Tensor:
    """[R, k, B]: the reference's CV at the parameters ``params`` ({name:
    [R, ...]}) on :func:`cv_frames`, on the host."""
    ref_mod = importlib.import_module(
        f"portbench.references.{cfg['reference']}")
    n = len(cfg["layer_dims"]) - 1
    P = [(params[f"weights.{i}"].to(device, dtype),
          params[f"biases.{i}"].to(device, dtype)) for i in range(n)]
    x = torch.as_tensor(cv_frames(cfg, inputs), device=device).to(dtype)
    with _precision(ref_mod, tf32), torch.no_grad():
        return ref_mod.heads(P, ref_mod.features(
            x, inputs.ref.to(dtype))).double().cpu()


def _host(tensors: dict) -> dict:
    return {n: t.double().cpu() for n, t in tensors.items()}


def per_replica(readings: dict, reference, cv_ref=None) -> tuple:
    """``({number: [R]}, {number: [L, R] leaf gaps})``: every compared
    number of the program's ``readings`` against the reference's
    ``(losses [steps, R], grad1, change, params)`` and, for ``cv``, its CV
    ``cv_ref`` [R, k, B] at the program's parameters, per replica, and the
    per-leaf gaps behind ``grad`` (its worst leaf) and ``change`` (its
    median leaf)."""
    r_loss, r_grad, r_change = reference[:3]
    r_loss = r_loss.double().cpu()
    r_grad = _host(r_grad)
    moving = [n for n in r_grad if n not in still_leaves(r_grad)]
    if "epoch_losses" in readings:
        p = torch.as_tensor(np.asarray(readings["epoch_losses"], np.float64))
        r = r_loss.reshape(p.shape[0], -1, r_loss.shape[1]).mean(1)
        loss = ((p - r).abs() / r.abs()).max(dim=0).values
    else:
        gaps = []
        for seq in readings["losses"]:
            p = torch.as_tensor(np.asarray(seq, np.float64))
            p = p.reshape(p.shape[0], -1)
            r = r_loss[: p.shape[0]]
            gaps.append(((p - r).abs() / r.abs()).max(dim=0).values)
        loss = torch.stack(gaps).max(dim=0).values
    numbers, leaves = {"loss": loss}, {}
    for name, prog, ref in (("grad", readings.get("grad1"), r_grad),
                            ("change", readings.get("change"), r_change)):
        if prog is None:
            continue
        g = leaf_gaps(prog, _host(ref), moving)  # [L, R]
        numbers[name] = (g.max(dim=0).values if name == "grad"
                         else g.median(dim=0).values)
        leaves[name] = dict(zip(moving, g.unbind(0)))
    if cv_ref is not None and "cv" in readings:
        gap = (readings["cv"].double() - cv_ref).abs()
        numbers["cv"] = (gap / cv_ref.std(dim=2, keepdim=True)).amax(
            dim=(1, 2))
    return numbers, leaves


def numbers_of(cfg: dict, inputs, readings: dict, reference, device):
    """:func:`per_replica` with the reference's CV at the parameters that
    ``readings`` ended with."""
    cv_ref = (reference_cv(cfg, inputs, readings["params"], device)
              if "cv" in readings else None)
    return per_replica(readings, reference, cv_ref)


def _finite(v) -> float:
    v = float(v)
    return v if math.isfinite(v) else float("inf")


def worst(numbers: dict, judged: torch.Tensor | None = None,
          only=None) -> dict:
    """Each number's worst replica: over the ``judged`` ones (all by
    default) for the numbers in ``only`` (every number by default), over
    all for the others. A NaN or a replica set left empty reads infinite."""
    out = {}
    for k, v in numbers.items():
        if judged is not None and (only is None or k in only):
            v = v[judged]
        out[k] = _finite(v.max()) if v.numel() else float("inf")
    return out


def chaotic(numbers32: dict, levels: dict) -> torch.Tensor:
    """[R] bool: the replicas on which the float32 reference's
    ``numbers32`` exceed the ``chaos`` level of some number."""
    out = None
    for k, level in levels.items():
        v = numbers32[k].nan_to_num(nan=float("inf")) > level
        out = v if out is None else out | v
    return out


def reference_readings(reference, epochs: int | None = None,
                       cv=None) -> dict:
    """The reference's own output in the form of a program's readings: the
    control (the reference in lower precision), a planted fault and the
    float32 reference of a sweep's chaos rule are judged as the program is.
    ``epochs`` gives a sweep's form: each epoch's mean train loss; ``cv``
    the CV [R, k, B] that the reference in the program's place computed at
    its own final parameters."""
    losses, grad1, change, final = reference
    losses = losses.double().cpu()
    out = {"grad1": _host(grad1), "change": _host(change),
           "params": _host(final)}
    if cv is not None:
        out["cv"] = cv
    if epochs is None:
        out["losses"] = [losses.numpy()]
    else:
        out["epoch_losses"] = losses.reshape(epochs, -1,
                                             losses.shape[1]).mean(1).numpy()
        del out["grad1"]
    return out


def judge(cfg: dict, wl: dict, plan: tuple, inputs, readings: dict,
          device) -> tuple:
    """``(numbers, log lines)``: the compared numbers of ``readings``
    against the float64 reference, over the judged replicas; with the
    workload's ``chaos`` levels, ``left_out`` too."""
    reference = follow_reference(cfg, inputs, *plan, device)
    nums, leaves = numbers_of(cfg, inputs, readings, reference, device)
    judged, lines = None, []
    levels = wl["checks"].get("chaos")
    if levels:
        ref32 = follow_reference(cfg, inputs, *plan, device,
                                 dtype=torch.float32)
        n32, _ = per_replica(
            reference_readings(ref32, int(wl["epochs_per_call"])), reference)
        del ref32
        out = chaotic(n32, levels)
        judged = ~out
        lines.append("left out (float32 reference past the chaos level): "
                     + str(torch.nonzero(out).flatten().tolist()))
    result = worst(nums, judged, levels)
    if levels:
        result["left_out"] = int((~judged).sum())
    for name, gaps in leaves.items():
        lines.append(f"{name} gap by leaf: " + ", ".join(
            f"{n} {v:.3g}" for n, v in worst(gaps, judged).items()))
    return result, lines
