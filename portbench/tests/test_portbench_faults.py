"""Whole runs on the CPU at a small size, the look for a card skipped: a
sound run comes out correct, and a run whose timed path is broken
underneath comes out not correct, for each fault a training cell can have
on one card: a step that leaves the state unchanged, half of each batch
left out (the mean taken over the rest), and, in a sweep, half of the
replicas left unchanged."""

import time

import pytest
import torch

from colvarsfinder_tpu_torch.core.eigenfunction import EigenFunctionTask
from colvarsfinder_tpu_torch.parallel import ensemble
from portbench import harness

from cells import small

SOLO = ["ala2_transfer.fused", "ala2_transfer.plain", "ala2_generator.gram"]
SWEEP = "ala2_transfer.sweep64"
CELLS = SOLO + [SWEEP]


def run(cell):
    wl, cfg = small(cell)
    return harness.run(cell, cfg, wl, 1, "cpu", 2**31 + 12345, 0.1, False,
                       time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    def no_update(self):
        for p in self.model.parameters():
            p.grad.zero_()

    monkeypatch.setattr(EigenFunctionTask, "_before_step", no_update)
    monkeypatch.setattr(ensemble._ReplicaOptimizer, "step",
                        lambda self: None)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_caught(cell, monkeypatch):
    metrics = EigenFunctionTask._batch_metrics
    inputs = EigenFunctionTask._replica_inputs

    def halve(tensors):
        return [t[: t.shape[0] // 2] if torch.is_tensor(t) else t
                for t in tensors]

    monkeypatch.setattr(EigenFunctionTask, "_batch_metrics",
                        lambda self, *b: metrics(self, *halve(b)))
    monkeypatch.setattr(EigenFunctionTask, "_replica_inputs",
                        lambda self, b: tuple(halve(inputs(self, b))))
    out = run(cell)
    assert not out["correct"], out["checks"]


def test_half_the_replicas_unchanged_is_caught(monkeypatch):
    step = ensemble._ReplicaOptimizer.step

    @torch.no_grad()
    def half_step(self):
        keep = [p[p.shape[0] // 2:].clone() for p in self.params]
        step(self)
        for p, k in zip(self.params, keep):
            p[p.shape[0] // 2:] = k

    monkeypatch.setattr(ensemble._ReplicaOptimizer, "step", half_step)
    out = run(SWEEP)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change"]["value"] > 0.5
