"""PyTorch port, the span recorder (``logging_utils``): nesting, parent and
call ids, the ring's bound, tracing off; the spans of a small training run,
of a sweep and of a ``torch.profiler`` trace on the CPU; the benchmark's
readers of them (``portbench/metrics``) on span lists made by hand."""

import glob
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from colvarsfinder_tpu_torch import (
    AlignmentLayer,
    EigenFunctions,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    WeightedTrajectory,
    logging_utils,
)
from colvarsfinder_tpu_torch.logging_utils import (
    Recorder,
    reset_trace,
    set_tracing,
    span,
    spans,
)
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.parallel import ensemble, train_hyperparameter_sweep

N_FRAMES, N_ATOMS = 240, 4


@pytest.fixture(autouse=True)
def _fresh():
    """Each test starts from an empty recorder, with tracing on."""
    prev = set_tracing(True)
    reset_trace()
    yield
    set_tracing(prev)
    reset_trace()


def _task(path, **kw):
    """A small transfer-operator task on the CPU: 3 epochs of 4 train and 1
    test batch, a progress event after every epoch."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, N_FRAMES)
    traj = WeightedTrajectory(trajectory=x, weights=w, dt=0.01, verbose=False)
    atoms = list(range(N_ATOMS))
    pp = PreprocessingANN(AlignmentLayer(x[0], atoms),
                          FeatureLayer([Feature("p", "position", atoms)]))
    args = dict(alpha=8.0, eig_weights=[1.0, 0.5], lag_tau=0.02, k=2,
                learning_rate=0.005, batch_size=45, num_epochs=3,
                test_ratio=0.2, verbose=False, tensorboard=False, seed=0,
                debug_mode=False, save_model_every_step=0, export_cv=False,
                progress_interval=1, device="cpu")
    args.update(kw)
    return EigenFunctionTask(traj, pp, EigenFunctions([12, 6, 1], 2, seed=0),
                             str(path), **args)


def by_name(recorded, name):
    return [s for s in recorded if s.name == name]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_spans_nest_with_parent_and_call_ids():
    with span("outer", a=1) as outer:
        with span("inner") as inner:
            with span("leaf", replay=True) as leaf:
                pass
        with span("second") as second:
            pass
    with span("next call") as other:
        pass
    got = spans()
    # in the order they ended
    assert [s.name for s in got] == ["leaf", "inner", "second", "outer",
                                     "next call"]
    assert outer.parent is None and outer.call == outer.id
    assert inner.parent == outer.id and leaf.parent == inner.id
    assert second.parent == outer.id
    assert {s.call for s in (outer, inner, leaf, second)} == {outer.id}
    assert other.call == other.id != outer.id
    assert leaf.attrs == {"replay": True} and outer.attrs == {"a": 1}
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns
    assert leaf.end_ns <= inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    assert outer.seconds == (outer.end_ns - outer.start_ns) * 1e-9 > 0
    assert not any(s.profiled for s in got)


def test_the_ring_drops_the_oldest_and_counts_them():
    assert logging_utils.SPAN_CAPACITY == 65536
    rec = Recorder(capacity=4)
    for i in range(6):
        with rec.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in rec.spans()] == [2, 3, 4, 5]
    assert rec.counters() == {"cvf.trace.dropped": 2}
    rec.count("c", 3)
    rec.count("c")
    assert rec.counters()["c"] == 4
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {}


def test_tracing_off_records_nothing(tmp_path):
    assert set_tracing(False) is True
    with span("a") as a, span("b") as b:
        pass
    assert a is b  # one shared context
    assert np.isnan(a.seconds)
    logging_utils.count("c")
    task = _task(tmp_path)
    task.train()
    assert spans() == [] and logging_utils.counters() == {}
    # the recorder times epoch_times: off, they read nan, one per epoch
    assert len(task.epoch_times) == 3 and np.isnan(task.epoch_times).all()
    assert np.isfinite(task.train_loss).all()
    assert set_tracing(True) is False


def test_launch_counts_are_counters():
    _cuda.reset_launch_counts()
    _cuda.LAUNCHES["stats_fwd"] += 2
    logging_utils.count(_cuda.COUNTER + "fused_align", 3)
    assert _cuda.launch_counts() == {"kabsch_qcp": 0, "fused_align": 3,
                                     "stats_fwd": 2, "stats_bwd": 0,
                                     "pair_distances": 0, "kabsch_exact": 0}
    assert logging_utils.counters()["cvf.kernel.launches.stats_fwd"] == 2
    _cuda.reset_launch_counts()
    assert dict(_cuda.LAUNCHES) == dict.fromkeys(_cuda.KERNELS, 0)


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------


def test_a_training_run_records_its_phases(tmp_path):
    task = _task(tmp_path)
    init, = by_name(spans(), "cvf.task.init")
    assert init.attrs == {"task": "EigenFunctionTask"} and init.parent is None
    reset_trace()
    task.train()
    got = spans()
    train, = by_name(got, "cvf.task.train")
    prepare, = by_name(got, "cvf.task.prepare")
    chunks = by_name(got, "cvf.epoch.chunk")
    issues = by_name(got, "cvf.epoch.issue")
    fetches = by_name(got, "cvf.epoch.fetch")
    records = by_name(got, "cvf.epoch.record")
    assert len(chunks) == len(issues) == len(fetches) == len(records) == 3
    assert {s.call for s in got} == {train.id}
    assert prepare.parent == train.id
    assert [s.attrs["epoch"] for s in issues] == [0, 1, 2]
    assert not any(s.attrs["replay"] for s in issues)  # the CPU: eager
    for c, i, f in zip(chunks, issues, fetches):
        assert i.parent == f.parent == c.id
        assert c.start_ns <= i.start_ns < i.end_ns <= f.start_ns
        assert f.end_ns <= c.end_ns
    assert not by_name(got, "cvf.graph.capture")  # nothing is captured
    # epoch_times are the chunk spans' durations, one epoch a chunk
    assert task.epoch_times == [c.seconds for c in chunks]
    # a second call prepares nothing: the batches are kept
    reset_trace()
    task.train()
    assert not by_name(spans(), "cvf.task.prepare")
    assert len(by_name(spans(), "cvf.task.train")) == 1


def test_a_sweep_records_its_host_phases(tmp_path):
    task = _task(tmp_path, num_epochs=2)
    reset_trace()
    res = train_hyperparameter_sweep(
        task, {"learning_rate": [1e-3, 4e-3], "alpha": [4.0, 8.0]})
    assert len(res) == 2
    got = spans()
    call, = by_name(got, "cvf.sweep.call")
    load, = by_name(got, "cvf.sweep.load")
    run, = by_name(got, "cvf.sweep.run")
    unpack, = by_name(got, "cvf.sweep.unpack")
    assert {s.call for s in got} == {call.id}
    assert load.parent == run.parent == unpack.parent == call.id
    assert load.end_ns <= run.start_ns and run.end_ns <= unpack.start_ns
    assert run.attrs == {"epochs": 2}
    assert ensemble.last_run_seconds == run.seconds > 0
    ensemble.release_sweeps()


@pytest.mark.parametrize("how", ["profile_dir", "session"])
def test_a_profiler_trace_holds_the_spans(tmp_path, how):
    """Spans opened while a ``torch.profiler`` session records are flagged
    ``profiled`` and appear in its chrome trace as ``user_annotation``
    events, one each."""
    from torch.profiler import ProfilerActivity, profile

    task = _task(tmp_path / "run", num_epochs=2)
    reset_trace()
    if how == "profile_dir":
        task.profile_dir = str(tmp_path / "prof")
        task.train()
        path, = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    else:
        path = str(tmp_path / "trace.json")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            task.train()
        prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("cvf."))
    got = spans()
    assert all(s.profiled for s in got)
    assert names == sorted(s.name for s in got)
    assert names.count("cvf.epoch.issue") == 2
    assert "cvf.task.train" in names and "cvf.task.prepare" in names
    # after the session spans are not profiled
    reset_trace()
    with span("after"):
        pass
    assert not spans()[0].profiled


# ---------------------------------------------------------------------------
# the benchmark's readers, on span lists made by hand
# ---------------------------------------------------------------------------

_ids = iter(range(1, 10**6))


def S(name, start_us, end_us, call=1, profiled=False, **attrs):
    return SimpleNamespace(name=name, start_ns=int(start_us * 1e3),
                           end_ns=int(end_us * 1e3), id=next(_ids),
                           parent=None, call=call, profiled=profiled,
                           attrs=attrs)


def solo_spans():
    """Set-up (construction, preparation, one capturing epoch), then two
    calls of replayed epochs, and a profiled call that must not count."""
    out = [S("cvf.task.init", 0, 2e6, call=1),
           S("cvf.task.prepare", 3e6, 3.5e6, call=2),
           S("cvf.epoch.issue", 4e6, 5e6, call=2, replay=False),
           S("cvf.graph.capture", 4e6, 5e6, call=2),
           S("cvf.epoch.fetch", 5e6, 5.01e6, call=2)]
    t = 6e6
    for call in (3, 4):
        for _ in range(4):
            out += [S("cvf.epoch.issue", t, t + 100, call=call, replay=True),
                    S("cvf.epoch.fetch", t + 100, t + 15000, call=call)]
            t += 15040  # 40 us from a fetch's end to the next launch
        t += 1e6  # between calls: no pair
    out += [S("cvf.epoch.issue", t, t + 900, call=5, replay=True,
              profiled=True),
            S("cvf.epoch.fetch", t + 900, t + 20000, call=5, profiled=True),
            S("cvf.epoch.issue", t + 21000, t + 22000, call=5, replay=True,
              profiled=True),
            S("cvf.graph.capture", t + 30000, t + 40000, call=5,
              profiled=True)]
    return out


def sweep_spans():
    out = [S("cvf.task.init", 0, 1e6, call=1)]
    t = 2e6
    for call, capture in ((2, True), (3, False), (4, False), (5, False)):
        out.append(S("cvf.sweep.load", t, t + 3000 * call, call=call))
        if capture:
            out.append(S("cvf.graph.capture", t + 1e4, t + 5e6, call=call))
        out.append(S("cvf.sweep.run", t + 5e6, t + 6e6, call=call))
        out.append(S("cvf.sweep.unpack", t + 6e6, t + 6e6 + 1000, call=call))
        t += 1e7
    return out


def test_readers_on_hand_made_spans():
    from portbench.metrics import (
        between_epochs_us,
        capture_s,
        construct_s,
        epoch_issue_ms_p95,
        graph_captures,
        prepare_s,
        sweep_host_ms,
    )

    solo, sweep = solo_spans(), sweep_spans()
    assert construct_s.value(solo) == pytest.approx(2.0)
    assert prepare_s.value(solo) == pytest.approx(0.5)
    assert capture_s.value(solo) == pytest.approx(1.0)  # unprofiled only
    assert graph_captures.value(solo) == 2.0  # the profiled one counts
    assert epoch_issue_ms_p95.value(solo) == pytest.approx(0.1)
    assert between_epochs_us.value(solo) == pytest.approx(40.0)
    # the sweep's calls after the capturing one: 9, 12 and 15 ms of load,
    # 1 ms of unpack each
    assert sweep_host_ms.value(sweep) == pytest.approx(13.0)
    assert construct_s.value(sweep) == pytest.approx(1.0)
    assert graph_captures.value(sweep) == 1.0
    # outside their cells they find nothing to read
    assert epoch_issue_ms_p95.value(sweep) is None
    assert between_epochs_us.value(sweep) is None
    assert sweep_host_ms.value(solo) is None
    assert prepare_s.value(sweep) is None


def test_readers_read_the_recorder_and_a_program_without_one(tmp_path,
                                                              monkeypatch):
    from portbench.metrics import _spans, construct_s, prepare_s

    _task(tmp_path).train()
    got = spans()
    assert construct_s.read(None) == pytest.approx(
        by_name(got, "cvf.task.init")[0].seconds)
    assert prepare_s.read(None) > 0
    # a program before the recorder: the readers read nothing, and raise
    # nothing
    monkeypatch.delattr(logging_utils, "spans")
    assert _spans.recorded() is None
    assert construct_s.read(None) is None
