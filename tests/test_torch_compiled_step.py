"""PyTorch port, the compiled training program on the CPU: the epoch body
that the card captures as a CUDA graph, run eagerly here, against the JAX
package's curves for every chunking of the epochs; the launch accounting of
captures and replays and the holder of graphs (``graphs.py``); the package's
import layers around it; the events that drop a captured epoch; profile_dir
and release_device_data. The card's side (capture, replay, graph against
eager) is in tests/test_torch_cuda.py."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_eigenfunction_task import (  # noqa: F401  (fixture reuse)
    COMMON,
    DIMS,
    DT,
    K,
    N_ATOMS,
    _one_thread,
    _port_task,
    _trajectory,
    jax_run,
)

from colvarsfinder_tpu_torch import (
    AlignmentLayer,
    EigenFunctions,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    WeightedTrajectory,
)
from colvarsfinder_tpu_torch.config import (
    default_dtype,
    matmul_precision,
    set_default_dtype,
    set_matmul_precision,
)
from colvarsfinder_tpu_torch import graphs
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops.features import Identity


@pytest.mark.parametrize("progress_interval", [0, 1, 3])
@pytest.mark.parametrize(
    "fused,rtol_loss,rtol_eig",
    # the tolerances of test_training_curves_match_jax: f32 rounding only
    # for the plain step, the JAX package's fused-vs-plain bar for the fused
    [(False, 1e-4, 1e-4), (True, 2e-3, 5e-3)],
)
def test_epoch_body_gives_jax_curves(jax_run, tmp_path, fused, rtol_loss,
                                     rtol_eig, progress_interval):
    """4 epochs in one chunk, in chunks of 1, or of 3 and 1: the JAX
    curves each time, and the same bits as one chunk."""
    runs = {}
    for interval in {0, progress_interval}:
        _cuda.reset_launch_counts()
        task = _port_task(jax_run, tmp_path / str(interval), fused,
                          split_indices=jax_run["split"],
                          progress_interval=interval)
        task.train()
        assert sum(_cuda.launch_counts().values()) == 0  # CPU: no kernel
        assert not task._graphs  # nothing is captured on the CPU
        assert len(task.epoch_times) == len(task.loss_list) == 4
        runs[interval] = task
    task = runs[progress_interval]
    for got, want in ((task.train_loss, jax_run["loss"]),
                      (task.test_loss, jax_run["test"])):
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=rtol_loss)
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=rtol_eig)
    np.testing.assert_array_equal(task._cvec, jax_run["cvec"])
    one_chunk = runs[0]
    np.testing.assert_array_equal(task.train_loss, one_chunk.train_loss)
    np.testing.assert_array_equal(task.test_loss, one_chunk.test_loss)
    for (tr, te), (tr0, te0) in zip(task.loss_list, one_chunk.loss_list):
        np.testing.assert_array_equal(tr, tr0)
        np.testing.assert_array_equal(te, te0)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_capture_takes_back_its_launches_and_each_replay_adds_them():
    _cuda.reset_launch_counts()
    _cuda.LAUNCHES["fused_align"] = 7
    with graphs.held_counts() as held:
        # what the wrappers count while a step is captured
        _cuda.LAUNCHES["fused_align"] += 2
        _cuda.LAUNCHES["stats_fwd"] += 1
        _cuda.LAUNCHES["stats_bwd"] += 1
    assert held == {"kabsch_qcp": 0, "fused_align": 2, "stats_fwd": 1,
                    "stats_bwd": 1, "pair_distances": 0, "kabsch_exact": 0}
    # the capture ran nothing
    assert _cuda.launch_counts() == {"kabsch_qcp": 0, "fused_align": 7,
                                     "stats_fwd": 0, "stats_bwd": 0,
                                     "pair_distances": 0, "kabsch_exact": 0}
    graph = _FakeGraph()
    for _ in range(3):
        graphs.replay(graph, held)
    assert graph.replays == 3
    assert _cuda.launch_counts() == {"kabsch_qcp": 0, "fused_align": 13,
                                     "stats_fwd": 3, "stats_bwd": 3,
                                     "pair_distances": 0, "kabsch_exact": 0}
    _cuda.reset_launch_counts()


def test_a_capture_carries_the_heads_counts_into_each_replay():
    """Counters other than the launches (the stacked heads' split and whole
    layer products, counted in Python while a step is captured) are held
    under their full names, taken back out, and added by every replay."""
    from colvarsfinder_tpu_torch import logging_utils

    logging_utils.reset_trace()
    logging_utils.count("cvf.heads.whole", 4)
    with graphs.held_counts() as held:
        logging_utils.count("cvf.heads.split", 8)
        logging_utils.count("cvf.heads.whole", 4)
        _cuda.LAUNCHES["fused_align"] += 1
    assert held == {"kabsch_qcp": 0, "fused_align": 1, "stats_fwd": 0,
                    "stats_bwd": 0, "pair_distances": 0, "kabsch_exact": 0,
                    "cvf.heads.split": 8, "cvf.heads.whole": 4}
    got = logging_utils.counters()
    assert got["cvf.heads.split"] == 0 and got["cvf.heads.whole"] == 4
    assert sum(_cuda.launch_counts().values()) == 0
    graph = _FakeGraph()
    for _ in range(3):
        graphs.replay(graph, held)
    got = logging_utils.counters()
    assert got["cvf.heads.split"] == 24 and got["cvf.heads.whole"] == 16
    assert _cuda.launch_counts()["fused_align"] == 3
    logging_utils.reset_trace()


def test_a_failed_capture_counts_nothing():
    _cuda.reset_launch_counts()
    with pytest.raises(RuntimeError, match="capturing"):
        with graphs.held_counts() as held:
            _cuda.LAUNCHES["kabsch_qcp"] += 2
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    assert held["kabsch_qcp"] == 2
    assert sum(_cuda.launch_counts().values()) == 0


def test_a_holder_captures_each_kind_once_and_drops_every_kind_when_stale(
        monkeypatch):
    """A holder of graphs on the card, with a stubbed capture: one capture
    per kind; each replay adds the counts its graph holds; a changed key
    drops every kind; inside graphs.eager() the body runs every time."""
    from colvarsfinder_tpu_torch import logging_utils

    def capture(body, device, key_fn, what):
        body()  # the eager run
        key, held = key_fn()
        with graphs.held_counts() as launches:
            body()
        return graphs.Captured(_FakeGraph(), launches, key, held)

    monkeypatch.setattr(graphs, "capture", capture)
    logging_utils.reset_trace()
    key, runs = [0], {"train": 0, "test": 0}

    def body(kind):
        runs[kind] += 1
        _cuda.LAUNCHES["fused_align"] += 2
        logging_utils.count("cvf.heads.split", 3)

    holder = graphs.Graphs(torch.device("cuda"), lambda: (key[0], []))
    assert graphs.Graphs(torch.device("cpu")).mode("train") == "eager"
    assert holder.mode(None) == "eager"  # a kind of None is never captured
    assert holder.mode("train") == "capture"
    for _ in range(3):
        for kind in runs:
            holder.run(kind, lambda kind=kind: body(kind))
    assert sorted(holder) == ["test", "train"]
    assert holder.mode("train") == "replay"
    assert runs == {"train": 2, "test": 2}  # the eager run and the capture
    assert [holder[k].graph.replays for k in runs] == [2, 2]
    # three epochs of each kind: the eager one and two replays
    assert _cuda.launch_counts()["fused_align"] == 2 * 3 * 2
    assert logging_utils.counters()["cvf.heads.split"] == 3 * 3 * 2
    assert not holder.check() and len(holder) == 2
    key[0] = 1
    assert holder.check() and not holder
    with graphs.eager():
        assert holder.mode("train") == "eager"
        for _ in range(3):
            holder.run("train", lambda: body("train"))
    assert runs["train"] == 5 and not holder
    with graphs.eager(blocks=4):
        assert graphs.report_blocks(10) == 4 and graphs.report_blocks(3) == 3
    assert graphs.report_blocks(10) == 10 and holder.mode("train") == "capture"
    logging_utils.reset_trace()


PKG = Path(graphs.__file__).resolve().parent


def _package_imports(path: Path) -> set:
    """The package's modules that the file ``path`` imports, anywhere in
    it (a function's lazy imports included)."""
    here = path.relative_to(PKG.parent).with_suffix("").parts

    def module(dotted: str) -> bool:
        p = PKG.parent.joinpath(*dotted.split("."))
        return p.with_suffix(".py").exists() or (p / "__init__.py").exists()

    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = list(here[:len(here) - node.level]) if node.level else []
            base = ".".join(parts + ([node.module] if node.module else []))
            found.update(f"{base}.{a.name}" if module(f"{base}.{a.name}")
                         else base for a in node.names)
    return {m for m in found if m.split(".")[0] == PKG.name}


def test_no_module_outside_core_imports_the_task_module():
    task = f"{PKG.name}.core.task"
    outside = [p for p in sorted(PKG.rglob("*.py"))
               if p.relative_to(PKG).parts[0] != "core"]
    assert len(outside) > 30
    assert [p.name for p in outside if task in _package_imports(p)] == []
    assert task in _package_imports(PKG / "core" / "eigenfunction.py")


def test_the_graphs_module_imports_nothing_above_the_kernel_build_layer():
    assert _package_imports(PKG / "graphs.py") == {
        f"{PKG.name}.logging_utils", f"{PKG.name}.ops._cuda"}


def _task(path, **kw):
    """A small CPU task of the plain step, built without the JAX package."""
    x, w = _trajectory()
    traj = WeightedTrajectory(trajectory=x, weights=w, dt=DT, verbose=False)
    pp = PreprocessingANN(
        AlignmentLayer(x[0], list(range(N_ATOMS))),
        FeatureLayer([Feature("p", "position", list(range(N_ATOMS)))]),
    )
    args = {**COMMON, "save_model_every_step": 0, "num_epochs": 1, **kw}
    return EigenFunctionTask(traj, pp, EigenFunctions(DIMS, K, seed=0),
                             str(path), device="cpu", **args)


def _fake_capture(task):
    """Install a captured epoch as the card would after its eager epoch."""
    key, held = task._graph_key()
    task._graphs["epoch"] = graphs.Captured(_FakeGraph(), {}, key, held)


@pytest.fixture
def trained(tmp_path):
    task = _task(tmp_path)
    task.train()  # one epoch: Adam's state exists, as after a capture
    task.save_training_state(0, str(tmp_path / "state.pt"))
    return task, tmp_path / "state.pt"


@pytest.mark.parametrize("event", ["load_training_state",
                                   "init_model_and_optimizer",
                                   "release_device_data"])
def test_events_drop_the_captured_epoch(trained, event):
    task, state = trained
    prepared = task._prepared
    _fake_capture(task)
    task.model.weights[0].grad = torch.ones_like(task.model.weights[0])
    if event == "load_training_state":
        assert task.load_training_state(str(state)) == 0
    else:
        getattr(task, event)()
    assert not task._graphs
    # the gradients the graph left on the parameters go with it
    assert task.model.weights[0].grad is None
    if event == "release_device_data":
        assert task._prepared is None
        task.train()  # prepares the data again
        assert task._prepared is not None and task._prepared is not prepared
        assert np.isfinite(task.train_loss).all()
    else:
        assert task._prepared is prepared


def _reload_optimizer_state(task, state):
    # new state tensors, loaded past the task
    task.optimizer.load_state_dict(
        torch.load(str(state), weights_only=True)["optimizer"])


CHANGES = {
    "nothing": None,
    "lr": lambda t, s: t.optimizer.param_groups[0].update(lr=0.01),
    "optimizer hyperparameters": (
        lambda t, s: t.optimizer.param_groups[0].update(eps=1e-6)),
    "matmul precision": lambda t, s: set_matmul_precision("high"),
    "default dtype": lambda t, s: set_default_dtype("float64"),
    "fused_step": lambda t, s: setattr(t, "fused_step", True),
    "sort_eigvals_in_training": (
        lambda t, s: setattr(t, "_sort_eigvals_in_training", False)),
    "preprocessing layer": lambda t, s: setattr(t, "_pp_for_loss", Identity()),
    "optimizer state tensors": _reload_optimizer_state,
    "prepared data": lambda t, s: (setattr(t, "_prepared", None),
                                   t._prepare_data()),
    "optimizer object": lambda t, s: setattr(
        t, "optimizer",
        t.make_optimizer("Adam", t.model.parameters(), t.learning_rate)),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_stale_captured_epoch_is_dropped(trained, change):
    """The captured epoch is checked at every chunk against the key of
    what it bakes in or reads by address; a change to any of them drops
    it, so a stale graph never replays."""
    task, state = trained
    precision, dtype = matmul_precision(), default_dtype()
    _fake_capture(task)
    key = task._graph_key()[0]
    assert key == task._graphs["epoch"].key
    try:
        if CHANGES[change] is not None:
            CHANGES[change](task, state)
        changed = task._graph_key()[0] != key
        task._check_graph()
    finally:
        set_matmul_precision({"medium": "default"}.get(precision, precision))
        set_default_dtype(dtype)
    assert changed == (change != "nothing")
    assert (not task._graphs) == changed


def test_profile_dir_writes_a_trace(tmp_path):
    task = _task(tmp_path / "run", profile_dir=str(tmp_path / "prof"))
    task.train()
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    # None, the default, traces nothing
    quiet = _task(tmp_path / "quiet")
    assert quiet.profile_dir is None
    quiet.train()
    assert len(list(tmp_path.rglob("*.pt.trace.json"))) == 1
