"""PyTorch port, ``workflow.adaptive_cv_discovery``.

* The loop against the JAX package's: the JAX draws fed through the port's
  noise seam (``JaxNoise`` of ``tests/test_torch_sampling.py``, each sampler
  call of a round given its own scheme and seed), the same initial
  parameters in each round's task and the same split injected through
  ``split_indices``, training in float64. The samplers integrate in float32
  in both packages and round in other orders (frames part by float32 ulps,
  ``test_torch_sampling.py``), and each round retrains on those frames and
  biases along the retrained CV, so the bar is ``LOOP_RTOL`` on the frames,
  weights, losses and parameters. The hills are a fixed 0.3 wide: the
  default width, 0.35 of a barely trained CV's spread, is 0.02 here, and
  along hills that sharp two float32 walkers part within a few hundred
  steps.
* The behavioural cases of ``tests/test_workflow.py`` on the port's own
  draws, and the round-0 replica-exchange bootstrap.
* Warm start copies the trained parameters into the next task's own
  tensors; the first head is taken per chain row.
* A loop in a process where pandas cannot be imported.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.workflow import adaptive_cv_discovery as jax_adaptive

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.utils import sampling as tsampling
from colvarsfinder_tpu_torch.workflow import adaptive_cv_discovery
from test_torch_sampling import JaxNoise

REPO = Path(__file__).resolve().parent.parent
LOOP_RTOL = 1e-4


def double_well(xp):
    """V = (x1^2 - 1)^2 + 8 x2^2 at beta 6 (tests/test_workflow.py)."""

    class DoubleWell2D:
        dim = 2
        beta = 6.0

        def V(self, x):
            return (x[0] ** 2 - 1.0) ** 2 + 8.0 * x[1] ** 2

        def gradV(self, x):
            return xp.stack([4.0 * x[0] * (x[0] ** 2 - 1.0), 16.0 * x[1]])

    return DoubleWell2D()


TASK = dict(alpha=10.0, eig_weights=[1.0], k=1, learning_rate=0.01,
            save_model_every_step=0, verbose=False, tensorboard=False)


def _make_task(outdir, epochs=15, batch=200):
    def make_task(traj, round_idx):
        return port.EigenFunctionTask(
            traj, None, port.EigenFunctions([2, 16, 1], 1, seed=round_idx),
            str(outdir / f"cv{round_idx}"), lag_tau=traj.dt, batch_size=batch,
            num_epochs=epochs, seed=round_idx, device="cpu", **TASK)

    return make_task


# ---------------------------------------------------------------- the loop


def _split(traj, r):
    """The same train/test split of the lagged-pair starts for both
    packages (20% test)."""
    starts = traj.valid_lagged_starts(1)
    perm = np.random.default_rng(100 + r).permutation(starts)
    n_test = int(np.ceil(0.2 * perm.size))
    return perm[n_test:], perm[:n_test]


class JaxNoise32(JaxNoise):
    """``JaxNoise`` drawing float32 under float64 mode, as the JAX samplers
    do (they draw in the float32 state's dtype)."""

    def normal(self, out, stream, i):
        with jax.enable_x64(False):
            super().normal(out, stream, i)

    def uniform(self, out, stream, i):
        with jax.enable_x64(False):
            super().uniform(out, stream, i)


@pytest.fixture
def f64():
    jconfig.set_default_dtype("float64")
    pconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")
    pconfig.set_default_dtype("float32")


def test_loop_matches_jax(f64, tmp_path, monkeypatch):
    seed = 3
    # round 0's overdamped run, then one metadynamics walker per round
    monkeypatch.setattr(
        tsampling, "_make_noise",
        lambda s, device: JaxNoise32(s, "em" if s == seed else "metad", 1))
    heads = {}

    def jax_task(traj, r):
        head = heads[r] = JaxEigenFunctions([2, 16, 1], 1, seed=10 + r)
        return JaxTask(traj, None, head, str(tmp_path / f"j{r}"),
                       lag_tau=traj.dt, batch_size=50, num_epochs=4,
                       seed=r, split_indices=_split(traj, r), **TASK)

    def port_task(traj, r):
        params = [{n: np.asarray(v) for n, v in p.items()}
                  for p in heads[r].params]
        return port.EigenFunctionTask(
            traj, None, port.EigenFunctions.from_numpy(params),
            str(tmp_path / f"t{r}"), lag_tau=traj.dt, batch_size=50,
            num_epochs=4, seed=r, split_indices=_split(traj, r),
            device="cpu", **TASK)

    kw = dict(n_rounds=2, X0=np.array([1.0, 0.0]), unbiased_steps=2_000,
              metad_steps=2_000, step_size=0.005, frame_interval=10,
              hill_height=0.3, hill_width=0.3, bias_factor=8.0, seed=seed,
              verbose=False)
    want = jax_adaptive(double_well(jnp), jax_task,
                        output_path=str(tmp_path / "js"), **kw)
    got = adaptive_cv_discovery(double_well(torch), port_task,
                                output_path=str(tmp_path / "ts"),
                                device="cpu", **kw)
    assert next(got.task.model.parameters()).dtype == torch.float64

    def close(a, b, what):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=LOOP_RTOL,
                                   atol=LOOP_RTOL * np.abs(b).max(),
                                   err_msg=what)

    for r, (g, w) in enumerate(zip(got.rounds, want.rounds)):
        close(g.segment.trajectory, w.segment.trajectory, f"round {r} frames")
        close(g.segment.weights, w.segment.weights, f"round {r} weights")
        close(g.task.train_loss, w.task.train_loss_df.to_numpy(),
              f"round {r} train loss")
        close(g.task.test_loss, w.task.test_loss_df.to_numpy(),
              f"round {r} test loss")
        for li, p in enumerate(w.task.model.params):
            close(g.task.model.weights[li].detach(), p["weight"],
                  f"round {r} layer {li} weight")
        if r:
            close(g.metad.hill_heights, w.metad.hill_heights,
                  f"round {r} hill heights")
            close(g.metad.cv_values, w.metad.cv_values, f"round {r} CV")
    np.testing.assert_array_equal(got.pooled.segment_starts,
                                  want.pooled.segment_starts)
    close(got.cv_range_per_round(), want.cv_range_per_round(), "cv ranges")


# ------------------------------------------------- behaviour, port's draws


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("adaptive")
    return adaptive_cv_discovery(
        double_well(torch), _make_task(out), n_rounds=2,
        X0=np.array([1.0, 0.0]), unbiased_steps=10_000, metad_steps=10_000,
        step_size=0.005, frame_interval=25, hill_height=0.6,
        bias_factor=8.0, output_path=str(out / "sampling"), seed=3,
        verbose=False, device="cpu")


def test_round_artifacts(result):
    assert len(result.rounds) == 2
    r0, r1 = result.rounds
    assert r0.metad is None and r1.metad is not None
    assert r0.index == 0 and r1.index == 1
    for r in result.rounds:
        assert np.isfinite(r.task.train_loss).all()
        assert callable(r.cv_model)


def test_biased_round_explores(result):
    x0_unbiased = result.rounds[0].segment.trajectory[:, 0]
    x0_biased = result.rounds[1].segment.trajectory[:, 0]
    assert x0_unbiased.min() > -0.5  # trapped
    assert x0_biased.min() < -0.5  # crossed


def test_pooled_dataset(result):
    n0 = result.rounds[0].segment.n_frames
    n1 = result.rounds[1].segment.n_frames
    assert result.pooled.n_frames == n0 + n1
    np.testing.assert_array_equal(result.pooled.segment_starts, [0, n0])
    assert abs(result.pooled.weights.mean() - 1.0) < 1e-5
    assert result.rounds[1].segment.weights.std() > 1e-3


def test_final_cv_separates_wells(result):
    pooled = result.pooled
    with torch.no_grad():
        cv = result.cv_model(torch.from_numpy(pooled.trajectory)).numpy()
    r = np.corrcoef(cv.reshape(-1), pooled.trajectory[:, 0])[0, 1]
    assert abs(r) > 0.7


def test_exploration_signal(result):
    spans = result.cv_range_per_round()
    assert spans.shape == (2, 1)
    assert np.isfinite(spans).all()
    assert spans[1, 0] > 0.8 * spans[0, 0]


def test_single_round_is_plain_training(tmp_path):
    res = adaptive_cv_discovery(
        double_well(torch), _make_task(tmp_path), n_rounds=1,
        X0=np.array([1.0, 0.0]), unbiased_steps=5_000, step_size=0.005,
        frame_interval=50, output_path=str(tmp_path / "s"), seed=0,
        verbose=False, device="cpu")
    assert len(res.rounds) == 1
    assert res.rounds[0].metad is None
    assert (res.pooled.segment_starts is None
            or len(res.pooled.segment_starts) <= 1)


def test_warm_start_carries_weights(tmp_path):
    """Round 1 enters train() holding round 0's trained parameters, in its
    own tensors, with an empty optimizer state."""
    entry = {}

    def make_task(traj, r):
        t = _make_task(tmp_path)(traj, r)
        real_train = t.train
        own = [p for p in t.model.parameters()]

        def spy_train():
            entry[r] = ([p.detach().clone() for p in t.model.parameters()],
                        all(a is b for a, b in zip(own,
                                                   t.model.parameters())),
                        len(t.optimizer.state))
            return real_train()

        t.train = spy_train
        return t

    res = adaptive_cv_discovery(
        double_well(torch), make_task, n_rounds=2, X0=np.array([1.0, 0.0]),
        unbiased_steps=3_000, metad_steps=2_000, step_size=0.005,
        frame_interval=25, hill_height=0.6, bias_factor=8.0,
        warm_start=True, output_path=str(tmp_path / "ws"), seed=1,
        verbose=False, device="cpu")
    r0_trained = list(res.rounds[0].task.model.parameters())
    r1_initial, same_tensors, opt_state = entry[1]
    assert same_tensors and opt_state == 0
    for a, b in zip(r0_trained, r1_initial):
        assert torch.equal(a, b)
    r1_final = list(res.rounds[1].task.model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(r1_initial, r1_final))


def test_bias_takes_each_rows_first_head(tmp_path, monkeypatch):
    """The metadynamics CV is each chain row's first head of the trained
    CV, on the chain batch (not row 0's value for every row)."""
    from colvarsfinder_tpu_torch import workflow

    seen = {}
    real = workflow.integrate_sde_metadynamics

    def spy(pot, cv, **kw):
        x = torch.tensor([[1.0, 0.0], [-1.0, 0.2], [0.3, -0.1]])
        seen["head"] = cv(x)
        # the trained CV the loop closed over (cv_head0's default argument)
        seen["full"] = cv.__defaults__[0](x)
        return real(pot, cv, **kw)

    monkeypatch.setattr(workflow, "integrate_sde_metadynamics", spy)
    res = adaptive_cv_discovery(
        double_well(torch), _make_task(tmp_path, epochs=2, batch=20),
        n_rounds=2, X0=np.array([1.0, 0.0]), unbiased_steps=1_000,
        metad_steps=500, step_size=0.005, frame_interval=10,
        output_path=str(tmp_path / "h"), seed=2, verbose=False, device="cpu")
    assert res.rounds[1].metad is not None
    assert seen["head"].shape == (3, 1)
    assert torch.equal(seen["head"], seen["full"].reshape(3, -1)[:, :1])
    assert len(set(seen["head"].reshape(-1).tolist())) == 3


def test_remd_bootstrap_sees_both_wells(tmp_path):
    res = adaptive_cv_discovery(
        double_well(torch), _make_task(tmp_path), n_rounds=1,
        X0=np.array([-1.0, 0.0]), unbiased_steps=20_000, step_size=0.005,
        frame_interval=50, bootstrap="remd", remd_betas=[6.0, 2.0, 0.8],
        output_path=str(tmp_path / "sampling"), seed=3, verbose=False,
        device="cpu")
    seg = res.rounds[0].segment
    x1, w = seg.trajectory[:, 0], seg.weights
    frac_right = float(np.average(x1 > 0, weights=w))
    assert 0.1 < frac_right < 0.9
    np.testing.assert_allclose(w.mean(), 1.0, rtol=1e-6)
    assert seg.segment_starts is not None and len(seg.segment_starts) >= 3
    assert np.isfinite(res.task.train_loss).all()

    with pytest.raises(ValueError, match="bootstrap"):
        adaptive_cv_discovery(
            double_well(torch), _make_task(tmp_path), n_rounds=1,
            unbiased_steps=100, bootstrap="nope", verbose=False,
            output_path=str(tmp_path / "s2"), device="cpu")


_NO_PANDAS = """
import json, sys
sys.modules["pandas"] = None
from pathlib import Path
import numpy as np
import torch
import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch.workflow import adaptive_cv_discovery


class Well:
    dim, beta = 2, 6.0

    def V(self, x):
        return (x[0] ** 2 - 1.0) ** 2 + 8.0 * x[1] ** 2


out = Path(sys.argv[1])


def make_task(traj, r):
    return port.EigenFunctionTask(
        traj, None, port.EigenFunctions([2, 6, 1], 1, seed=r), str(out / str(r)),
        alpha=10.0, eig_weights=[1.0], lag_tau=traj.dt, k=1, batch_size=20,
        num_epochs=2, save_model_every_step=0, verbose=False,
        tensorboard=False, device="cpu")


res = adaptive_cv_discovery(
    Well(), make_task, n_rounds=2, X0=np.array([1.0, 0.0]),
    unbiased_steps=1_000, metad_steps=1_000, step_size=0.005,
    frame_interval=10, warm_start=True, output_path=str(out / "s"), seed=0,
    verbose=True, device="cpu")
assert np.isfinite(res.task.train_loss).all()
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if m.split(".")[0] == "pandas" and mod is not None)))
"""


def test_loop_without_pandas(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _NO_PANDAS, str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[adaptive] round 1: trained on" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_metadynamics_along_a_float64_cv_matches_jax(f64, monkeypatch):
    """A float64 torch CV module takes the float32 chains in its own dtype
    (``utils/enhanced.py:_cv_fn``), as the JAX package promotes them; before,
    the module's first layer raised on the dtype mismatch."""
    from colvarsfinder_tpu.utils import enhanced as jenh

    from colvarsfinder_tpu_torch.utils import enhanced as tenh

    monkeypatch.setattr(tsampling, "_make_noise",
                        lambda s, device: JaxNoise32(s, "metad", 1))
    head = JaxEigenFunctions([2, 6, 1], 1, seed=4)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in head.params]
    tcv = port.EigenFunctions.from_numpy(params)
    assert next(tcv.parameters()).dtype == torch.float64
    kw = dict(n_steps=40, deposit_interval=10, step_size=0.005,
              hill_height=0.3, hill_width=0.3, bias_factor=8.0, seed=2,
              X0=[1.0, 0.0], verbose=False)
    want = jenh.integrate_sde_metadynamics(double_well(jnp),
                                           lambda s: head(s), **kw)
    got = tenh.integrate_sde_metadynamics(double_well(torch), tcv,
                                          device="cpu", **kw)
    for name in ("frames", "cv_values", "hill_heights"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=2e-5, err_msg=name)
