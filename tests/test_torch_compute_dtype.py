"""PyTorch port, the bfloat16 compute mode (config.set_compute_dtype,
config.set_bf16_style): setter validation, mlp_apply and stacked_mlp_apply
in each style against the JAX functions under the same configuration,
'acc32' and 'w32' tighter than 'pure', float32 parameters and gradients,
a solo task's captured-epoch key following numerics_key(), and a bfloat16
sweep against the JAX package's bfloat16 sweep."""

import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.models import EigenFunctions as JaxEF
from colvarsfinder_tpu.models import create_sequential_nn as jax_seq
from colvarsfinder_tpu.models.module import stacked_mlp_apply as jax_stacked

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.models.module import (
    params_from_numpy,
    stacked_mlp_apply,
)

# JAX's own bar for a bfloat16 forward against float32
# (tests/test_compute_dtype.py:77,88), here between the two packages in
# the same style: each rounds to bfloat16 at the same places, in other
# summation orders
BF16_BAR = 3e-2
STYLES = ("pure", "acc32", "w32")


@pytest.fixture(autouse=True)
def _restore():
    yield
    for cfg in (jconfig, pconfig):
        cfg.set_compute_dtype("float32")
        cfg.set_bf16_style("pure")


def _mode(dtype, style="pure"):
    for cfg in (jconfig, pconfig):
        cfg.set_compute_dtype(dtype)
        cfg.set_bf16_style(style)


def test_setter_validation():
    with pytest.raises(ValueError, match="compute dtype"):
        pconfig.set_compute_dtype("float16")
    pconfig.set_default_dtype("float64")
    try:
        with pytest.raises(ValueError, match="float64"):
            pconfig.set_compute_dtype("bfloat16")
    finally:
        pconfig.set_default_dtype("float32")
    pconfig.set_compute_dtype(torch.bfloat16)
    assert pconfig.compute_dtype() == torch.bfloat16
    assert pconfig.compute_dtype_name() == "bfloat16"
    assert pconfig.numerics_key()[2] == "bfloat16"
    with pytest.raises(ValueError, match="bf16 style"):
        pconfig.set_bf16_style("fp8")
    pconfig.set_bf16_style("acc32")
    assert pconfig.bf16_style() == "acc32"
    assert pconfig.numerics_key()[3] == "acc32"
    pconfig.set_compute_dtype("float32")
    assert pconfig.compute_dtype() == torch.float32


def _sequential(dims, seed):
    jm = jax_seq(dims, seed=seed)
    named = {n: np.asarray(v) for n, v in jm.named_parameters()}
    return jm, params_from_numpy(named, dims)


def _stacked(dims, k, seed):
    jm = JaxEF(dims, k=k, seed=seed)
    pm = port.EigenFunctions.from_numpy(
        [{n: np.asarray(v) for n, v in p.items()} for p in jm.params])
    return jm, pm


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("stacked", [False, True])
def test_mixed_precision_matches_jax(style, stacked):
    x = np.random.default_rng(7).standard_normal((64, 6)).astype(np.float32)
    if stacked:
        jm, pm = _stacked([6, 16, 16, 1], 2, 5)

        def jax_f(x):
            return np.asarray(jax_stacked(jm.params, x, "tanh"))

        def port_f(x):
            return stacked_mlp_apply(list(pm.weights), list(pm.biases),
                                     torch.from_numpy(x), "tanh")
    else:
        jm, pm = _sequential([6, 16, 16, 3], 5)

        def jax_f(x):
            return np.asarray(jm(x))

        def port_f(x):
            return pm(torch.from_numpy(x))

    with torch.no_grad():
        y32 = port_f(x).numpy()
    _mode("bfloat16", style)
    with torch.no_grad():
        got = port_f(x)
    assert got.dtype == torch.float32  # cast back for the loss
    want = jax_f(x)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() < BF16_BAR * scale
    assert np.abs(got.numpy() - y32).max() < BF16_BAR * scale
    assert np.any(got.numpy() != y32)  # the mode engaged


@pytest.mark.parametrize("stacked", [False, True])
def test_acc32_and_w32_tighter_than_pure(stacked):
    """Per pass, f32 accumulation ('acc32') and f32 weights ('w32') land
    closer to the float32 forward than 'pure' (the JAX package's
    guarantee, tests/test_compute_dtype.py:97-125)."""
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal((512, 6)).astype(np.float32))
    if stacked:
        pm = port.EigenFunctions([6, 16, 16, 1], 2, seed=5)
    else:
        pm = port.create_sequential_nn([6, 16, 16, 3], seed=5)
    with torch.no_grad():
        y32 = pm(x)
        errs = {}
        for style in STYLES:
            _mode("bfloat16", style)
            errs[style] = float((pm(x) - y32).abs().max())
            assert errs[style] > 0
    assert errs["acc32"] < errs["pure"]
    assert errs["w32"] < errs["pure"]


@pytest.mark.parametrize("style", STYLES)
def test_parameters_and_gradients_stay_float32(style):
    pm = port.EigenFunctions([2, 8, 1], 2, seed=0)
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((8, 2)).astype(np.float32))
    _mode("bfloat16", style)
    (pm(x) ** 2).sum().backward()
    for p in pm.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()


def test_graph_key_follows_numerics(tmp_path):
    """A solo task's captured-epoch key holds numerics_key(): flipping the
    compute dtype or the style changes it, so the card re-captures instead
    of replaying a graph of other numerics."""
    x = np.random.default_rng(0).standard_normal((200, 2)).astype(np.float32)
    task = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False), None,
        port.EigenFunctions([2, 8, 1], 2, seed=0), str(tmp_path),
        alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.1, k=2,
        batch_size=50, num_epochs=2, verbose=False, tensorboard=False,
        save_model_every_step=0, device="cpu")
    task.train()
    keys = [task._graph_key()[0]]
    for dtype, style in (("bfloat16", "pure"), ("bfloat16", "acc32"),
                         ("float32", "acc32")):
        _mode(dtype, style)
        keys.append(task._graph_key()[0])
    assert len(set(keys)) == 4
    # a bfloat16 run trains finitely, within JAX's bf16 training bar of
    # float32 (tests/test_compute_dtype.py:172)
    _mode("float32")
    l32 = task.train_loss.copy()
    task2 = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False), None,
        port.EigenFunctions([2, 8, 1], 2, seed=0), str(tmp_path),
        alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.1, k=2,
        batch_size=50, num_epochs=2, verbose=False, tensorboard=False,
        save_model_every_step=0, device="cpu")
    _mode("bfloat16")
    task2.train()
    assert np.isfinite(task2.train_loss).all()
    np.testing.assert_allclose(task2.train_loss[:, 0], l32[:, 0], rtol=0.1,
                               atol=0.05)
    assert not np.array_equal(task2.train_loss, l32)


def test_sweep_in_bf16_stays_near_float32(tmp_path):
    """A bfloat16 sweep against a float32 one, replica by replica, at
    JAX's bf16 bar (tests/test_compute_dtype.py:188-200), the mode
    restored after each; its parameters stay float32."""
    from colvarsfinder_tpu_torch.parallel import train_hyperparameter_sweep
    from colvarsfinder_tpu_torch.parallel import ensemble

    x = np.random.default_rng(0).standard_normal((256, 2)).astype(np.float32)
    task = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False), None,
        port.EigenFunctions([2, 10, 1], 2, seed=3), str(tmp_path),
        alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.2, k=2,
        batch_size=64, num_epochs=3, test_ratio=0.25, verbose=False,
        tensorboard=False, save_model_every_step=0, device="cpu")
    grid = {"learning_rate": [0.005, 0.02], "alpha": [5.0, 20.0]}
    r32 = train_hyperparameter_sweep(task, grid)
    r16 = train_hyperparameter_sweep(task, grid, compute_dtype="bfloat16")
    assert pconfig.compute_dtype_name() == "float32"
    for a, b in zip(r32, r16):
        assert np.isfinite(b.train_loss).all()
        np.testing.assert_allclose(b.train_loss[:, 0], a.train_loss[:, 0],
                                   rtol=0.1, atol=0.05)
        assert not np.array_equal(a.train_loss, b.train_loss)
        assert all(v.dtype == torch.float32 for v in b.model.values())
    ensemble.release_sweeps()


def test_bf16_sweep_matches_the_jax_bf16_sweep(tmp_path):
    """The same grid, initial parameters and split through both packages'
    bfloat16 sweeps ('pure'): the curves agree within JAX's per-pass bf16
    bar, much closer than either is to its float32 sweep at high learning
    rates (the two libraries round to bfloat16 at the same places)."""
    from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
    from colvarsfinder_tpu.parallel import ensemble as jens
    from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

    from colvarsfinder_tpu_torch.core.task import train_test_split
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 2)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 256)
    jm, pm = _stacked([2, 10, 1], 2, 0)
    args = dict(alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.2, k=2,
                learning_rate=0.01, batch_size=64, num_epochs=3,
                test_ratio=0.25, verbose=False, tensorboard=False,
                save_model_every_step=0, debug_mode=False,
                split_indices=train_test_split(np.arange(254), 0.25, 0))
    grid = {"learning_rate": [0.005, 0.02, 0.05, 0.1],
            "alpha": [5.0, 20.0, 80.0, 80.0]}
    jt = JaxTask(JaxTraj(trajectory=x, weights=w, dt=0.1, verbose=False),
                 None, jm, str(tmp_path / "jax"), export_cv=False, **args)
    pt = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=0.1,
                                verbose=False),
        None, pm, str(tmp_path / "port"), device="cpu", **args)
    want = jens.train_hyperparameter_sweep(jt, grid, compute_dtype="bfloat16")
    got = train_hyperparameter_sweep(pt, grid, compute_dtype="bfloat16")
    for j, p in zip(want, got):
        np.testing.assert_allclose(p.train_loss[:, 0],
                                   j.train_loss_df["loss"].to_numpy(),
                                   rtol=BF16_BAR)
    ensemble.release_sweeps()
