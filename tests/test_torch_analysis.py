"""PyTorch port, ``analysis``: the numpy validation battery copied from the
JAX package, and the two functions that evaluate a CV.

* Every copied function gets the same seeded inputs in both packages; the
  results agree to 1e-12 relative (``RTOL``; they run the same numpy code).
* :func:`cv_consistency` and :func:`cv_sensitivity` of CVs with
  transplanted parameters: through the plain alignment in float64 on both
  sides (``F64_RTOL``); through K2's layer in float32, the port's plain
  version against the JAX Pallas kernel interpreted on the CPU, at K2's
  gradient bar (``GRAD_TOL``, ``tests/test_torch_alignment.py``).
* A numpy CV takes central finite differences equal to the JAX package's; a
  torch CV whose forward or backward raises propagates the error.
"""

import numpy as np
import pytest
import torch

from colvarsfinder_tpu import analysis as jan
from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.export import ColvarModel as JaxColvarModel
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.ops.kabsch_pallas import FusedAlignmentLayer as JaxFused

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import analysis as tan
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.ops import _cuda

RTOL = 1e-12
# the plain alignment (SVD Kabsch, METHOD) in float64 in both libraries
F64_RTOL = 1e-8
# K2's gradient bar (tests/test_torch_alignment.py GRAD_TOL): float32 QCP
# in two libraries
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
N_ATOMS = 5
# the plain alignment of the float64 cases (the JAX package compiles its
# jacrev through the SVD in seconds, through the QCP in minutes)
METHOD = "svd"


def _same(a, b, path="result"):
    """Equal structure, numbers within ``RTOL``."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif hasattr(a, "__dict__") and not isinstance(a, np.ndarray):
        assert type(a).__name__ == type(b).__name__, path
        _same(vars(a), vars(b), path)
    elif isinstance(a, (str, bool, type(None))):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                       equal_nan=True, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def _ar1(n=3000, k=2, seed=0, a=(0.95, 0.8)):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, k))
    for t in range(1, n):
        y[t] = np.asarray(a[:k]) * y[t - 1] + rng.standard_normal(k)
    return y


def _weights(n, seed=1):
    return np.random.default_rng(seed).uniform(0.5, 1.5, n)


def _block_chain(n=20_000, seed=0):
    """A 9-state chain with three metastable blocks (as in
    tests/test_analysis.py)."""
    rng = np.random.default_rng(seed)
    T = np.full((9, 9), 1e-4)
    for b in range(3):
        T[3 * b:3 * b + 3, 3 * b:3 * b + 3] = 1.0
    T[2, 3] = T[3, 2] = T[5, 6] = T[6, 5] = 5e-3
    T /= T.sum(axis=1, keepdims=True)
    cdf = np.cumsum(T, axis=1)
    u = rng.uniform(size=n)
    s = np.zeros(n, dtype=np.int64)
    for t in range(1, n):
        s[t] = min(np.searchsorted(cdf[s[t - 1]], u[t]), 8)
    return s


Y, W, SEG = _ar1(), _weights(3000), [0, 1400]
S = _block_chain()
X4 = np.concatenate([_ar1(k=2, seed=3), _ar1(k=2, seed=4, a=(0.5, 0.3))],
                    axis=1) @ np.random.default_rng(5).standard_normal((4, 4))


def _msm_methods(m):
    res = m.msm(S, lag=5, n_states=9, weights=_weights(S.size, 2))
    return dict(res=res, stationary=res.stationary,
                timescales=res.timescales(dt=0.1, k=3),
                mfpt=res.mfpt([7, 8], dt=0.1),
                rate=res.tpt_rate([0, 1], [7, 8], dt=0.1),
                committor=res.committor([0, 1], [7, 8]),
                pcca=res.pcca(3), assign=res.metastable_assignments(3),
                coarse=res.coarse_grain(3))


def _linear(m, which):
    if which == "tica":
        cv = m.tica(X4, lag=4, n_components=3, weights=_weights(3000, 6),
                    dt=0.5, segment_starts=SEG)
    else:
        cv = m.pca(X4, n_components=2, weights=_weights(3000, 6))
    return cv, cv(X4[:100])


CASES = {
    "implied_timescales_rate": lambda m: m.implied_timescales(
        [0.5, 2.0, -1.0]),
    "implied_timescales_log": lambda m: m.implied_timescales(
        [0.5, 2.0, -1.0, 0.1], lag_time=0.4, method="log"),
    "free_energy_1d": lambda m: m.free_energy_profile(
        Y[:, 0], weights=W, beta=2.0, bins=30),
    "free_energy_2d": lambda m: m.free_energy_profile(
        Y, bins=12, value_range=[(-6, 6), (-4, 4)]),
    "free_energy_bootstrap": lambda m: m.free_energy_profile(
        Y[:, 0], weights=W, bins=20, n_bootstrap=8, seed=3,
        segment_starts=SEG),
    "free_energy_auto_block": lambda m: m.free_energy_profile(
        Y[:, 1], bins=20, n_bootstrap=5, block_frames=None, seed=1),
    "block_bootstrap_indices": lambda m: m._block_bootstrap_indices(
        np.random.default_rng(4), np.arange(100), 7, 20, 130),
    "autocorrelation": lambda m: m.autocorrelation(
        Y, [1, 3, 10], weights=W, segment_starts=SEG),
    "ck_test": lambda m: m.ck_test(Y, lag=3, n_multiples=4, weights=W),
    "timescales_vs_lag": lambda m: m.timescales_vs_lag(
        Y, [1, 2, 5, 10], dt=0.2, weights=W, segment_starts=SEG),
    "timescales_vs_lag_bootstrap": lambda m: m.timescales_vs_lag_bootstrap(
        Y, [1, 5], dt=0.2, n_bootstrap=6, block_frames=100, seed=2),
    "vamp_score": lambda m: m.vamp_score(Y, 4, weights=W, method="VAMP-1"),
    "discretize_1d": lambda m: m.discretize(Y[:, 0], n_bins=17),
    "discretize_2d": lambda m: m.discretize(
        Y, n_bins=5, value_range=[(-5, 5), (-3, 3)]),
    "msm": _msm_methods,
    "tica": lambda m: _linear(m, "tica"),
    "pca": lambda m: _linear(m, "pca"),
    "validate_cv": lambda m: m.validate_cv(
        Y, lag=3, dt=0.1, weights=W, segment_starts=SEG),
    "msm_ck_test": lambda m: m.msm_ck_test(
        S, lag=2, n_sets=3, n_multiples=3, n_states=9),
    "committor_self_consistency": lambda m: m.committor_self_consistency(
        1 / (1 + np.exp(-Y[:, 0])), Y[:, 0] < -2, Y[:, 0] > 2, lag=2,
        n_bins=8, weights=W),
    "statistical_inefficiency": lambda m: m.statistical_inefficiency(
        Y, SEG, mintime=4),
    "decorrelated_indices": lambda m: m.decorrelated_indices(
        Y, SEG, offset=2),
    "decorrelated_indices_g": lambda m: m.decorrelated_indices(Y, g=3.5),
    "cv_consistency_numpy": lambda m: m.cv_consistency(
        [lambda x: x[:, :2], lambda x: x[:, :2] @ [[1.0, 2.0], [0.5, -1.0]],
         lambda x: np.tanh(x[:, 1:3])], X4),
    "cv_sensitivity_numpy": lambda m: m.cv_sensitivity(
        lambda x: np.stack([np.sin(x[:, 0]) * x[:, 1], x[:, 2] ** 2], 1),
        X4[:300], weights=W[:300], labels=["a", "b", "c", "d"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_functions_match_jax(name):
    _same(CASES[name](tan), CASES[name](jan))


def test_every_public_name_is_ported():
    assert sorted(tan.__all__) == sorted(jan.__all__)


@pytest.fixture
def f64():
    """Both packages in float64 mode, float32 restored afterwards."""
    jconfig.set_default_dtype("float64")
    pconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")
    pconfig.set_default_dtype("float32")


def _cvs(kind, seed, k=2):
    """One CV from each package with the same parameters: the plain
    (SVD) alignment or K2's layer, position features and k tanh
    heads."""
    rng = np.random.default_rng(0)
    ref = 1.5 * rng.standard_normal((N_ATOMS, 3))
    idx = list(range(N_ATOMS))
    head = JaxEigenFunctions([3 * N_ATOMS, 8, 8, 1], k, seed=seed)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in head.params]
    if kind == "fused":
        jal, tal = JaxFused(ref, idx), port.FusedAlignmentLayer(ref, idx)
    else:
        jal = JaxAlign(ref, idx, method=METHOD)
        tal = port.AlignmentLayer(ref, idx, method=METHOD)
    feats = [("p", "position", idx)]
    jcv = JaxColvarModel(
        JaxPP(jal, JaxFeatureLayer([JaxFeature(*f) for f in feats])), head)
    tcv = port.ColvarModel(
        port.PreprocessingANN(
            tal, port.FeatureLayer([port.Feature(*f) for f in feats])),
        port.EigenFunctions.from_numpy(params))
    x = ref[None] + 0.4 * rng.standard_normal((128, N_ATOMS, 3))
    return jcv, tcv, x


def _dtype_of(tcv):
    return next(tcv.parameters()).dtype


@pytest.mark.parametrize("center", [True, False])
def test_cv_consistency_plain_float64(f64, center):
    cvs = [_cvs("plain", seed) for seed in (1, 2, 3)]
    x = cvs[0][2]
    assert _dtype_of(cvs[0][1]) == torch.float64
    want = jan.cv_consistency([c[0] for c in cvs], x, center=center)
    got = tan.cv_consistency([c[1] for c in cvs], x, center=center)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=F64_RTOL)
    assert not np.allclose(got, np.eye(3))


def _sensitivity_close(got, want, tol):
    for name in ("sensitivity", "relative"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(
            a, b, rtol=tol["rtol"], atol=tol["atol"] * np.abs(b).max(),
            err_msg=name)
    assert got.labels == want.labels and got.aggregated == want.aggregated


@pytest.mark.parametrize("aggregate,normalize,batch",
                         [("xyz", "std", 64), ("none", "none", 8192)])
def test_cv_sensitivity_plain_float64(f64, aggregate, normalize, batch):
    jcv, tcv, x = _cvs("plain", 4)
    w = _weights(len(x), 7)
    kw = dict(weights=w, normalize=normalize, aggregate=aggregate,
              batch_size=batch)
    want = jan.cv_sensitivity(jcv, x, **kw)
    got = tan.cv_sensitivity(tcv, x, **kw)
    assert got.sensitivity.dtype == np.float64
    _sensitivity_close(got, want, dict(rtol=F64_RTOL, atol=F64_RTOL))


def test_cv_sensitivity_through_k2_float32():
    """K2's layer: the port's plain version (no launch on the CPU) against
    the JAX kernel interpreted on the CPU, both float32."""
    jcv, tcv, x = _cvs("fused", 5)
    x = x[:48].astype(np.float32)
    _cuda.reset_launch_counts()
    got = tan.cv_sensitivity(tcv, x, aggregate="xyz", batch_size=48)
    assert _cuda.launch_counts()["fused_align"] == 0
    want = jan.cv_sensitivity(jcv, x, aggregate="xyz", batch_size=48)
    _sensitivity_close(got, want, GRAD_TOL)


def test_cv_consistency_through_k2_float32():
    pairs = [_cvs("fused", seed) for seed in (6, 7)]
    x = pairs[0][2].astype(np.float32)
    want = jan.cv_consistency([p[0] for p in pairs], x)
    got = tan.cv_consistency([p[1] for p in pairs], x)
    np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_torch_callable_and_numpy_cv_choose_their_paths():
    """A callable returning a tensor takes autograd (exact for a linear
    map); the same map in numpy takes finite differences, equal to the
    JAX package's."""
    A = np.random.default_rng(8).standard_normal((4, 2))
    x = X4[:200]
    exact = tan.cv_sensitivity(
        lambda v: torch.as_tensor(v) @ torch.from_numpy(A), x,
        normalize="none")
    want = np.sqrt((A.T ** 2))
    np.testing.assert_allclose(exact.sensitivity, want, rtol=1e-12)
    fd_port = tan.cv_sensitivity(lambda v: v @ A, x, normalize="none")
    fd_jax = jan.cv_sensitivity(lambda v: np.asarray(v) @ A, x,
                                normalize="none")
    _same(fd_port.sensitivity, fd_jax.sensitivity)
    assert not np.array_equal(fd_port.sensitivity, exact.sensitivity)


class _Boom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("backward failed")


class _RaisingCV(torch.nn.Module):
    def __init__(self, where):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 2, dtype=torch.float64))
        self.where = where

    def forward(self, x):
        if self.where == "forward":
            raise RuntimeError("forward failed")
        return _Boom.apply(x) @ self.w


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_torch_cv_errors_propagate(where):
    """No fallback to finite differences: the CV's own error raises."""
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        tan.cv_sensitivity(_RaisingCV(where), X4[:50])


def test_cv_values_follow_the_module(f64):
    """``_cv_on_numpy`` runs a module in its parameters' dtype, without
    grad, in chunks, and returns numpy."""
    _, tcv, x = _cvs("plain", 9)
    with torch.no_grad():
        want = tcv(torch.from_numpy(x)).numpy()
    got = tan._cv_on_numpy(tcv, x)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
