"""PyTorch port, CV deployment artifacts: one CV built in both packages from
the same numpy weights, saved by each package's ``EigenFunctionTask.save_model``
before any training step, so both hold identical parameters. The save
directories must hold the same artifacts: the numpy spec and arrays equal,
the native program byte-equal, the two TorchScript modules equal to each
other and to the port's CV model, and no numpy, native or TorchScript
artifact where the CV has no spec (``FusedAlignmentLayer``, ``Lambda``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.core import AutoEncoderTask as JaxAETask
from colvarsfinder_tpu.core import CommittorTask as JaxCommittorTask
from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
from colvarsfinder_tpu.deploy import load_numpy_cv as jax_load_numpy_cv
from colvarsfinder_tpu.models import AutoEncoder as JaxAutoEncoder
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.models import create_sequential_nn as jax_sequential
from colvarsfinder_tpu.ops import Lambda as JaxLambda
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.ops.kabsch_pallas import FusedAlignmentLayer as JaxFused
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch.deploy import UnsupportedLayerError, build_spec

N_FRAMES, N_ATOMS, M_ALIGN, DT, K = 40, 8, 6, 0.01, 2
ALIGN_IDX = [5, 0, 2, 7, 3, 1]  # unsorted: the spec keeps the order
FEATURES = [
    ("p", "position", [0, 2, 5], None),
    ("b", "bond", [1, 6], None),
    ("a", "angle", [0, 3, 4], None),
    ("ar", "angle_rad", [2, 4, 6], None),
    ("d", "dihedral", [0, 1, 2, 3], None),
    ("dr", "dihedral_rad", [4, 5, 6, 7], None),
    ("c", "contact", [1, 7], {"r0": 1.5, "nn": 6}),
]
D_R = 9 + 1 + 1 + 1 + 2 + 1 + 1
# the files that only one package writes: its model and training state
OWN = {"model.npz", "model.pt", "train_state.npz", "train_state.pt"}
CV_FILES = {"cv_params.npz", "cv_spec.json", "cv_numpy_spec.json",
            "cv_numpy.npz", "cv_native.bin", "scripted_cv_cpu.pt"}
TASK_ARGS = dict(alpha=5.0, eig_weights=[1.0, 0.5], lag_tau=2 * DT, k=K,
                 learning_rate=0.01, save_model_every_step=0, batch_size=16,
                 num_epochs=1, test_ratio=0.25, verbose=False,
                 tensorboard=False, seed=0, debug_mode=False)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    base = 1.5 * rng.standard_normal((N_ATOMS, 3))
    x = base[None] + 0.2 * rng.standard_normal((N_FRAMES, N_ATOMS, 3))
    ref = x[0][ALIGN_IDX]
    masses = np.linspace(1.0, 16.0, M_ALIGN)
    return x.astype(np.float32), ref.astype(np.float32), masses


def _pp(lib, kind, ref, masses):
    """The same preprocessing layer from either package."""
    if kind == "lambda":
        if lib == "jax":
            return JaxLambda(lambda x: x.reshape(x.shape[0], -1)[:, :D_R])
        return port.ops.Lambda(lambda x: x.reshape(x.shape[0], -1)[:, :D_R])
    feats = [(JaxFeature if lib == "jax" else port.Feature)(*f)
             for f in FEATURES]
    layer = (JaxFeatureLayer if lib == "jax" else port.FeatureLayer)(feats)
    if kind == "fused":
        al = (JaxFused if lib == "jax" else port.FusedAlignmentLayer)(
            ref, ALIGN_IDX)
    else:
        al = (JaxAlign if lib == "jax" else port.AlignmentLayer)(
            ref, ALIGN_IDX,
            align_weights=masses if kind == "weighted" else None)
    return (JaxPP if lib == "jax" else port.PreprocessingANN)(al, layer)


def _save_both(tmp_path, kind, activation="tanh"):
    """Each package's save_model on the same CV; returns both directories
    and the port's task."""
    x, ref, masses = _data()
    w = np.random.default_rng(1).uniform(0.5, 1.5, N_FRAMES)
    jm = JaxEigenFunctions([D_R, 8, 8, 1], K, activation=activation, seed=4)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    jtask = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                    _pp("jax", kind, ref, masses), jm,
                    str(tmp_path / "jax"), export_cv=False, **TASK_ARGS)
    ptask = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", kind, ref, masses),
        port.EigenFunctions.from_numpy(params, activation), str(tmp_path /
                                                               "port"),
        device="cpu", **TASK_ARGS)
    jtask.save_model(0)
    ptask.save_model(0)
    return tmp_path / "jax" / "latest", tmp_path / "port" / "latest", ptask, x


def _save_both_committor(tmp_path):
    """Each package's CommittorTask.save_model on the same logit CV (a
    ``Sequential`` head); returns both directories and the port's task."""
    x, ref, masses = _data()
    w = np.random.default_rng(1).uniform(0.5, 1.5, N_FRAMES)
    jm = jax_sequential([D_R, 8, 8, 1], seed=5)
    named = {n: np.asarray(v) for n, v in jm.named_parameters()}
    c = x[:, 0, 0]
    args = dict(region_a=c < np.quantile(c, 0.2),
                region_b=c > np.quantile(c, 0.8), save_model_every_step=0,
                batch_size=16, num_epochs=1, test_ratio=0.25, verbose=False,
                tensorboard=False, seed=0, debug_mode=False)
    jtask = JaxCommittorTask(
        JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
        _pp("jax", "plain", ref, masses), jm, str(tmp_path / "jax"),
        export_cv=False, **args)
    ptask = port.CommittorTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", "plain", ref, masses),
        port.models.params_from_numpy(named, [D_R, 8, 8, 1]),
        str(tmp_path / "port"), device="cpu", **args)
    jtask.save_model(0)
    ptask.save_model(0)
    return tmp_path / "jax" / "latest", tmp_path / "port" / "latest", ptask, x


def _save_both_ae(tmp_path):
    """Each package's AutoEncoderTask.save_model on the same CV: the
    preprocessing layer and the encoder (a ``Sequential``, two CVs)."""
    x, ref, masses = _data()
    w = np.random.default_rng(1).uniform(0.5, 1.5, N_FRAMES)
    jm = JaxAutoEncoder([D_R, 8, 8, 2], [2, 8, D_R], seed=6)
    params = [[{n: np.asarray(v) for n, v in p.items()} for p in seq.params]
              for seq in (jm.encoder, jm.decoder)]
    args = dict(save_model_every_step=0, batch_size=16, num_epochs=1,
                test_ratio=0.25, verbose=False, tensorboard=False, seed=0,
                debug_mode=False)
    jtask = JaxAETask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                      _pp("jax", "plain", ref, masses), jm,
                      str(tmp_path / "jax"), export_cv=False, **args)
    ptask = port.AutoEncoderTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", "plain", ref, masses), port.AutoEncoder.from_numpy(
            *params), str(tmp_path / "port"), device="cpu", **args)
    jtask.save_model(0)
    ptask.save_model(0)
    return tmp_path / "jax" / "latest", tmp_path / "port" / "latest", ptask, x


def _names(d):
    return {p.name for p in d.iterdir()} - OWN


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("kind,activation", [("plain", "tanh"),
                                             ("weighted", "gelu"),
                                             ("committor", "tanh"),
                                             ("autoencoder", "tanh")])
def test_save_model_writes_the_jax_artifacts(tmp_path, kind, activation):
    if kind in ("committor", "autoencoder"):
        if kind == "committor":
            jdir, pdir, ptask, x = _save_both_committor(tmp_path)
            k, dumps = 1, ("0_1_weight.txt", "0_3_bias.txt")
        else:
            jdir, pdir, ptask, x = _save_both_ae(tmp_path)
            k, dumps = 2, ("0_1_weight.txt", "1_3_weight.txt", "1_3_bias.txt")
        with open(pdir / "cv_numpy_spec.json") as f:
            assert json.load(f)["graph"]["stages"][1]["kind"] == "mlp"
        # the per-CV text dumps (the last layer sliced to the CV's row),
        # equal in both
        for name in dumps:
            np.testing.assert_array_equal(np.loadtxt(pdir / name),
                                          np.loadtxt(jdir / name))
        # cv_params.npz: the same arrays under each package's names
        jp, pp = _npz(jdir / "cv_params.npz"), _npz(pdir / "cv_params.npz")
        al = "pp_layer.alignment_layer."
        mapping = {"0.0.0": al + "ref_centered", "0.0.1": al + "align_idx"}
        for li in range(3):
            for part in ("weight", "bias"):
                mapping[f"1.0.{li}.{part}"] = f"head.{li + 1}.{part}"
        assert set(jp) == set(mapping) and set(pp) == set(mapping.values())
        for jkey, pkey in mapping.items():
            np.testing.assert_array_equal(pp[pkey], jp[jkey])
    else:
        jdir, pdir, ptask, x = _save_both(tmp_path, kind, activation)
        k = K
    assert _names(jdir) == _names(pdir)
    assert CV_FILES <= _names(pdir)
    assert {"model.pt", "train_state.pt"} <= {p.name for p in pdir.iterdir()}

    with open(jdir / "cv_numpy_spec.json") as f, \
            open(pdir / "cv_numpy_spec.json") as g:
        assert json.load(f) == json.load(g)
    jp, pp = _npz(jdir / "cv_numpy.npz"), _npz(pdir / "cv_numpy.npz")
    assert list(jp) == list(pp)
    for key in jp:
        assert jp[key].dtype == pp[key].dtype, key
        np.testing.assert_array_equal(pp[key], jp[key])
    assert (jdir / "cv_native.bin").read_bytes() == \
        (pdir / "cv_native.bin").read_bytes()

    # the two TorchScript modules, and the port's live CV model, on a batch
    # and on a single state (f32; tests/test_torch_deploy.py's bar)
    cv = ptask.colvar_model()
    js = torch.jit.load(str(jdir / "scripted_cv_cpu.pt"))
    ps = torch.jit.load(str(pdir / "scripted_cv_cpu.pt"))
    xb = torch.from_numpy(x)
    with torch.no_grad():
        live = cv(xb)
        for state in (xb, xb[3]):
            a, b = ps(state), js(state)
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, atol=2e-6, rtol=0)
        torch.testing.assert_close(ps(xb), live, atol=2e-6, rtol=0)
        torch.testing.assert_close(ps(xb[3]), live[3], atol=2e-6, rtol=0)

    # values and input Jacobian of the numpy evaluators, in float64
    xs = x[:7].astype(np.float64)
    pv, pj = port.load_numpy_cv(str(pdir), with_grad=True)(xs)
    jv, jj = jax_load_numpy_cv(str(jdir), with_grad=True)(xs)
    assert pj.shape == (7, k, N_ATOMS, 3)
    np.testing.assert_allclose(pv, jv, atol=1e-8, rtol=0)
    np.testing.assert_allclose(pj, jj, atol=1e-8, rtol=0)


def test_cv_params_match_through_the_weight_mapping(tmp_path):
    jdir, pdir, _, _ = _save_both(tmp_path, "weighted")
    jp, pp = _npz(jdir / "cv_params.npz"), _npz(pdir / "cv_params.npz")
    al = "pp_layer.alignment_layer."
    mapping = {"0.0.0": al + "ref_centered", "0.0.1": al + "align_idx",
               "0.0.2": al + "align_weights"}
    for li in range(3):
        mapping[f"1.0.{li}.weight"] = f"head.weights.{li}"
        mapping[f"1.0.{li}.bias"] = f"head.biases.{li}"
    assert set(jp) == set(mapping)
    assert set(pp) == set(mapping.values())
    for jkey, pkey in mapping.items():
        np.testing.assert_array_equal(pp[pkey], jp[jkey])
    with open(jdir / "cv_spec.json") as f, open(pdir / "cv_spec.json") as g:
        js, ps = json.load(f), json.load(g)
    assert ps["param_order"] == list(pp)
    for field in ("format", "input_state_shape", "pp_layer", "head"):
        assert ps[field] == js[field], field
    assert ps["input_state_shape"] == [N_ATOMS, 3]


@pytest.mark.parametrize("kind", ["fused", "lambda"])
def test_cv_without_a_spec_writes_only_params_and_manifest(tmp_path, kind):
    jdir, pdir, ptask, _ = _save_both(tmp_path, kind)
    assert _names(jdir) == _names(pdir)
    assert _names(pdir) & CV_FILES == {"cv_params.npz", "cv_spec.json"}
    with pytest.raises(UnsupportedLayerError):
        build_spec(ptask.colvar_model(), {})


def test_each_package_reads_the_others_numpy_artifact(tmp_path):
    jdir, pdir, _, x = _save_both(tmp_path, "plain")
    xs = x[:5].astype(np.float64)
    a = port.load_numpy_cv(str(jdir))(xs)
    b = jax_load_numpy_cv(str(pdir))(xs)
    np.testing.assert_array_equal(a, b)
    # the TorchScript module rebuilt from the JAX package's numpy artifact
    # alone is the one the port wrote
    path = port.torchscript_from_numpy_cv(str(jdir), str(tmp_path / "re"))
    with torch.no_grad():
        xb = torch.from_numpy(x)
        torch.testing.assert_close(
            torch.jit.load(path)(xb),
            torch.jit.load(str(pdir / "scripted_cv_cpu.pt"))(xb),
            atol=0, rtol=0)


def test_gelu_is_the_tanh_approximation():
    z = np.linspace(-6.0, 6.0, 101, dtype=np.float32)
    from colvarsfinder_tpu.models.module import ACTIVATIONS as JAX_ACT
    from colvarsfinder_tpu_torch.models.module import ACTIVATIONS
    np.testing.assert_allclose(
        ACTIVATIONS["gelu"](torch.from_numpy(z)).numpy(),
        np.asarray(JAX_ACT["gelu"](jnp.asarray(z))), atol=1e-6, rtol=0)


def test_export_colvar_takes_a_tensor_and_refuses_stablehlo(tmp_path):
    x, ref, masses = _data()
    cv = port.ColvarModel(_pp("port", "plain", ref, masses),
                          port.EigenFunctions([D_R, 8, 1], K))
    port.export_colvar(cv, torch.from_numpy(x[:1]), str(tmp_path))
    assert CV_FILES <= {p.name for p in tmp_path.iterdir()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.export_colvar(cv, x[:1], str(tmp_path), write_stablehlo=True)
