"""PyTorch port, the migration to and from the original colvarsfinder's
``model.pt`` state dicts (``checkpoint.load_torch_state_dict`` /
``save_torch_state_dict``) against the JAX package's, for the four model
types: a state dict named as the original names it, made with numpy from a
seed, loads into both packages; the two models compute the same function
(float32, 1e-6); the port writes back the very names and values, the ones
the JAX package writes, and a module laid out as the original's loads them
with ``strict=True``."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from colvarsfinder_tpu import checkpoint as jck
from colvarsfinder_tpu.models import AutoEncoder as JaxAE
from colvarsfinder_tpu.models import EigenFunctions as JaxEF
from colvarsfinder_tpu.models import RegAutoEncoder as JaxRegAE
from colvarsfinder_tpu.models import create_sequential_nn as jax_seq

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import checkpoint as tck

# float32 forwards of the same parameters in two libraries
ATOL = 1e-6
D_IN, K = 6, 3
#: each type's networks: (prefix, layer dims, heads or None)
NETS = {
    "sequential": [("", [D_IN, 8, 5, 2], None)],
    "eigenfunctions": [("eigen_funcs.", [D_IN, 8, 8, 1], K)],
    "autoencoder": [("encoder.", [D_IN, 8, 2], None),
                    ("decoder.", [2, 8, D_IN], None)],
    "regautoencoder": [("encoder.", [D_IN, 8, 2], None),
                       ("decoder.", [2, 8, D_IN], None),
                       ("reg.", [2, 5, 1], K)],
}


def _templates(kind):
    """The JAX and the port template of one architecture (their own
    weights, which the load replaces)."""
    if kind == "sequential":
        return jax_seq(NETS[kind][0][1], seed=1), port.create_sequential_nn(
            NETS[kind][0][1], seed=1)
    if kind == "eigenfunctions":
        return JaxEF([D_IN, 8, 8, 1], k=K, seed=1), port.EigenFunctions(
            [D_IN, 8, 8, 1], K)
    if kind == "autoencoder":
        return (JaxAE([D_IN, 8, 2], [2, 8, D_IN], seed=1),
                port.AutoEncoder([D_IN, 8, 2], [2, 8, D_IN]))
    return (JaxRegAE([D_IN, 8, 2], [2, 8, D_IN], [2, 5, 1], K=K, seed=1),
            port.RegAutoEncoder([D_IN, 8, 2], [2, 8, D_IN], [2, 5, 1], K))


def _reference_state_dict(kind, seed=0):
    """Names as the original colvarsfinder's modules hold them (Linear
    layers '1', '2', ... in each Sequential; heads in ModuleLists)."""
    rng = np.random.default_rng(seed)
    sd = collections.OrderedDict()
    for prefix, dims, heads in NETS[kind]:
        for h in range(heads or 1):
            pre = prefix if heads is None else f"{prefix}{h}."
            for i in range(len(dims) - 1):
                sd[f"{pre}{i + 1}.weight"] = torch.from_numpy(
                    rng.uniform(-0.5, 0.5, (dims[i + 1], dims[i]))
                    .astype(np.float32))
                sd[f"{pre}{i + 1}.bias"] = torch.from_numpy(
                    rng.uniform(-0.5, 0.5, dims[i + 1]).astype(np.float32))
    return sd


def _reference_module(kind):
    """A module laid out as the original's (its nn.py: Sequentials of
    Linear layers named '1', '2', ..., activations between them; the heads
    in ModuleLists 'eigen_funcs' and 'reg')."""
    def seq(dims):
        layers = []
        for i in range(len(dims) - 1):
            layers.append((str(i + 1), nn.Linear(dims[i], dims[i + 1])))
            if i < len(dims) - 2:
                layers.append((f"activation {i + 1}", nn.Tanh()))
        return nn.Sequential(collections.OrderedDict(layers))

    if kind == "sequential":
        return seq(NETS[kind][0][1])
    root = nn.Module()
    for prefix, dims, heads in NETS[kind]:
        name = prefix.rstrip(".")
        root.add_module(name, seq(dims) if heads is None else nn.ModuleList(
            [seq(dims) for _ in range(heads)]))
    return root


@pytest.mark.parametrize("source", ["mapping", "path"])
@pytest.mark.parametrize("kind", list(NETS))
def test_loaded_model_matches_jax(tmp_path, kind, source):
    sd = _reference_state_dict(kind)
    src = sd
    if source == "path":
        src = str(tmp_path / "model.pt")
        torch.save(sd, src)
    jt, tt = _templates(kind)
    jm, tm = jck.load_torch_state_dict(jt, src), tck.load_torch_state_dict(
        tt, src)
    assert type(tm) is type(tt) and tm is not tt
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (17, D_IN)).astype(np.float32))
    with torch.no_grad():
        got = tm(x).numpy()
    want = np.asarray(jm(jnp.asarray(x.numpy())))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", list(NETS))
def test_saved_state_dict_round_trips(tmp_path, kind):
    """The port writes back the names and values it loaded, the state dict
    the JAX package writes for the same model, in its order, and one the
    original's layout loads with strict=True."""
    sd = _reference_state_dict(kind)
    jt, tt = _templates(kind)
    tm = tck.load_torch_state_dict(tt, sd)
    out = tck.save_torch_state_dict(tm, str(tmp_path / "out" / "model.pt"))
    jout = jck.save_torch_state_dict(jck.load_torch_state_dict(jt, sd))
    assert list(out) == list(jout) and sorted(out) == sorted(sd)
    for name, value in sd.items():
        assert out[name].dtype == torch.float32
        assert torch.equal(out[name], value), name
        assert torch.equal(out[name], jout[name]), name
    back = torch.load(tmp_path / "out" / "model.pt", weights_only=True)
    assert all(torch.equal(back[n], out[n]) for n in out)
    ref = _reference_module(kind)
    ref.load_state_dict(out, strict=True)


def test_float64_template_keeps_its_dtype():
    """The loaded parameters take the template's dtype (and device)."""
    tt = port.EigenFunctions([D_IN, 8, 8, 1], K, dtype=torch.float64)
    tm = tck.load_torch_state_dict(tt, _reference_state_dict(
        "eigenfunctions"))
    assert {p.dtype for p in tm.parameters()} == {torch.float64}


def test_unsupported_type_is_refused_as_in_jax():
    for fn in ("load_torch_state_dict", "save_torch_state_dict"):
        args = ((object(), {}) if fn.startswith("load") else (object(),))
        with pytest.raises(TypeError) as jerr:
            getattr(jck, fn)(*args)
        with pytest.raises(TypeError) as terr:
            getattr(tck, fn)(*args)
        assert str(terr.value) == str(jerr.value)


def test_top_level_exports():
    assert port.load_torch_state_dict is tck.load_torch_state_dict
    assert port.save_torch_state_dict is tck.save_torch_state_dict
