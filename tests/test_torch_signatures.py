"""PyTorch port, the API against the JAX package's: every public name of
``analysis``, ``plotting``, ``tune``, ``workflow``, ``checkpoint``,
``ops.alignment``, ``utils.enhanced`` and the top level exists in the port,
and every function, class constructor and public method of the first seven
(and the task constructors, ``EigenFunctionTask.loss_func`` and
``core.losses.eigen_loss``) takes the same parameters (names, kinds,
defaults) in the same order.

The exceptions, each also listed in ROADMAP.md (deliberate differences):
``EXTRA`` names parameters the port adds at the end, ``PORT_DEFAULTS``
defaults the port gives where the JAX package has none, and ``JAX_ONLY``
what the port does not carry, each with the ROADMAP entry that gives its
counterpart or its reason."""

import inspect

import pytest

import colvarsfinder_tpu as jtop
from colvarsfinder_tpu import analysis as jan
from colvarsfinder_tpu import checkpoint as jck
from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu import core as jcore
from colvarsfinder_tpu import export as jexport
from colvarsfinder_tpu import models as jmodels
from colvarsfinder_tpu import plotting as jplot
from colvarsfinder_tpu import tune as jtune
from colvarsfinder_tpu import workflow as jwork
from colvarsfinder_tpu.core import losses as jlosses
from colvarsfinder_tpu.ops import alignment as jal
from colvarsfinder_tpu.utils import enhanced as jenh

import colvarsfinder_tpu_torch as ttop
from colvarsfinder_tpu_torch import analysis as tan
from colvarsfinder_tpu_torch import checkpoint as tck
from colvarsfinder_tpu_torch import config as tconfig
from colvarsfinder_tpu_torch import core as tcore
from colvarsfinder_tpu_torch import export as texport
from colvarsfinder_tpu_torch import models as tmodels
from colvarsfinder_tpu_torch import plotting as tplot
from colvarsfinder_tpu_torch import tune as ttune
from colvarsfinder_tpu_torch import workflow as twork
from colvarsfinder_tpu_torch.core import losses as tlosses
from colvarsfinder_tpu_torch.ops import alignment as tal
from colvarsfinder_tpu_torch.utils import enhanced as tenh

#: (JAX module, port module, the names compared: None for every name of
#: the JAX module's __all__ and its public methods)
MODULES = {
    "analysis": (jan, tan, None),
    "plotting": (jplot, tplot, None),
    "tune": (jtune, ttune, None),
    "workflow": (jwork, twork, None),
    "checkpoint": (jck, tck, None),
    "ops.alignment": (jal, tal, None),
    "utils.enhanced": (jenh, tenh, None),
    "core": (jcore, tcore, ("AutoEncoderTask", "CommittorTask",
                            "EigenFunctionTask", "EigenFunctionTask.loss_func",
                            "RegAutoEncoderTask")),
    "core.losses": (jlosses, tlosses, ("eigen_loss",)),
}
#: public names outside the JAX module's __all__, compared as well
MORE = {
    "ops.alignment": ("newton_diff_mode", "quaternion_from_covariance",
                      "quaternion_to_rotation_entries"),
    "utils.enhanced": ("SteeredResult", "integrate_sde_steered"),
}
#: where the samplers run (the card unless 'cpu') (ROADMAP.md, deliberate
#: differences: samplers)
_SAMPLER = ("device",)
#: port-only trailing parameters
EXTRA = {
    # where the samplers of the adaptive loop run
    ("workflow", "adaptive_cv_discovery"): ("device",),
    ("utils.enhanced", "integrate_sde_metadynamics"): _SAMPLER,
    ("utils.enhanced", "integrate_sde_umbrella"): _SAMPLER,
    ("utils.enhanced", "integrate_sde_steered"): _SAMPLER,
    ("utils.enhanced", "integrate_sde_remd"): _SAMPLER,
    # the per-sample Jacobian inside a replica map and the mesh's gather
    # (ROADMAP.md, deliberate differences: the mesh; sweeps)
    ("core.losses", "eigen_loss"): ("jac", "gather"),
}
#: port-only defaults, which the port's transfer-operator callers rely on
PORT_DEFAULTS = {("core.losses", "eigen_loss"): {"beta": 1.0,
                                                 "diag_coeff": None}}

_PYTREE = "the tree_flatten protocol (torch modules)"
_STATE = "the state dict and cv_params.npz"
#: (module, name, parameter or None for the name): the ROADMAP.md entry
JAX_ONLY = {
    ("checkpoint", "save_pytree", None): _STATE,
    ("checkpoint", "load_pytree", None): _STATE,
    ("checkpoint", "tree_to_named_arrays", None): _STATE,
    ("checkpoint", "save_spec", None): _STATE,
    ("checkpoint", "save_orbax", None): "save_orbax / load_orbax",
    ("checkpoint", "load_orbax", None): "save_orbax / load_orbax",
    ("config", "set_compilation_cache", None): "the kernels' build directory",
    ("config", "compilation_cache_dir", None):
        "the kernels' build directory",
    ("core", "TrainingTask.compile_multi_epoch", None): "the captured epoch",
    ("core", "TrainingTask.relayout", None): "the captured epoch",
    ("core", "TrainingTask.unwrap_opt_state", None):
        "torch.optim param groups",
    ("core", "TrainingTask.set_learning_rate", None):
        "torch.optim param groups",
    ("ops.alignment", "AlignmentLayer.tree_flatten", None): _PYTREE,
    ("ops.alignment", "AlignmentLayer", "_ref_centered"): _PYTREE,
    ("ops.alignment", "AlignmentLayer", "_align_idx"): _PYTREE,
    ("ops.alignment", "AlignmentLayer", "_align_weights"): _PYTREE,
    ("export", "ColvarModel.tree_flatten", None): _PYTREE,
    ("models", "EigenFunctions.tree_flatten", None): _PYTREE,
    ("models", "EigenFunctions", "key"): "key= (seed= / generator=)",
    ("models", "AutoEncoder", "key"): "key= (seed= / generator=)",
    ("models", "RegAutoEncoder", "key"): "key= (seed= / generator=)",
    ("models", "create_sequential_nn", "key"): "key= (seed= / generator=)",
}
PAIRS = {**{m: (j, t) for m, (j, t, _) in MODULES.items()},
         "config": (jconfig, tconfig), "export": (jexport, texport),
         "models": (jmodels, tmodels)}


def _params(obj):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(obj).parameters.values()]


def _callables(module, names):
    for name in names:
        obj = getattr(module, name)
        if inspect.isclass(obj):
            yield name, obj
            for meth, fn in vars(obj).items():
                if callable(fn) and not meth.startswith("_"):
                    yield f"{name}.{meth}", fn
        elif callable(obj):
            yield name, obj


def _resolve(module, name):
    for part in name.split("."):
        module = getattr(module, part, None)
    return module


def _compared(mod):
    jm, _, names = MODULES[mod]
    if names is not None:
        return list(names)
    found = [n for n, _ in _callables(jm, list(jm.__all__) + list(
        MORE.get(mod, ())))]
    return [n for n in found if (mod, n, None) not in JAX_ONLY]


CASES = [(mod, name) for mod in MODULES for name in _compared(mod)]


def test_every_public_name_exists():
    for mod, (jm, tm, names) in MODULES.items():
        if names is not None:
            continue
        for name in jm.__all__:
            if (mod, name, None) in JAX_ONLY:
                assert not hasattr(tm, name), (mod, name)
            else:
                assert name in tm.__all__ and hasattr(tm, name), (mod, name)
    # the top level exports every name the JAX package's does
    assert set(jtop.__all__) <= set(ttop.__all__)
    for name in jtop.__all__:
        assert hasattr(ttop, name), name


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}.{n}" for m, n in CASES])
def test_same_parameters(mod, name):
    jm, tm, _ = MODULES[mod]
    jobj, tobj = _resolve(jm, name), _resolve(tm, name)
    dropped = {p for (m, n, p) in JAX_ONLY if (m, n) == (mod, name) and p}
    want = [p for p in _params(jobj) if p[0] not in dropped]
    defaults = PORT_DEFAULTS.get((mod, name), {})
    want = [(n, k, defaults.get(n, d)) for n, k, d in want]
    got = _params(tobj)
    extra = EXTRA.get((mod, name), ())
    n = len(got) - len(extra)
    assert [p[0] for p in got[n:]] == list(extra)
    assert got[:n] == want, (mod, name)


JAX_ONLY_CASES = sorted(JAX_ONLY, key=str)


@pytest.mark.parametrize("mod,name,param", JAX_ONLY_CASES,
                         ids=[f"{m}.{n}" + (f"({p}=)" if p else "")
                              for m, n, p in JAX_ONLY_CASES])
def test_jax_only_names_are_absent_from_the_port(mod, name, param):
    """Each recorded exception is real: in the JAX package, not in the
    port (so the list and ROADMAP.md stay true)."""
    jm, tm = PAIRS[mod]
    jobj, tobj = _resolve(jm, name), _resolve(tm, name)
    assert jobj is not None, (mod, name)
    if param is None:
        assert tobj is None, (mod, name)
    else:
        assert param in inspect.signature(jobj).parameters
        assert param not in inspect.signature(tobj).parameters
