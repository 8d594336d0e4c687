"""PyTorch port, the API of ``analysis``, ``plotting``, ``tune`` and
``workflow``: every public name of the JAX package's four modules exists in
the port, and every function, class constructor and public method takes the
same parameters (names, kinds, defaults) in the same order.

The exceptions, each also listed in ROADMAP.md (deliberate differences):
``EXTRA`` names parameters the port adds at the end."""

import inspect

import pytest

from colvarsfinder_tpu import analysis as jan
from colvarsfinder_tpu import plotting as jplot
from colvarsfinder_tpu import tune as jtune
from colvarsfinder_tpu import workflow as jwork

from colvarsfinder_tpu_torch import analysis as tan
from colvarsfinder_tpu_torch import plotting as tplot
from colvarsfinder_tpu_torch import tune as ttune
from colvarsfinder_tpu_torch import workflow as twork

MODULES = {"analysis": (jan, tan), "plotting": (jplot, tplot),
           "tune": (jtune, ttune), "workflow": (jwork, twork)}
# port-only trailing parameters: where the samplers of the adaptive loop
# run (the card unless 'cpu')
EXTRA = {("workflow", "adaptive_cv_discovery"): ("device",)}


def _params(obj):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(obj).parameters.values()]


def _callables(module):
    for name in module.__all__:
        obj = getattr(module, name)
        if inspect.isclass(obj):
            yield name, obj
            for meth, fn in vars(obj).items():
                if callable(fn) and not meth.startswith("_"):
                    yield f"{name}.{meth}", fn
        elif callable(obj):
            yield name, obj


CASES = [(mod, name) for mod, (jm, _) in MODULES.items()
         for name, _ in _callables(jm)]


def test_every_public_name_exists():
    for mod, (jm, tm) in MODULES.items():
        assert set(jm.__all__) <= set(tm.__all__), mod
        for name in jm.__all__:
            assert hasattr(tm, name), (mod, name)


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}.{n}" for m, n in CASES])
def test_same_parameters(mod, name):
    jm, tm = MODULES[mod]
    jobj, tobj = jm, tm
    for part in name.split("."):
        jobj, tobj = getattr(jobj, part), getattr(tobj, part)
    got = _params(tobj)
    extra = EXTRA.get((mod, name), ())
    n = len(got) - len(extra)
    assert [p[0] for p in got[n:]] == list(extra)
    assert got[:n] == _params(jobj), (mod, name)
