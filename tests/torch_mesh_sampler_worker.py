"""One rank of the tests of ``tests/test_torch_mesh_samplers.py``.

    python tests/torch_mesh_sampler_worker.py MODE SPEC OUT RANK WORLD INIT

It imports torch and the port only, never JAX and never
``tests/conftest.py`` (pytest does not collect this file). MODE ``mesh``
joins a gloo group of WORLD ranks through the file ``INIT`` and runs every
case on a mesh over it, then the refusals of a count that does not divide;
MODE ``single`` runs every case on a mesh of one rank and again without a
mesh. SPEC is a pickle of each case's random draws by ``(stream, index)``
(the JAX package's, recorded by the test), served through the port's noise
seam ``sampling._make_noise``. Every result goes to
``OUT/<mode><world>_rank<rank>.npz``, and each run's files to
``OUT/files/<mode><world>_rank<rank>/<case>`` (``<case>_plain`` without a
mesh).

The cases are the JAX package's own meshed-sampler tests, at their sizes:
``tests/test_metad_reweight.py:176-184``, ``tests/test_umbrella.py:165-170``,
``tests/test_steered.py:138-142`` and ``tests/test_remd.py:130-134``.
:func:`run` takes the enhanced-sampling module and the array module, so the
test runs the JAX package's side through it too."""

from __future__ import annotations

import os
import pickle
import sys
from datetime import timedelta

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: each case's sampler and arguments; "pot" names the potential
CASES = {
    "metadynamics": dict(
        pot="double_well_8", n_steps=1_000, X0=[1.0], step_size=0.005,
        deposit_interval=50, hill_height=0.4, hill_width=0.3,
        bias_factor=8.0, n_chains=8, seed=4),
    "umbrella": dict(
        pot="double_well_4", centers=np.linspace(-1.2, 1.2, 16), kappa=40.0,
        n_steps=2_000, X0=[1.0], step_size=0.002, report_interval=20,
        seed=5),
    "steered": dict(
        pot="harmonic_2d", cv_start=0.0, cv_end=1.0, kappa=30.0,
        n_steps=1_000, n_realizations=16, X0=np.zeros(2), step_size=1e-3,
        report_interval=100, seed=7),
    "remd": dict(
        pot="harmonic_1d", betas=np.geomspace(4.0, 0.5, 8), n_steps=5_000,
        step_size=0.02, report_interval=10, exchange_interval=100, seed=9,
        X0=[1.0]),
}
#: the JAX package's draws by case (each case's scheme and walker count)
SCHEMES = {"metadynamics": ("metad", 8), "umbrella": ("em", 1),
           "steered": ("em", 1), "remd": ("remd", 1)}
#: the cases that write files
WRITES = ("metadynamics", "umbrella", "remd")


def potential(name, xp):
    """The JAX tests' potentials, on one state, in ``xp``."""

    class Pot:
        pass

    pot = Pot()
    if name.startswith("double_well"):
        pot.dim, pot.beta = 1, float(name.rsplit("_", 1)[1])
        pot.V = lambda x: (x[0] ** 2 - 1.0) ** 2
    elif name == "harmonic_2d":
        pot.dim, pot.beta = 2, 1.0
        pot.V = lambda x: 0.5 * x[0] ** 2 + 0.5 * x[1] ** 2
    else:
        pot.dim, pot.beta = 1, 1.0
        pot.V = lambda x: 0.5 * x[0] ** 2
    return pot


def cv(x):
    """The coordinate itself: ``x[:1]`` of one state, ``[c, 1]`` of a
    chain batch."""
    return x[..., :1]


def run(lib, xp, case, **over):
    """Case ``case`` through ``lib``'s sampler (the JAX package's
    ``utils.enhanced`` or the port's), with ``over`` added."""
    kw = dict(CASES[case], verbose=False, **over)
    pot = potential(kw.pop("pot"), xp)
    if case == "metadynamics":
        return lib.integrate_sde_metadynamics(pot, cv, **kw)
    if case == "umbrella":
        return lib.integrate_sde_umbrella(pot, cv, kw.pop("centers"),
                                          kw.pop("kappa"), **kw)
    if case == "steered":
        return lib.integrate_sde_steered(pot, cv, kw.pop("cv_start"),
                                         kw.pop("cv_end"), kw.pop("kappa"),
                                         **kw)
    return lib.integrate_sde_remd(pot, kw.pop("betas"), **kw)


def arrays(res):
    """Every array of a sampler's result, by name."""
    return {k: v for k, v in vars(res).items() if isinstance(v, np.ndarray)}


def odd(lib, xp, case, **over):
    """Case ``case``, cut to 100 steps, with three walkers, windows, pulls
    or slots."""
    three = {"metadynamics": dict(n_chains=3),
             "umbrella": dict(centers=[-0.5, 0.0, 0.5]),
             "steered": dict(n_realizations=3),
             "remd": dict(betas=[3.0, 2.0, 1.0])}[case]
    return run(lib, xp, case, n_steps=100, **three, **over)


class Replay:
    """Recorded draws served by ``(stream, index)``."""

    def __init__(self, draws):
        self.draws = draws

    def normal(self, out, stream, i):
        import torch

        value = self.draws[(stream, i)]
        if tuple(value.shape) != tuple(out.shape):
            raise ValueError(f"draw {(stream, i)} of shape {value.shape} "
                             f"asked as {tuple(out.shape)}")
        out.copy_(torch.from_numpy(value))

    uniform = normal


def main(mode, spec, out_dir, rank, world, init):
    import warnings
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from colvarsfinder_tpu_torch.parallel import make_data_mesh
    from colvarsfinder_tpu_torch.utils import enhanced as tenh
    from colvarsfinder_tpu_torch.utils import sampling

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")  # the steered pulls' shared start
    with open(spec, "rb") as f:
        draws = pickle.load(f)
    case_now = []
    sampling._make_noise = lambda seed, device: Replay(draws[case_now[-1]])
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=60))
    mesh = make_data_mesh()
    name = f"{mode}{world}_rank{rank}"
    files = Path(out_dir) / "files" / name
    out = {}
    try:
        for case in CASES:
            case_now.append(case)
            runs = [("mesh", mesh, case)]
            if mode == "single":
                runs.append(("plain", None, f"{case}_plain"))
            for tag, m, where in runs:
                over = dict(mesh=m, device="cpu")
                if case in WRITES:
                    over["sampling_output_path"] = str(files / where)
                for k, v in arrays(run(tenh, torch, case, **over)).items():
                    out[f"{tag}/{case}/{k}"] = v
        if mode == "mesh":
            for case in CASES:
                try:
                    odd(tenh, torch, case, mesh=mesh, device="cpu")
                    got = "no exception"
                except ValueError as err:  # held by the test
                    got = str(err)
                out[f"refusal/{case}"] = np.asarray(got)
    finally:
        dist.destroy_process_group()
    np.savez(str(Path(out_dir) / name) + ".npz", **out)


if __name__ == "__main__":
    mode, spec, out_dir, rank, world, init = sys.argv[1:]
    main(mode, spec, out_dir, int(rank), int(world), init)
