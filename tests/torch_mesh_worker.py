"""One rank of the data-mesh tests of ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_worker.py MODE SPEC OUT RANK WORLD INIT

It imports torch and the port only, never JAX and never
``tests/conftest.py`` (pytest does not collect this file). MODE ``mesh``
joins a gloo group of WORLD ranks through the file ``INIT`` and trains every
case on a mesh over it; MODE ``single`` trains every case on a mesh of one
rank and again without a mesh. SPEC is a pickle of the cases' initial
parameters (numpy, made by the test from the JAX models); every result goes
to ``OUT/<mode><world>_rank<rank>.npz``. The data is made here from seeds,
with numpy, and the test makes the same data for the JAX runs."""

from __future__ import annotations

import os
import pickle
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N, N_ATOMS, DT, LAG = 256, 4, 0.01, 2
TEST_RATIO = 0.25
COMMON = dict(batch_size=64, num_epochs=3, test_ratio=TEST_RATIO,
              save_model_every_step=0, verbose=False, tensorboard=False,
              debug_mode=False, seed=0, learning_rate=0.01)
#: the parity cases: the family and the options of each
CASES = {
    "transfer": ("transfer", {}),
    "generator_vjp": ("generator", {"gram_pp": False}),
    "generator_gram": ("generator_gram", {}),
    "committor": ("committor", {}),
    "ae": ("ae", {}),
    "regae": ("regae", {}),
    "streaming": ("transfer", {"streaming": True}),
    "shard_trajectory": ("transfer", {"shard_trajectory": True}),
}
#: the sweep grid (R = 4) and the replica ensemble's learning rates
GRID = {"learning_rate": [0.005, 0.01, 0.02, 0.04],
        "alpha": [5.0, 10.0, 20.0, 40.0]}
#: the refusals on a mesh of two ranks
REFUSALS = ["fused_step", "train_batch", "test_batch", "replicas",
            "meshed_task", "wire_dtype"]


def data(seed=3):
    """Frames of four atoms about a reference, the first moving along x,
    and non-uniform weights."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((N_ATOMS, 3))
    x = ref[None] + 0.2 * rng.standard_normal((N, N_ATOMS, 3))
    x[:, 0, 0] += np.linspace(-1.0, 1.0, N)[rng.permutation(N)]
    return ref, x.astype(np.float32), rng.uniform(0.5, 1.5, N)


def family_of(case):
    return CASES[case][0]


def lag_of(family):
    return LAG if family in ("transfer", "regae") else 0


def flat(family):
    return family in ("generator", "committor", "ae", "regae")


def split(family, test_ratio=TEST_RATIO):
    from colvarsfinder_tpu_torch.core.task import train_test_split

    return train_test_split(np.arange(N - lag_of(family)), test_ratio, 0)


def task_args(family):
    """The constructor arguments of a family beside the common ones."""
    ref, x, _ = data()
    a = {}
    if family in ("transfer", "generator", "generator_gram"):
        a.update(alpha=10.0, eig_weights=[1.0, 0.5], k=2,
                 lag_tau=LAG * DT if family == "transfer" else 0.0)
    elif family == "committor":
        c = x[:, 0, 0]
        a.update(alpha=100.0, beta=1.0, region_a=c < np.quantile(c, 0.15),
                 region_b=c > np.quantile(c, 0.85))
    elif family == "regae":
        a.update(eig_weights=[1.0, 0.5], alpha=1.0, gamma=(0.5, 0.25),
                 eta=(0.1, 0.1, 0.1), lag_tau_ae=LAG * DT,
                 lag_tau_reg=LAG * DT)
    return a


def port_pp(family, ref):
    import colvarsfinder_tpu_torch as port

    atoms = list(range(N_ATOMS))
    if flat(family):
        return None
    feats = [port.Feature("p", "position", atoms)]
    if family == "generator_gram":
        # a layer that is not the identity: the Gram path by default
        return port.FeatureLayer(feats + [port.Feature("b", "bond", [0, 3])])
    return port.PreprocessingANN(port.AlignmentLayer(ref, atoms),
                                 port.FeatureLayer(feats))


def port_model(family, params):
    import colvarsfinder_tpu_torch as port
    from colvarsfinder_tpu_torch.models.module import params_from_numpy

    if family in ("transfer", "generator", "generator_gram"):
        return port.EigenFunctions.from_numpy(params)
    if family == "committor":
        return params_from_numpy(params, [3 * N_ATOMS, 10, 1])
    if family == "ae":
        return port.AutoEncoder.from_numpy(*params)
    return port.RegAutoEncoder.from_numpy(*params)


def port_task(family, params, path, mesh=None, **kw):
    import colvarsfinder_tpu_torch as port

    ref, x, w = data()
    if flat(family):
        x = x.reshape(N, -1)
    cls = {"transfer": port.EigenFunctionTask,
           "generator": port.EigenFunctionTask,
           "generator_gram": port.EigenFunctionTask,
           "committor": port.CommittorTask, "ae": port.AutoEncoderTask,
           "regae": port.RegAutoEncoderTask}[family]
    args = {**COMMON, "split_indices": split(family), **task_args(family),
            **kw}
    traj = port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                   verbose=False)
    return cls(traj, port_pp(family, ref), port_model(family, params),
               str(path), device="cpu", mesh=mesh, **args)


def rows_of(task):
    """Every batch's metric row of every epoch, train then test."""
    return np.stack([np.concatenate(epoch) for epoch in task.loss_list])


def prepared_bytes(task):
    train, test = task._prepare_data()[:2]
    return sum(t.numel() * t.element_size() for batch in train + test
               for t in batch if t is not None)


def run_case(case, params, out, tag, path, mesh):
    family, kw = CASES[case]
    task = port_task(family, params, path, mesh=mesh, **kw)
    task.train()
    out[f"{tag}/{case}/rows"] = rows_of(task)
    for n, p in task.model.named_parameters():
        out[f"{tag}/{case}/param/{n}"] = p.detach().numpy().copy()
    if not task._streaming:
        out[f"{tag}/{case}/bytes"] = np.asarray(prepared_bytes(task))


def sweeps(params, out, tag, path, mesh):
    """R = 4 lr x alpha sweep, a replica ensemble of four tasks and an
    architecture ensemble (a group of two, a group of three, a single)."""
    from colvarsfinder_tpu_torch.parallel import (
        train_architecture_ensemble,
        train_hyperparameter_sweep,
        train_replica_ensemble,
    )

    p = params["transfer"]
    res = train_hyperparameter_sweep(
        port_task("transfer", p, path / "sweep"), GRID, mesh=mesh)
    for r, x in enumerate(res):
        out[f"{tag}/sweep/{r}/train"] = x.train_loss
        out[f"{tag}/sweep/{r}/test"] = x.test_loss
        for n, v in x.model.items():
            out[f"{tag}/sweep/{r}/param/{n}"] = v.numpy()
        out[f"{tag}/sweep/{r}/exp_avg"] = x.opt_state["state"][0][
            "exp_avg"].numpy()
    res = train_hyperparameter_sweep(
        port_task("transfer", p, path / "chunked"), GRID, chunk_size=2,
        mesh=mesh)
    for r, x in enumerate(res):
        out[f"{tag}/chunked/{r}/train"] = x.train_loss

    tasks = [port_task("transfer", p, path / f"ens{r}",
                       learning_rate=GRID["learning_rate"][r],
                       alpha=GRID["alpha"][r]) for r in range(4)]
    train_replica_ensemble(tasks, mesh=mesh)
    for r, t in enumerate(tasks):
        out[f"{tag}/ensemble/{r}/rows"] = rows_of(t)
        for n, v in t.model.named_parameters():
            out[f"{tag}/ensemble/{r}/param/{n}"] = v.detach().numpy().copy()

    wide = params["transfer_wide"]
    tasks = ([port_task("transfer", p, path / f"a{r}",
                        learning_rate=0.01 * (r + 1)) for r in range(2)]
             + [port_task("transfer", wide, path / f"b{r}",
                          learning_rate=0.01 * (r + 1)) for r in range(3)]
             + [port_task("ae", params["ae"], path / "c")])
    train_architecture_ensemble(tasks, mesh=mesh)
    for r, t in enumerate(tasks):
        out[f"{tag}/arch/{r}/rows"] = rows_of(t)


def refusals(params, out, path, mesh):
    """Each refusal's exception on a mesh of two ranks, as (class name,
    message)."""
    from colvarsfinder_tpu_torch.parallel import train_hyperparameter_sweep

    p = params["transfer"]
    cases = {
        "fused_step": lambda: port_task("transfer", p, path / "f", mesh,
                                        fused_step=True),
        # 64 / 63 do not divide over two ranks after the clamp
        "train_batch": lambda: port_task("transfer", p, path / "t", mesh,
                                         batch_size=63).train(),
        # a test split of 63 frames, clamped from batch_size 64
        "test_batch": lambda: port_task(
            "transfer", p, path / "s", mesh, test_ratio=0.248,
            split_indices=split("transfer", 0.248)).train(),
        "replicas": lambda: train_hyperparameter_sweep(
            port_task("transfer", p, path / "r"),
            {"alpha": [1.0, 2.0, 3.0]}, mesh=mesh),
        "meshed_task": lambda: train_hyperparameter_sweep(
            port_task("transfer", p, path / "m", mesh),
            {"alpha": [1.0, 2.0]}),
    }

    def wire():
        task = port_task("transfer", p, path / "w", mesh, streaming=True)
        task.stream_wire_dtype = "float16"
        task.train()

    cases["wire_dtype"] = wire
    for name in REFUSALS:
        try:
            cases[name]()
            got = ("", "no exception")
        except Exception as err:  # recorded, and held by the test
            got = (type(err).__name__ + "|" + "|".join(
                c.__name__ for c in type(err).__mro__), str(err))
        out[f"refusal/{name}"] = np.asarray(got)


def collectives(out, mesh, rank):
    """The gather's backward and the gradient sum on two ranks, and the
    helpers."""
    from colvarsfinder_tpu_torch.parallel import replicate
    from colvarsfinder_tpu_torch.parallel.collectives import (
        all_reduce_grads,
        gather_rows,
    )
    from colvarsfinder_tpu_torch.parallel.mesh import (
        shard_batches,
        shard_frames,
    )

    # L = (t_0 + t_1)^2 with t = (1, 2): dL/dt_r = 6 on each rank
    t = torch.tensor([rank + 1.0], dtype=torch.float64, requires_grad=True)
    (g,) = gather_rows(mesh, t)
    (g.sum() ** 2).backward()
    out["gather/value"] = g.detach().numpy()
    out["gather/grad"] = t.grad.numpy()
    # a shared parameter: t_r = theta * x_r, the gradient summed over ranks
    theta = torch.nn.Parameter(torch.tensor(0.5, dtype=torch.float64))
    x = torch.tensor([1.0, 2.0], dtype=torch.float64) + 2 * rank
    (y,) = gather_rows(mesh, theta * x)
    (y.sum() ** 2).backward()
    all_reduce_grads([theta], mesh)
    out["gather/theta_grad"] = theta.grad.numpy()
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2).double()
    replicate(lin, mesh)
    out["replicate/weight"] = lin.weight.detach().numpy()
    out["shard/batches"] = shard_batches(np.arange(12).reshape(2, 6), mesh)
    out["shard/frames"] = shard_frames(np.arange(5), mesh, pad=True)


def main(mode, spec, out_dir, rank, world, init):
    from pathlib import Path

    torch.set_num_threads(1)
    from colvarsfinder_tpu_torch import config
    from colvarsfinder_tpu_torch.parallel import make_data_mesh

    config.set_default_dtype("float64")
    with open(spec, "rb") as f:
        params = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=60))
    mesh = make_data_mesh()
    path = Path(out_dir) / f"{mode}{world}_rank{rank}"
    out = {}
    try:
        for case in CASES:
            run_case(case, params[family_of(case)], out, "mesh",
                     path / case, mesh)
            if mode == "single":
                run_case(case, params[family_of(case)], out, "plain",
                         path / f"{case}_plain", None)
        sweeps(params, out, "mesh", path, mesh)
        if mode == "single":
            sweeps(params, out, "plain", path / "plain", None)
        else:
            refusals(params, out, path / "refusals", mesh)
            collectives(out, mesh, rank)
    finally:
        dist.destroy_process_group()
    np.savez(str(path) + ".npz", **out)


if __name__ == "__main__":
    mode, spec, out_dir, rank, world, init = sys.argv[1:]
    main(mode, spec, out_dir, int(rank), int(world), init)
