r"""Dipeptide-style MD workflow on the PyTorch port (the port of
``examples/dipeptide.py``; counterpart of the reference's
examples/dipeptide/main.ipynb), fully native — no MDAnalysis/OpenMM needed.

Steps:
  1. build an alanine-dipeptide-like topology (22 atoms, 3 residues);
  2. synthesize an MD-like trajectory with a *planted two-state ψ-dihedral
     mode* (the NME side of the molecule rotates around the CA-C bond
     between two metastable torsion angles) plus thermal noise and random
     rigid-body motion, written/read as compressed XTC — the reference's
     trajectory format (main.ipynb cell 2);
  3. select the 10 heavy atoms (``type C or type O or type N``), build the
     preprocessing layer: Kabsch alignment + position features (d_r = 30);
  4. train k=2 eigenfunctions of the transfer operator with lag time
     (reference main.ipynb cells 10-18);
  5. scientific validation (reference main.ipynb cells 6 and 21): compute
     the Ramachandran angles φ/ψ with the native dihedral features, check
     the leading CV tracks the planted torsional mode, and save the
     CV-vs-ψ scatter plot;
  6. export the CV model as a deployment artifact (the numpy, native and
     TorchScript files, and the compiled programs unless
     ``--skip-programs``) and a PLUMED input.

The trajectory is read through the port's ``Universe`` (its XTC decoder,
native where ``g++`` builds it). Training runs on the card unless
``--device cpu``; ``--plot`` saves the Ramachandran scatter (matplotlib).

Run:  python examples/torch/dipeptide.py [--epochs 20] [--device cpu]
A cut run (the CPU test): --n-frames 2000 --epochs 2 --skip-programs
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from colvarsfinder_tpu_torch import write_plumed_metad
from colvarsfinder_tpu_torch.analysis import (
    ck_test,
    cv_sensitivity,
    free_energy_profile,
    implied_timescales,
    vamp_score,
)
from colvarsfinder_tpu_torch.core import EigenFunctionTask
from colvarsfinder_tpu_torch.export import export_colvar
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.ops import (
    AlignmentLayer,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    backbone_dihedrals,
)
from colvarsfinder_tpu_torch.utils import (
    Universe,
    WeightedTrajectory,
    write_xtc,
)
from colvarsfinder_tpu_torch.utils.io import Topology, write_gro

# full-topology atom indices of the Ramachandran backbone quadruples
PHI_ATOMS = (4, 6, 8, 14)   # C(ACE) - N - CA - C
PSI_ATOMS = (6, 8, 14, 16)  # N - CA - C - N(NME)
PSI_ROTATING = list(range(15, 22))  # O + NME cap: moves with the ψ rotation


def build_topology() -> Topology:
    """22-atom ACE-ALA-NME-like topology with plausible geometry."""
    rng = np.random.default_rng(0)
    names = [
        "HH31", "CH3", "HH32", "HH33", "C", "O",          # ACE
        "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3",  # ALA
        "C", "O",
        "N", "H", "CH3", "HH31", "HH32", "HH33",          # NME
    ]
    resids = [1] * 6 + [2] * 10 + [3] * 6
    resnames = ["ACE"] * 6 + ["ALA"] * 10 + ["NME"] * 6
    # a bent backbone with jittered substituents (nm scale)
    pos = np.zeros((22, 3), dtype=np.float32)
    backbone = {1: 0, 4: 1, 6: 2, 8: 3, 14: 4, 16: 5, 18: 6}
    for i in range(22):
        if i in backbone:
            t = backbone[i]
            pos[i] = [0.14 * t, 0.05 * ((-1) ** t), 0.02 * t]
        else:
            anchor = max((b for b in backbone if b <= i), default=1)
            pos[i] = pos[anchor] + 0.1 * rng.standard_normal(3)
    return Topology(names=names, resids=resids, resnames=resnames,
                    positions=pos, title="synthetic alanine dipeptide")


def dihedral_np(x, a, b, c, d):
    """Torsion angle (rad) of atoms a-b-c-d for frames [n, N, 3] (numpy)."""
    b1 = x[:, b] - x[:, a]
    b2 = x[:, c] - x[:, b]
    b3 = x[:, d] - x[:, c]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=1, keepdims=True))
    xx = (n1 * n2).sum(axis=1)
    yy = (m1 * n2).sum(axis=1)
    return np.arctan2(yy, xx)


def _rotation_about_axis(axis, angle):
    """Rodrigues rotation matrix for a unit axis and angle."""
    ux, uy, uz = axis
    K = np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]])
    return (
        np.eye(3) * np.cos(angle)
        + np.sin(angle) * K
        + (1 - np.cos(angle)) * np.outer(axis, axis)
    )


def synthesize_trajectory(top: Topology, n_frames: int, dt_ps: float,
                          outdir: str):
    """MD-like frames with a *real* ψ-dihedral two-state mode: the O + NME
    cap rotates around the CA-C bond, hopping between two metastable
    torsion angles — the reaction coordinate the CV should discover
    (stands in for the reference's biased alanine-dipeptide data).

    Returns (xtc_path, planted ψ series [n_frames]).
    """
    rng = np.random.default_rng(42)
    base = top.positions.astype(np.float64)

    # two-state Markov jump + OU jitter around each well
    psi_states = np.array([-1.2, 2.0])  # rad (~ -69°, ~115°)
    state = np.zeros(n_frames, dtype=int)
    for t in range(1, n_frames):
        flip = rng.random() < 0.01
        state[t] = 1 - state[t - 1] if flip else state[t - 1]
    jitter = np.zeros(n_frames)
    for t in range(1, n_frames):
        jitter[t] = 0.9 * jitter[t - 1] + 0.08 * rng.standard_normal()
    psi_target = psi_states[state] + jitter

    psi0 = dihedral_np(base[None], *PSI_ATOMS)[0]
    # rotation axis along the C -> CA direction so a positive rotation
    # angle increases ψ under the dihedral sign convention used here
    axis = base[PSI_ATOMS[1]] - base[PSI_ATOMS[2]]
    axis /= np.linalg.norm(axis)
    pivot = base[PSI_ATOMS[2]]

    frames = np.repeat(base[None], n_frames, axis=0)
    for t in range(n_frames):
        R = _rotation_about_axis(axis, psi_target[t] - psi0)
        frames[t, PSI_ROTATING] = (
            (frames[t, PSI_ROTATING] - pivot) @ R.T + pivot
        )
    frames += 0.004 * rng.standard_normal(frames.shape)  # thermal noise
    # random rigid-body motion per frame (so alignment has real work)
    for t in range(n_frames):
        A = rng.standard_normal((3, 3))
        Q, Rq = np.linalg.qr(A)
        Q = Q * np.sign(np.diag(Rq))
        if np.linalg.det(Q) < 0:
            Q[:, 0] = -Q[:, 0]
        frames[t] = frames[t] @ Q + rng.standard_normal(3)

    path = os.path.join(outdir, "md_traj.xtc")
    write_xtc(path, frames.astype(np.float32), dt_ps=dt_ps)
    return path, psi_target


def validate_cv_vs_dihedrals(cv_vals, phi, psi, outdir=None, verbose=True):
    """Reference main.ipynb cells 6/21: check the leading CV resolves the
    torsional mode and plot CV over the Ramachandran plane.

    Returns |R| — the multiple correlation (sqrt of the regression R²) of
    the leading CV on the ψ circle basis (1, cos ψ, sin ψ): the CV tracks
    the torsional mode iff it is (to first order) a function of ψ. A
    single fixed projection like cos(ψ - ψ̄) would miss the mode whenever
    the slow coordinate lies along the orthogonal circle direction.
    """
    basis = np.stack([np.ones_like(psi), np.cos(psi), np.sin(psi)], axis=1)
    y = cv_vals[:, 0] - cv_vals[:, 0].mean()
    coef, *_ = np.linalg.lstsq(basis, y, rcond=None)
    resid = y - basis @ coef
    corr = float(np.sqrt(max(0.0, 1.0 - (resid**2).sum() / (y**2).sum())))
    if verbose:
        print(f"R(CV_1 ~ cos/sin psi) = {corr:.3f}")
    if outdir is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        sc = axes[0].scatter(
            np.degrees(phi), np.degrees(psi), c=cv_vals[:, 0], s=2,
            cmap="coolwarm",
        )
        axes[0].set_xlabel("phi (deg)")
        axes[0].set_ylabel("psi (deg)")
        axes[0].set_title("CV_1 over the Ramachandran plane")
        fig.colorbar(sc, ax=axes[0])
        axes[1].scatter(np.degrees(psi), cv_vals[:, 0], s=2)
        axes[1].set_xlabel("psi (deg)")
        axes[1].set_ylabel("CV_1")
        axes[1].set_title("CV_1 vs psi")
        fig.tight_layout()
        out = os.path.join(outdir, "cv_vs_ramachandran.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        if verbose:
            print(f"scatter saved to {out}")
    return abs(corr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/cvf_dipeptide")
    ap.add_argument("--epochs", type=int, default=100)  # ref main.ipynb cell 14
    ap.add_argument("--n-frames", type=int, default=20_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--plot", action="store_true",
                    help="save the CV-vs-Ramachandran scatter (matplotlib)")
    ap.add_argument("--skip-programs", action="store_true",
                    help="export without the compiled CV programs")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    top = build_topology()
    gro_path = os.path.join(args.outdir, "top.gro")
    write_gro(gro_path, top)
    xtc_path, _psi_planted = synthesize_trajectory(
        top, args.n_frames, dt_ps=10.0, outdir=args.outdir
    )

    # the reference's exact entry pattern (main.ipynb cell 2):
    # Universe(top.gro, md_center.xtc) -> select heavy atoms ->
    # WeightedTrajectory(universe, input_ag)
    u = Universe(gro_path, xtc_path)
    print(f"loaded {u!r}")

    # builders cross-check: the automatic backbone scan reproduces the
    # hand-typed Ramachandran quadruples above
    auto = {f.name: f.atom_indices for f in backbone_dihedrals(u.atoms)}
    assert auto["phi_2"] == PHI_ATOMS and auto["psi_2"] == PSI_ATOMS, auto
    print(f"backbone_dihedrals found: {sorted(auto)}")

    input_ag = u.select_atoms("type C or type O or type N")
    align_ag = u.select_atoms("type C or type O or type N")
    print(f"input atoms: {len(input_ag)} ({input_ag.names})")

    traj_obj = WeightedTrajectory(universe=u, input_ag=input_ag,
                                  verbose=False)

    # preprocessing: alignment + positions (d_r = 30)
    align = AlignmentLayer(
        align_ag.positions,
        align_indices=align_ag.indices_within(input_ag),
    )
    feat = FeatureLayer(
        [Feature("p1", "position", list(range(len(input_ag))))]
    )
    pp_layer = PreprocessingANN(align, feat)
    print(feat.get_feature_info())

    model = EigenFunctions([30, 20, 20, 20, 1], 2, seed=0)
    task = EigenFunctionTask(
        traj_obj, pp_layer, model,
        model_path=os.path.join(args.outdir, "training-output"),
        alpha=20.0, eig_weights=[1.0, 0.2], lag_tau=0.01, k=2,
        learning_rate=0.002, batch_size=2_000, num_epochs=args.epochs,
        test_ratio=0.2, save_model_every_step=0, verbose=False,
        tensorboard=False, seed=0, device=args.device,
    )
    task.train()
    print(task.loss_names)
    print(np.array2string(task.train_loss[-5:], precision=5))

    # scientific validation: φ/ψ from the raw coordinates (full topology
    # indices remapped into the heavy-atom input), CV vs ψ correlation
    full2rel = {int(g): j for j, g in enumerate(input_ag.ix)}
    phi_rel = [full2rel[i] for i in PHI_ATOMS]
    psi_rel = [full2rel[i] for i in PSI_ATOMS]
    raw = traj_obj.trajectory.astype(np.float32)
    phi = dihedral_np(raw, *phi_rel)
    psi = dihedral_np(raw, *psi_rel)

    cv = task.colvar_model()
    with torch.no_grad():
        cv_vals = cv(torch.from_numpy(raw).to(task.device)).cpu().numpy()
    corr = validate_cv_vs_dihedrals(cv_vals, phi, psi,
                                    outdir=args.outdir if args.plot else None)
    if corr < 0.6:
        print("WARNING: leading CV does not track the torsional mode")

    # physical read-out: timescales implied by the trained eigenvalue
    # estimates, and the free-energy profile along the leading CV
    eig_cols = [i for i, c in enumerate(task.loss_names)
                if c.startswith("eig_")]
    rates = task.train_loss[-1, eig_cols]
    ts = implied_timescales(rates, lag_time=0.01, method="log")
    print("implied timescales (ps):", np.round(ts, 3))

    # Markovianity / slow-content check of the CV time series itself
    # (docs/validation.md): cv_vals is frame-ordered by construction
    ck = ck_test(cv_vals, lag=task.lag_idx, n_multiples=4,
                 weights=traj_obj.weights)
    v2 = vamp_score(cv_vals, task.lag_idx, weights=traj_obj.weights)
    print(f"CK max deviation {ck.max_deviation:.4f} "
          f"(Markovian CVs sit well below ~0.05); "
          f"VAMP-2 {v2:.4f} of max {task.k}")
    centers, fes = free_energy_profile(
        cv_vals[:, 0], weights=traj_obj.weights, beta=1.0, bins=40
    )
    n_wells = int(
        np.sum((fes[1:-1] < fes[:-2]) & (fes[1:-1] < fes[2:]))
    )
    print(f"free-energy profile along CV_1: {n_wells} local minima, "
          f"barrier {np.nanmax(fes[np.isfinite(fes)]):.2f} kT")

    # interpretability: per-atom attribution of CV_1. The rigid
    # alignment couples every atom through the fitted rotation, so the
    # response spreads beyond the four psi atoms — the diagnostic here
    # is the RANKING, not exclusivity (input gradients by autograd on the
    # CV's device)
    sens = cv_sensitivity(
        cv, raw[::10], weights=traj_obj.weights[::10], aggregate="xyz",
        labels=list(input_ag.names),
    )
    top = sens.top(0, n=4)
    print("CV_1 attribution (top heavy atoms):",
          [(lbl, round(s, 3)) for lbl, s in top])
    psi_share = sens.relative[0, psi_rel].sum()
    print(f"psi-dihedral atoms carry {psi_share:.0%} of CV_1's response "
          f"(uniform would be {len(psi_rel) / len(input_ag.names):.0%})")

    export_colvar(cv, raw[:1], os.path.join(args.outdir, "cv_artifact"),
                  write_stablehlo=not args.skip_programs)
    print("CV exported to", os.path.join(args.outdir, "cv_artifact"))

    # PLUMED deployment: the same artifact becomes a runnable biasing input
    # (positions mode here — the CV graph includes the alignment layer, so
    # PLUMED feeds raw heavy-atom POSITIONs and autograds through it)
    pl = write_plumed_metad(
        os.path.join(args.outdir, "cv_artifact"),
        sigma=0.1, height=1.2, pace=500, biasfactor=8.0, temp=300.0,
        atoms=input_ag.ix,
    )
    print(f"PLUMED input written: {pl.dat_path} ({pl.mode} mode, "
          f"{len(pl.arg_names)} args -> {','.join(pl.components)})")
    assert np.isfinite(cv_vals).all()


if __name__ == "__main__":
    main()
