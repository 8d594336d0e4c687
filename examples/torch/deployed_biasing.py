"""Consume the deployed CV artifact from an "external MD engine" (the port
of ``examples/deployed_biasing.py`` to the PyTorch port).

The reference's deployment interface is a TorchScript module handed to an
MD engine, which biases sampling along the CV via torch autograd forces
(reference: colvarsfinder/core.py:212-227 + utils.py:220-223, the PLUMED
path). This example plays the *engine's* role for this framework's
artifact:

  1. train a transfer-operator eigenfunction CV on double-well data and
     ``save_model`` it on the card (writes the numpy + native artifacts,
     and the compiled programs unless ``--quick``);
  2. an ENGINE-SIDE umbrella-sampling loop — pure numpy, no framework
     classes, no tensors — loads the artifact with
     ``load_numpy_cv(dir, with_grad=True)`` (or the C++ evaluator via
     ``load_native_cv`` when built) and integrates overdamped Langevin
     under harmonic restraints ``0.5 k (xi(x) - s)^2``, with the CV
     forces coming from the artifact's analytic Jacobian;
  3. validates that the window means of xi track the restraint centers —
     i.e. the artifact's forces are good enough to steer the system
     across the barrier it never crosses unbiased.

Run: python examples/torch/deployed_biasing.py [--outdir /tmp/cvf_deploy_bias]
     [--device cpu] [--quick]
A cut run (the CPU test): --quick.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


# --- the system: a 2D double well (barrier along x) ----------------------

BETA = 4.0


def potential_grad(x):
    """V = (x0^2-1)^2 + 2 x1^2, dV as numpy (the engine's own force field)."""
    g = np.empty_like(x)
    g[..., 0] = 4.0 * x[..., 0] * (x[..., 0] ** 2 - 1.0)
    g[..., 1] = 4.0 * x[..., 1]
    return g


def train_cv(outdir: str, quick: bool = False, device=None):
    """Framework side: learn the slow CV and export the artifact."""
    from colvarsfinder_tpu_torch.core import EigenFunctionTask
    from colvarsfinder_tpu_torch.models import EigenFunctions
    from colvarsfinder_tpu_torch.utils import WeightedTrajectory

    rng = np.random.default_rng(0)
    # mixture over both wells (as if from replica/high-T data): the CV
    # must learn the x0 transition coordinate
    n = 2000 if quick else 8000
    side = rng.choice([-1.0, 1.0], size=n)
    pts = np.stack(
        [side + 0.25 * rng.standard_normal(n),
         0.35 * rng.standard_normal(n)], axis=1
    ).astype(np.float32)
    traj = WeightedTrajectory(trajectory=pts, dt=0.1, verbose=False)
    model = EigenFunctions([2, 16, 16, 1], k=1, seed=0)
    task = EigenFunctionTask(
        traj, None, model, os.path.join(outdir, "cv"),
        alpha=20.0, eig_weights=[1.0], lag_tau=0.5, k=1,
        learning_rate=0.01, batch_size=500,
        num_epochs=30 if quick else 120,
        test_ratio=0.2, save_model_every_step=0, verbose=False,
        tensorboard=False, debug_mode=False, seed=0, device=device,
        export_cv=not quick,
    )
    task.train()
    task.save_model(task.num_epochs, "final")
    return os.path.join(outdir, "cv", "final")


def run_engine(artifact_dir: str, quick: bool = False, prefer_native=True):
    """Engine side: umbrella sampling along the deployed CV.

    Only numpy + the artifact loader run here — the shape of an MD-engine
    plugin (the C++ evaluator path is exactly what a real plugin links).
    """
    try:
        if not prefer_native:
            raise RuntimeError
        from colvarsfinder_tpu_torch.deploy_native import load_native_cv

        cv = load_native_cv(artifact_dir, with_grad=True)
        backend = "native C++ (cveval)"
    except Exception:
        from colvarsfinder_tpu_torch.deploy import load_numpy_cv

        cv = load_numpy_cv(artifact_dir, with_grad=True)
        backend = "numpy"

    rng = np.random.default_rng(1)
    x = np.array([-1.0, 0.0])
    v_left, _ = cv(x.astype(np.float64))
    v_right, _ = cv(np.array([1.0, 0.0]))
    centers = np.linspace(float(v_left[0]), float(v_right[0]), 8)

    kappa = 60.0
    h = 2e-3
    noise = np.sqrt(2.0 * h / BETA)
    n_steps = 800 if quick else 3000
    window_means = []
    for s in centers:
        vals = []
        for it in range(n_steps):
            val, jac = cv(x)
            xi = float(val[0])
            # bias force: -kappa (xi - s) dxi/dx from the ARTIFACT Jacobian
            force = -potential_grad(x) - kappa * (xi - s) * jac[0]
            x = x + h * force + noise * rng.standard_normal(2)
            if it >= n_steps // 4:
                vals.append(xi)
        window_means.append(float(np.mean(vals)))
    window_means = np.asarray(window_means)
    corr = np.corrcoef(centers, window_means)[0, 1]
    return backend, centers, window_means, corr, float(x[0])


def main(outdir: str, quick: bool = False, device=None):
    artifact = train_cv(outdir, quick=quick, device=device)
    backend, centers, means, corr, x0_final = run_engine(artifact, quick=quick)
    print(f"engine backend: {backend}")
    for s, m in zip(centers, means):
        print(f"  restraint center {s:+.3f} -> window mean xi {m:+.3f}")
    print(f"R(center, window mean) = {corr:.3f}; final x0 = {x0_final:+.2f}")
    assert corr > 0.9, (
        "umbrella windows did not track the restraint centers — the "
        f"artifact forces failed to steer the system (R={corr:.3f})"
    )
    assert x0_final > 0.3, (
        "the biased walker never crossed the barrier the unbiased "
        f"dynamics is trapped behind (final x0 {x0_final:+.2f})"
    )
    print("deployed-artifact biasing OK: the engine-side loop steered the "
          "system across the barrier using only the artifact's forces")
    return corr


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="/tmp/cvf_deploy_bias")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    main(args.outdir, quick=args.quick, device=args.device)
