r"""Enhanced sampling along learned collective variables (port of
``colvarsfinder_tpu/utils/enhanced.py``).

A trained CV (a ``ColvarModel``, ``task.colvar_model()``, or any torch
callable on a batch of states) drives:

* **umbrella sampling**: :class:`BiasedPotential` composes
  ``V(x) + bias(cv(x))`` into a potential for
  :func:`~.sampling.integrate_sde_overdamped`, and
  :func:`integrate_sde_umbrella` runs K windows as one chain batch, with
  :func:`mbar_weights` to recombine them;
* **(well-tempered) metadynamics**: :func:`integrate_sde_metadynamics`,
  hills deposited into fixed ``[c, n_hills, k]`` buffers at a hill index
  that lives on the device, the bias force by autograd through the hill
  sum and the CV;
* **steered pulls** with Jarzynski work (:func:`integrate_sde_steered`),
  the restraint's centre moved by a step counter on the device;
* **replica exchange** (:func:`integrate_sde_remd`), the Metropolis test
  and the permutation on the device.

Each report (or deposition) block is a Python loop of steps on the chain
batch; on the card the first block of each kind runs eagerly and is
captured as a CUDA graph, and every later one is a replay
(:class:`.sampling._Blocks`). The CV is called on the chain batch
``[c, dim]``, which is a torch ``nn.Module``'s contract: the kernel layers'
``autograd.Function`` (``FusedAlignmentLayer``, K2) have no vmap rule, and
the bias force is autograd of the batch's summed energy, exact because the
rows are independent. The JAX package calls ``cv_model`` on one state
``[dim]`` under ``vmap``.

The result dataclasses, :func:`mbar_weights` (but for the evaluation of
``bias_fns``, in torch) and the PLUMED interop (:class:`PlumedHills`,
:func:`read_plumed_hills`, :func:`metad_frame_weights`,
:func:`read_plumed_colvar`) are numpy, copied from the JAX module
(``enhanced.py:97-228, 472-649, 657-742, 925-1016, 1272-1407,
1665-2001``).

``mesh=`` (:func:`..parallel.make_data_mesh`, one process per card over
``torch.distributed``) shards the walkers, windows, pulls or replica slots
of a call over the ranks, as the JAX package shards them over its mesh's
first axis (``enhanced.py:386-398, 852-865, 1222-1235, 1598-1610``); a
count that does not divide raises ``ValueError`` before any work. A meshed
call gives the unmeshed call's numbers: every rank draws the whole call's
increments from the same seeded draws and keeps its own rows
(:class:`_RankNoise`), integrates its chains in the same captured blocks,
and at the end one all-gather of the recorded arrays gives every rank the
whole result (:func:`_gather_chains`). Metadynamics walkers, umbrella
windows and steered pulls are independent, so nothing else crosses the
ranks; a replica exchange gathers the slots' states inside its captured
block, decides on the whole batch with the same uniforms on every rank, and
keeps its own rows. Only rank 0 writes files and prints.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..graphs import report_blocks
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import mesh_coords, shared_seed
from . import sampling as _sampling
from .sampling import _Blocks, _Recorder, _batch_grad, _chains, _f32

__all__ = [
    "BiasedPotential",
    "harmonic_restraint",
    "integrate_sde_metadynamics",
    "integrate_sde_umbrella",
    "integrate_sde_steered",
    "integrate_sde_remd",
    "MetadynamicsResult",
    "MBARResult",
    "mbar_weights",
    "UmbrellaResult",
    "SteeredResult",
    "REMDResult",
    "PlumedHills",
    "read_plumed_hills",
    "read_plumed_colvar",
    "metad_frame_weights",
]


def _mesh_rows(mesh, n: int, what: str, unit: str, device) -> tuple:
    """``(rows, rank)``: this rank's contiguous share of the ``n`` chains
    of a meshed call and its rank; every chain and rank 0 without a mesh.
    Raises ``ValueError`` in the JAX package's words when ``n`` does not
    divide over the mesh (``enhanced.py:391-395``), and when the mesh is
    over other devices than the call's."""
    if mesh is None:
        return slice(0, n), 0
    rank, size, _ = mesh_coords(mesh)
    if n % size:
        raise ValueError(
            f"{what} {n} must be divisible by the size of mesh axis "
            f"'{mesh.mesh_dim_names[0]}' ({size}), which the {unit} shard "
            "over"
        )
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh is over '{mesh.device_type}' devices and the call "
            f"runs on '{device.type}'")
    share = n // size
    return slice(rank * share, (rank + 1) * share), rank


class _RankNoise:
    """The draws of one rank of a meshed call. Each normal draw of the
    call (a block's increments ``[n, C, d]``, the chains on axis 1) is
    drawn whole from the call's draws (:func:`.sampling._make_noise`), in
    the order the unmeshed call draws, and this rank keeps its ``rows``;
    the exchange uniforms, which every rank needs whole, pass through. So
    every chain is integrated with the unmeshed call's numbers."""

    def __init__(self, noise, rows: slice, n_chains: int):
        self.noise, self.rows, self.n_chains = noise, rows, n_chains
        self.whole: dict = {}

    def normal(self, out: torch.Tensor, stream: str, i: int) -> None:
        shape = (out.shape[0], self.n_chains) + tuple(out.shape[2:])
        whole = self.whole.get(shape)
        if whole is None:
            whole = self.whole[shape] = out.new_empty(shape)
        self.noise.normal(whole, stream, i)
        out.copy_(whole[:, self.rows])

    def uniform(self, out: torch.Tensor, stream: str, i: int) -> None:
        self.noise.uniform(out, stream, i)


def _rank_noise(noise, mesh, rows: slice, n_chains: int):
    """The draws this rank integrates with: ``noise`` itself without a
    mesh."""
    return noise if mesh is None else _RankNoise(noise, rows, n_chains)


def _gather_chains(mesh, device, arrays) -> list:
    """The whole call's arrays on every rank. Each ``(array, axis)`` holds
    this rank's chains along ``axis`` (float32 or bool); the ranks' shares
    are concatenated in rank order along it, through one all-gather of one
    flat float32 buffer. Without a mesh the arrays themselves."""
    if mesh is None:
        return [a for a, _ in arrays]
    _, size, _ = mesh_coords(mesh)
    moved = [np.moveaxis(a, axis, 0) for a, axis in arrays]
    flat = np.concatenate([m.astype(np.float32).ravel() for m in moved])
    whole = all_gather_rows(mesh, torch.from_numpy(flat).to(device))
    whole = whole.cpu().numpy().reshape(size, -1)
    out, lo = [], 0
    for (a, axis), m in zip(arrays, moved):
        part = whole[:, lo:lo + m.size].reshape(
            (size * m.shape[0],) + m.shape[1:])
        lo += m.size
        out.append(np.ascontiguousarray(np.moveaxis(part, 0, axis))
                   .astype(a.dtype))
    return out


def harmonic_restraint(center, kappa: float) -> Callable:
    """Umbrella restraint ``0.5 * kappa * |s - center|^2`` on one CV value
    (``enhanced.py:59-67``); ``torch.func.vmap`` maps it over a batch."""
    center = torch.as_tensor(np.asarray(center, dtype=np.float32))

    def bias(s):
        s = torch.as_tensor(s)
        d = (s.to(torch.float32).reshape(-1)
             - center.to(s.device).reshape(-1))
        return 0.5 * kappa * torch.sum(d * d)

    return bias


class BiasedPotential:
    """``V_b(x) = V(x) + bias(cv(x))`` as a sampler-ready potential object
    (``enhanced.py:70-88``).

    ``V`` takes one state, as the potential contract says. The port's
    samplers call :meth:`batched_V` on the chain batch ``[c, dim]``: the
    base potential's ``V`` mapped over the chains, plus ``bias`` mapped
    over the CV values of ``cv_model`` called on the batch (a torch module's
    contract; a CV with a kernel layer cannot be vmapped). The gradient is
    autograd of the summed batch energy, through the base potential and the
    CV."""

    def __init__(self, pot_obj, cv_model: Callable, bias_fn: Callable):
        self.dim = pot_obj.dim
        self.beta = pot_obj.beta
        self.base_potential = pot_obj
        self._cv = cv_model
        self._bias = bias_fn
        self._base_v = _sampling._energy_fn(pot_obj)

    def V(self, x):
        return self.base_potential.V(x) + self._bias(self._cv(x[None])[0])

    def batched_V(self, x):
        return self._base_v(x) + torch.func.vmap(self._bias)(self._cv(x))


def _hill_energy(s, centers, heights, inv_two_sigma2):
    """Sum of deposited Gaussians at each walker's CV value: ``s`` [c, k],
    ``centers`` [c, H, k], ``heights`` [c, H] -> [c] (one walker's in
    ``enhanced.py:91-94``)."""
    d2 = torch.sum((s[:, None, :] - centers) ** 2, dim=-1)
    return torch.sum(heights * torch.exp(-d2 * inv_two_sigma2), dim=-1)


def _module_placement(cv_model):
    """``(device, dtype)`` of a module's first floating parameter or
    buffer, or None (not a module, or nothing floating in it)."""
    if isinstance(cv_model, torch.nn.Module):
        for t in itertools.chain(cv_model.parameters(), cv_model.buffers()):
            if t.is_floating_point():
                return t.device, t.dtype
    return None


def _module_dtype(cv_model) -> Optional[torch.dtype]:
    """The dtype a module computes in, or None."""
    placement = _module_placement(cv_model)
    return None if placement is None else placement[1]


def _cv_fn(cv_model):
    """The CV of a chain batch ``[c, dim] -> [c, k]`` in float32. A module
    takes the float32 chains in its own dtype (a float64 CV, as the JAX
    package promotes)."""
    dtype = _module_dtype(cv_model)

    def cv_fn(x):
        xin = x if dtype is None else x.to(dtype)
        return torch.as_tensor(cv_model(xin)).to(torch.float32).reshape(
            x.shape[0], -1)

    return cv_fn


def _eval_cv(cv_fn, flat: np.ndarray, device,
             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The CV of states ``[n, ...]`` on the device in ``dtype``, without
    grad, in chunks (also the analysis, plotting and workflow modules' way
    to evaluate a torch CV on numpy frames)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    out = []
    with torch.no_grad():
        for lo in range(0, flat.shape[0], _sampling._EVAL_CHUNK):
            x = torch.from_numpy(np.array(
                flat[lo:lo + _sampling._EVAL_CHUNK], dtype=np_dtype)
            ).to(device)
            out.append(torch.as_tensor(cv_fn(x)).cpu().numpy())
    return np.concatenate(out, axis=0)


def _cv_width(cv_fn, x0: torch.Tensor) -> int:
    """Components of the CV, from one evaluation at the first start."""
    with torch.no_grad():
        return int(cv_fn(x0[:1]).shape[1])


@dataclasses.dataclass
class MetadynamicsResult:
    """Outcome of a metadynamics run (single walker or [w, ...] stacked).

    Attributes:
        frames: states at each deposition time [n_hills, dim]
        cv_values: CV at each deposition [n_hills, cv_dim]
        hill_centers / hill_heights: the deposited bias
        hill_width: Gaussian sigma
        bias_factor: well-tempered gamma (None for standard metadynamics)
        beta: inverse temperature of the run
    """

    frames: np.ndarray
    cv_values: np.ndarray
    hill_centers: np.ndarray
    hill_heights: np.ndarray
    hill_width: float
    bias_factor: Optional[float]
    beta: float

    def select_walker(self, c: int) -> "MetadynamicsResult":
        """Single-walker view of a multi-walker (``n_chains > 1``) result."""
        return dataclasses.replace(
            self,
            frames=self.frames[c],
            cv_values=self.cv_values[c],
            hill_centers=self.hill_centers[c],
            hill_heights=self.hill_heights[c],
        )

    def bias(self, s) -> np.ndarray:
        """Evaluate the accumulated bias at CV value(s) ``s``."""
        if self.hill_centers.ndim == 3:
            raise ValueError(
                "multi-walker result: use .select_walker(c).bias(s)"
            )
        s = np.atleast_2d(np.asarray(s, dtype=np.float32))
        if s.shape[-1] != self.hill_centers.shape[-1]:
            s = s.reshape(-1, self.hill_centers.shape[-1])
        inv = 1.0 / (2.0 * self.hill_width**2)
        d2 = ((s[:, None, :] - self.hill_centers[None, :, :]) ** 2).sum(-1)
        return (self.hill_heights[None, :] * np.exp(-d2 * inv)).sum(-1)

    def free_energy(self, s) -> np.ndarray:
        """Free-energy estimate at CV value(s) ``s`` (up to a constant).

        Standard metadynamics: ``F(s) = -V_bias(s)``; well-tempered:
        ``F(s) = -gamma/(gamma-1) * V_bias(s)``.
        """
        scale = (
            1.0
            if self.bias_factor is None
            else self.bias_factor / (self.bias_factor - 1.0)
        )
        return -scale * self.bias(s)

    # ------------------------------------------------------------------
    def _cv_grid(self, grid_points: int) -> np.ndarray:
        """Default CV grid covering the visited region (+4 sigma margin)."""
        dim = self.hill_centers.shape[-1]
        if dim > 2:
            raise ValueError(
                f"no default grid for a {dim}-dimensional CV — pass "
                "grid=[n_points, cv_dim] explicitly"
            )
        axes = [
            np.linspace(
                self.hill_centers[:, d].min() - 4 * self.hill_width,
                self.hill_centers[:, d].max() + 4 * self.hill_width,
                grid_points,
            )
            for d in range(dim)
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=-1)

    def frame_weights(
        self,
        method: str = "final-bias",
        grid: Optional[np.ndarray] = None,
        grid_points: int = 129,
    ) -> np.ndarray:
        """Unbiased-ensemble weights for the deposition-time frames.

        Turns a biased run into :class:`~.trajectory
        .WeightedTrajectory` input (weights mean-normalized to 1, the
        package convention) so the CV can be *retrained* on data that
        crossed the barriers — the iterate-the-CV workflow the reference
        ecosystem runs through a PLUMED reweight plus ``calc_weights``
        (reference utils.py:220-223, :354-417).

        Args:
            method: ``'final-bias'`` — the quasi-static estimator
                ``w_i ∝ exp(beta * V_b(s_i))`` with ``V_b`` the final
                accumulated bias (the stationary distribution of
                well-tempered metadynamics is ``∝ exp(-beta (F + V_b))``).
                ``'tiwary'`` — the time-dependent estimator of Tiwary &
                Parrinello (J. Phys. Chem. B 119, 2015):
                ``w_i ∝ exp(beta * (V(s_i, t_i) - c(t_i)))`` where
                ``V(·, t_i)`` is the bias when frame ``i`` was recorded and
                ``c(t) = (1/beta) ln(∫ e^{beta*gamma*V/(gamma-1)} ds /
                ∫ e^{beta*V/(gamma-1)} ds)`` on a CV grid (for standard
                metadynamics the ``gamma -> inf`` limit is used).
            grid: optional explicit CV grid [n_points, cv_dim] for the
                ``c(t)`` integrals (``'tiwary'`` only).
            grid_points: per-dimension size of the default grid.

        Returns:
            weights [n_hills] with mean 1, aligned with ``self.frames``.
        """
        if self.hill_centers.ndim == 3:
            raise ValueError(
                "multi-walker result: use .select_walker(c).frame_weights()"
            )
        # delegate to the general estimator (the deposition frames are
        # the special case: frame i sees hills j < i)
        n_h = self.hill_centers.shape[0]
        hills = PlumedHills(
            times=np.arange(n_h, dtype=np.float64),
            centers=np.asarray(self.hill_centers, dtype=np.float64),
            sigmas=np.full(
                (n_h, self.hill_centers.shape[-1]), float(self.hill_width)
            ),
            heights=np.asarray(self.hill_heights, dtype=np.float64),
            bias_factor=self.bias_factor,
        )
        return metad_frame_weights(
            self.cv_values, hills, beta=self.beta, method=method,
            grid=grid, grid_points=grid_points,
            _cutoffs=np.arange(n_h),
        )



def _metad_scan(energy, cv_fn, x, noise, run, step_size, beta, hill_height,
                wt_denom, inv_two_sigma2, n_hills, deposit_interval,
                pre_steps, well_tempered):
    """Every walker's metadynamics run at once (the JAX ``_metad_scan``,
    ``enhanced.py:231-291``, under ``vmap`` there), on ``x`` [c, d] in
    place: an unbiased burn-in on one ``[pre_steps, c, d]`` draw, then per
    hill a block of ``deposit_interval`` steps under the hills so far and
    one hill per walker at its CV value, written at a hill index that the
    block advances on the device.

    Returns ``({"x": [H, c, d], "s": [H, c, k]}, centers [c, H, k],
    heights [c, H])``."""
    c, d = x.shape
    dev = x.device
    scale = float(_sampling._noise_scale(step_size, beta))
    dt = _f32(step_size)
    cv_dim = _cv_width(cv_fn, x)
    centers = torch.zeros((c, n_hills, cv_dim), dtype=torch.float32,
                          device=dev)
    heights = torch.zeros((c, n_hills), dtype=torch.float32, device=dev)
    hill = torch.zeros(1, dtype=torch.long, device=dev)

    def total(xx):
        return energy(xx) + _hill_energy(cv_fn(xx), centers, heights,
                                         inv_two_sigma2)

    def step(xi):
        _sampling._em_update(x, _batch_grad(total, x), xi, dt, scale)

    buf = torch.empty((deposit_interval, c, d), dtype=x.dtype, device=dev)
    if pre_steps:
        burn = torch.empty((pre_steps, c, d), dtype=x.dtype, device=dev)
        noise.normal(burn, "metad_burn", 0)
        _sampling._burn_in(
            run, buf, step, pre_steps,
            lambda i, n: buf[:n].copy_(
                burn[i * deposit_interval:i * deposit_interval + n]))
    rec = _Recorder(n_hills, {"x": x, "s": centers[:, 0]})

    def block():
        for j in range(deposit_interval):
            step(buf[j])
        with torch.no_grad():
            s = cv_fn(x)
            if well_tempered:
                h = hill_height * torch.exp(
                    -_hill_energy(s, centers, heights, inv_two_sigma2)
                    / wt_denom)
                heights.index_copy_(1, hill, h[:, None])
            else:
                heights.index_fill_(1, hill, hill_height)
            centers.index_copy_(1, hill, s[:, None, :])
        hill.add_(1)
        rec.write("x", x)
        rec.write("s", s)
        rec.advance()

    for i in range(report_blocks(n_hills)):
        run.block("main", lambda i=i: noise.normal(buf, "main", i), block)
        rec.end_block()
    return rec.result(), centers.cpu().numpy(), heights.cpu().numpy()


def integrate_sde_metadynamics(
    pot_obj,
    cv_model: Callable,
    n_steps: int,
    sampling_output_path: Optional[str] = None,
    X0: Optional[np.ndarray] = None,
    pre_steps: int = 0,
    step_size: float = 0.01,
    deposit_interval: int = 500,
    hill_height: float = 1.0,
    hill_width: float = 0.2,
    bias_factor: Optional[float] = None,
    n_chains: int = 1,
    seed: Optional[int] = None,
    mesh=None,
    verbose: bool = True,
    device=None,
) -> MetadynamicsResult:
    """Metadynamics along a (learned) CV (``enhanced.py:294-464``).

    Every ``deposit_interval`` integrator steps a Gaussian hill of width
    ``hill_width`` is deposited at each walker's CV value; the history-
    dependent bias force is autograd of the hill sum composed with the CV.
    ``bias_factor`` (gamma > 1) enables well-tempered metadynamics:
    deposited heights decay as ``exp(-beta * V_bias / (gamma - 1))``.

    Args:
        pot_obj: base potential (``dim`` / ``beta`` / ``V`` in torch),
            as for ``integrate_sde_overdamped``.
        cv_model: torch map from a chain batch ``[c, dim]`` to CV values
            ``[c, ...]``.
        n_steps: total integrator steps (``n_steps // deposit_interval``
            hills are deposited).
        sampling_output_path: when given, writes ``traj.txt`` rows at the
            deposition times plus a PLUMED-style ``HILLS`` file
            (time, center..., sigma..., height, biasf).
        n_chains: independent walkers, one chain batch (each with its own
            hill pool).
        mesh: a 1-axis mesh (:func:`..parallel.make_data_mesh`) over which
            the walkers shard, ``n_chains / W`` on each rank; every rank
            returns the whole result, and only rank 0 writes files.
        device: the card unless ``'cpu'`` is asked for; each deposition
            block is one captured CUDA graph there.

    Returns:
        :class:`MetadynamicsResult`; arrays gain a leading walker axis
        when ``n_chains > 1``.
    """
    if bias_factor is not None and bias_factor <= 1.0:
        raise ValueError("bias_factor (well-tempered gamma) must be > 1")
    n_hills = n_steps // deposit_interval
    if n_hills < 1:
        raise ValueError("n_steps must be at least deposit_interval")
    dim = pot_obj.dim
    beta = float(pot_obj.beta)
    dev = resolve_device(device)
    rows, rank = _mesh_rows(mesh, n_chains, "n_chains", "walkers", dev)

    # on a mesh with seed=None, rank 0's draw
    noise = _sampling._make_noise(shared_seed(seed, mesh, dev), dev)
    X0 = _sampling._starts(X0, noise, "x0", (n_chains, dim), dev)
    _sampling._require_torch(pot_obj, X0[0], "integrate_sde_metadynamics")

    wt_denom = _f32(
        (bias_factor - 1.0) / beta if bias_factor is not None else 1.0)
    rec, centers, heights = _metad_scan(
        _sampling._energy_fn(pot_obj), _cv_fn(cv_model),
        _chains(X0[rows], dev), _rank_noise(noise, mesh, rows, n_chains),
        _Blocks(dev), step_size, beta,
        _f32(hill_height), wt_denom, _f32(1.0 / (2.0 * hill_width**2)),
        int(n_hills), int(deposit_interval), int(pre_steps),
        bias_factor is not None,
    )
    frames, cvs, centers, heights = _gather_chains(mesh, dev, [
        (rec["x"], 1), (rec["s"], 1), (centers, 0), (heights, 0)])
    frames = np.swapaxes(frames, 0, 1)
    cvs = np.swapaxes(cvs, 0, 1)

    if sampling_output_path is not None and rank == 0:
        os.makedirs(sampling_output_path, exist_ok=True)
        times = (np.arange(n_hills) + 1) * deposit_interval * step_size
        for c in range(n_chains):
            suffix = "" if c == 0 else f"_chain{c}"
            with open(
                os.path.join(sampling_output_path, f"traj{suffix}.txt"), "w"
            ) as f:
                for j in range(n_hills):
                    f.write(
                        f"{times[j]:.3f} "
                        + " ".join(f"{v:.6f}" for v in frames[c, j])
                        + "\n"
                    )
            with open(
                os.path.join(sampling_output_path, f"HILLS{suffix}"), "w"
            ) as f:
                k = centers.shape[-1]
                cols = (
                    ["time"]
                    + [f"cv_{i}" for i in range(k)]
                    + [f"sigma_cv_{i}" for i in range(k)]
                    + ["height", "biasf"]
                )
                f.write("#! FIELDS " + " ".join(cols) + "\n")
                bf = bias_factor if bias_factor is not None else -1.0
                # PLUMED convention: well-tempered HILLS store heights
                # rescaled by gamma/(gamma-1) (sum_hills then integrates
                # to -F); read_plumed_hills undoes this on load
                hscale = (
                    bias_factor / (bias_factor - 1.0)
                    if bias_factor is not None
                    else 1.0
                )
                for j in range(n_hills):
                    row = (
                        [times[j]]
                        + list(centers[c, j])
                        + [hill_width] * k
                        + [heights[c, j] * hscale, bf]
                    )
                    f.write(" ".join(f"{v:.6f}" for v in row) + "\n")

    if verbose and rank == 0:
        print(
            f"metadynamics: {n_hills} hills deposited per walker "
            f"({n_chains} walkers, gamma="
            f"{bias_factor if bias_factor is not None else 'inf (standard)'})"
        )

    squeeze = n_chains == 1
    return MetadynamicsResult(
        frames=frames[0] if squeeze else frames,
        cv_values=cvs[0] if squeeze else cvs,
        hill_centers=centers[0] if squeeze else centers,
        hill_heights=heights[0] if squeeze else heights,
        hill_width=float(hill_width),
        bias_factor=bias_factor,
        beta=beta,
    )


@dataclasses.dataclass
class MBARResult:
    """Outcome of :func:`mbar_weights`.

    Attributes:
        weights: per-window unbiased-ensemble frame weights, normalized so
            the POOLED mean is 1 (the package's WeightedTrajectory
            convention) — concatenate along with the frames to retrain.
        free_energies: window free energies f_k in kT (f_0 = 0): the
            log-normalizers MBAR solves for.
        n_iter: self-consistent iterations used.
        converged: whether ``max|df|`` fell below ``tol``.
    """

    weights: list
    free_energies: np.ndarray
    n_iter: int
    converged: bool


def mbar_weights(
    cv_values,
    bias_fns=None,
    beta: float = 1.0,
    *,
    u_kn: Optional[np.ndarray] = None,
    tol: float = 1e-10,
    max_iter: int = 2_000,
) -> MBARResult:
    """Unbiased-ensemble weights for pooled umbrella-sampling windows (MBAR).

    Solves the multistate Bennett acceptance ratio equations (Shirts &
    Chodera, J. Chem. Phys. 129, 2008) for K umbrella windows sampled with
    :class:`BiasedPotential` + :func:`integrate_sde_overdamped`:

    .. math::

        f_k = -\\ln \\sum_n \\frac{e^{-u_k(x_n)}}
              {\\sum_j N_j e^{f_j - u_j(x_n)}},
        \\qquad w_n \\propto \\Big(\\sum_j N_j e^{f_j - u_j(x_n)}\\Big)^{-1}

    with reduced bias energies ``u_k = beta * bias_k(cv)`` (the windows
    share the base potential, so only the bias enters). The returned
    weights feed :class:`~.trajectory
    .WeightedTrajectory` directly — the umbrella counterpart of
    :meth:`MetadynamicsResult.frame_weights`, closing the same
    bias-then-retrain loop the reference ecosystem runs through PLUMED +
    ``calc_weights`` (reference utils.py:220-223, :354-417).

    Args:
        cv_values: list of per-window CV samples, each [n_k] or
            [n_k, cv_dim] (map the window's frames through the trained CV).
        bias_fns: list of K bias callables on a single CV value (e.g.
            :func:`harmonic_restraint` closures — torch functions; they are
            vmapped over the pooled samples once per window).
        beta: inverse temperature of the runs.
        u_kn: alternatively, the precomputed reduced bias-energy matrix
            [K, N_total] over the pooled samples (numpy-only path;
            overrides ``bias_fns``).
        tol: convergence threshold on ``max|df|`` per iteration.
        max_iter: iteration cap (a warning is emitted if hit).

    Returns:
        :class:`MBARResult`.
    """
    cvs = [np.atleast_2d(np.asarray(c, dtype=np.float64).T).T for c in cv_values]
    cvs = [c.reshape(c.shape[0], -1) for c in cvs]
    n_k = np.asarray([c.shape[0] for c in cvs])
    pooled = np.concatenate(cvs, axis=0)
    n_tot = pooled.shape[0]

    if u_kn is None:
        if bias_fns is None:
            raise ValueError("pass either bias_fns or u_kn")
        if len(bias_fns) != len(cvs):
            raise ValueError(
                f"{len(bias_fns)} bias_fns for {len(cvs)} windows"
            )
        # the biases in torch on the CPU, in the default dtype (float64 in
        # the parity mode, as JAX's x64)
        rows = []
        pooled_t = torch.as_tensor(pooled, dtype=default_dtype())
        for fn in bias_fns:
            vals = torch.func.vmap(
                lambda s, fn=fn: torch.as_tensor(fn(s)).reshape(()))(pooled_t)
            rows.append(vals.detach().numpy().astype(np.float64))
        u = beta * np.stack(rows, axis=0)
    else:
        u = np.asarray(u_kn, dtype=np.float64)
        if u.shape != (len(cvs), n_tot):
            raise ValueError(
                f"u_kn shape {u.shape} != {(len(cvs), n_tot)}"
            )

    log_n = np.log(n_k.astype(np.float64))
    K = len(cvs)

    def _log_denom(f):
        # log denominator per pooled sample:
        # logsumexp_j(log N_j + f_j - u_jn)
        a = log_n[:, None] + f[:, None] - u  # [K, N]
        m = a.max(axis=0)
        return np.log(np.exp(a - m[None, :]).sum(axis=0)) + m

    def _scf_step(f, log_d):
        # f_k update: -logsumexp_n(-u_kn - log_d)
        b = -u - log_d[None, :]
        mb = b.max(axis=1)
        f_new = -(np.log(np.exp(b - mb[:, None]).sum(axis=1)) + mb)
        return f_new - f_new[0]

    # Self-consistent iteration alone converges geometrically and stalls
    # when window overlap is weak; after a short SCF warm-up we switch to
    # Newton-Raphson on the (convex) MBAR objective
    # phi(f) = sum_n log sum_j N_j e^{f_j - u_jn} - sum_k N_k f_k
    # (Shirts & Chodera 2008), which reaches machine precision in a
    # handful of steps. f_0 is pinned; the Newton solve runs in the
    # (K-1)-dim subspace. A Newton step that fails to reduce the gradient
    # norm falls back to an SCF step for that iteration.
    f = np.zeros(K)
    converged = False
    it = 0
    delta = np.inf
    scf_warmup = 10
    log_d_next = None  # carried from an accepted Newton step
    for it in range(1, max_iter + 1):
        log_d = _log_denom(f) if log_d_next is None else log_d_next
        log_d_next = None
        if it <= scf_warmup or K == 1:
            f_new = _scf_step(f, log_d)
        else:
            # W_kn = exp(f_k - u_kn - log_d_n); grad_k = N_k (sum_n W_kn - 1)
            W = np.exp(f[:, None] - u - log_d[None, :])
            nw = n_k[:, None] * W  # [K, N]
            grad = nw.sum(axis=1) - n_k
            # Hessian: H_kl = -sum_n (N_k W_kn)(N_l W_ln) (k != l),
            # H_kk = sum_n N_k W_kn (1 - N_k W_kn)
            H = -(nw @ nw.T)
            np.fill_diagonal(H, np.diag(H) + nw.sum(axis=1))
            try:
                step = np.zeros(K)
                step[1:] = np.linalg.solve(H[1:, 1:], -grad[1:])
                f_try = f + step
                f_try -= f_try[0]
                log_d_try = _log_denom(f_try)
                W_t = np.exp(f_try[:, None] - u - log_d_try[None, :])
                grad_try = (n_k[:, None] * W_t).sum(axis=1) - n_k
                if np.abs(grad_try).max() < np.abs(grad).max():
                    f_new = f_try
                    log_d_next = log_d_try  # reuse next iteration
                else:
                    f_new = _scf_step(f, log_d)
            except np.linalg.LinAlgError:
                f_new = _scf_step(f, log_d)
        delta = np.abs(f_new - f).max()
        f = f_new
        if delta < tol:
            converged = True
            break
    if not converged:
        import warnings

        warnings.warn(
            f"MBAR did not converge in {max_iter} iterations "
            f"(last max|df| = {delta:.2e})"
        )

    log_d = _log_denom(f)
    log_w = -log_d
    w = np.exp(log_w - log_w.max())
    w /= w.mean()
    splits = np.cumsum(n_k)[:-1]
    return MBARResult(
        weights=[np.asarray(s) for s in np.split(w, splits)],
        free_energies=f,
        n_iter=it,
        converged=converged,
    )


@dataclasses.dataclass
class UmbrellaResult:
    """Outcome of :func:`integrate_sde_umbrella` (K windows).

    Attributes:
        frames: states at the report times, [K, n_reports, dim].
        cv_values: CV at each recorded frame, [K, n_reports, cv_dim].
        centers: restraint centers, [K, cv_dim].
        kappas: restraint strengths, [K].
        beta: inverse temperature of the runs.
        dt: time between recorded frames (``step_size * report_interval``).
    """

    frames: np.ndarray
    cv_values: np.ndarray
    centers: np.ndarray
    kappas: np.ndarray
    beta: float
    dt: float

    @property
    def n_windows(self) -> int:
        return len(self.centers)

    def bias_fns(self):
        """The K restraints as callables on a CV value — exactly the
        biases the windows were integrated under, ready for
        :func:`mbar_weights`."""
        return [
            harmonic_restraint(c, float(k))
            for c, k in zip(self.centers, self.kappas)
        ]

    def mbar(self, **kwargs) -> MBARResult:
        """Recombine the windows: MBAR unbiased-ensemble weights + window
        free energies (forwards ``tol`` / ``max_iter``)."""
        return mbar_weights(
            list(self.cv_values), self.bias_fns(), beta=self.beta, **kwargs
        )

    def to_weighted_trajectory(self, mbar_result: Optional[MBARResult] = None):
        """Pool every window into ONE training-ready
        :class:`~.trajectory.WeightedTrajectory`:
        frames concatenated, MBAR unbiased-ensemble weights attached
        (pooled mean 1), ``segment_starts`` marking window boundaries so
        time-lagged objectives never pair frames across windows."""
        from .trajectory import WeightedTrajectory

        mb = mbar_result if mbar_result is not None else self.mbar()
        n = self.frames.shape[1]
        # boundaries go through the constructor so the zero-weight frame
        # filter (MBAR weights can underflow to 0.0) remaps them
        return WeightedTrajectory(
            trajectory=self.frames.reshape(-1, *self.frames.shape[2:]),
            weights=np.concatenate(mb.weights),
            dt=self.dt,
            verbose=False,
            segment_starts=np.arange(self.n_windows) * n,
        )

    def subsample(self, g: Optional[float] = None) -> "UmbrellaResult":
        """Decimate every window to (approximately) independent frames.

        Strides the report axis by ``ceil(g)``, where ``g`` defaults to
        the CONSERVATIVE statistical inefficiency — the maximum of
        :func:`~..analysis.statistical_inefficiency`
        over all windows and CV heads — so that the MBAR solve and its
        downstream error estimates (which assume independent samples)
        see one frame per correlation time. The pymbar
        ``subsample_correlated_data`` workflow; chain as
        ``result.subsample().to_weighted_trajectory()``.
        """
        from ..analysis import statistical_inefficiency

        if g is None:
            g = max(
                float(np.max(statistical_inefficiency(cv)))
                for cv in self.cv_values
            )
        stride = max(1, int(np.ceil(float(g) - 1e-9)))
        return dataclasses.replace(
            self,
            frames=self.frames[:, ::stride],
            cv_values=self.cv_values[:, ::stride],
            dt=self.dt * stride,
        )



def integrate_sde_umbrella(
    pot_obj,
    cv_model: Callable,
    centers,
    kappa,
    n_steps: int,
    sampling_output_path: Optional[str] = None,
    X0: Optional[np.ndarray] = None,
    pre_steps: int = 0,
    step_size: float = 0.01,
    report_interval: int = 100,
    seed: Optional[int] = None,
    mesh=None,
    verbose: bool = True,
    device=None,
) -> UmbrellaResult:
    """Umbrella sampling along a (learned) CV, all K windows as one chain
    batch (``enhanced.py:745-917``).

    Each window k integrates ``V(x) + 0.5 * kappa_k * |cv(x) - c_k|^2``
    (restraint force by autograd through the CV) with Euler–Maruyama, in
    report blocks as :func:`~.sampling.integrate_sde_overdamped`.

    Args:
        pot_obj: base potential (``dim`` / ``beta`` / ``V`` in torch).
        cv_model: torch map from a chain batch ``[c, dim]`` to CV values
            (any trailing shape; flattened per state).
        centers: [K] (scalar CV) or [K, cv_dim] restraint centers.
        kappa: restraint strength, scalar or per-window [K].
        n_steps: integrator steps per window.
        sampling_output_path: when given, writes per-window
            ``traj_win{k}.txt`` rows (t, x...) plus ``windows.csv``
            (center..., kappa).
        X0: initial state [dim] shared by all windows, or per-window
            [K, dim] starts; default a standard-normal draw shared by all.
        pre_steps: per-window burn-in steps (discarded).
        mesh: a 1-axis mesh (:func:`..parallel.make_data_mesh`) over which
            the windows shard, ``K / W`` on each rank; every rank returns
            the whole result, and only rank 0 writes files.
        step_size / report_interval / seed / verbose / device: as in
            :func:`~.sampling.integrate_sde_overdamped`.

    Returns:
        :class:`UmbrellaResult`.
    """
    centers = np.asarray(centers, dtype=np.float64)
    if centers.ndim == 1:
        centers = centers[:, None]
    K, cv_dim = centers.shape
    kappas = np.broadcast_to(
        np.asarray(kappa, dtype=np.float64), (K,)
    ).astype(np.float64)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    dim = pot_obj.dim
    beta = float(pot_obj.beta)
    dev = resolve_device(device)
    rows, rank = _mesh_rows(mesh, K, "window count", "windows", dev)

    # on a mesh with seed=None, rank 0's draw
    noise = _sampling._make_noise(shared_seed(seed, mesh, dev), dev)
    if X0 is None:
        X0 = _sampling._starts(None, noise, "x0", (dim,), dev)
    X0 = np.asarray(X0, dtype=np.float64)
    if X0.ndim == 1:
        X0 = np.broadcast_to(X0, (K, dim))
    elif X0.shape != (K, dim):
        raise ValueError(f"X0 must be [dim] or [K, dim]; got {X0.shape}")
    _sampling._require_torch(pot_obj, X0[0], "integrate_sde_umbrella")

    x = _chains(X0[rows], dev)
    c_arr = torch.as_tensor(centers[rows].astype(np.float32), device=dev)
    k_arr = torch.as_tensor(kappas[rows].astype(np.float32), device=dev)
    energy = _sampling._energy_fn(pot_obj)
    cv_fn = _cv_fn(cv_model)

    # fail fast on a CV/centers dimensionality mismatch: a size-1 mismatch
    # would broadcast silently for the whole run
    cv_out = _cv_width(cv_fn, x)
    if cv_out != cv_dim:
        raise ValueError(
            f"cv_model returns {cv_out} components but centers have {cv_dim}"
        )

    def biased_v(xx):
        d = cv_fn(xx) - c_arr
        return energy(xx) + 0.5 * k_arr * torch.sum(d * d, dim=-1)

    n_reports = (n_steps - 1) // report_interval + 1
    rec = _sampling._em_scan(
        lambda xx: _batch_grad(biased_v, xx), x,
        _rank_noise(noise, mesh, rows, K), _Blocks(dev),
        step_size, float(_sampling._noise_scale(step_size, beta)),
        int(report_interval), int(n_reports), int(pre_steps),
    )
    (frames,) = _gather_chains(mesh, dev, [(rec["x"], 1)])
    frames = frames.transpose(1, 0, 2)  # [K, n_reports, dim]
    cv_values = _eval_cv(cv_fn, frames.reshape(-1, dim), dev).reshape(
        K, n_reports, cv_dim
    )

    if sampling_output_path is not None and rank == 0:
        os.makedirs(sampling_output_path, exist_ok=True)
        times = np.arange(n_reports) * step_size * report_interval
        for k in range(K):
            np.savetxt(
                os.path.join(sampling_output_path, f"traj_win{k}.txt"),
                np.column_stack([times, frames[k]]),
                fmt="%.8g",
            )
        header = ",".join(
            [f"center_{d}" for d in range(cv_dim)] + ["kappa"]
        )
        np.savetxt(
            os.path.join(sampling_output_path, "windows.csv"),
            np.column_stack([centers, kappas]),
            fmt="%.8g",
            delimiter=",",
            header=header,
            comments="",
        )

    if verbose and rank == 0:
        means = cv_values.mean(axis=1)
        print(
            f"umbrella sampling: {K} windows x {n_reports} frames; "
            f"window CV means {np.round(means.ravel(), 3)}"
        )

    return UmbrellaResult(
        frames=frames.astype(np.float32),
        cv_values=cv_values,
        centers=centers,
        kappas=kappas,
        beta=beta,
        dt=step_size * report_interval,
    )


@dataclasses.dataclass
class SteeredResult:
    """Outcome of :func:`integrate_sde_steered` (M pulling realizations).

    The restraint center moves linearly from ``cv_start`` to ``cv_end``
    over the protocol; ``works[m, t]`` is realization m's accumulated
    PROTOCOL work :math:`W_t = \\sum_s [U(x_s; \\lambda_{s+1}) -
    U(x_s; \\lambda_s)]` up to report t (the discrete Jarzynski/Crooks
    convention — work is tallied at fixed configuration when the
    restraint moves, then the state evolves under the new restraint).

    Attributes:
        frames: [M, n_reports, dim] states at the report times.
        cv_values: [M, n_reports, cv_dim] CV at each recorded frame.
        works: [M, n_reports] cumulative protocol work (energy units).
        schedule: [n_reports, cv_dim] restraint center at each report.
        kappa: restraint strength.
        beta: inverse temperature of the runs.
        dt: time between recorded frames.
    """

    frames: np.ndarray
    cv_values: np.ndarray
    works: np.ndarray
    schedule: np.ndarray
    kappa: float
    beta: float
    dt: float

    @property
    def n_realizations(self) -> int:
        return self.frames.shape[0]

    def jarzynski(self) -> np.ndarray:
        """Free-energy profile along the pulling schedule by the
        Jarzynski equality: ``dF_t = -ln E[exp(-beta W_t)] / beta``
        over the M realizations ([n_reports], relative to the
        equilibrated start; stiff-spring interpretation: the free
        energy of the RESTRAINED ensemble at ``schedule[t]``, which
        approaches the potential of mean force as ``kappa`` grows).
        The exponential average is dominated by rare low-work
        realizations — check :meth:`cumulant` agreement (near-Gaussian
        work) before trusting a fast-pulling estimate."""
        w = self.beta * self.works  # [M, T]
        m = w.min(axis=0)
        return (
            m - np.log(np.mean(np.exp(-(w - m)), axis=0))
        ) / self.beta

    def cumulant(self) -> np.ndarray:
        """Second-order cumulant estimate ``E[W_t] - beta Var[W_t]/2``
        ([n_reports]) — exact for Gaussian work distributions, far
        lower variance than :meth:`jarzynski` at small M; large
        disagreement between the two flags non-Gaussian dissipation
        (pull slower or add realizations)."""
        # unbiased (ddof=1) work variance: at the default M=16 the
        # ddof=0 estimate under-reads the dissipation correction ~6%
        ddof = 1 if self.works.shape[0] > 1 else 0
        return self.works.mean(axis=0) - (
            self.beta * self.works.var(axis=0, ddof=ddof) / 2.0
        )

    @property
    def dissipated_work(self) -> np.ndarray:
        """Mean dissipation ``E[W_t] - dF_t`` ([n_reports], >= 0 by the
        second law up to estimator noise); a quasi-static pull keeps it
        well under ``1/beta``."""
        return self.works.mean(axis=0) - self.jarzynski()

    def window_starts(self, centers) -> np.ndarray:
        """Per-window initial states for
        :func:`integrate_sde_umbrella`'s ``X0`` — for each requested
        center, the recorded frame (any realization) whose CV is
        closest, at the report where the schedule passed nearest that
        center. Returns [K, dim]: the steered chain seeds every
        umbrella window inside its own basin, eliminating long
        relaxation burn-ins for windows far from the unbiased start."""
        centers = np.asarray(centers, dtype=np.float64)
        if centers.ndim == 1:
            centers = centers[:, None]
        starts = np.empty(
            (centers.shape[0], self.frames.shape[2]), dtype=np.float64
        )
        for j, c in enumerate(centers):
            t = int(
                np.argmin(((self.schedule - c) ** 2).sum(axis=-1))
            )
            m = int(
                np.argmin(((self.cv_values[:, t] - c) ** 2).sum(axis=-1))
            )
            starts[j] = self.frames[m, t]
        return starts



def _steered_scan(energy, cv_fn, x, noise, run, step_size, beta, c0, c1,
                  kappa, n_sub, n_reports, pre_steps) -> dict:
    """All M realizations of the pulling protocol at once (the JAX
    ``_steered_scan``, ``enhanced.py:1019-1089``), on ``x`` [M, dim] in
    place: the burn-in under the restraint FIXED at ``c0``, then each step
    tallies the work of moving the centre at fixed state and steps under
    the moved restraint. The centre follows a step counter that the blocks
    advance on the device.

    Returns ``{"x": [T, M, dim], "s": [T, M, k], "w": [T, M],
    "c": [T, k]}``."""
    n_steps = n_sub * n_reports
    scale = float(_sampling._noise_scale(step_size, beta))
    dt = _f32(step_size)
    step_no = torch.zeros((), dtype=torch.long, device=x.device)
    work = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    dc = c1 - c0

    def center(s):
        return c0 + (s.to(torch.float32) / n_steps) * dc

    def force_and_cv(c):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            y = cv_fn(xg)
            d = y - c
            e = energy(xg) + 0.5 * kappa * torch.sum(d * d, dim=-1)
            (g,) = torch.autograd.grad(e.sum(), xg)
        return g, y.detach()

    def em(g, xi):
        _sampling._em_update(x, g, xi, dt, scale)

    buf = torch.empty((n_sub,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    _sampling._burn_in(run, buf, lambda xi: em(force_and_cv(c0)[0], xi),
                       pre_steps, lambda i, n: noise.normal(buf, "burn", i))

    def step(xi):
        ca, cb = center(step_no), center(step_no + 1)
        g, y = force_and_cv(cb)
        dw = 0.5 * kappa * (
            torch.sum((y - cb) ** 2, dim=-1)
            - torch.sum((y - ca) ** 2, dim=-1)
        )
        em(g, xi)
        work.add_(dw)
        step_no.add_(1)

    rec = _Recorder(n_reports, {"x": x, "s": cv_fn(x[:, :]).detach(),
                                "w": work, "c": c0})

    def block():
        for j in range(n_sub):
            step(buf[j])
        with torch.no_grad():
            rec.write("s", cv_fn(x))
        rec.write("x", x)
        rec.write("w", work)
        rec.write("c", center(step_no))
        rec.advance()

    for i in range(report_blocks(n_reports)):
        run.block("main", lambda i=i: noise.normal(buf, "main", i), block)
        rec.end_block()
    return rec.result()


def integrate_sde_steered(
    pot_obj,
    cv_model: Callable,
    cv_start,
    cv_end,
    kappa,
    n_steps: int,
    n_realizations: int = 16,
    X0: Optional[np.ndarray] = None,
    pre_steps: int = 0,
    step_size: float = 0.01,
    report_interval: int = 100,
    seed: Optional[int] = None,
    mesh=None,
    verbose: bool = True,
    device=None,
) -> SteeredResult:
    """Steered pulling along a (learned) CV with Jarzynski work accounting,
    all M realizations as one chain batch (``enhanced.py:1092-1264``).

    A stiff harmonic restraint ``0.5 * kappa * |cv(x) - c(t)|^2`` is
    dragged linearly from ``cv_start`` to ``cv_end`` over ``n_steps`` while
    the protocol work is tallied per realization.

    Args:
        pot_obj: base potential (``dim`` / ``beta`` / ``V`` in torch).
        cv_model: torch map from a chain batch ``[c, dim]`` to CV values.
        cv_start / cv_end: restraint center endpoints (scalar CV or
            [cv_dim]).
        kappa: restraint strength (scalar).
        n_steps: protocol length in integrator steps (must divide by
            ``report_interval``).
        n_realizations: independent pulls M (the Jarzynski average runs
            over these).
        X0: shared start [dim] (default standard normal) or per-
            realization [M, dim] starts.
        pre_steps: equilibration steps under the restraint FIXED at
            ``cv_start`` (discarded); with ``pre_steps=0`` a warning is
            emitted unless ``X0`` gives per-realization starts.
        mesh: a 1-axis mesh (:func:`..parallel.make_data_mesh`) over which
            the pulls shard, ``M / W`` on each rank; every rank returns the
            whole result.
        step_size / report_interval / seed / verbose / device: as in
            :func:`~.sampling.integrate_sde_overdamped`.

    Returns:
        :class:`SteeredResult`.
    """
    dim = pot_obj.dim
    beta = float(pot_obj.beta)
    c0 = np.asarray(cv_start, dtype=np.float64).reshape(-1)
    c1 = np.asarray(cv_end, dtype=np.float64).reshape(-1)
    if c0.shape != c1.shape:
        raise ValueError(
            f"cv_start {c0.shape} and cv_end {c1.shape} must match"
        )
    cv_dim = c0.size
    if n_steps < 1 or n_steps % report_interval:
        raise ValueError(
            f"n_steps ({n_steps}) must be a positive multiple of "
            f"report_interval ({report_interval}) so every report "
            "carries an exact work tally"
        )
    M = int(n_realizations)
    if pre_steps == 0 and (X0 is None or np.ndim(X0) == 1):
        # shared (often random) starts with no burn-in: the pulls do not
        # begin in the restrained equilibrium ensemble, so the
        # Jarzynski/cumulant free energies are silently biased
        warnings.warn(
            "integrate_sde_steered: pre_steps=0 with a shared X0 start "
            "— realizations are not equilibrated under the fixed "
            "cv_start restraint, biasing jarzynski()/cumulant(). Pass "
            "pre_steps>0 (the umbrella example uses 3000) or "
            "per-realization equilibrium X0 [M, dim].",
            stacklevel=2,
        )
    dev = resolve_device(device)
    rows, rank = _mesh_rows(mesh, M, "n_realizations", "pulls", dev)

    # on a mesh with seed=None, rank 0's draw
    noise = _sampling._make_noise(shared_seed(seed, mesh, dev), dev)
    if X0 is None:
        X0 = _sampling._starts(None, noise, "x0", (dim,), dev)
    X0 = np.asarray(X0, dtype=np.float64)
    if X0.ndim == 1:
        X0 = np.broadcast_to(X0, (M, dim))
    elif X0.shape != (M, dim):
        raise ValueError(f"X0 must be [dim] or [M, dim]; got {X0.shape}")
    _sampling._require_torch(pot_obj, X0[0], "integrate_sde_steered")

    x = _chains(X0[rows], dev)
    cv_fn = _cv_fn(cv_model)
    cv_out = _cv_width(cv_fn, x)
    if cv_out != cv_dim:
        raise ValueError(
            f"cv_model returns {cv_out} components but cv_start has "
            f"{cv_dim}"
        )

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    n_reports = n_steps // report_interval
    rec = _steered_scan(
        _sampling._energy_fn(pot_obj), cv_fn, x,
        _rank_noise(noise, mesh, rows, M), _Blocks(dev),
        step_size, beta, f32(c0), f32(c1), _f32(kappa),
        int(report_interval), int(n_reports), int(pre_steps),
    )
    frames, cvs, works = _gather_chains(mesh, dev, [
        (rec["x"], 1), (rec["s"], 1), (rec["w"], 1)])
    res = SteeredResult(
        frames=frames.transpose(1, 0, 2),
        cv_values=cvs.transpose(1, 0, 2),
        works=np.asarray(works, dtype=np.float64).T,
        schedule=np.asarray(rec["c"], dtype=np.float64),
        kappa=float(kappa),
        beta=beta,
        dt=step_size * report_interval,
    )

    if verbose and rank == 0:
        print(
            f"steered pulling: {M} realizations x {n_reports} reports; "
            f"<W> {res.works[:, -1].mean():.4g}, "
            f"dF(Jarzynski) {res.jarzynski()[-1]:.4g}"
        )
    return res


@dataclasses.dataclass
class REMDResult:
    """Outcome of :func:`integrate_sde_remd` (K temperature slots).

    ``frames[k]`` is the TEMPERATURE-SLOT trajectory at ``betas[k]`` —
    slot k always samples the Boltzmann distribution at its own beta;
    accepted exchanges teleport configurations between slots, so slot
    trajectories are thermodynamically exact but kinetically
    discontinuous at swap points (``swap_history`` records them; the
    pooled :meth:`to_weighted_trajectory` turns each swap into a segment
    boundary so time-lagged objectives never pair across a teleport).

    Attributes:
        frames: [K, n_reports, dim] recorded states per slot.
        energies: [K, n_reports] potential energies of the recorded states.
        betas: [K] inverse temperatures (slot order).
        dt: time between recorded frames.
        pair_attempts / pair_accepts: [K-1] exchange statistics for the
            neighbor pairs (k, k+1).
        swap_history: [n_reports, K] bool — True where slot k's
            configuration was swapped just before recording frame j.
    """

    frames: np.ndarray
    energies: np.ndarray
    betas: np.ndarray
    dt: float
    pair_attempts: np.ndarray
    pair_accepts: np.ndarray
    swap_history: np.ndarray

    @property
    def n_replicas(self) -> int:
        return len(self.betas)

    @property
    def pair_acceptance(self) -> np.ndarray:
        """Acceptance rate per neighbor pair (nan where never attempted);
        a well-designed ladder sits around 0.2-0.4 everywhere."""
        with np.errstate(invalid="ignore"):
            return np.where(
                self.pair_attempts > 0,
                self.pair_accepts / np.maximum(self.pair_attempts, 1),
                np.nan,
            )

    def mbar(self, sys_beta: Optional[float] = None, **kwargs) -> MBARResult:
        """Temperature-MBAR weights targeting ``sys_beta`` (default: the
        coldest ladder temperature, i.e. the LARGEST beta): reduced bias
        energies
        ``u_k(x) = (beta_k - sys_beta) V(x)`` over the pooled samples —
        every slot contributes, hot slots downweighted exactly."""
        target = float(self.betas.max() if sys_beta is None else sys_beta)
        v_pooled = self.energies.reshape(-1)
        u_kn = (self.betas[:, None] - target) * v_pooled[None, :]
        return mbar_weights(
            [e[:, None] for e in self.energies], u_kn=u_kn, **kwargs
        )

    def to_weighted_trajectory(
        self,
        sys_beta: Optional[float] = None,
        mbar_result: Optional[MBARResult] = None,
    ):
        """Pool every slot into ONE training-ready
        :class:`~.trajectory.WeightedTrajectory`:
        frames concatenated, temperature-MBAR weights at ``sys_beta``
        attached (pooled mean 1), and ``segment_starts`` marking both the
        slot boundaries and every ACCEPTED exchange, so time-lagged
        training pairs never span a configuration teleport."""
        from .trajectory import WeightedTrajectory

        mb = mbar_result if mbar_result is not None else self.mbar(sys_beta)
        K, n, _ = self.frames.shape
        starts = [np.arange(K) * n]
        swap_j, swap_k = np.nonzero(self.swap_history)
        if swap_j.size:
            starts.append(swap_k * n + swap_j)
        # boundaries go through the constructor so the zero-weight frame
        # filter (temperature-MBAR weights of hot-slot energy spikes can
        # underflow to 0.0) remaps them to the surviving frames
        return WeightedTrajectory(
            trajectory=self.frames.reshape(-1, *self.frames.shape[2:]),
            weights=np.concatenate(mb.weights),
            dt=self.dt,
            verbose=False,
            segment_starts=np.unique(np.concatenate(starts)),
        )

    def subsample(self, g: Optional[float] = None) -> "REMDResult":
        """Decimate every temperature slot to (approximately)
        independent frames.

        Strides the report axis by ``ceil(g)``, with ``g`` defaulting to
        the maximum statistical inefficiency of the per-slot POTENTIAL
        ENERGY series (the observable temperature-MBAR actually
        reweights by) — computed with per-slot swap points as segment
        boundaries so the correlation estimate never spans a
        configuration teleport. ``swap_history`` is folded down so a
        kept frame is marked swapped iff ANY swap occurred since the
        previous kept frame; :meth:`to_weighted_trajectory` on the
        subsampled result therefore still breaks lagged pairs at every
        surviving discontinuity.
        """
        from ..analysis import statistical_inefficiency

        K, n = self.energies.shape
        if g is None:
            g = 1.0
            for k in range(K):
                segs = np.unique(
                    np.concatenate(
                        [[0], np.nonzero(self.swap_history[:, k])[0]]
                    )
                )
                g = max(
                    g,
                    float(statistical_inefficiency(
                        self.energies[k], segment_starts=segs
                    )[0]),
                )
        stride = max(1, int(np.ceil(float(g) - 1e-9)))
        kept = np.arange(0, n, stride)
        swapped = np.empty((kept.size, K), dtype=bool)
        swapped[0] = self.swap_history[0]
        for i in range(1, kept.size):
            swapped[i] = self.swap_history[
                kept[i - 1] + 1 : kept[i] + 1
            ].any(axis=0)
        return dataclasses.replace(
            self,
            frames=self.frames[:, kept],
            energies=self.energies[:, kept],
            swap_history=swapped,
            dt=self.dt * stride,
        )



def integrate_sde_remd(
    pot_obj,
    betas,
    n_steps: int,
    sampling_output_path: Optional[str] = None,
    X0: Optional[np.ndarray] = None,
    pre_steps: int = 0,
    step_size: float = 0.01,
    report_interval: int = 100,
    exchange_interval: Optional[int] = None,
    seed: Optional[int] = None,
    mesh=None,
    verbose: bool = True,
    device=None,
) -> REMDResult:
    """Replica-exchange (parallel tempering) sampling, all K temperature
    slots as one chain batch with neighbour-swap Metropolis attempts on the
    device (``enhanced.py:1502-1657``).

    Swaps satisfy detailed balance:
    ``P = min(1, exp((beta_a - beta_b)(V_a - V_b)))``, alternating
    even/odd neighbour pairs; the test runs in log space, the permutation is
    a gather, and the acceptance counts and the swap history stay on the
    device until the end of the call.

    Args:
        pot_obj: potential (``dim`` / ``beta`` / ``V`` in torch; ``gradV``
            optional).
        betas: [K] inverse-temperature ladder (slot k stays at
            ``betas[k]``).
        n_steps: integrator steps per slot.
        exchange_interval: steps between swap attempts (a multiple of
            ``report_interval``; default ``10 * report_interval``).
        sampling_output_path: when given, writes per-slot
            ``traj_replica{k}.txt`` (t, x...) and ``replicas.csv``
            (beta, pair acceptance).
        X0: initial state [dim] shared by all slots, or per-slot [K, dim].
        mesh: a 1-axis mesh (:func:`..parallel.make_data_mesh`) over which
            the slots shard, ``K / W`` on each rank; each exchange gathers
            the slots' states and decides on the whole ladder on every
            rank, every rank returns the whole result, and only rank 0
            writes files.
        pre_steps / step_size / report_interval / seed / verbose / device:
            as in :func:`~.sampling.integrate_sde_overdamped`.

    Returns:
        :class:`REMDResult`.
    """
    betas = np.asarray(betas, dtype=np.float64).reshape(-1)
    K = betas.shape[0]
    if K < 2:
        raise ValueError("replica exchange needs at least 2 betas")
    if (betas <= 0).any():
        raise ValueError("betas must be positive")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if exchange_interval is None:
        exchange_interval = 10 * report_interval
    if exchange_interval % report_interval:
        raise ValueError(
            f"exchange_interval ({exchange_interval}) must be a multiple "
            f"of report_interval ({report_interval})"
        )
    eeb = exchange_interval // report_interval
    dim = pot_obj.dim
    dev = resolve_device(device)
    rows, rank = _mesh_rows(mesh, K, "replica count", "slots", dev)

    # on a mesh with seed=None, rank 0's draw
    noise = _sampling._make_noise(shared_seed(seed, mesh, dev), dev)
    if X0 is None:
        X0 = _sampling._starts(None, noise, "x0", (dim,), dev)
    X0 = np.asarray(X0, dtype=np.float64)
    if X0.ndim == 1:
        X0 = np.broadcast_to(X0, (K, dim))
    elif X0.shape != (K, dim):
        raise ValueError(f"X0 must be [dim] or [K, dim]; got {X0.shape}")
    _sampling._require_torch(pot_obj, X0[0], "integrate_sde_remd")

    x = _chains(X0[rows], dev)
    b32 = betas.astype(np.float32)
    noise = _rank_noise(noise, mesh, rows, K)
    exchange, counts = _exchange(_sampling._energy_fn(pot_obj), x,
                                 torch.as_tensor(b32, device=dev), noise,
                                 mesh, rows)
    n_reports = (n_steps - 1) // report_interval + 1
    rec = _sampling._em_scan(
        _sampling._grad_fn(pot_obj), x, noise, _Blocks(dev),
        step_size,
        torch.as_tensor(_sampling._noise_scale(step_size, b32[rows])[:, None],
                        device=dev),
        int(report_interval), int(n_reports), int(pre_steps),
        exchange=exchange, every=int(eeb),
    )
    frames, swap_history = _gather_chains(mesh, dev, [
        (rec["x"], 1), (rec["moved"], 1)])
    frames = frames.transpose(1, 0, 2)  # [K, n_reports, dim]
    # swap_history: [n_reports, K]
    att, accs = (t.cpu().numpy()[: K - 1] for t in counts)

    energies = _sampling._batched_energy(pot_obj, frames, dev, True)

    result = REMDResult(
        frames=frames.astype(np.float32),
        energies=energies,
        betas=betas,
        dt=step_size * report_interval,
        pair_attempts=att,
        pair_accepts=accs,
        swap_history=swap_history,
    )

    if sampling_output_path is not None and rank == 0:
        os.makedirs(sampling_output_path, exist_ok=True)
        times = np.arange(n_reports) * step_size * report_interval
        for k in range(K):
            np.savetxt(
                os.path.join(sampling_output_path, f"traj_replica{k}.txt"),
                np.column_stack([times, frames[k]]),
                fmt="%.8g",
            )
        acc_rates = np.append(result.pair_acceptance, np.nan)
        np.savetxt(
            os.path.join(sampling_output_path, "replicas.csv"),
            np.column_stack([betas, acc_rates]),
            fmt="%.8g",
            delimiter=",",
            header="beta,pair_acceptance_up",
            comments="",
        )

    if verbose and rank == 0:
        print(
            f"replica exchange: {K} slots x {n_reports} frames; "
            f"pair acceptance {np.round(result.pair_acceptance, 3)}"
        )
    return result


def _exchange(energy, x, betas, noise, mesh=None, rows=slice(None)):
    """Replica exchange on the chain batch ``x`` [K, d], on the device
    (``attempt_exchange``, ``enhanced.py:1453-1471``): ``draw(attempt)``
    fills the attempt's uniforms; ``apply()`` tests the even or odd
    neighbour pairs (by an attempt counter on the device) in log space,
    permutes ``x`` in place, counts attempts and acceptances per pair, and
    returns which slots moved. Returns ``((draw, apply), (attempts,
    accepts))``.

    On a mesh ``x`` holds this rank's ``rows`` of the K slots: ``apply()``
    all-gathers the slots' states (:func:`..parallel.collectives.
    all_gather_rows`), decides on the whole ladder with the uniforms every
    rank draws whole, keeps its own rows of the permuted states and returns
    its rows of the moves; the counts are the whole ladder's on every
    rank."""
    K = betas.shape[0]
    dev = x.device
    i_arr = torch.arange(K, device=dev)
    u = torch.empty(K, dtype=torch.float32, device=dev)
    attempt = torch.zeros((), dtype=torch.long, device=dev)
    att = torch.zeros(K, dtype=torch.int32, device=dev)
    accs = torch.zeros(K, dtype=torch.int32, device=dev)

    def draw(a):
        noise.uniform(u, "exchange", a)

    def apply():
        xs = x if mesh is None else all_gather_rows(mesh, x)
        with torch.no_grad():
            vs = energy(xs)
        parity = attempt % 2
        partner = torch.where((i_arr - parity) % 2 == 0, i_arr + 1, i_arr - 1)
        valid = (partner >= 0) & (partner < K)
        partner_c = partner.clamp(0, K - 1)
        lo = torch.minimum(i_arr, partner_c)
        hi = torch.maximum(i_arr, partner_c)
        # swapping x_lo <-> x_hi between slots lo/hi changes the joint
        # Gibbs exponent by (beta_lo - beta_hi)(V_lo - V_hi); accept in
        # log space (exp can overflow when the move is downhill)
        dlt = (betas[lo] - betas[hi]) * (vs[lo] - vs[hi])
        acc = valid & (torch.log(u[lo]) < dlt)  # symmetric within a pair
        x.copy_(xs[torch.where(acc, partner_c, i_arr)[rows]])
        is_lo = valid & (i_arr == lo)
        att.add_(is_lo.to(torch.int32))
        accs.add_((is_lo & acc).to(torch.int32))
        attempt.add_(1)
        return acc[rows]

    return (draw, apply), (att, accs)


# ---------------------------------------------------------------------------
# PLUMED interop: HILLS files + generalized metadynamics reweighting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlumedHills:
    """Contents of a (PLUMED-style) HILLS file.

    Attributes:
        times: ``[H]`` deposition times.
        centers: ``[H, k]`` hill centers (the CV at deposition).
        sigmas: ``[H, k]`` per-hill Gaussian widths.
        heights: ``[H]`` DEPOSITED heights. For well-tempered runs
            :func:`read_plumed_hills` has already undone PLUMED's
            ``gamma/(gamma-1)`` file rescaling, so these are the heights
            the bias is actually built from.
        bias_factor: well-tempered gamma, or None for standard
            metadynamics (PLUMED writes ``biasf`` of 1, or -1 in this
            package's writer, for non-tempered runs).
    """

    times: np.ndarray
    centers: np.ndarray
    sigmas: np.ndarray
    heights: np.ndarray
    bias_factor: Optional[float]

    @property
    def n_hills(self) -> int:
        return len(self.heights)

    def bias(self, s) -> np.ndarray:
        """Accumulated (final) bias at CV value(s) ``s`` [m, k] or [m]."""
        s = np.atleast_2d(np.asarray(s, dtype=np.float64))
        if s.shape[-1] != self.centers.shape[-1]:
            s = s.reshape(-1, self.centers.shape[-1])
        inv = 1.0 / (2.0 * self.sigmas**2)  # [H, k]
        d2 = ((s[:, None, :] - self.centers[None, :, :]) ** 2 * inv[None])
        return (self.heights[None, :] * np.exp(-d2.sum(-1))).sum(-1)


def read_plumed_hills(path: str) -> PlumedHills:
    """Parse a PLUMED ``HILLS`` file (also the format this package's
    :func:`integrate_sde_metadynamics` writes).

    Layout: ``#! FIELDS time <cv...> sigma_<cv...> height biasf`` header
    followed by numeric rows; repeated header blocks (PLUMED restarts)
    and comment lines are tolerated. The CV dimensionality is inferred
    from the FIELDS names (columns between ``time`` and the first
    ``sigma_*``).

    The reweighting entry point for trajectories biased by an EXTERNAL
    engine: run PLUMED metadynamics anywhere, then
    :func:`metad_frame_weights` with the CV series of the frames (e.g.
    the COLVAR file) to get unbiased-ensemble training weights
    (reference ecosystem path: utils.py:220-223 + :354-417).
    """
    rows: list = []
    k = None
    header: Optional[list] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                toks = line.split()
                if "SET" in toks and "multivariate" in toks:
                    flag = toks[toks.index("multivariate") + 1 :]
                    if flag and flag[0].lower() == "true":
                        raise ValueError(
                            f"{path}: multivariate (adaptive-Gaussian) "
                            "HILLS files store k(k+1)/2 covariance "
                            "columns and are not supported"
                        )
                if "FIELDS" in toks:
                    # names like: #! FIELDS time cv1 ... sigma_cv1 ... height biasf
                    try:
                        fields = toks[toks.index("FIELDS") + 1 :]
                        if header is not None and fields != header:
                            raise ValueError(
                                f"{path}: restart block changes the "
                                f"columns ({header} -> {fields})"
                            )
                        header = fields
                        t_idx = fields.index("time")
                        sig0 = next(
                            i for i, nm in enumerate(fields)
                            if nm.startswith("sigma_")
                        )
                        k = sig0 - (t_idx + 1)
                        if fields[sig0 + k] != "height":
                            raise ValueError(
                                f"{path}: expected 'height' after {k} "
                                f"sigma columns, found "
                                f"'{fields[sig0 + k]}' — non-diagonal "
                                "(multivariate) sigma layout?"
                            )
                    except (StopIteration, IndexError):
                        raise ValueError(
                            f"{path}: unrecognized FIELDS header: {line}"
                        ) from None
                continue
            rows.append([float(v) for v in line.split()])
    if not rows:
        raise ValueError(f"{path}: no hill rows")
    data = np.asarray(rows, dtype=np.float64)
    if k is None:
        # no header: infer from column count (time, k cv, k sigma,
        # height, biasf)
        if (data.shape[1] - 3) % 2:
            raise ValueError(
                f"{path}: cannot infer CV dimensionality from "
                f"{data.shape[1]} columns without a FIELDS header"
            )
        k = (data.shape[1] - 3) // 2
    if data.shape[1] < 2 * k + 3:
        raise ValueError(
            f"{path}: rows have {data.shape[1]} columns, expected "
            f"{2 * k + 3} (time, {k} cv, {k} sigma, height, biasf)"
        )
    times = data[:, 0]
    centers = data[:, 1 : 1 + k]
    sigmas = data[:, 1 + k : 1 + 2 * k]
    heights = data[:, 1 + 2 * k].copy()
    biasf = data[:, 2 + 2 * k]
    bf = float(biasf[0])
    bias_factor = bf if bf > 1.0 else None
    if bias_factor is not None:
        # PLUMED convention (MetaD::writeGaussian): well-tempered HILLS
        # store heights rescaled by gamma/(gamma-1) so sum_hills
        # integrates to -F directly; undo it to recover the DEPOSITED
        # heights the bias is actually built from (PLUMED's own reader
        # does the same division).
        heights *= (bias_factor - 1.0) / bias_factor
    return PlumedHills(times, centers, sigmas, heights, bias_factor)


def _hills_grid(centers: np.ndarray, sigmas: np.ndarray,
                grid_points: int) -> np.ndarray:
    dim = centers.shape[-1]
    if dim > 2:
        raise ValueError(
            f"no default grid for a {dim}-dimensional CV — pass "
            "grid=[n_points, cv_dim] explicitly"
        )
    smax = float(sigmas.max())
    axes = [
        np.linspace(
            centers[:, d].min() - 4 * smax,
            centers[:, d].max() + 4 * smax,
            grid_points,
        )
        for d in range(dim)
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


def metad_frame_weights(
    cv_values,
    hills: PlumedHills,
    frame_times=None,
    beta: float = 1.0,
    method: str = "tiwary",
    grid: Optional[np.ndarray] = None,
    grid_points: int = 129,
    _cutoffs=None,
) -> np.ndarray:
    """Unbiased-ensemble weights for ARBITRARY frames of a metadynamics
    run described by a HILLS file.

    The generalization of :meth:`MetadynamicsResult.frame_weights` to
    frames that are not the deposition frames — e.g. a PLUMED COLVAR
    series sampled every MD step while hills were deposited every
    PACE steps, or frames re-evaluated through a retrained CV.

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV values of the frames to
            reweight (must be the same CV the hills act on).
        hills: :class:`PlumedHills` (from :func:`read_plumed_hills` or
            built directly from arrays).
        frame_times: ``[n]`` times of the frames on the SAME clock as
            ``hills.times``. Required for ``method='tiwary'`` (each
            frame sees only hills deposited strictly before it);
            ignored by ``'final-bias'``.
        beta: inverse temperature of the run.
        method: ``'final-bias'`` (quasi-static, ``w ∝ exp(beta V_b(s))``
            with the final bias) or ``'tiwary'`` (time-dependent
            estimator — see :meth:`MetadynamicsResult.frame_weights`).
        grid / grid_points: CV grid for the Tiwary ``c(t)`` integrals.

    Returns:
        weights ``[n]`` with mean 1, aligned with ``cv_values``.
    """
    s = np.atleast_2d(np.asarray(cv_values, dtype=np.float64))
    k = hills.centers.shape[-1]
    if s.shape[-1] != k:
        s = s.reshape(-1, k)
    n = s.shape[0]
    H = hills.n_hills
    inv = 1.0 / (2.0 * hills.sigmas**2)  # [H, k]
    heights = hills.heights.astype(np.float64)

    if method == "final-bias":
        expo = beta * hills.bias(s)
    elif method == "tiwary":
        if _cutoffs is not None:
            cut = np.asarray(_cutoffs, dtype=np.int64)
        else:
            if frame_times is None:
                raise ValueError(
                    "method='tiwary' needs frame_times (hills deposited "
                    "strictly before each frame define its bias)"
                )
            cut = np.searchsorted(
                hills.times, np.asarray(frame_times, dtype=np.float64),
                side="left",
            )
        if grid is None:
            grid = _hills_grid(hills.centers, hills.sigmas, grid_points)
        grid = np.asarray(grid, dtype=np.float64)

        beta_f = float(beta)
        if hills.bias_factor is None:  # standard metadynamics
            a1, a2 = beta_f, 0.0
        else:
            g = hills.bias_factor
            a1, a2 = beta_f * g / (g - 1.0), beta_f / (g - 1.0)

        # c after j hills, j = 0..H, via grid integrals of the partial
        # bias (log-sum-exp, chunked over grid points)
        log_i1 = np.full(H + 1, -np.inf)
        log_i2 = np.full(H + 1, -np.inf)
        chunk = max(1, int(2e7) // max(H, 1))
        for lo in range(0, grid.shape[0], chunk):
            gpts = grid[lo : lo + chunk]
            d2 = (
                (gpts[None, :, :] - hills.centers[:, None, :]) ** 2
                * inv[:, None, :]
            ).sum(-1)
            hill_mat = heights[:, None] * np.exp(-d2)  # [H, g]
            vpart = np.concatenate(
                [np.zeros((1, gpts.shape[0])), np.cumsum(hill_mat, axis=0)],
                axis=0,
            )  # [H+1, g]: bias after j hills
            for log_acc, a in ((log_i1, a1), (log_i2, a2)):
                m = (a * vpart).max(axis=1)
                ssum = np.log(
                    np.exp(a * vpart - m[:, None]).sum(axis=1)
                ) + m
                hi = np.maximum(log_acc, ssum)
                log_acc[:] = hi + np.log(
                    np.exp(log_acc - hi) + np.exp(ssum - hi)
                )
        c_after = (log_i1 - log_i2) / beta_f  # [H+1]

        # V(s_i, t_i): partial bias at each frame's own CV (chunked)
        v_own = np.empty(n)
        fchunk = max(1, int(2e7) // max(H, 1))
        for lo in range(0, n, fchunk):
            sl = s[lo : lo + fchunk]
            d2f = (
                (sl[:, None, :] - hills.centers[None, :, :]) ** 2
                * inv[None, :, :]
            ).sum(-1)
            M = heights[None, :] * np.exp(-d2f)  # [m, H]
            csum = np.concatenate(
                [np.zeros((sl.shape[0], 1)), np.cumsum(M, axis=1)], axis=1
            )
            v_own[lo : lo + fchunk] = csum[
                np.arange(sl.shape[0]), cut[lo : lo + fchunk]
            ]
        expo = beta_f * (v_own - c_after[cut])
    else:
        raise ValueError(
            f"unknown reweighting method '{method}' "
            "(use 'final-bias' or 'tiwary')"
        )
    w = np.exp(expo - expo.max())
    return w / w.mean()


def read_plumed_colvar(path: str, fields: Optional[list] = None):
    """Parse a PLUMED ``COLVAR`` file (``PRINT`` output: ``#! FIELDS
    time <name...>`` header + numeric rows; restart blocks tolerated).

    Args:
        path: COLVAR file path.
        fields: optional list of column names to return (default: every
            column after ``time``).

    Returns:
        ``(times [n], values [n, len(fields)], names)`` — feed
        ``values``/``times`` straight into :func:`metad_frame_weights`
        (select the biased CV columns via ``fields``).
    """
    names: Optional[list] = None
    rows: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if "FIELDS" in line:
                    toks = line.split()
                    new = toks[toks.index("FIELDS") + 1 :]
                    if names is not None and new != names:
                        raise ValueError(
                            f"{path}: restart block changes the columns "
                            f"({names} -> {new})"
                        )
                    names = new
                continue
            rows.append([float(v) for v in line.split()])
    if names is None:
        raise ValueError(f"{path}: no FIELDS header")
    if not rows:
        raise ValueError(f"{path}: no data rows")
    data = np.asarray(rows, dtype=np.float64)
    if data.shape[1] != len(names):
        raise ValueError(
            f"{path}: rows have {data.shape[1]} columns but FIELDS "
            f"names {len(names)}"
        )
    if "time" not in names:
        raise ValueError(f"{path}: no 'time' column in FIELDS")
    t_idx = names.index("time")
    times = data[:, t_idx]
    value_names = [nm for i, nm in enumerate(names) if i != t_idx]
    if fields is not None:
        missing = [nm for nm in fields if nm not in value_names]
        if missing:
            raise ValueError(
                f"{path}: columns {missing} not present "
                f"(available: {value_names})"
            )
        value_names = list(fields)
    cols = [names.index(nm) for nm in value_names]
    return times, data[:, cols], value_names
