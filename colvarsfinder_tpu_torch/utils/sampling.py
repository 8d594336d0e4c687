r"""Trajectory samplers (port of ``colvarsfinder_tpu/utils/sampling.py``).

* :func:`integrate_sde_overdamped`: Euler–Maruyama integration of
  overdamped Langevin dynamics, ``n_chains`` independent chains at once.
* :func:`integrate_sde_langevin`: underdamped Langevin dynamics by the
  BAOAB splitting.
* :func:`integrate_md_langevin`: the host-side OpenMM wrapper, copied from
  ``sampling.py:573-665`` (OpenMM imported when called).

The JAX package integrates as one ``lax.scan`` over report blocks of
``n_sub`` steps. Here each block is a Python loop of ``n_sub`` steps on the
chain batch, in place on tensors allocated once per call
(:class:`_Blocks`). On the card the first block of each kind (burn-in,
report, exchange) runs eagerly on a side stream and is captured as a CUDA
graph (:class:`..graphs.Graphs`); every later block of that kind is a
replay. A block's Brownian increments are drawn before the block, outside
the graph, into a fixed buffer; the recorded frames go to device buffers
at a row index that the block advances on the device (:class:`_Recorder`),
and the host fetches them once per call, or once per chunk of reports. No
host sync happens inside a block.

The potential keeps the JAX contract: ``dim``, ``beta`` and ``V`` (and
optionally ``gradV``) on ONE state ``[d]``. ``V`` and ``gradV`` are mapped
over the chains with ``torch.func.vmap``, and ``torch.func.grad`` of ``V``
stands in for a missing ``gradV``. Whether a potential is written in torch
is decided before integrating, by one call on a CPU tensor
(:func:`_is_torch_potential`); one that returns no tensor takes the host
numpy loop of the JAX package (``_run_numpy``, ``_run_numpy_baoab``,
``_numpy_grad``: copied from ``sampling.py:244-292,537-570``), which gives
the JAX fallback's numbers bit for bit. An error of a torch potential
raises.

Every random draw of a call goes through one seam, :func:`_make_noise`:
one ``torch.Generator`` on the call's device, seeded with ``seed``. The
same seed gives other samples than the JAX package's keys do; the CPU
tests replace the seam with the JAX package's draws.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..graphs import Graphs, report_blocks
from .trajectory import csv_rows

__all__ = [
    "integrate_sde_overdamped",
    "integrate_sde_langevin",
    "integrate_md_langevin",
]

#: device bytes of recorded reports kept between two host fetches
_CHUNK_BYTES = 256 << 20
#: states per batch when energies or CVs of recorded frames are evaluated
_EVAL_CHUNK = 65536


class _Noise:
    """The random draws of one sampler call: one ``torch.Generator`` on the
    call's device, seeded with ``seed``, drawn in the order the call asks.

    Every draw names its stream and index: ``"x0"`` / ``"v0"`` (the default
    starts [c, d]), ``"burn"`` / ``"main"`` (block ``i``'s increments
    [n_sub, c, d]), ``"metad_burn"`` (metadynamics' one burn-in draw
    [pre_steps, c, d]) and, through :meth:`uniform`, ``"exchange"``
    (replica exchange attempt ``i``'s uniforms [K]). The default ignores the
    names; a replacement (the CPU tests') reproduces the JAX package's keys
    from them."""

    def __init__(self, seed: int, device: torch.device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))

    def normal(self, out: torch.Tensor, stream: str, i: int) -> None:
        out.normal_(generator=self.generator)

    def uniform(self, out: torch.Tensor, stream: str, i: int) -> None:
        out.uniform_(generator=self.generator)


def _make_noise(seed: int, device: torch.device) -> _Noise:
    """The draws of one sampler call (the seam the CPU tests replace)."""
    return _Noise(seed, device)


class _Blocks(Graphs):
    """The graphs of one sampler call's blocks, by kind; they die with the
    call. :meth:`block` runs ``draw()`` (the block's random numbers, into
    fixed buffers) and then ``body()`` (the block's steps, in place on fixed
    tensors), eagerly, replayed or captured (:meth:`..graphs.Graphs.run`);
    a block of kind ``None`` (a burn-in's partial last block) always runs
    eagerly."""

    def block(self, kind, draw, body) -> None:
        draw()
        self.run(kind, body, what="a sampler block")


class _Recorder:
    """Per-report outputs of a sampler call.

    ``like`` maps each output's name to a tensor of one report's shape and
    dtype. Inside a block, :meth:`write` puts a report at a row counter
    that lives on the device and :meth:`advance` moves it on; after each
    block the host calls :meth:`end_block`, which fetches the rows once the
    device buffers (at most :data:`_CHUNK_BYTES`) are full. :meth:`result`
    fetches the rest and returns ``{name: [n_reports, ...] numpy}``."""

    def __init__(self, n_reports: int, like: dict):
        row_bytes = sum(t.numel() * t.element_size() for t in like.values())
        self.rows = max(1, min(n_reports, _CHUNK_BYTES // max(row_bytes, 1)))
        device = next(iter(like.values())).device
        self.dev = {k: torch.zeros((self.rows,) + tuple(t.shape),
                                   dtype=t.dtype, device=device)
                    for k, t in like.items()}
        self.host = {k: np.zeros((n_reports,) + tuple(t.shape),
                                 dtype=torch.empty(0, dtype=t.dtype)
                                 .numpy().dtype)
                     for k, t in like.items()}
        self.row = torch.zeros(1, dtype=torch.long, device=device)
        self.done = self.pending = 0

    def write(self, name: str, value: torch.Tensor) -> None:
        self.dev[name].index_copy_(0, self.row, value.unsqueeze(0))

    def advance(self) -> None:
        self.row.add_(1)

    def end_block(self) -> None:
        self.pending += 1
        if self.pending == self.rows:
            self._fetch()

    def _fetch(self) -> None:
        n = self.pending
        for k, buf in self.dev.items():
            self.host[k][self.done:self.done + n] = buf[:n].cpu().numpy()
        self.done += n
        self.pending = 0
        self.row.zero_()

    def result(self) -> dict:
        if self.pending:
            self._fetch()
        return self.host


def _f32(v) -> float:
    """``v`` rounded to float32, as the JAX package passes its scalars."""
    return float(np.float32(v))


def _noise_scale(step_size: float, beta) -> np.ndarray:
    """``sqrt(2 dt / beta)`` in float32 arithmetic (``_em_scan``)."""
    return np.sqrt(np.float32(2.0) * np.float32(step_size)
                   / np.asarray(beta, dtype=np.float32))


def _starts(X0, noise, stream: str, shape: tuple, device) -> np.ndarray:
    """``X0`` (or ``V0``) broadcast to ``shape`` in float64, or a standard
    normal draw of ``shape`` in float32 when it is None."""
    if X0 is not None:
        return np.broadcast_to(np.asarray(X0, dtype=np.float64), shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    noise.normal(out, stream, 0)
    return out.cpu().numpy()


def _chains(X0: np.ndarray, device) -> torch.Tensor:
    """The chain batch of a call on ``device``: float32, its own memory."""
    return torch.from_numpy(np.array(X0, dtype=np.float32)).to(device)


def _is_torch_potential(pot_obj, x0) -> bool:
    """Whether the potential is written in torch, decided up front by one
    call of its ``V`` (and ``gradV``, where it has one) on a CPU tensor of
    the state ``x0``: a potential that returns no tensor is a numpy one.
    A :class:`..enhanced.BiasedPotential` is probed through its base."""
    base = getattr(pot_obj, "base_potential", pot_obj)
    probe = torch.as_tensor(np.asarray(x0, dtype=np.float32))
    fns = [base.V]
    if getattr(base, "gradV", None) is not None:
        fns.append(base.gradV)
    return all(isinstance(fn(probe.clone()), torch.Tensor) for fn in fns)


def _require_torch(pot_obj, x0, who: str) -> None:
    """Samplers without a numpy loop (as in the JAX package, which needs a
    traceable potential there) refuse a numpy potential up front."""
    if not _is_torch_potential(pot_obj, x0):
        raise TypeError(
            f"{who} needs a potential written in torch: its V (and gradV) "
            "must return tensors")


def _energy_fn(pot_obj):
    """``[c, d] -> [c]`` potential energies of a chain batch: the
    potential's own ``batched_V`` where it has one
    (:class:`..enhanced.BiasedPotential`), else ``V`` mapped over the
    chains."""
    batched = getattr(pot_obj, "batched_V", None)
    if batched is not None:
        return batched
    return torch.func.vmap(lambda x: torch.as_tensor(pot_obj.V(x)).reshape(()))


def _batch_grad(energy, x: torch.Tensor) -> torch.Tensor:
    """Gradient of the summed energies of a chain batch: each row's
    gradient, since the rows are independent. Autograd on the batch, for
    CVs whose kernel layers have no vmap rule."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(energy(xg).sum(), xg)
    return g


def _grad_fn(pot_obj):
    """``[c, d] -> [c, d]`` gradient of the potential for each chain:
    ``gradV`` mapped over the chains, or ``torch.func.grad`` of ``V`` where
    it has none (``_resolve_grad``); a potential with a ``batched_V``
    (:class:`..enhanced.BiasedPotential`) through autograd on the batch."""
    batched = getattr(pot_obj, "batched_V", None)
    if batched is not None:
        return lambda x: _batch_grad(batched, x)
    grad = getattr(pot_obj, "gradV", None)
    if grad is None:
        grad = torch.func.grad(
            lambda x: torch.as_tensor(pot_obj.V(x)).sum())
    return torch.func.vmap(grad)


def _em_update(x: torch.Tensor, g: torch.Tensor, xi: torch.Tensor,
               dt: float, scale) -> None:
    """The Euler–Maruyama update ``x - g dt + scale xi`` in place, in two
    kernels; ``scale`` is a number or a tensor that broadcasts over ``x``."""
    x.add_(g, alpha=-dt)
    if isinstance(scale, torch.Tensor):
        x.addcmul_(scale, xi)
    else:
        x.add_(xi, alpha=scale)


def _burn_in(run: _Blocks, buf: torch.Tensor, step, pre_steps: int,
             draw) -> None:
    """``pre_steps`` unrecorded steps in blocks of ``n_sub = len(buf)``:
    ``draw(i, n)`` fills the first ``n`` rows of ``buf`` for block ``i``;
    a partial last block takes exactly the first ``n`` rows (the JAX
    scans' ``take = i * n_sub + j < pre_steps``) and runs eagerly."""
    n_sub = buf.shape[0]
    for i in range(-(-pre_steps // n_sub)):
        n = min(n_sub, pre_steps - i * n_sub)

        def body(n=n):
            for j in range(n):
                step(buf[j])

        run.block("burn" if n == n_sub else None,
                  lambda i=i, n=n: draw(i, n), body)


def _em_scan(grad_fn, x, noise, run, step_size, scale, n_sub, n_reports,
             pre_steps, exchange=None, every=1) -> dict:
    """Euler–Maruyama on the chains ``x`` [c, d] (in place): the burn-in,
    then ``n_reports`` blocks of ``n_sub`` steps, each recording the state
    after its first step (the JAX ``_em_scan``, ``sampling.py:52-112``).

    ``scale`` is the noise scale, a number or [c, 1]. ``exchange``
    (replica exchange) is ``(draw(attempt), apply() -> moved [c])``, run
    at the start of every ``every``-th block inside its graph and recorded
    as ``"moved"``. Returns the recorder's ``{"x": [n_reports, c, d]}``."""
    buf = torch.empty((n_sub,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dt = _f32(step_size)

    def step(xi):
        _em_update(x, grad_fn(x), xi, dt, scale)

    _burn_in(run, buf, step, pre_steps,
             lambda i, n: noise.normal(buf, "burn", i))
    like = {"x": x}
    if exchange is not None:
        still = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        like["moved"] = still
    rec = _Recorder(n_reports, like)

    def block(moved):
        step(buf[0])
        rec.write("x", x)
        if moved is not None:
            rec.write("moved", moved)
        for j in range(1, n_sub):
            step(buf[j])
        rec.advance()

    for b in range(report_blocks(n_reports)):
        if exchange is not None and b % every == 0:
            def draw(b=b):
                exchange[0](b // every)
                noise.normal(buf, "main", b)

            run.block("exchange", draw, lambda: block(exchange[1]()))
        else:
            run.block("main", lambda b=b: noise.normal(buf, "main", b),
                      lambda: block(None if exchange is None else still))
        rec.end_block()
    return rec.result()


def integrate_sde_overdamped(
    pot_obj,
    n_steps: int,
    sampling_output_path: str,
    X0: Optional[np.ndarray] = None,
    pre_steps: int = 0,
    step_size: float = 0.01,
    traj_txt_filename: str = "traj.txt",
    csv_filename: str = "output.csv",
    report_interval: int = 100,
    report_interval_stdout: int = 100,
    seed: Optional[int] = None,
    n_chains: int = 1,
    verbose: bool = True,
    device=None,
):
    r"""Sample overdamped Langevin dynamics with Euler–Maruyama
    (``colvarsfinder_tpu/utils/sampling.py:115-219``).

    ``pot_obj`` has ``dim``, ``beta`` and ``V`` (optionally ``gradV``) on
    one state; a trajectory text file (rows ``t x_1 ... x_d``) and a
    Time,Energy CSV are written to ``sampling_output_path`` for each chain
    (chain c > 0 with the suffix ``_chain{c}``). The state after the update
    of step ``i`` is recorded iff ``i % report_interval == 0``, stamped
    ``i * step_size``; trailing unrecorded steps are skipped.

    Runs on ``device`` (the card unless ``'cpu'`` is asked for), each report
    block one captured CUDA graph there; a potential that is not written in
    torch runs the host numpy loop instead, with a warning.

    Returns ``(frames, energies)``: ``[n_reports, d]`` and ``[n_reports]``
    for one chain, ``[n_chains, n_reports, d]`` and ``[n_chains,
    n_reports]`` otherwise.
    """
    dim = pot_obj.dim
    sampling_beta = float(pot_obj.beta)
    dev = resolve_device(device)

    if verbose:
        print(f"writing trajectory outputs to: {sampling_output_path}")
        print(f"sampling beta={sampling_beta:.3f}, dt={step_size:.3f}\n")

    if seed is None:
        seed = np.random.randint(0, 2**31 - 1)
    noise = _make_noise(seed, dev)
    X0 = _starts(X0, noise, "x0", (n_chains, dim), dev)
    n_reports = (n_steps - 1) // report_interval + 1 if n_steps > 0 else 0

    is_torch = _is_torch_potential(pot_obj, X0[0])
    if is_torch:
        x = _chains(X0, dev)
        out = _em_scan(_grad_fn(pot_obj), x, noise, _Blocks(dev),
                       step_size, float(_noise_scale(step_size, sampling_beta)),
                       int(report_interval), int(n_reports), int(pre_steps))
        frames = np.swapaxes(out["x"], 0, 1).astype(np.float64)
    else:
        warnings.warn(
            "potential is not written in torch (its V returned no tensor); "
            "falling back to host numpy integration"
        )
        frames = _run_numpy(
            pot_obj, X0, seed, step_size, sampling_beta,
            report_interval, n_reports, pre_steps, n_steps,
        )

    times = np.arange(n_reports) * report_interval * step_size
    energies = _batched_energy(pot_obj, frames, dev, is_torch)
    _write_chains(sampling_output_path, traj_txt_filename, csv_filename,
                  frames, times, energies)

    if verbose:
        print(f"{n_reports} frames recorded per chain ({n_chains} chains)")

    if n_chains == 1:
        return frames[0], energies[0]
    return frames, energies


def _with_suffix(filename: str, suffix: str) -> str:
    if not suffix:
        return filename
    root, ext = os.path.splitext(filename)
    return f"{root}{suffix}{ext}"


def _rows(fmt: str, *cols) -> str:
    """Rows of the columns ``cols`` (arrays of one row per entry, side by
    side) through the per-row %-format ``fmt``, in one formatting call."""
    table = np.column_stack(cols)
    return (fmt * table.shape[0]) % tuple(table.ravel().tolist())


def _write_chains(path: str, traj_name: str, csv_name: str,
                  frames: np.ndarray, times: np.ndarray,
                  energies: np.ndarray) -> None:
    """Each chain's trajectory text and Time,Energy CSV, in the JAX
    package's formats: rows ``t x_1 ... x_d`` (``%.3f``, ``%.6f``), and the
    CSV as pandas' ``to_csv`` writes it (:func:`.trajectory.csv_rows`)."""
    os.makedirs(path, exist_ok=True)
    traj_fmt = "%.3f" + " %.6f" * frames.shape[2] + "\n"
    for c in range(frames.shape[0]):
        suffix = "" if c == 0 else f"_chain{c}"
        with open(os.path.join(path, _with_suffix(traj_name, suffix)),
                  "w+") as f:
            f.write(_rows(traj_fmt, times, frames[c]))
        with open(os.path.join(path, _with_suffix(csv_name, suffix)),
                  "w") as f:
            f.write("Time,Energy\n")
            f.write(csv_rows(times, energies[c]))


def _numpy_grad(pot_obj):
    """Host-side gradient for the numpy fallback: ``gradV`` if the potential
    defines it, else central finite differences on ``V`` (copied from
    ``sampling.py:244-267``)."""
    grad_fn = getattr(pot_obj, "gradV", None)
    if grad_fn is not None:
        return lambda x: np.asarray(grad_fn(x), dtype=np.float64)
    V = getattr(pot_obj, "V", None)
    if V is None:
        raise AttributeError(
            "potential defines neither gradV nor V; cannot integrate"
        )

    def fd_grad(x, eps=1e-6):
        g = np.empty_like(x)
        for i in range(x.shape[0]):
            xp, xm = x.copy(), x.copy()
            xp[i] += eps
            xm[i] -= eps
            g[i] = (float(V(xp)) - float(V(xm))) / (2 * eps)
        return g

    return fd_grad


def _run_numpy(pot_obj, X0, seed, step_size, beta, report_interval,
               n_reports, pre_steps, n_steps):
    """Host fallback replicating the reference loop semantics (copied from
    ``sampling.py:270-292``)."""
    rng = np.random.default_rng(seed)
    grad_fn = _numpy_grad(pot_obj)
    n_chains, dim = X0.shape
    frames = np.zeros((n_chains, n_reports, dim))
    noise_scale = np.sqrt(2 * step_size / beta)
    for c in range(n_chains):
        x = np.array(X0[c], dtype=np.float64)
        for _ in range(pre_steps):
            xi = rng.standard_normal(dim)
            x = x - grad_fn(x) * step_size + noise_scale * xi
        j = 0
        last_record = (n_reports - 1) * report_interval
        for i in range(last_record + 1):
            xi = rng.standard_normal(dim)
            x = x - grad_fn(x) * step_size + noise_scale * xi
            if i % report_interval == 0:
                frames[c, j] = x
                j += 1
    return frames


def _batched_energy(pot_obj, frames: np.ndarray, device,
                    is_torch: bool) -> np.ndarray:
    """``V`` of every recorded frame ``[c, n, d]`` -> ``[c, n]``: in float32
    on the device, in chunks, for a torch potential; state by state on the
    host for a numpy one (``sampling.py:295-308``)."""
    n_chains, n_reports, dim = frames.shape
    flat = frames.reshape(-1, dim)
    if not is_torch:
        vals = np.array(
            [np.asarray(pot_obj.V(x)).reshape(()) for x in flat]
        )
        return vals.reshape(n_chains, n_reports)
    energy = _energy_fn(pot_obj)
    out = np.empty(flat.shape[0], dtype=np.float64)
    with torch.no_grad():
        for lo in range(0, flat.shape[0], _EVAL_CHUNK):
            x = _chains(flat[lo:lo + _EVAL_CHUNK], device)
            out[lo:lo + x.shape[0]] = energy(x).cpu().numpy()
    return out.reshape(n_chains, n_reports)


# ---------------------------------------------------------------------------
# underdamped Langevin (BAOAB)
# ---------------------------------------------------------------------------


def _baoab_scan(grad_fn, x, v, noise, run, dt, c1, c2, inv_mass, sigma_v,
                n_sub, n_reports, pre_steps) -> dict:
    """BAOAB on the chains ``x``, ``v`` [c, d] (in place), the force at the
    end of a step reused by the next step's leading B, recording ``(x, v)``
    after the first step of each block (``sampling.py:316-382``). Returns
    ``{"x": [n_reports, c, d], "v": [n_reports, c, d]}``."""
    buf = torch.empty((n_sub,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    half_dt = _f32(np.float32(0.5) * np.float32(dt))
    c1 = _f32(c1)
    c2_sigma = _f32(c2) * sigma_v
    f = grad_fn(x).clone()

    # each substep in place, in one or two kernels
    def step(xi):
        v.addcmul_(f, inv_mass, value=-half_dt)      # B
        x.add_(v, alpha=half_dt)                     # A
        v.mul_(c1).addcmul_(c2_sigma, xi)            # O
        x.add_(v, alpha=half_dt)                     # A
        f.copy_(grad_fn(x))
        v.addcmul_(f, inv_mass, value=-half_dt)      # B

    _burn_in(run, buf, step, pre_steps,
             lambda i, n: noise.normal(buf, "burn", i))
    rec = _Recorder(n_reports, {"x": x, "v": v})

    def block():
        step(buf[0])
        rec.write("x", x)
        rec.write("v", v)
        for j in range(1, n_sub):
            step(buf[j])
        rec.advance()

    for b in range(report_blocks(n_reports)):
        run.block("main", lambda b=b: noise.normal(buf, "main", b), block)
        rec.end_block()
    return rec.result()


def integrate_sde_langevin(
    pot_obj,
    n_steps: int,
    sampling_output_path: str,
    X0: Optional[np.ndarray] = None,
    V0: Optional[np.ndarray] = None,
    friction: float = 1.0,
    masses=None,
    pre_steps: int = 0,
    step_size: float = 0.01,
    traj_txt_filename: str = "traj.txt",
    csv_filename: str = "output.csv",
    report_interval: int = 100,
    seed: Optional[int] = None,
    n_chains: int = 1,
    return_velocities: bool = False,
    verbose: bool = True,
    device=None,
):
    r"""Sample UNDERDAMPED Langevin dynamics with the BAOAB integrator
    (``colvarsfinder_tpu/utils/sampling.py:385-534``):

    .. math::
        dx = v\,dt,\qquad
        m\,dv = -\nabla V(x)\,dt - \gamma m v\,dt
                + \sqrt{2\gamma m/\beta}\,dW

    with the exact OU substep :math:`c_1 = e^{-\gamma dt}`,
    :math:`c_2 = \sqrt{1 - c_1^2}`. Contract and outputs as
    :func:`integrate_sde_overdamped`.

    Args:
        friction: :math:`\gamma` in 1/time units.
        masses: scalar or per-dimension [d] masses (default 1).
        V0: initial velocities [d] or [n_chains, d]; default drawn from the
            Maxwell–Boltzmann distribution at ``pot_obj.beta``.
        return_velocities: also return recorded velocities.

    Returns:
        ``(frames, energies)`` or ``(frames, energies, velocities)``.
    """
    dim = pot_obj.dim
    sampling_beta = float(pot_obj.beta)
    dev = resolve_device(device)

    if verbose:
        print(f"writing trajectory outputs to: {sampling_output_path}")
        print(
            f"sampling beta={sampling_beta:.3f}, dt={step_size:.3f}, "
            f"friction={friction:.3f} (BAOAB)\n"
        )

    if seed is None:
        seed = np.random.randint(0, 2**31 - 1)
    noise = _make_noise(seed, dev)

    mass = np.broadcast_to(
        np.asarray(1.0 if masses is None else masses, dtype=np.float64),
        (dim,),
    )
    inv_mass = 1.0 / mass
    sigma_v = np.sqrt(1.0 / (sampling_beta * mass))
    c1 = float(np.exp(-friction * step_size))
    c2 = float(np.sqrt(1.0 - c1 * c1))

    X0 = _starts(X0, noise, "x0", (n_chains, dim), dev)
    if V0 is None:
        V0 = _starts(None, noise, "v0", (n_chains, dim), dev) * sigma_v
    else:
        V0 = np.broadcast_to(np.asarray(V0, dtype=np.float64), (n_chains, dim))

    n_reports = (n_steps - 1) // report_interval + 1 if n_steps > 0 else 0

    is_torch = _is_torch_potential(pot_obj, X0[0])
    if is_torch:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        out = _baoab_scan(
            _grad_fn(pot_obj), _chains(X0, dev), _chains(V0, dev), noise,
            _Blocks(dev), step_size, c1, c2, f32(inv_mass),
            f32(sigma_v), int(report_interval), int(n_reports),
            int(pre_steps),
        )
        frames = np.swapaxes(out["x"], 0, 1).astype(np.float64)
        vels = np.swapaxes(out["v"], 0, 1).astype(np.float64)
    else:
        warnings.warn(
            "potential is not written in torch (its V returned no tensor); "
            "falling back to host numpy integration"
        )
        frames, vels = _run_numpy_baoab(
            pot_obj, X0, V0, seed, step_size, c1, c2, inv_mass, sigma_v,
            report_interval, n_reports, pre_steps,
        )

    times = np.arange(n_reports) * report_interval * step_size
    energies = _batched_energy(pot_obj, frames, dev, is_torch)
    _write_chains(sampling_output_path, traj_txt_filename, csv_filename,
                  frames, times, energies)

    if verbose:
        print(f"{n_reports} frames recorded per chain ({n_chains} chains)")

    if n_chains == 1:
        frames, energies, vels = frames[0], energies[0], vels[0]
    if return_velocities:
        return frames, energies, vels
    return frames, energies


def _run_numpy_baoab(pot_obj, X0, V0, seed, dt, c1, c2, inv_mass, sigma_v,
                     report_interval, n_reports, pre_steps):
    """Host fallback with the same BAOAB stepping and recording points
    (copied from ``sampling.py:537-570``)."""
    rng = np.random.default_rng(seed)
    grad_fn = _numpy_grad(pot_obj)
    n_chains, dim = X0.shape
    frames = np.zeros((n_chains, n_reports, dim))
    vels = np.zeros((n_chains, n_reports, dim))
    half_dt = 0.5 * dt
    for c in range(n_chains):
        x = np.array(X0[c], dtype=np.float64)
        v = np.array(V0[c], dtype=np.float64)
        f = grad_fn(x)

        def step(x, v, f):
            v = v - half_dt * f * inv_mass
            x = x + half_dt * v
            v = c1 * v + c2 * sigma_v * rng.standard_normal(dim)
            x = x + half_dt * v
            f = grad_fn(x)
            v = v - half_dt * f * inv_mass
            return x, v, f

        for _ in range(pre_steps):
            x, v, f = step(x, v, f)
        j = 0
        last_record = (n_reports - 1) * report_interval
        for i in range(last_record + 1):
            x, v, f = step(x, v, f)
            if i % report_interval == 0:
                frames[c, j] = x
                vels[c, j] = v
                j += 1
    return frames, vels


def integrate_md_langevin(
    pdb,
    system,
    integrator,
    n_steps: int,
    sampling_output_path: str,
    pre_steps: int = 0,
    traj_dcd_filename: str = "traj.dcd",
    csv_filename: str = "output.csv",
    report_interval: int = 100,
    report_interval_stdout: int = 100,
    plumed_script: Optional[str] = None,
    verbose: bool = True,
):
    r"""Generate MD trajectory data by running Langevin dynamics in OpenMM
    (copied from ``colvarsfinder_tpu/utils/sampling.py:573-665``).

    MD integration is sequential engine work on the host (OpenMM's own
    engine); the products, a DCD trajectory and a statistics CSV under
    ``sampling_output_path``, feed training through
    :class:`WeightedTrajectory` / :func:`calc_weights`.

    Pipeline: [optional PLUMED bias] -> energy minimization ->
    ``pre_steps`` of un-recorded equilibration -> ``n_steps`` of production
    with a DCD reporter (every ``report_interval`` steps), a CSV reporter
    recording time/potential/total energy/temperature (needed downstream by
    ``calc_weights``), and a stdout progress reporter.

    Returns ``(dcd_path, csv_path, elapsed_seconds)``.
    """
    try:
        import openmm.app as mm_app
    except ImportError as e:  # pragma: no cover - depends on environment
        raise ImportError(
            "integrate_md_langevin requires OpenMM "
            "(pip install openmm); for SDE systems use "
            "integrate_sde_overdamped instead"
        ) from e
    import sys

    os.makedirs(sampling_output_path, exist_ok=True)
    dcd_path = os.path.join(sampling_output_path, traj_dcd_filename)
    csv_path = os.path.join(sampling_output_path, csv_filename)

    if plumed_script is not None:
        # bias the dynamics with a PLUMED script (optional plugin)
        from openmmplumed import PlumedForce

        system.addForce(PlumedForce(plumed_script))
        if verbose:
            print(f"PLUMED bias enabled:\n{plumed_script}", flush=True)

    simulation = mm_app.Simulation(pdb.topology, system, integrator)
    simulation.context.setPositions(pdb.positions)
    if verbose:
        name = simulation.context.getPlatform().getName()
        print(f"OpenMM platform: {name}", flush=True)
        print("minimizing energy...", flush=True)

    simulation.minimizeEnergy()

    if pre_steps > 0:
        if verbose:
            print(f"equilibrating for {pre_steps} steps...", flush=True)
        simulation.step(pre_steps)

    # reporters attach only for the production phase, so equilibration
    # frames never reach the trajectory file
    simulation.reporters = [
        mm_app.DCDReporter(dcd_path, report_interval),
        mm_app.StateDataReporter(
            csv_path, report_interval, time=True,
            potentialEnergy=True, totalEnergy=True, temperature=True,
        ),
        mm_app.StateDataReporter(
            sys.stdout, report_interval_stdout, step=True,
            temperature=True, elapsedTime=True,
        ),
    ]

    if verbose:
        print(f"production run: {n_steps} steps...", flush=True)
    t0 = time.time()
    simulation.step(n_steps)
    elapsed = time.time() - t0
    if verbose:
        print(
            f"done in {elapsed:.1f} s; trajectory -> {dcd_path}, "
            f"statistics -> {csv_path}",
            flush=True,
        )
    return dcd_path, csv_path, elapsed
