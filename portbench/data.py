"""Seeded inputs of a run, made on the run's device from ``--seed``: the
frames and their weights (by the configuration's recipe), the train/test
split and the initial parameters of the heads. The same seed gives the same
inputs; the program and the reference are handed the same arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: frames per block of the AR(1) recurrence (one matrix product per block,
#: then one recurrence over the blocks' last frames)
AR_BLOCK = 1024


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def ar1(eps: torch.Tensor, phi: torch.Tensor, start: torch.Tensor):
    """z_t = phi z_{t-1} + sqrt(1 - phi^2) eps_t per column of ``eps`` [n,
    c], from z_{-1} = ``start`` [c]: stationary with unit variance when
    ``start`` and ``eps`` are. Within a block of AR_BLOCK frames the sums
    are one batched product with the powers of phi; the blocks' carries
    are a recurrence over the blocks, in float64 on the host."""
    n, c = eps.shape
    L = AR_BLOCK
    nb = -(-n // L)
    e = torch.zeros(nb * L, c, dtype=eps.dtype, device=eps.device)
    e[:n] = eps * torch.sqrt(1.0 - phi * phi)
    j = torch.arange(L, device=eps.device, dtype=eps.dtype)
    lag = j[:, None] - j[None, :]  # [L, L], row t, column s
    powers = phi[:, None, None] ** lag.clamp(min=0)  # [c, L, L]
    powers = powers * (lag >= 0)
    local = torch.einsum("cts,bsc->btc", powers, e.view(nb, L, c))
    carry_in = np.empty((nb, c))
    phi_l = (phi.double() ** L).cpu().numpy()
    last = local[:, -1].double().cpu().numpy()
    z = start.double().cpu().numpy()
    for b in range(nb):
        carry_in[b] = z
        z = phi_l * z + last[b]
    grow = phi[None, :] ** (j[:, None] + 1)  # [L, c]
    carry = torch.as_tensor(carry_in, dtype=eps.dtype, device=eps.device)
    out = local + grow[None] * carry[:, None, :]
    return out.reshape(nb * L, c)[:n]


def ar_frames(p: dict, n_atoms: int, g: torch.Generator, device):
    """``(ref [N, 3], frames [n, N, 3], weights [n])`` in float32 on
    ``device``: frames ``ref + noise * z`` with each of the 3 N coordinates
    of z an AR(1) process whose correlation time (in frames) is drawn
    log-uniform in ``tau_frames``; weights uniform in ``weights``."""
    n, c = int(p["n_frames"]), 3 * n_atoms
    f32 = dict(dtype=torch.float32, device=device)
    ref = torch.randn(n_atoms, 3, generator=g, **f32)
    lo, hi = (math.log(t) for t in p["tau_frames"])
    tau = torch.exp(torch.empty(c, **f32).uniform_(lo, hi, generator=g))
    phi = torch.exp(-1.0 / tau)
    start = torch.randn(c, generator=g, **f32)
    eps = torch.randn(n, c, generator=g, **f32)
    z = ar1(eps, phi, start)
    frames = ref[None] + p["noise"] * z.view(n, n_atoms, 3)
    weights = torch.empty(n, **f32).uniform_(*p["weights"], generator=g)
    return ref, frames, weights


RECIPES = {"ar_frames": ar_frames}


def split(n_pairs: int, test_ratio: float, g: torch.Generator, device):
    """``(train, test)`` start indices: a seeded permutation of the lagged
    pairs' starts, the first ``ceil(test_ratio n)`` of it the test set (the
    rule of scikit-learn's ShuffleSplit)."""
    perm = torch.randperm(n_pairs, generator=g, device=device).cpu().numpy()
    n_test = math.ceil(test_ratio * n_pairs)
    return perm[n_test:].astype(np.int64), perm[:n_test].astype(np.int64)


def head_params(dims, k: int, replicas: int, g: torch.Generator, device):
    """Initial parameters of ``replicas`` stacks of k heads, one call per
    tensor: per layer weight [R, k, d_out, d_in] and bias [R, k, d_out],
    uniform in +-1/sqrt(d_in) (torch.nn.Linear's rule), float32."""
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        b = 1.0 / math.sqrt(d_in)
        f32 = dict(dtype=torch.float32, device=device)
        w = torch.empty(replicas, k, d_out, d_in, **f32).uniform_(
            -b, b, generator=g)
        bias = torch.empty(replicas, k, d_out, **f32).uniform_(
            -b, b, generator=g)
        out.append((w, bias))
    return out


class Inputs:
    """Everything a run is handed, made from one seed in one order."""

    def __init__(self, cfg: dict, seed: int, device, replicas: int = 1):
        g = generator(seed, device)
        p = cfg["data"]
        self.ref, frames, weights = RECIPES[p["recipe"]](
            p, cfg["n_atoms"], g, device)
        self.params = head_params(cfg["layer_dims"], cfg["k"], replicas, g,
                                  device)
        n_pairs = int(p["n_frames"]) - int(cfg["lag"])
        self.train_idx, self.test_idx = split(n_pairs, cfg["test_ratio"], g,
                                              device)
        # the program takes host arrays (WeightedTrajectory)
        self.frames = frames.cpu().numpy()
        self.weights = weights.cpu().numpy()
        self.ref_np = self.ref.cpu().numpy()

    def replica_params(self, r: int):
        """Replica r's per-layer (weight [k, o, i], bias [k, o])."""
        return [(w[r], b[r]) for w, b in self.params]
