#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. the card's name and power limit, the torch and CUDA versions, and the
   build of the CUDA kernels from ``colvarsfinder_tpu_torch/csrc``;
2. kernels K1-K4 against their plain PyTorch versions on the card, at the
   main path's shapes (B = 20,000 frames of 10 atoms, dims [30,20,20,20,1],
   k = 2), at a ragged B = 37 and at one sample past a multiple of K3's and
   K4's tiles (there with a seeded cotangent, see EDGE_B; it is one frame
   past a multiple of K1's tile too); K4 takes the head outputs Y that K3
   returns, Y is held against the plain head outputs, and K3/K4 must repeat
   bit for bit; K2 also on frames of the dipeptide's 22 atoms with 10
   unsorted align indices; K1 also on a view 4 bytes into its buffer, a zero
   frame (exactly the identity) and frames with two nearly equal singular
   values;
3. each kernel's device time (CUDA events, median of 21 batches of
   back-to-back calls queued behind a device sleep) beside its bound
   (the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s) and
   its plain version's device time (the summed durations of its kernels
   under torch.profiler); K1, K2 and K3 beside their times before their
   redesigns, K3 + K4 beside their time before K3's, K2's direct variant
   (one thread per frame) at the same shapes, and the launch shape and
   resident blocks and warps per SM of K1, K2, K3 and K4;
4. transfer-operator EigenFunctionTask training on data shaped like the
   repo's headline benchmark (120,000 frames, 10 atoms, lag 5, batch
   20,000, seed 0) with FusedAlignmentLayer and fused_step=True (K2, K3,
   K4), held against the plain-PyTorch step with AlignmentLayer
   (method='quaternion') on the card; then a short run through
   AlignmentLayer(method='cuda') (K1) with non-uniform align weights, held
   against the same run with method='quaternion'; the plain run saves its
   model, and
   the TorchScript CV it writes (``latest/scripted_cv_cpu.pt``) must load on
   the CPU and agree with the trained CV model. Every run trains through
   the captured epoch (a CUDA graph per epoch, replayed); the fused run is
   repeated with every epoch forced eager and must agree bit for bit;
5. steady-state training throughput of both steps, and over two more
   epochs of each under torch.profiler: wall and device time, device
   activities per step, the device's busy share and the graph replays
   (``cudaGraphLaunch`` calls) per epoch;
6. the Dirichlet form on phase 4's frames through FusedAlignmentLayer:
   the generator EigenFunctionTask (lag 0, beta 1, a seeded non-uniform
   diag_coeff) on the Gram path, on the vjp path (K2's forward, its
   backward differentiated twice) and with the Gram matrices in bfloat16,
   and the CommittorTask (``create_sequential_nn``, regions below the 5%
   and above the 95% quantile of the first aligned coordinate) on the Gram
   and vjp paths; each run through the captured epoch and again eagerly,
   bit for bit; vjp against Gram within the training bar, bf16 against
   float32 Gram within 2e-2; the generator loss's parameter gradient
   through K2 at the main path's batch against the plain layer's within
   K4's bar; samples/s, the Gram precompute's time and bytes, K1 and K2
   launches per batch, and device time and activities per step under
   torch.profiler;
7. the autoencoders on phase 4's frames at BASELINE config 3's widths and
   rate (encoder [30,30,30,2], decoder [2,30,30,30], lr 0.002), through
   FusedAlignmentLayer: the AutoEncoderTask (its features once, one K2
   launch, at construction), held against the same run through
   AlignmentLayer(method='quaternion'), whose saved TorchScript CV must
   load on the CPU and agree, and its features once more through K1
   (weighted alignment) against method='quaternion'; the
   RegAutoEncoderTask with all six terms (heads [2,20,20,1], K = 2, lag 5
   for both the reconstruction and the transfer regularizer), the
   generator regularizer on the Gram path and on the vjp path, and three
   epochs with the encoder frozen, whose bits must not change. Every run
   against its eager twin bit for bit. The transfer RegAE against the
   plain layer within the training bar while their sorts of the heads
   agree, and vjp against Gram, each over all 30 epochs within the drift
   bar of two plain versions (scripts/regae_drift.py) and step by step
   from the same parameters (vjp against Gram in float64). Samples/s, K2
   launches per batch, and device time and activities per step under
   torch.profiler.

The second-to-last line lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# the main path's workload (the shape of the repo's bench.py)
N_ATOMS, K, DIMS = 10, 2, (30, 20, 20, 20, 1)
N_FRAMES, LAG, DT, BATCH = 120_000, 5, 0.002, 20_000
ALPHA, EIG_W, LR, TEST_RATIO = 20.0, [1.0, 0.2], 0.002, 0.001
EPOCHS, K1_EPOCHS = 30, 2
RAGGED_B = 37
# one sample past a multiple of K4's 64-sample tile, and of K3's 64- or
# 32-sample tile
EDGE_B = 4 * 64 + 1
# K3, and K3 + K4, before K3's redesign; K2 and K1 before theirs (PERF.md,
# same card model)
K3_BEFORE_US = 148.92
K3_K4_BEFORE_US = 216.22
K2_BEFORE_US = 18.60
K1_BEFORE_US = 5.25
# per-atom align weights of the K1 run (masses of 1 to 16, seeded)
ALIGN_WEIGHTS = np.random.default_rng(1).uniform(1.0, 16.0, N_ATOMS)
# K2 on the dipeptide's atoms (examples/dipeptide/top.gro)
DIPEPTIDE_ATOMS, DIPEPTIDE_ALIGN = 22, 10

# H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the CPU tests' tolerances, kernel against plain version
TOL = {
    "kabsch_qcp": dict(atol=2e-5, rtol=0.0),
    "fused_align": dict(atol=2e-4, rtol=0.0),
    "stats_fwd": dict(atol=1e-4, rtol=5e-6),
    "stats_bwd": dict(atol=1e-3, rtol=2e-3),
}
# K3's head outputs against the plain heads: f32 FMA chains against
# cuBLAS (ten times the CPU tests' model-forward bar)
Y_TOL = dict(atol=1e-5, rtol=0.0)
# fused step against plain step over the training curves (the JAX
# package's fused-vs-plain bar)
CURVE_RTOL = {"loss": 2e-3, "eig_1": 5e-3}
# the saved TorchScript CV on the CPU against the trained CV model
# (tests/test_torch_deploy.py's bar)
SCRIPTED_ATOL = 2e-6
# phase 6: the generator's beta and diffusion diagonal (seeded, over the
# 30 flattened coordinates), the committor's regions (quantiles of the first
# aligned coordinate), and the bar of bf16 Gram storage against float32
# (tests/test_gram_dtype.py)
GEN_BETA = 1.0
GEN_DIAG = np.random.default_rng(2).uniform(0.5, 2.0, 3 * N_ATOMS)
COMMITTOR_Q = (0.05, 0.95)
BF16_RTOL = 2e-2
# phase 7: BASELINE config 3's widths and rate (benchmarks/run_baselines.py:
# 55,304), heads at the main path's hidden width, the all-six-terms settings
# of benchmarks/parity_step.py:295-297, lag 5 for both lagged terms
AE_DIMS = ([3 * N_ATOMS, 30, 30, 2], [2, 30, 30, 3 * N_ATOMS])
AE_REG_DIMS, AE_LR = [2, 20, 20, 1], 0.002
REG_TERMS = dict(eig_weights=[1.0, 0.5], alpha=1.0, gamma=[0.7, 3.0],
                 eta=[0.05, 0.1, 0.2], beta=1.0)
FREEZE_EPOCHS = 3
# phase 7's RegAE pairs over all 30 epochs. On these frames (i.i.d. noise,
# no slow mode) the heads keep near-zero variance and their sort flips, so
# two correct float32 versions of one RegAE run part further than the
# training bar. scripts/regae_drift.py trains two plain versions of each
# configuration (AlignmentLayer method='svd' against 'quaternion', model
# seeds 0-2) on the card; the largest gaps it read (H100 80GB HBM3, 700 W):
# transfer loss 2.108e-2, eig 2.710e-4; generator loss 9.125e-2, eig
# 3.672e-2. The bar is twice that, rounded up to one digit, and never
# below the training bar
DRIFT_RTOL = {"transfer": {"loss": 5e-2, "eig": 5e-3},
              "generator": {"loss": 2e-1, "eig": 8e-2}}
# the vjp and Gram steps of the RegAE's generator regularizer against each
# other in float64: on these frames the step amplifies rounding ~6e4-fold
# (float32 gradients sit ~3.6e-3 of their scale from float64's), so
# float64's 1.1e-16 becomes ~7e-12; 1e-9 leaves two orders of margin
F64_STEP_RTOL = 1e-9

KERNELS = {
    "kabsch_qcp": ("colvarsfinder_tpu_torch/csrc/kabsch.cu",
                   "colvarsfinder_tpu/ops/kabsch_pallas.py:48"),
    "fused_align": ("colvarsfinder_tpu_torch/csrc/kabsch.cu",
                    "colvarsfinder_tpu/ops/kabsch_pallas.py:140"),
    "stats_fwd": ("colvarsfinder_tpu_torch/csrc/fused_eigen.cu",
                  "colvarsfinder_tpu/ops/fused_eigen.py:146"),
    "stats_bwd": ("colvarsfinder_tpu_torch/csrc/fused_eigen.cu",
                  "colvarsfinder_tpu/ops/fused_eigen.py:230"),
}


def log(*a):
    print(*a, flush=True)


def make_data(seed=0):
    """Frames of a perturbed reference and non-uniform weights (the data
    of bench.py's make_data)."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((N_ATOMS, 3)).astype(np.float32)
    traj = (ref[None] + 0.3 * rng.standard_normal((N_FRAMES, N_ATOMS, 3))
            ).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, N_FRAMES).astype(np.float32)
    weights /= weights.mean()
    return ref, traj, weights


def device_ms(fn, calls=20, batches=21):
    """Device time of one call: ``calls`` back-to-back calls queued behind
    a device sleep (so host launch overhead does not show), timed with CUDA
    events; median over ``batches``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * (1.5 * host_s * calls + 2e-3))
    per = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / calls)
    return statistics.median(per)


def device_activities(prof):
    """Device activities of a torch.profiler run, summed per name, without
    the ranges that annotate them (a range such as Optimizer.step#Adam.step
    is also reported on the device's timeline, under the name of its
    host-side range, and spans the gaps between its kernels)."""
    events = prof.key_averages()
    ranges = {e.key for e in events if e.is_user_annotation}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.key not in ranges]


def busy_ms(fn, calls=5):
    """Device time of one call as the summed durations of its device
    activities under torch.profiler, mean over ``calls`` calls. For a plain
    version of hundreds of small kernels: more launches than the launch
    queue holds behind a device sleep, so CUDA events around it would time
    the host's enqueue as well."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in device_activities(prof))
    return busy_us / calls * 1e-3


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    if isinstance(a, (list, tuple)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a - b).abs().max())


def check_close(name, got, want):
    if isinstance(got, (list, tuple)):
        for g, w in zip(got, want):
            check_close(name, g, w)
        return
    torch.testing.assert_close(got, want, **TOL[name])


def near_degenerate_covariances(n, seed=7):
    """Covariances U diag(s) V^T with det > 0 and two singular values
    nearly or exactly equal (f32 QCP solves them to ~6e-7)."""
    rng = np.random.default_rng(seed)
    svals = [(1.0, 1.0 - e, 0.3) for e in (1e-2, 1e-4, 1e-6, 0.0)]
    svals += [(1.0, 0.5, 0.5 - e) for e in (1e-2, 1e-4, 1e-6, 0.0)]
    s = np.asarray(svals)[rng.integers(len(svals), size=n)]
    U, V = (np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
            for _ in range(2))
    U[:, :, 0] *= np.sign(np.linalg.det(U))[:, None]
    V[:, :, 0] *= np.sign(np.linalg.det(V))[:, None]
    return np.einsum("bij,bj,bkj->bik", U, s, V).astype(np.float32)


def k1_cases(C, dev):
    """K1 against its plain version beyond the main path's shapes: a view 4
    bytes into its buffer, a zero frame, near-degenerate frames."""
    from colvarsfinder_tpu_torch.ops.alignment import kabsch_rotations_quat
    from colvarsfinder_tpu_torch.ops.kabsch_cuda import kabsch_qcp_launch

    buf = torch.empty(C.numel() + 1, device=dev)
    view = buf[1:].view(C.shape)
    view.copy_(C)
    zero = C[:EDGE_B].clone()
    zero[0] = 0.0
    near = torch.from_numpy(near_degenerate_covariances(4096)).to(dev)
    for what, Ck in ((f"a view at {view.data_ptr() % 16} bytes past 16-byte "
                      "alignment", view),
                     ("a zero frame", zero),
                     ("near-degenerate frames", near)):
        got, want = kabsch_qcp_launch(Ck), kabsch_rotations_quat(Ck)
        torch.cuda.synchronize()
        check_close("kabsch_qcp", got, want)
        log(f"  kabsch_qcp   B={Ck.shape[0]:6d}, {what}: max |kernel - "
            f"plain| = {max_err(got, want):.3e} (tolerance "
            f"{TOL['kabsch_qcp']})")
        if Ck is zero and not torch.equal(got[0], torch.eye(3, device=dev)):
            raise AssertionError("K1: a zero frame is not exactly the identity")


def phase_kernels(ref_np, traj, weights, dev, cvf):
    """Phases 2 and 3: every kernel against its plain version, and timed."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.ops.alignment import (
        align_frames,
        kabsch_rotations_quat,
    )
    from colvarsfinder_tpu_torch.ops.fused_eigen import (
        _mlp_heads,
        _n_params,
        bwd_launch_shape,
        bwd_resident_blocks,
        eigen_loss_from_stats,
        flatten_params,
        fwd_launch_shape,
        fwd_resident_blocks,
        params_t_of,
        stats_bwd_launch,
        stats_fwd_launch,
        stats_layout,
        transfer_stats_reference,
        unflatten_grads,
    )
    from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
        KABSCH_TILE,
        AlignShape,
        align_launch_shape,
        align_resident_blocks,
        fused_align_launch,
        kabsch_qcp_launch,
        kabsch_resident_blocks,
    )

    ref = torch.from_numpy(ref_np - ref_np.mean(0)).to(dev)
    idx64 = torch.arange(N_ATOMS, device=dev)
    idx32 = idx64.to(torch.int32)
    model = cvf.EigenFunctions(DIMS, K, seed=0, device=dev)
    pt = params_t_of(model)
    flat = flatten_params(pt).detach().contiguous()
    params = list(model.parameters())
    n_stats, _ = stats_layout(K)
    results = {}

    bwd = bwd_launch_shape(DIMS, K)
    if EDGE_B % KABSCH_TILE != 1:
        raise AssertionError("EDGE_B is not one past a multiple of K1's tile")
    for B in (BATCH, RAGGED_B, EDGE_B):
        main = B == BATCH
        X = traj[:B].to(dev)
        Xl = traj[LAG:LAG + B].to(dev)
        w = weights[:B].to(dev)
        wl = weights[LAG:LAG + B].to(dev)
        sel_c = X - X.mean(1, keepdim=True)
        C = torch.einsum("bmi,mj->bij", sel_c, ref).contiguous()
        F = align_frames(X, ref, idx64).reshape(B, -1).contiguous()
        Fl = align_frames(Xl, ref, idx64).reshape(B, -1).contiguous()

        stats = transfer_stats_reference(pt, F, Fl, w, wl).detach()
        stats.requires_grad_()
        loss, _ = eigen_loss_from_stats(
            stats, k=K, alpha=ALPHA, eig_w=EIG_W, lag_idx=LAG, traj_dt=DT,
            sort_eigvals=True,
        )
        (d_stats,) = torch.autograd.grad(loss, stats)
        if B == EDGE_B:
            # a seeded unit-scale cotangent: the loss's own at a few hundred
            # samples is ~1e3 per stat, and the loss is invariant to a shift
            # of a head's output, so the output-bias gradient is a residue
            # of ~1e5-sized terms that neither f32 version resolves
            gen = torch.Generator().manual_seed(B)
            d_stats = torch.randn(n_stats, generator=gen).to(dev)
        d_stats = d_stats.contiguous()

        def k4_plain():
            s = transfer_stats_reference(pt, F, Fl, w, wl)
            return torch.autograd.grad(s, params, d_stats)

        _, Y = stats_fwd_launch(flat, F, Fl, w, wl, DIMS, K)
        with torch.no_grad():
            Y_plain = torch.stack([_mlp_heads(pt, F).T, _mlp_heads(pt, Fl).T])
        torch.testing.assert_close(Y, Y_plain, **Y_TOL)
        log(f"  K3 head outputs B={B:6d}: max |Y - plain| = "
            f"{max_err(Y, Y_plain):.3e} (tolerance {Y_TOL})")

        def k4_kernel():
            return stats_bwd_launch(flat, F, Fl, w, wl, Y, d_stats, DIMS, K)

        def k4_unflat(g):
            out = []
            for (gw, gb) in unflatten_grads(g, pt):
                out += [gw.transpose(1, 2), gb]
            # the order of model.parameters(): weights, then biases
            return out[0::2] + out[1::2]

        cases = {
            "kabsch_qcp": (lambda: kabsch_qcp_launch(C),
                           lambda: kabsch_rotations_quat(C)),
            "fused_align": (lambda: fused_align_launch(X, ref, idx32),
                            lambda: align_frames(X, ref, idx64,
                                                 method="quaternion")),
            "stats_fwd": (lambda: stats_fwd_launch(flat, F, Fl, w, wl, DIMS,
                                                   K)[0],
                          lambda: transfer_stats_reference(pt, F, Fl, w, wl)
                          .detach()),
            "stats_bwd": (lambda: k4_unflat(k4_kernel()),
                          lambda: list(k4_plain())),
        }
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check_close(name, got, want)
            if name in ("stats_fwd", "stats_bwd"):
                again = kern()
                torch.cuda.synchronize()
                for a, b in zip(got if isinstance(got, list) else [got],
                                again if isinstance(again, list) else [again]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name}: two calls differ")
            err = max_err(got, want)
            log(f"  {name:12s} B={B:6d}: max |kernel - plain| = {err:.3e} "
                f"(tolerance {TOL[name]})")
            if main:
                results[name] = {"max_abs_err": err}

        if not main:
            continue
        C_main = C
        direct_us = device_ms(lambda: fused_align_launch(
            X, ref, idx32, AlignShape(0, 256, 0))) * 1e3
        # phase 3: device time beside the bound, at the main path's shapes
        hid = sum(DIMS[1:-1])
        fma = sum(a * b for a, b in zip(DIMS[:-1], DIMS[1:]))
        fma_deep = sum(a * b for a, b in zip(DIMS[1:-1], DIMS[2:]))
        work = {
            # C in, R out; Horn coefficients + 16 Newton steps + adjugate
            "kabsch_qcp": (2 * B * 9 * 4, B * (16 * 12 + 450)),
            # frames in and out (+ reference, indices); covariance, QCP,
            # rotation of N atoms
            "fused_align": (2 * B * N_ATOMS * 3 * 4 + 16 * N_ATOMS,
                            B * (21 * N_ATOMS + 16 * 12 + 450)),
            # F, F_l, w, w_l in, stats and Y [2, k, B] out; 2 flops per
            # multiply-add of both passes through k heads
            "stats_fwd": (2 * B * (DIMS[0] + 1) * 4 + 2 * K * B * 4
                          + (_n_params(DIMS, K) + n_stats) * 4,
                          2 * 2 * B * K * fma),
            # the same inputs + Y + d_stats in, gradients out; forward,
            # the hidden-layer input cotangents and the weight gradients
            "stats_bwd": (2 * B * (DIMS[0] + 1) * 4 + 2 * K * B * 4
                          + (2 * _n_params(DIMS, K) + n_stats) * 4,
                          2 * 2 * B * K * (2 * fma + fma_deep)),
        }
        log(f"  (tanh evaluations per K3 call: {2 * B * K * hid}; not in the "
            "flop count)")
        for name, (kern, plain) in cases.items():
            ms = device_ms(kern)
            plain_ms = busy_ms(plain)
            plain_events_ms = device_ms(plain, calls=3)
            bound_ms, bound_by = bound(*work[name])
            results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None)
            log(f"  {name:12s} {ms * 1e3:9.2f} us  plain {plain_ms * 1e3:9.2f}"
                f" us (CUDA events: {plain_events_ms * 1e3:.2f} us)  bound "
                f"{bound_ms * 1e3:7.3f} us ({bound_by}: "
                f"{work[name][0] / 1e6:.2f} MB, {work[name][1] / 1e6:.1f} "
                "MFLOP)")
    # K2 on frames of the dipeptide's atoms, align indices unsorted
    rng = np.random.default_rng(DIPEPTIDE_ATOMS)
    base = rng.standard_normal((DIPEPTIDE_ATOMS, 3))
    x22 = torch.from_numpy((base + 0.3 * rng.standard_normal(
        (BATCH, DIPEPTIDE_ATOMS, 3))).astype(np.float32)).to(dev)
    i22_np = rng.permutation(DIPEPTIDE_ATOMS)[:DIPEPTIDE_ALIGN]
    i22 = torch.from_numpy(i22_np).to(dev)
    r22 = torch.from_numpy((base[i22_np] - base[i22_np].mean(0))
                           .astype(np.float32)).to(dev)
    got = fused_align_launch(x22, r22, i22.to(torch.int32))
    want = align_frames(x22, r22, i22, method="quaternion")
    torch.cuda.synchronize()
    check_close("fused_align", got, want)
    log(f"  fused_align  B={BATCH:6d}, {DIPEPTIDE_ATOMS} atoms, align "
        f"indices {i22.tolist()}: max |kernel - plain| = "
        f"{max_err(got, want):.3e} (tolerance {TOL['fused_align']})")
    k1_cases(C_main, dev)

    k1 = results["kabsch_qcp"]["ms"] * 1e3
    log(f"  K1 {k1:.2f} us (before its redesign: {K1_BEFORE_US} us)")
    k2 = results["fused_align"]["ms"] * 1e3
    k3 = results["stats_fwd"]["ms"] * 1e3
    k3_k4 = k3 + results["stats_bwd"]["ms"] * 1e3
    log(f"  K2 {k2:.2f} us (before its redesign: {K2_BEFORE_US} us; its "
        f"direct variant in this run: {direct_us:.2f} us)")
    log(f"  K3 {k3:.2f} us (before its redesign: {K3_BEFORE_US} us); K3 + K4 "
        f"{k3_k4:.2f} us (before: {K3_K4_BEFORE_US} us)")
    k1_res = kabsch_resident_blocks()
    log(f"  K1 launch: tile {KABSCH_TILE} frames, {KABSCH_TILE} threads, "
        f"{36 * KABSCH_TILE} B shared memory per block, "
        f"{-(-BATCH // KABSCH_TILE)} blocks; resident per SM {k1_res} blocks "
        f"= {k1_res * -(-KABSCH_TILE // 32)} warps "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    k2_shape = align_launch_shape(N_ATOMS, N_ATOMS)
    k2_res = align_resident_blocks(k2_shape)
    log(f"  K2 launch: tile {k2_shape.tile} frames, {k2_shape.threads} "
        f"threads, {k2_shape.smem_bytes} B shared memory per block, "
        f"{k2_shape.blocks(BATCH)} blocks; resident per SM {k2_res} blocks "
        f"= {k2_res * k2_shape.threads // 32} warps "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    for name, shape, per, resident in (
        ("K3", fwd_launch_shape(DIMS, K), "", fwd_resident_blocks(DIMS, K)),
        ("K4", bwd, f" x {K} heads", bwd_resident_blocks(DIMS, K)),
    ):
        log(f"  {name} launch: tile {shape.tile} samples{per}, "
            f"{shape.threads} threads, {shape.smem_bytes} B shared memory "
            f"per block; resident per SM {resident} blocks = "
            f"{resident * shape.threads // 32} warps "
            "(cudaOccupancyMaxActiveBlocksPerMultiprocessor; "
            f"{shape.blocks_per_sm} blocks = {shape.warps_per_sm} warps by "
            "the SM's limits at the 80-register cap)")
    _cuda.reset_launch_counts()
    return results


def make_task(cvf, traj_obj, ref, path, fused, method, epochs,
              save_every=0, align_weights=None):
    if method == "fused":
        align = cvf.FusedAlignmentLayer(ref, list(range(N_ATOMS)))
    else:
        align = cvf.AlignmentLayer(ref, list(range(N_ATOMS)), method=method,
                                   align_weights=align_weights)
    pp = cvf.PreprocessingANN(
        align,
        cvf.FeatureLayer([cvf.Feature("p", "position",
                                      list(range(N_ATOMS)))]),
    )
    return cvf.EigenFunctionTask(
        traj_obj, pp, cvf.EigenFunctions(list(DIMS), K, seed=0), path,
        alpha=ALPHA, eig_weights=EIG_W, lag_tau=LAG * DT,
        learning_rate=LR, save_model_every_step=save_every, k=K,
        batch_size=BATCH, num_epochs=epochs, test_ratio=TEST_RATIO,
        verbose=False, tensorboard=False, seed=0, debug_mode=False,
        fused_step=fused, progress_interval=1,
    )


def phase_training(ref, traj_np, w_np, cvf):
    """Phases 4 and 5: the main path, the plain path, the K1 path."""
    from colvarsfinder_tpu_torch.ops import _cuda

    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    n_pairs = N_FRAMES - LAG
    n_test = math.ceil(TEST_RATIO * n_pairs)
    nb_train = (n_pairs - n_test) // BATCH
    nb_test = 1 if n_test < BATCH else n_test // BATCH
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fused, method, epochs in (
            ("fused", True, "fused", EPOCHS),
            ("fused eager", True, "fused", EPOCHS),
            ("plain", False, "quaternion", EPOCHS),
            # weighted alignment, whose kernel route is K1
            ("k1", True, "cuda", K1_EPOCHS),
            ("k1 plain", True, "quaternion", K1_EPOCHS),
        ):
            # the plain run saves its model once, after its last epoch
            task = make_task(cvf, traj_obj, ref, f"{tmp}/{label}", fused,
                             method, epochs,
                             save_every=epochs if label == "plain" else 0,
                             align_weights=(ALIGN_WEIGHTS if "k1" in label
                                            else None))
            # the comparison run: every epoch eager (a private switch that
            # nothing in the package sets)
            task._eager_on_card = label == "fused eager"
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            task.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            loss = task.train_loss[:, 0]
            if not np.isfinite(task.train_loss).all():
                raise AssertionError(f"{label}: non-finite training metrics")
            if epochs > 2 and not loss[-1] < loss[0]:
                raise AssertionError(f"{label}: loss did not fall: {loss}")
            steady = statistics.median(task.epoch_times[2:] or
                                       task.epoch_times)
            sps = nb_train * BATCH / steady
            runs[label] = dict(task=task, counts=counts, wall=wall,
                               sps=sps, epochs=epochs)
            if (task._graph is None) != (label == "fused eager"):
                raise AssertionError(f"{label}: captured graph "
                                     f"{task._graph is not None}")
            log(f"  {label:11s}: {epochs} epochs in {wall:.2f} s, loss "
                f"{loss[0]:.5f} -> {loss[-1]:.5f}, eig_1 "
                f"{task.train_loss[-1, 3]:.4f}; launches {counts}")
            if label == "plain":
                check_scripted_cv(task, f"{tmp}/{label}/latest", traj_np)

    # the schedule: per epoch nb_train steps and nb_test test batches; each
    # batch aligns X and X_l (K2 or K1) and computes the stats (K3); each
    # train step runs the stats backward (K4)
    for label, align_kernel in (("fused", "fused_align"),
                                ("fused eager", "fused_align"),
                                ("k1", "kabsch_qcp"), ("k1 plain", None)):
        r = runs[label]
        e = r["epochs"]
        want = {"kabsch_qcp": 0, "fused_align": 0,
                "stats_fwd": e * (nb_train + nb_test),
                "stats_bwd": e * nb_train}
        if align_kernel:
            want[align_kernel] = 2 * e * (nb_train + nb_test)
        if r["counts"] != want:
            raise AssertionError(f"{label}: launches {r['counts']}, the "
                                 f"schedule implies {want}")
    if any(runs["plain"]["counts"].values()):
        raise AssertionError(f"plain step launched {runs['plain']['counts']}")

    for kern, plain in (("fused", "plain"), ("k1", "k1 plain")):
        for col, name in ((0, "loss"), (3, "eig_1")):
            a = runs[kern]["task"].train_loss[:, col]
            b = runs[plain]["task"].train_loss[:, col]
            rel = float(np.max(np.abs(a - b) / np.abs(b)))
            log(f"  {kern} vs {plain} {name}: max relative difference "
                f"{rel:.3e} over {runs[kern]['epochs']} epochs (tolerance "
                f"{CURVE_RTOL[name]})")
            np.testing.assert_allclose(a, b, rtol=CURVE_RTOL[name])
    fused, plain = runs["fused"]["task"], runs["plain"]["task"]
    # the captured epochs against the same epochs run eagerly: bit for bit
    eager = runs["fused eager"]["task"]
    same = all(np.array_equal(a, b) for ea, eb in zip(fused.loss_list,
                                                       eager.loss_list)
               for a, b in zip(ea, eb))
    same &= all(torch.equal(a, b) for a, b in zip(fused.model.parameters(),
                                                  eager.model.parameters()))
    log(f"  fused (graph) vs fused eager, {EPOCHS} epochs: every batch's "
        f"metric row and every final parameter bit for bit equal: {same}")
    if not same:
        raise AssertionError("the captured fused epochs differ from the "
                             "eager ones")
    if not np.array_equal(fused._cvec, plain._cvec):
        raise AssertionError(f"cvec {fused._cvec} != {plain._cvec}")
    cv = fused.colvar_model()
    with torch.no_grad():
        out = cv(torch.from_numpy(traj_np[:1000]).cuda())
    if out.shape != (1000, K) or not torch.isfinite(out).all():
        raise AssertionError(f"CV model output {tuple(out.shape)} not finite")
    return runs


def check_scripted_cv(task, latest, traj_np, frames=100, label="plain"):
    """The saved TorchScript CV, loaded on the CPU, against the trained CV
    model on the card."""
    names = sorted(os.listdir(latest))
    log(f"  {label}: latest/ holds {names}")
    missing = {"cv_params.npz", "cv_spec.json", "cv_numpy_spec.json",
               "cv_numpy.npz", "cv_native.bin", "scripted_cv_cpu.pt"}
    missing -= set(names)
    if missing:
        raise AssertionError(f"save_model wrote no {sorted(missing)}")
    scripted = torch.jit.load(f"{latest}/scripted_cv_cpu.pt",
                              map_location="cpu")
    x = torch.from_numpy(traj_np[:frames])
    with torch.no_grad():
        got = scripted(x)
        want = task.colvar_model()(x.cuda()).cpu()
    err = max_err(got, want)
    log(f"  scripted_cv_cpu.pt on the CPU vs the trained CV model on the "
        f"card, {frames} frames: max |difference| = {err:.3e} (tolerance "
        f"{SCRIPTED_ATOL})")
    torch.testing.assert_close(got, want, atol=SCRIPTED_ATOL, rtol=0)


def phase_profile(runs, epochs=2, chunk=10):
    """Phase 5: torch.profiler over ``epochs`` more epochs of each trained
    task (replays of its captured epoch). Per training step: the wall time,
    the device time (the summed durations of the device activities), the
    device activities, and the busy share (device time over wall time);
    per epoch, the graph replays (``cudaGraphLaunch`` calls on the host).
    Tracing every kernel of a replay slows the replay down, so the busy
    share is also given against the unprofiled steady-state epoch time of
    phase 4 (one host fetch per epoch), and samples/s once more with one
    fetch per ``chunk`` epochs. Kernel time summed per name."""
    out = {}
    for label in ("fused", "plain"):
        task = runs[label]["task"]
        n_samples = len(task._prepare_data()[0]) * BATCH
        task.num_epochs, task.progress_interval = chunk, 0
        task.train()
        chunked_sps = n_samples / task.epoch_times[-1]
        task.num_epochs, task.progress_interval = epochs, 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            task.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = device_activities(prof)
        busy = sum(e.self_device_time_total for e in kernels) * 1e-6
        steps = epochs * len(task._prepare_data()[0])
        replays = sum(e.count for e in prof.key_averages()
                      if e.key == "cudaGraphLaunch")
        epoch_s = n_samples / runs[label]["sps"]
        row = {
            "samples_per_s": runs[label]["sps"],
            "samples_per_s_one_fetch_per_chunk": chunked_sps,
            "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy * 1e3 / steps,
            "device_activities_per_step":
                sum(e.count for e in kernels) / steps,
            "device_busy_share": busy / wall,
            "steady_busy_share": busy / epochs / epoch_s,
            "graph_replays_per_epoch": replays / epochs,
        }
        log(f"  {label}: {row['samples_per_s']:,.0f} samples/s "
            f"({epoch_s * 1e3:.4f} ms/epoch; one fetch per {chunk} epochs: "
            f"{chunked_sps:,.0f}); profiled, {steps} steps + {epochs} test "
            f"batches in {wall * 1e3:.2f} ms: wall "
            f"{row['wall_ms_per_step']:.4f} ms/step, device "
            f"{row['device_ms_per_step']:.4f} ms/step, "
            f"{row['device_activities_per_step']:.1f} device activities/"
            f"step, busy share {100 * row['device_busy_share']:.1f}% "
            f"(of the unprofiled epoch: "
            f"{100 * row['steady_busy_share']:.1f}%), "
            f"{row['graph_replays_per_epoch']:g} graph replays/epoch")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        for e in top:
            log(f"    {e.self_device_time_total / steps:9.1f} us/step "
                f"{e.count / steps:5.1f}x/step  {e.key[:70]}")
        out[label] = row
    return out


def make_dirichlet(cvf, kind, traj_obj, ref, path, epochs, regions=None,
                   **kw):
    """A generator EigenFunctionTask (``gen_*``) or a CommittorTask
    (``com_*``) through FusedAlignmentLayer and position features, on the
    Gram path unless ``kind`` ends in ``vjp``."""
    atoms = list(range(N_ATOMS))
    pp = cvf.PreprocessingANN(
        cvf.FusedAlignmentLayer(ref, atoms),
        cvf.FeatureLayer([cvf.Feature("p", "position", atoms)]))
    args = dict(learning_rate=LR, save_model_every_step=0,
                batch_size=BATCH, num_epochs=epochs, test_ratio=TEST_RATIO,
                verbose=False, tensorboard=False, seed=0, debug_mode=False,
                progress_interval=1, diag_coeff=GEN_DIAG, beta=GEN_BETA,
                gram_pp=not kind.endswith("vjp"), **kw)
    if kind.startswith("gen"):
        return cvf.EigenFunctionTask(
            traj_obj, pp, cvf.EigenFunctions(list(DIMS), K, seed=0), path,
            alpha=ALPHA, eig_weights=EIG_W, lag_tau=0.0, k=K,
            gram_dtype="bfloat16" if kind == "gen_bf16" else None, **args)
    return cvf.CommittorTask(
        traj_obj, pp, cvf.create_sequential_nn(list(DIMS), seed=0), path,
        region_a=regions[0], region_b=regions[1], alpha=ALPHA, **args)


def dirichlet_profile(task, epochs=2):
    """Device time and device activities per training step over ``epochs``
    more epochs (replays) under torch.profiler, and the device activities
    that take the most time."""
    task.num_epochs = epochs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task.train()
        torch.cuda.synchronize()
    kernels = device_activities(prof)
    steps = epochs * len(task._prepare_data()[0])
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return (sum(e.self_device_time_total for e in kernels) * 1e-3 / steps,
            sum(e.count for e in kernels) / steps,
            [(e.self_device_time_total / steps, e.count / steps, e.key)
             for e in top])


def second_order_check(cvf, ref, traj_np, w_np):
    """The generator loss's parameter gradient at the main path's batch
    through FusedAlignmentLayer (K2's forward, its backward recorded and
    differentiated again) against the same loss through
    AlignmentLayer(method='quaternion'); the gradient of the Dirichlet
    quotients alone must be nonzero."""
    from colvarsfinder_tpu_torch.core.losses import eigen_loss

    dev = torch.device("cuda")
    atoms = list(range(N_ATOMS))
    X = torch.from_numpy(traj_np[:BATCH]).to(dev)
    w = torch.from_numpy(w_np[:BATCH]).to(dev)
    dc = torch.from_numpy(GEN_DIAG.astype(np.float32)).to(dev)
    grads = {}
    for name, align in (("fused", cvf.FusedAlignmentLayer(ref, atoms)),
                        ("plain", cvf.AlignmentLayer(ref, atoms))):
        pp = cvf.PreprocessingANN(
            align, cvf.FeatureLayer([cvf.Feature("p", "position", atoms)]))
        pp = pp.to(dev)
        model = cvf.EigenFunctions(list(DIMS), K, seed=0, device=dev)
        loss, aux = eigen_loss(model, pp, X, w, None, None, k=K,
                               alpha=ALPHA, eig_w=EIG_W, beta=GEN_BETA,
                               diag_coeff=dc, lag_idx=0, traj_dt=DT,
                               sort_eigvals=True)
        params = list(model.parameters())
        g_dir = torch.autograd.grad(aux.non_penalty_loss, params,
                                    retain_graph=True)
        g_all = torch.autograd.grad(loss, params)
        grads[name] = (g_all, g_dir)
    torch.cuda.synchronize()
    for i in (0, 1):
        check_close("stats_bwd", list(grads["fused"][i]),
                    list(grads["plain"][i]))
    norm = math.sqrt(sum(float((g * g).sum()) for g in grads["fused"][1]))
    err = max_err(list(grads["fused"][0]), list(grads["plain"][0]))
    log(f"  K2 second order, B={BATCH}: generator loss gradient through "
        f"FusedAlignmentLayer vs AlignmentLayer('quaternion'): max |diff| "
        f"{err:.3e} (tolerance {TOL['stats_bwd']}); norm of the Dirichlet "
        f"quotients' gradient through K2 {norm:.4e}")
    if not norm > 0:
        raise AssertionError("K2: the Dirichlet term has no gradient")
    return err, norm


def phase_dirichlet(card, ref, traj_np, w_np, cvf):
    """Phase 6: the generator and the committor on phase 4's frames."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.ops.alignment import align_frames

    dev = torch.device("cuda")
    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    with torch.no_grad():
        first = align_frames(torch.from_numpy(traj_np).to(dev),
                             torch.from_numpy(ref - ref.mean(0)).to(dev),
                             torch.arange(N_ATOMS, device=dev))[:, 0, 0]
    c = first.cpu().numpy()
    lo, hi = np.quantile(c, COMMITTOR_Q)
    regions = (c < lo, c > hi)
    log(f"  committor regions: {int(regions[0].sum())} frames in A, "
        f"{int(regions[1].sum())} in B")
    runs, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("gen_gram", "gen_vjp", "gen_bf16", "com_gram",
                     "com_vjp"):
            pair = []
            for eager in (False, True):
                label = kind + (" eager" if eager else "")
                task = make_dirichlet(cvf, kind, traj_obj, ref,
                                      f"{tmp}/{label}", EPOCHS, regions)
                task._eager_on_card = eager
                torch.cuda.synchronize()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                data = task._prepare_data()
                torch.cuda.synchronize()
                prep_s = time.perf_counter() - t0
                prep_counts = _cuda.launch_counts()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                task.train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _cuda.launch_counts()
                tl = task.train_loss
                if not np.isfinite(tl).all():
                    raise AssertionError(f"{label}: non-finite metrics")
                if not tl[-1, 0] < tl[0, 0]:
                    raise AssertionError(f"{label}: loss did not fall: "
                                         f"{tl[:, 0]}")
                if (task._graph is None) != eager:
                    raise AssertionError(f"{label}: captured graph "
                                         f"{task._graph is not None}")
                if task._gram != (not kind.endswith("vjp")):
                    raise AssertionError(f"{label}: Gram path {task._gram}")
                nb = len(data[0]) + len(data[1])
                steady = statistics.median(task.epoch_times[2:])
                m_bytes = sum(b[1].numel() * b[1].element_size()
                              for b in data[0] + data[1]) if task._gram else 0
                want = 0 if task._gram else EPOCHS * nb
                if counts != {**dict.fromkeys(counts, 0),
                              "fused_align": want}:
                    raise AssertionError(f"{label}: launches {counts}, the "
                                         f"schedule implies {want} K2")
                row = dict(samples_per_s=len(data[0]) * BATCH / steady,
                           wall_s=wall, prepare_s=prep_s, gram_bytes=m_bytes,
                           k1_per_batch=counts["kabsch_qcp"] / (EPOCHS * nb),
                           k2_per_batch=counts["fused_align"] / (EPOCHS * nb),
                           k2_in_prepare=prep_counts["fused_align"])
                log(f"  {label:14s}: {EPOCHS} epochs in {wall:.2f} s, "
                    f"{row['samples_per_s']:,.0f} samples/s, loss "
                    f"{tl[0, 0]:.5f} -> {tl[-1, 0]:.5f}; batches prepared in "
                    f"{prep_s:.3f} s (Gram matrices {m_bytes / 1e6:.1f} MB, "
                    f"{row['k2_in_prepare']} K2 launches); per batch "
                    f"{row['k1_per_batch']:g} K1, {row['k2_per_batch']:g} K2 "
                    f"launches ({card})")
                if not eager:
                    out[kind] = row
                pair.append(task)
            graph, eager_task = pair
            same = all(np.array_equal(a, b)
                       for ea, eb in zip(graph.loss_list, eager_task.loss_list)
                       for a, b in zip(ea, eb))
            same &= all(torch.equal(a, b) for a, b in zip(
                graph.model.parameters(), eager_task.model.parameters()))
            log(f"  {kind} (graph) vs eager, {EPOCHS} epochs: every metric "
                f"row and final parameter bit for bit equal: {same}")
            if not same:
                raise AssertionError(f"{kind}: the captured epochs differ "
                                     "from the eager ones")
            runs[kind] = graph

        bars = (("gen_vjp", "gen_gram", ((0, "loss"), (3, "eig_1"))),
                ("com_vjp", "com_gram", ((0, "loss"), (1, "dirichlet"))),
                ("gen_bf16", "gen_gram", ((0, "loss"),)))
        for a_kind, b_kind, cols in bars:
            for col, name in cols:
                a = runs[a_kind].train_loss[:, col]
                b = runs[b_kind].train_loss[:, col]
                rtol = (BF16_RTOL if a_kind == "gen_bf16"
                        else CURVE_RTOL.get(name, CURVE_RTOL["eig_1"]))
                rel = float(np.max(np.abs(a - b) / np.abs(b)))
                log(f"  {a_kind} vs {b_kind} {name}: max relative difference "
                    f"{rel:.3e} over {EPOCHS} epochs (tolerance {rtol})")
                np.testing.assert_allclose(a, b, rtol=rtol)
        q = runs["com_gram"].committor_values(traj_np[:1000])
        if q.shape != (1000,) or not ((q > 0) & (q < 1)).all():
            raise AssertionError("committor values outside (0, 1)")
        for kind in ("gen_gram", "gen_vjp", "com_gram"):
            ms, acts, top = dirichlet_profile(runs[kind])
            out[kind].update(device_ms_per_step=ms,
                             device_activities_per_step=acts)
            log(f"  {kind}: profiled, device {ms:.4f} ms/step, {acts:.1f} "
                f"device activities/step ({card})")
            for us, count, key in top:
                log(f"    {us:9.1f} us/step {count:7.1f}x/step  {key[:70]}")
    err, norm = second_order_check(cvf, ref, traj_np, w_np)
    out["k2_second_order"] = dict(max_abs_err=err, dirichlet_grad_norm=norm)
    return out


def make_ae(cvf, kind, traj_obj, ref, path, epochs, method="fused",
            save_every=0, align_weights=None, seed=0):
    """An AutoEncoderTask (``ae``) or a RegAutoEncoderTask with all six
    terms: transfer regularizer (``reg``, ``freeze`` with the encoder
    frozen) or generator regularizer on the Gram or vjp path (``gen_gram``,
    ``gen_vjp``); the alignment is FusedAlignmentLayer, or
    AlignmentLayer(method=method); the model's weights from ``seed``."""
    atoms = list(range(N_ATOMS))
    if method == "fused":
        align = cvf.FusedAlignmentLayer(ref, atoms)
    else:
        align = cvf.AlignmentLayer(ref, atoms, method=method,
                                   align_weights=align_weights)
    pp = cvf.PreprocessingANN(
        align, cvf.FeatureLayer([cvf.Feature("p", "position", atoms)]))
    args = dict(learning_rate=AE_LR, save_model_every_step=save_every,
                batch_size=BATCH, num_epochs=epochs, test_ratio=TEST_RATIO,
                verbose=False, tensorboard=False, seed=0, debug_mode=False,
                progress_interval=1)
    if kind == "ae":
        return cvf.AutoEncoderTask(traj_obj, pp,
                                   cvf.AutoEncoder(*AE_DIMS, seed=seed), path,
                                   **args)
    gen = kind.startswith("gen")
    return cvf.RegAutoEncoderTask(
        traj_obj, pp, cvf.RegAutoEncoder(*AE_DIMS, AE_REG_DIMS, K, seed=seed),
        path, lag_tau_ae=LAG * DT, lag_tau_reg=0.0 if gen else LAG * DT,
        gram_pp=(kind == "gen_gram") if gen else None,
        freeze_encoder=kind == "freeze", **REG_TERMS, **args)


def check_launches(label, got, want):
    want = {**dict.fromkeys(got, 0), **want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the schedule implies "
                             f"{want}")


def run_ae(cvf, card, kind, traj_obj, ref, path, epochs, eager=False,
           **kw):
    """Build (the launches counted from the constructor on), prepare and
    train one autoencoder task; checks the metrics and returns the task,
    its numbers and the launches of the build and of the training."""
    from colvarsfinder_tpu_torch.ops import _cuda

    label = path.rsplit("/", 1)[-1]
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    task = make_ae(cvf, kind, traj_obj, ref, path, epochs, **kw)
    task._eager_on_card = eager
    if kind != "ae":
        record_sort_decisions(task)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = task._prepare_data()
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prep_counts = _cuda.launch_counts()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    task.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    tl = task.train_loss
    if not np.isfinite(tl).all():
        raise AssertionError(f"{label}: non-finite training metrics")
    if epochs > 2 and not tl[-1, 0] < tl[0, 0]:
        raise AssertionError(f"{label}: loss did not fall: {tl[:, 0]}")
    if (task._graph is None) != eager:
        raise AssertionError(f"{label}: captured graph "
                             f"{task._graph is not None}")
    nb = len(data[0]) + len(data[1])
    steady = statistics.median(task.epoch_times[2:] or task.epoch_times)
    gram = getattr(task, "_gram", False)
    m_bytes = sum(b[2].numel() * b[2].element_size()
                  for b in data[0] + data[1]) if gram else 0
    row = dict(samples_per_s=len(data[0]) * BATCH / steady, wall_s=wall,
               build_s=build_s, prepare_s=prep_s, gram_bytes=m_bytes,
               k1_in_build=prep_counts["kabsch_qcp"],
               k2_in_build=prep_counts["fused_align"],
               k2_per_batch=counts["fused_align"] / (epochs * nb))
    log(f"  {label:12s}: {epochs} epochs in {wall:.2f} s, "
        f"{row['samples_per_s']:,.0f} samples/s, loss {tl[0, 0]:.5f} -> "
        f"{tl[-1, 0]:.5f}; built in {build_s:.3f} s ({row['k2_in_build']} "
        f"K2, {row['k1_in_build']} K1 launches), batches prepared in "
        f"{prep_s:.3f} s (Gram matrices {m_bytes / 1e6:.1f} MB); per batch "
        f"{row['k2_per_batch']:g} K2 launches ({card})")
    return task, row, counts, prep_counts


def same_bits(a, b):
    """Every batch's metric row of every epoch and every final parameter
    bit for bit equal."""
    return (all(np.array_equal(x, y) for ea, eb in zip(a.loss_list,
                                                        b.loss_list)
                for x, y in zip(ea, eb))
            and all(torch.equal(x, y) for x, y in zip(a.model.parameters(),
                                                      b.model.parameters())))


def record_sort_decisions(task):
    """Keep, per epoch, the cvec of every train batch (the eigenvalue sort's
    decisions) as the task fetches its metric rows."""
    task.sort_log = []
    fetched = task._chunk_fetched

    def keep(train_cm):
        task.sort_log += [rows[:, len(task.loss_names):].astype(int)
                          for rows in train_cm]
        fetched(train_cm)

    task._chunk_fetched = keep


def check_curves(a_label, a, b_label, b, cols, hold="all", drift=None):
    """Two runs' training curves: within the training bar over every epoch
    (``hold="all"``), over the epochs before the first train batch whose
    sort of the heads (cvec) differs between the runs (``"sorted"``: where
    two eigenvalues cross, the sort changes the objective's gradient, and
    the transfer objective's preserved quirk, numerator unsorted and
    denominator sorted, its value, so from there on the runs minimise
    different objectives) or over none (None); and over every epoch within
    ``drift`` (``{"loss": rtol, "eig": rtol}``) where given. Returns the
    epochs held to the training bar and the largest relative difference
    over all epochs."""
    n = len(a.train_loss)
    held = n
    if hold == "sorted":
        same = [np.array_equal(x, y) for x, y in zip(a.sort_log, b.sort_log)]
        held = same.index(False) if False in same else n
        log(f"  {a_label} vs {b_label}: every train batch sorted the heads "
            f"alike in the first {held} of {n} epochs")
        if held == 0:
            raise AssertionError(f"{a_label} vs {b_label}: the heads sorted "
                                 "differently in the first epoch")
    elif hold is None:
        held = 0
    worst = 0.0
    for col in cols:
        name = a.loss_names[col]
        rtol = CURVE_RTOL["loss"] if col == 0 else CURVE_RTOL["eig_1"]
        x, y = a.train_loss[:, col], b.train_loss[:, col]
        rel = np.abs(x - y) / np.abs(y)
        worst = max(worst, float(rel.max()))
        over = np.flatnonzero(rel > rtol)
        all_rtol = None if drift is None else drift[
            "loss" if col == 0 else "eig"]
        log(f"  {a_label} vs {b_label} {name}: max relative difference "
            f"{float(rel.max()):.3e} over {n} epochs (training bar {rtol}, "
            f"held over the first {held}, first epoch past it: "
            f"{over[0] if over.size else None}; drift bar {all_rtol} over "
            "every epoch)")
        np.testing.assert_allclose(x[:held], y[:held], rtol=rtol)
        if drift is not None:
            np.testing.assert_allclose(x, y, rtol=all_rtol)
    return held, worst


def same_state_check(cvf, traj_obj, ref, tmp, a, b, float64=False):
    """Two versions of a task's step from the same (initial) parameters,
    on every train batch. In float32 (K2 against the plain layer): the loss
    and the eigenvalues within the training bar, the parameter gradient
    within K4's relative bar with entries near zero held against the
    largest entry, as the CPU tests hold gradients (a head's output bias
    has a gradient of rounding residue only, the loss being blind to a
    shift of a head). In float64 (two formulations of one step, both
    through K2, whose float32 features they share): every metric and the
    gradient within F64_STEP_RTOL. ``a`` and ``b`` are ``(label, kind,
    make_ae keywords)``."""
    from colvarsfinder_tpu_torch.config import set_default_dtype

    rows, grads = [], []
    set_default_dtype("float64" if float64 else "float32")
    try:
        for label, kind, kw in (a, b):
            task = make_ae(cvf, kind, traj_obj, ref, f"{tmp}/same {label}", 1,
                           **kw)
            params = list(task.model.parameters())
            for batch in task._prepare_data()[0]:
                loss, row = task._batch_metrics(*batch)
                grads.append(torch.autograd.grad(loss, params))
                rows.append(row[:len(task.loss_names)].detach().cpu().numpy())
    finally:
        set_default_dtype("float32")
    names = task.loss_names
    cols = ([0] + [i for i, nm in enumerate(names) if nm.startswith("eig_")]
            if not float64 else list(range(len(names))))
    half = len(rows) // 2
    rows = (np.stack(rows[:half]), np.stack(rows[half:]))
    grads = ([g for gs in grads[:half] for g in gs],
             [g for gs in grads[half:] for g in gs])
    rel = np.abs(rows[0] - rows[1]) / np.abs(rows[1])
    rtol = F64_STEP_RTOL if float64 else TOL["stats_bwd"]["rtol"]
    scale = max(float(g.abs().max()) for g in grads[1])
    err = max_err(grads[0], grads[1]) / scale
    bar = {"all": rtol} if float64 else CURVE_RTOL
    log(f"  {a[0]} vs {b[0]}, {'float64, ' if float64 else ''}each of "
        f"{half} steps from the same parameters: max relative difference "
        f"of the {'metrics' if float64 else 'loss and eigenvalues'} "
        f"{float(rel[:, cols].max()):.3e} (tolerance {bar}); parameter "
        f"gradient max |diff| {err:.3e} of its largest entry {scale:.4g} "
        f"(tolerance rtol {rtol}, atol {rtol} of the largest entry)")
    for col in cols:
        tol = (rtol if float64 else
               CURVE_RTOL["loss"] if col == 0 else CURVE_RTOL["eig_1"])
        np.testing.assert_allclose(rows[0][:, col], rows[1][:, col],
                                   rtol=tol, err_msg=names[col])
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=rtol, atol=rtol * scale)
    return float(rel[:, cols].max()), err


def phase_autoencoders(card, ref, traj_np, w_np, cvf):
    """Phase 7: the AutoEncoderTask and the RegAutoEncoderTask on phase 4's
    frames."""
    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    eig_cols = [4 + i for i in range(K)]
    out, tasks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kind, epochs, eager, kw in (
            ("ae", "ae", EPOCHS, False, {}),
            ("ae eager", "ae", EPOCHS, True, {}),
            ("ae plain", "ae", EPOCHS, False,
             dict(method="quaternion", save_every=EPOCHS)),
            ("reg", "reg", EPOCHS, False, {}),
            ("reg eager", "reg", EPOCHS, True, {}),
            ("reg plain", "reg", EPOCHS, False, dict(method="quaternion")),
            ("gen_gram", "gen_gram", EPOCHS, False, {}),
            ("gen_gram eager", "gen_gram", EPOCHS, True, {}),
            ("gen_vjp", "gen_vjp", EPOCHS, False, {}),
            ("gen_vjp eager", "gen_vjp", EPOCHS, True, {}),
            ("freeze", "freeze", FREEZE_EPOCHS, False, {}),
            ("freeze eager", "freeze", FREEZE_EPOCHS, True, {}),
        ):
            if kind == "freeze" and not eager:
                # the initial encoder: the same seed's
                enc0 = list(cvf.RegAutoEncoder(*AE_DIMS, AE_REG_DIMS, K,
                                               seed=0).encoder.parameters())
            task, row, counts, build = run_ae(
                cvf, card, kind, traj_obj, ref, f"{tmp}/{label}", epochs,
                eager, **kw)
            nb = len(task._prepared[0]) + len(task._prepared[1])
            fused = kw.get("method", "fused") == "fused"
            if kind == "ae":
                check_launches(f"{label} build", build,
                               {"fused_align": 1 if fused else 0})
                check_launches(label, counts, {})
            elif kind == "gen_gram":
                # one frame at construction for the feature width d_r, then
                # per batch the Gram pass and the lagged features
                check_launches(f"{label} build", build,
                               {"fused_align": 1 + 2 * nb})
                check_launches(label, counts, {})
            else:
                # per batch the features of X and of X lagged (one pass for
                # both lagged terms, whose lags are equal), and on the vjp
                # path the input-gradient pass
                per_batch = 3 if kind == "gen_vjp" else 2
                check_launches(f"{label} build", build, {})
                check_launches(label, counts, {
                    "fused_align": per_batch * epochs * nb if fused else 0})
            if label == "ae plain":
                check_scripted_cv(task, f"{tmp}/{label}/latest", traj_np,
                                  label=label)
            if kind != "ae":
                log(f"  {label}: final cvec {task._cvec.tolist()}")
            if kind == "freeze" and not eager:
                same = all(torch.equal(a, b.cuda()) for a, b in zip(
                    task.model.encoder.parameters(), enc0))
                log(f"  freeze, {epochs} epochs: encoder parameters bit for "
                    f"bit equal to their initial values: {same}")
                if not same:
                    raise AssertionError("freeze_encoder moved the encoder")
            tasks[label] = task
            if not eager:
                out[label] = row

        for kind in ("ae", "reg", "gen_gram", "gen_vjp", "freeze"):
            same = same_bits(tasks[kind], tasks[f"{kind} eager"])
            log(f"  {kind} (graph) vs eager: every metric row and final "
                f"parameter bit for bit equal: {same}")
            if not same:
                raise AssertionError(f"{kind}: the captured epochs differ "
                                     "from the eager ones")
        check_curves("ae", tasks["ae"], "ae plain", tasks["ae plain"], [0])
        # the RegAE pairs: the training bar over the epochs before the
        # transfer pair's sorts of the heads part, the drift bar of two
        # plain versions over every epoch, and step by step from the same
        # parameters
        for a, b, config, hold in (
                ("reg", "reg plain", "transfer", "sorted"),
                ("gen_vjp", "gen_gram", "generator", None)):
            out[f"{a} vs {b}"] = dict(zip(
                ("epochs_held", "max_rel_all_epochs"),
                check_curves(a, tasks[a], b, tasks[b], [0] + eig_cols,
                             hold, DRIFT_RTOL[config])))
        for a, b, f64 in ((("reg", "reg", {}),
                           ("reg plain", "reg", dict(method="quaternion")),
                           False),
                          (("gen_vjp", "gen_vjp", {}),
                           ("gen_gram", "gen_gram", {}), True)):
            out[f"{a[0]} vs {b[0]} same state"] = dict(zip(
                ("max_rel_metrics", "grad_max_abs_err_of_scale"),
                same_state_check(cvf, traj_obj, ref, tmp, a, b, f64)))

        # the AE's features through K1 (weighted alignment) against the same
        # alignment in plain PyTorch
        feats = {}
        for method in ("cuda", "quaternion"):
            task, _, _, build = run_ae(
                cvf, card, "ae", traj_obj, ref, f"{tmp}/ae k1 {method}", 1,
                method=method, align_weights=ALIGN_WEIGHTS)
            check_launches(f"ae k1 {method} build", build,
                           {"kabsch_qcp": 1 if method == "cuda" else 0})
            feats[method] = task._feature_traj
        err = max_err(feats["cuda"], feats["quaternion"])
        log(f"  AE features through K1 (weighted), {N_FRAMES} frames: max "
            f"|K1 route - plain| = {err:.3e} (tolerance {TOL['fused_align']})")
        torch.testing.assert_close(feats["cuda"], feats["quaternion"],
                                   **TOL["fused_align"])
        out["ae_k1_features_max_abs_err"] = err

        for label in ("ae", "reg", "gen_gram", "gen_vjp", "freeze"):
            ms, acts, top = dirichlet_profile(tasks[label])
            out[label].update(device_ms_per_step=ms,
                              device_activities_per_step=acts)
            log(f"  {label}: {out[label]['samples_per_s']:,.0f} samples/s; "
                f"profiled, device {ms:.4f} ms/step, {acts:.1f} device "
                f"activities/step ({card})")
            for us, count, key in top:
                log(f"    {us:9.1f} us/step {count:7.1f}x/step  {key[:70]}")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    import colvarsfinder_tpu_torch as cvf
    from colvarsfinder_tpu_torch.config import set_matmul_precision
    from colvarsfinder_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    set_matmul_precision("highest")  # full f32: no TF32 in cuBLAS or cuDNN
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    build_s = _cuda.build_all()
    log(f"kernel build (one nvcc per source, in parallel): {build_s:.2f} s")

    ref, traj_np, w_np = make_data(0)
    dev = torch.device("cuda")
    log("phase 2-3: kernels against plain versions, and timed")
    kern = phase_kernels(ref, torch.from_numpy(traj_np),
                         torch.from_numpy(w_np), dev, cvf)
    log("phase 4: training")
    runs = phase_training(ref, traj_np, w_np, cvf)

    log(f"phase 5: steady-state training throughput on {card}: fused step "
        f"(K2+K3+K4) {runs['fused']['sps']:,.0f} samples/s, plain step "
        f"{runs['plain']['sps']:,.0f} samples/s")
    prof = phase_profile(runs)
    log("phase 6: the generator and the committor (Dirichlet form)")
    dirichlet = phase_dirichlet(card, ref, traj_np, w_np, cvf)
    log("phase 7: the autoencoder and the regularized autoencoder")
    autoencoders = phase_autoencoders(card, ref, traj_np, w_np, cvf)
    launches = {"kabsch_qcp": runs["k1"]["counts"]["kabsch_qcp"]}
    for name in ("fused_align", "stats_fwd", "stats_bwd"):
        launches[name] = runs["fused"]["counts"][name]
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = kern[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "card": card,
        "throughput_samples_per_s": {"fused": runs["fused"]["sps"],
                                     "plain": runs["plain"]["sps"]},
        "profile": prof,
        "dirichlet": dirichlet,
        "autoencoders": autoencoders,
    }))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
