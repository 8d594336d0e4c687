#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. the card's name and power limit, the torch and CUDA versions, and the
   build of the CUDA kernels from ``colvarsfinder_tpu_torch/csrc``;
2. kernels K1-K4 against their plain PyTorch versions on the card, at the
   main path's shapes (B = 20,000 frames of 10 atoms, dims [30,20,20,20,1],
   k = 2) and at a ragged B = 37; K3/K4 must repeat bit for bit;
3. each kernel's device time (CUDA events, median of 21 batches of
   back-to-back calls queued behind a device sleep) beside its bound
   (the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s) and
   its plain version's device time (the summed durations of its kernels
   under torch.profiler);
4. transfer-operator EigenFunctionTask training on data shaped like the
   repo's headline benchmark (120,000 frames, 10 atoms, lag 5, batch
   20,000, seed 0) with FusedAlignmentLayer and fused_step=True (K2, K3,
   K4), held against the plain-PyTorch step with AlignmentLayer
   (method='quaternion') on the card; then a short run through
   AlignmentLayer(method='cuda') (K1);
5. steady-state training throughput of both steps, and the device's busy
   share over two more epochs of each under torch.profiler.

The second-to-last line lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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
# fused step against plain step over the training curves (the JAX
# package's fused-vs-plain bar)
CURVE_RTOL = {"loss": 2e-3, "eig_1": 5e-3}

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


def phase_kernels(ref_np, traj, weights, dev, cvf):
    """Phases 2 and 3: every kernel against its plain version, and timed."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.ops.alignment import (
        align_frames,
        kabsch_rotations_quat,
    )
    from colvarsfinder_tpu_torch.ops.fused_eigen import (
        _n_params,
        eigen_loss_from_stats,
        flatten_params,
        params_t_of,
        stats_bwd_launch,
        stats_fwd_launch,
        stats_layout,
        transfer_stats_reference,
        unflatten_grads,
    )
    from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
        fused_align_launch,
        kabsch_qcp_launch,
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

    for B in (BATCH, RAGGED_B):
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
        d_stats = d_stats.contiguous()

        def k4_plain():
            s = transfer_stats_reference(pt, F, Fl, w, wl)
            return torch.autograd.grad(s, params, d_stats)

        def k4_kernel():
            return stats_bwd_launch(flat, F, Fl, w, wl, d_stats, DIMS, K)

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
                                                   K),
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
            # F, F_l, w, w_l in, stats out; 2 flops per multiply-add of
            # both passes through k heads
            "stats_fwd": (2 * B * (DIMS[0] + 1) * 4
                          + (_n_params(DIMS, K) + n_stats) * 4,
                          2 * 2 * B * K * fma),
            # the same inputs + d_stats in, gradients out; forward, the
            # hidden-layer input cotangents and the weight gradients
            "stats_bwd": (2 * B * (DIMS[0] + 1) * 4
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
    _cuda.reset_launch_counts()
    return results


def make_task(cvf, traj_obj, ref, path, fused, method, epochs, **kw):
    if method == "fused":
        align = cvf.FusedAlignmentLayer(ref, list(range(N_ATOMS)))
    else:
        align = cvf.AlignmentLayer(ref, list(range(N_ATOMS)), method=method)
    pp = cvf.PreprocessingANN(
        align,
        cvf.FeatureLayer([cvf.Feature("p", "position",
                                      list(range(N_ATOMS)))]),
    )
    return cvf.EigenFunctionTask(
        traj_obj, pp, cvf.EigenFunctions(list(DIMS), K, seed=0), path,
        alpha=ALPHA, eig_weights=EIG_W, lag_tau=LAG * DT,
        learning_rate=LR, save_model_every_step=0, k=K, batch_size=BATCH,
        num_epochs=epochs, test_ratio=TEST_RATIO, verbose=False,
        tensorboard=False, seed=0, debug_mode=False, fused_step=fused,
        progress_interval=1, **kw,
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
            ("plain", False, "quaternion", EPOCHS),
            ("k1", True, "cuda", K1_EPOCHS),
        ):
            task = make_task(cvf, traj_obj, ref, f"{tmp}/{label}", fused,
                             method, epochs)
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
            log(f"  {label:5s}: {epochs} epochs in {wall:.2f} s, loss "
                f"{loss[0]:.5f} -> {loss[-1]:.5f}, eig_1 "
                f"{task.train_loss[-1, 3]:.4f}; launches {counts}")

    # the schedule: per epoch nb_train steps and nb_test test batches; each
    # batch aligns X and X_l (K2 or K1) and computes the stats (K3); each
    # train step runs the stats backward (K4)
    for label, align_kernel in (("fused", "fused_align"), ("k1",
                                                           "kabsch_qcp")):
        r = runs[label]
        e = r["epochs"]
        want = {"kabsch_qcp": 0, "fused_align": 0,
                align_kernel: 2 * e * (nb_train + nb_test),
                "stats_fwd": e * (nb_train + nb_test),
                "stats_bwd": e * nb_train}
        if r["counts"] != want:
            raise AssertionError(f"{label}: launches {r['counts']}, the "
                                 f"schedule implies {want}")
    if any(runs["plain"]["counts"].values()):
        raise AssertionError(f"plain step launched {runs['plain']['counts']}")

    fused, plain = runs["fused"]["task"], runs["plain"]["task"]
    for col, name in ((0, "loss"), (3, "eig_1")):
        a, b = fused.train_loss[:, col], plain.train_loss[:, col]
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        log(f"  fused vs plain {name}: max relative difference {rel:.3e} "
            f"over {EPOCHS} epochs (tolerance {CURVE_RTOL[name]})")
        np.testing.assert_allclose(a, b, rtol=CURVE_RTOL[name])
    if not np.array_equal(fused._cvec, plain._cvec):
        raise AssertionError(f"cvec {fused._cvec} != {plain._cvec}")
    cv = fused.colvar_model()
    with torch.no_grad():
        out = cv(torch.from_numpy(traj_np[:1000]).cuda())
    if out.shape != (1000, K) or not torch.isfinite(out).all():
        raise AssertionError(f"CV model output {tuple(out.shape)} not finite")
    return runs


def phase_profile(runs, epochs=2):
    """Device busy share of training: torch.profiler over ``epochs`` more
    epochs of an already-trained task; kernel time summed per name."""
    out = {}
    for label in ("fused", "plain"):
        task = runs[label]["task"]
        task.num_epochs = epochs
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
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log(f"  {label}: {steps} steps + {epochs} test batches in "
            f"{wall * 1e3:.1f} ms; device busy {busy * 1e3:.2f} ms "
            f"({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} "
            "device activities")
        for e in top:
            log(f"    {e.self_device_time_total / steps:9.1f} us/step "
                f"{e.count // steps:4d}x/step  {e.key[:70]}")
        out[label] = {"wall_ms_per_step": wall * 1e3 / steps,
                      "device_busy_share": busy / wall}
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
    }))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
