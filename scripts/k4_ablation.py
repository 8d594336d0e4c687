#!/usr/bin/env python3
"""Where K3's and K4's time goes: phase ablation, K3's tiles and K4's batch
sweep on one NVIDIA card.

    python3 scripts/k4_ablation.py

No profiler that reads hardware counters is assumed. Instead the script
builds ``colvarsfinder_tpu_torch/csrc/fused_eigen.cu`` as it is and copies
with one phase removed (K4's hidden-layer forward, cotangent backprop and dW
contraction; K3's hidden-layer forward, the tanh of its hidden layers, its
output layer, its in-block stats, and its whole body, which leaves the
launch and the reduction launch), and times each at the main path's shapes
(B = 20,000, dims [30,20,20,20,1], k = 2). The time a phase's removal saves
is that phase's share. The copies compute wrong results; only their time is
read. It times K3 at each of its tiles, then K4 over batch
sizes around one and two waves of resident blocks. Device times are CUDA
events, as in chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from colvarsfinder_tpu_torch.models import EigenFunctions  # noqa: E402
from colvarsfinder_tpu_torch.ops import _cuda  # noqa: E402
from colvarsfinder_tpu_torch.ops import fused_eigen as fe  # noqa: E402

# the loop headers that a removed phase runs zero times, or the lines that
# skip it (each occurs once in the source: K3's hidden-layer loop is written
# apart from K4's)
REMOVE = {
    "forward": ("for (int l = 0; l < L - 1; ++l) {",
                "for (int l = 0; l < 0; ++l) {"),
    "backprop": ("for (int l = L - 1; l >= 1; --l) {",
                 "for (int l = L - 1; l >= L; --l) {"),
    "dW": ("for (int wt = tid >> 1; wt < n_tiles; wt += NT >> 1) {",
           "for (int wt = tid >> 1; wt < 0; wt += NT >> 1) {"),
    "K3 forward": ("for (int l = 0; l + 1 < L; ++l) {",
                   "for (int l = 0; l + 1 < 0; ++l) {"),
    # in rows_forward, which K4 shares; only K3 is timed with this copy
    "K3 tanh": ("out[(o0 + j) * P + lane + 32 * r] = act_tanh(acc[j][r]);",
                "out[(o0 + j) * P + lane + 32 * r] = acc[j][r];"),
    "K3 output layer": ("            out_forward(src, din,",
                        "            if (din < 0) out_forward(src, din,"),
    "K3 stats": ("for (int j = warp; j < n_stats; j += nwarps) {",
                 "for (int j = warp; j < 0; j += nwarps) {"),
    "K3 body": ("    float* sW = smem;                // [n_params]",
                "    if (n_params > 0) return;\n"
                "    float* sW = smem;                // [n_params]"),
}
K3_PHASES = ("K3 forward", "K3 tanh", "K3 output layer", "K3 stats",
             "K3 body")


def build(tmp: Path) -> dict:
    src = (_cuda.CSRC / "fused_eigen.cu").read_text()
    procs = {}
    for name in ("kernel", *REMOVE):
        text = src
        if name in REMOVE:
            old, new = REMOVE[name]
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: loop header not found once")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        cu, so = tmp / f"{stem}.cu", tmp / f"{stem}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _cuda._SIGNATURES["fused_eigen"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(B, flat, dev, seed=0):
    rng = np.random.default_rng(seed)
    d0 = cs.DIMS[0]

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    F, Fl = t(rng.standard_normal((B, d0))), t(rng.standard_normal((B, d0)))
    w, wl = t(rng.uniform(0.5, 1.5, B)), t(rng.uniform(0.5, 1.5, B))
    _, Y = fe.stats_fwd_launch(flat, F, Fl, w, wl, cs.DIMS, cs.K)
    ds = t(rng.standard_normal(fe.stats_layout(cs.K)[0]))
    return F, Fl, w, wl, Y, ds


def launcher(lib, flat, data):
    F, Fl, w, wl, Y, ds = data
    B = F.shape[0]
    shape = fe.bwd_launch_shape(cs.DIMS, cs.K)
    partials = torch.empty(-(-B // shape.tile) * flat.shape[0],
                           device=flat.device)
    grads = torch.empty_like(flat)

    def run():
        err = lib.cvf_stats_bwd(
            flat.data_ptr(), F.data_ptr(), Fl.data_ptr(), w.data_ptr(),
            wl.data_ptr(), Y.data_ptr(), ds.data_ptr(), partials.data_ptr(),
            grads.data_ptr(), fe._dims_arg(cs.DIMS), len(cs.DIMS) - 1, cs.K,
            B, shape.tile, shape.smem_bytes, _cuda.stream_handle())
        _cuda.check(err, "cvf_stats_bwd")

    return run


def fwd_launcher(lib, flat, data, tile):
    F, Fl, w, wl = data[:4]
    B = F.shape[0]
    n_stats = fe.stats_layout(cs.K)[0]
    partials = torch.empty(-(-B // tile) * n_stats, device=flat.device)
    stats = torch.empty(n_stats, device=flat.device)
    Y = torch.empty((2, cs.K, B), device=flat.device)
    smem = fe.stats_smem_bytes(cs.DIMS, cs.K, tile, backward=False)

    def run():
        err = lib.cvf_stats_fwd(
            flat.data_ptr(), F.data_ptr(), Fl.data_ptr(), w.data_ptr(),
            wl.data_ptr(), partials.data_ptr(), stats.data_ptr(),
            Y.data_ptr(), fe._dims_arg(cs.DIMS), len(cs.DIMS) - 1, cs.K, B,
            tile, smem, _cuda.stream_handle())
        _cuda.check(err, "cvf_stats_fwd")

    return run


def k_blocks(B, shape):
    return -(-B // shape.tile) * cs.K


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_ablation: needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    model = EigenFunctions(cs.DIMS, cs.K, seed=0, device=dev)
    flat = fe.flatten_params(fe.params_t_of(model)).detach().contiguous()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        data = inputs(cs.BATCH, flat, dev)
        full = cs.device_ms(launcher(libs["kernel"], flat, data)) * 1e3
        print(f"K4 at B={cs.BATCH}: {full:.2f} us", flush=True)
        for name in REMOVE:
            if name in K3_PHASES:
                continue
            us = cs.device_ms(launcher(libs[name], flat, data)) * 1e3
            print(f"  without the {name:8s}: {us:8.2f} us (the phase: "
                  f"{full - us:6.2f} us)", flush=True)
        fwd = fe.fwd_launch_shape(cs.DIMS, cs.K)
        for tile in sorted(fe.TILES, reverse=True):
            us = cs.device_ms(fwd_launcher(libs["kernel"], flat, data,
                                           tile)) * 1e3
            print(f"K3 at B={cs.BATCH}, tile {tile:2d} ({-(-cs.BATCH // tile)}"
                  f" blocks of {fe.THREADS_PER_SAMPLE * tile} threads): "
                  f"{us:.2f} us", flush=True)
            if tile == fwd.tile:
                full = us
        for name in K3_PHASES:
            us = cs.device_ms(fwd_launcher(libs[name], flat, data,
                                           fwd.tile)) * 1e3
            print(f"  without the {name:15s}: {us:8.2f} us (the phase: "
                  f"{full - us:6.2f} us)", flush=True)
        shape = fe.bwd_launch_shape(cs.DIMS, cs.K)
        slots = torch.cuda.get_device_properties(0).multi_processor_count * (
            fe.bwd_resident_blocks(cs.DIMS, cs.K))
        for waves in (0.5, 1.0, 1.5, 2.0):
            B = int(waves * slots / cs.K) * shape.tile
            us = cs.device_ms(launcher(libs["kernel"], flat,
                                       inputs(B, flat, dev))) * 1e3
            print(f"  B={B:6d} ({k_blocks(B, shape):5d} blocks, "
                  f"{k_blocks(B, shape) / slots:.2f} waves of {slots}): "
                  f"{us:8.2f} us", flush=True)
        print(f"  B={cs.BATCH:6d} ({k_blocks(cs.BATCH, shape):5d} blocks, "
              f"{k_blocks(cs.BATCH, shape) / slots:.2f} waves)", flush=True)


if __name__ == "__main__":
    main()
