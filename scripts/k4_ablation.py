#!/usr/bin/env python3
"""Where K2's, K3's and K4's time goes: phase ablation, tiles and batch
sweeps on one NVIDIA card.

    python3 scripts/k4_ablation.py          # all sections
    python3 scripts/k4_ablation.py k2       # K2 only
    python3 scripts/k4_ablation.py k3k4     # K3 and K4 only

No profiler that reads hardware counters is assumed. Instead the script
builds ``colvarsfinder_tpu_torch/csrc/fused_eigen.cu`` and ``kabsch.cu`` as
they are and copies with one phase removed, and times each at the main
path's shapes (B = 20,000; K3/K4: dims [30,20,20,20,1], k = 2; K2: 10 atoms,
all align atoms). The time a phase's removal saves is that phase's share.
The copies compute wrong results; only their time is read.

* K4: its hidden-layer forward, cotangent backprop and dW contraction; then
  K4 over batch sizes around one and two waves of resident blocks.
* K3: its tiles; its hidden-layer forward, the tanh of its hidden layers,
  its output layer, its in-block stats, and its whole body (which leaves
  the launch and the reduction launch).
* K2: the QCP solve (R taken as the normalized covariance, which keeps the
  covariance), the QCP call replaced by the identity (the compiler then
  drops the covariance too: the whole solve), and the whole body (the
  launch alone); its tiles and its direct variant; a batch sweep.

Device times are CUDA events, as in chip_smoke.py.
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
from colvarsfinder_tpu_torch.ops import kabsch_cuda as kc  # noqa: E402

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
# K2 (csrc/kabsch.cu): the line in frame_rotation that solves QCP (K1
# writes its own call as qcp_rotation(c, r)), and the staged kernel's last
# line before its loads
REMOVE_K2 = {
    "QCP": ("        cvf::qcp_rotation(c, R);\n",
            "        for (int i = 0; i < 9; ++i) R[i] = c[i];\n"),
    "solve": ("        cvf::qcp_rotation(c, R);\n",
              "        cvf::identity9(R);\n"),
    "body": ("    const float* xt = x + b0 * W;\n",
             "    const float* xt = x + b0 * W;\n    if (T > 0) return;\n"),
}


def build(tmp: Path, source="fused_eigen", removals=None) -> dict:
    """The source as it is ("kernel") and one copy per removal, one nvcc
    each, all started together."""
    removals = REMOVE if removals is None else removals
    src = (_cuda.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name in ("kernel", *removals):
        text = src
        if name in removals:
            old, new = removals[name]
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: line to replace not found once")
            text = text.replace(old, new)
        stem = f"{source}_" + name.replace(" ", "_")
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
        for fn, argtypes in _cuda._SIGNATURES[source].items():
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


def align_launcher(lib, B, shape, dev, seed=0):
    """K2 at the main path's frame: 10 atoms, all of them aligned."""
    rng = np.random.default_rng(seed)
    N = cs.N_ATOMS
    x = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)
                         ).to(dev)
    ref = torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32)
                           ).to(dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)

    def run():
        err = lib.cvf_fused_align(
            x.data_ptr(), ref.data_ptr(), idx.data_ptr(), out.data_ptr(), B,
            N, N, shape.tile, shape.smem_bytes, _cuda.stream_handle())
        _cuda.check(err, "cvf_fused_align")

    return run


def k2_section(tmp: Path, dev):
    libs = build(tmp, "kabsch", REMOVE_K2)
    N = cs.N_ATOMS
    main = kc.align_launch_shape(N, N)
    full = cs.device_ms(align_launcher(libs["kernel"], cs.BATCH, main,
                                       dev)) * 1e3
    print(f"K2 at B={cs.BATCH}, N={N}, tile {main.tile} "
          f"({main.blocks(cs.BATCH)} blocks of {main.threads} threads): "
          f"{full:.2f} us", flush=True)
    for name in REMOVE_K2:
        us = cs.device_ms(align_launcher(libs[name], cs.BATCH, main,
                                         dev)) * 1e3
        print(f"  without the {name:5s}: {us:8.2f} us (the phase: "
              f"{full - us:6.2f} us)", flush=True)
    # each tile twice, in turns, to show the spread between repeats
    for tile in (16, 32, 64, 128, 0, 128, 64, 32, 16):
        shape = (kc.AlignShape(tile, kc.STAGED_THREADS,
                               kc.align_smem_bytes(N, N, tile)) if tile
                 else kc.AlignShape(0, kc.DIRECT_THREADS, 0))
        us = cs.device_ms(align_launcher(libs["kernel"], cs.BATCH, shape,
                                         dev)) * 1e3
        what = f"tile {tile:3d}" if tile else "direct variant"
        print(f"  {what:14s} ({shape.blocks(cs.BATCH):4d} blocks of "
              f"{shape.threads} threads): {us:8.2f} us", flush=True)
    for B in (1_000, 5_000, 10_000, 20_000, 40_000, 80_000, 160_000):
        us = cs.device_ms(align_launcher(libs["kernel"], B, main, dev)) * 1e3
        print(f"  B={B:7d} ({main.blocks(B):5d} blocks): {us:8.2f} us "
              f"({2 * B * N * 3 * 4 / (us * 1e-6) / 1e12:.3f} TB/s of frames "
              "in and out)", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_ablation: needs an NVIDIA card")
    sections = sys.argv[1:] or ["k3k4", "k2"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    if "k2" in sections:
        with tempfile.TemporaryDirectory() as tmp:
            k2_section(Path(tmp), dev)
    if "k3k4" not in sections:
        return
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
