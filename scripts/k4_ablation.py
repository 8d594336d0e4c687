#!/usr/bin/env python3
"""Where K1's, K2's, K3's and K4's time goes: phase ablation, tiles and batch
sweeps on one NVIDIA card.

    python3 scripts/k4_ablation.py          # all sections
    python3 scripts/k4_ablation.py k1       # K1 only
    python3 scripts/k4_ablation.py k2       # K2 only
    python3 scripts/k4_ablation.py k3k4     # K3 and K4 only

No profiler that reads hardware counters is assumed. Instead the script
builds ``colvarsfinder_tpu_torch/csrc/fused_eigen.cu`` and ``kabsch.cu`` as
they are and copies with one phase removed (``_cuda.build_copies``), and
times each at the main path's shapes (B = 20,000; K3/K4: dims
[30,20,20,20,1], k = 2; K1/K2: 10 atoms, all align atoms). The time a
phase's removal saves is that phase's share. The copies compute wrong
results; only their time is read.

* K4: its hidden-layer forward, cotangent backprop and dW contraction; then
  K4 over batch sizes around one and two waves of resident blocks.
* K3: its tiles; its hidden-layer forward, the tanh of its hidden layers,
  its output layer, its in-block stats, and its whole body (which leaves
  the launch and the reduction launch).
* K2: the QCP solve (R taken as the normalized covariance, which keeps the
  covariance), the QCP call replaced by the identity (the compiler then
  drops the covariance too: the whole solve), and the whole body (the
  launch alone); its tiles and its direct variant; a batch sweep.
* K1: the whole body (the launch alone), the whole solve (QCP replaced by
  the identity), the normalization as nine divisions in place of one
  reciprocal; an early exit added to the Newton loop (its time, the step at
  which each frame's lam repeats, the frames where it changes bits, from
  copies that write lam in place of R, and the multiply-adds it makes nvcc
  fuse otherwise, from the PTX); its tiles; a batch sweep.

Device times are CUDA events, as in chip_smoke.py.
"""

from __future__ import annotations

import difflib
import functools
import re
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
# The Newton loop of csrc/qcp.cuh (shared by K1 and K2), and an early exit
# tried in its place: the lanes vote, and leave together once each lane's
# lam repeats the value of one step before (a fixed point) or of two steps
# before (a 2-cycle), step 16's value then chosen by the parity of the steps
# left. It is not in the kernels: it changes bits (k1_exactness).
NEWTON_LOOP = """\
    float lam = 2.0f * sqrtf(fro2);
#pragma unroll
    for (int it = 0; it < kNewtonIters; ++it) {
        const float p = ((lam * lam + c2) * lam + c1) * lam + c0;
        const float dp = (4.0f * lam * lam + 2.0f * c2) * lam + c1;
        lam = lam - p / (fabsf(dp) > 1e-12f ? dp : 1e-12f);
    }
"""
EXIT_LOOP = """\
    const unsigned solving = __activemask();
    float lam = 2.0f * sqrtf(fro2);
    float prev = lam;
#pragma unroll
    for (int it = 0; it < kNewtonIters; ++it) {
        const float p = ((lam * lam + c2) * lam + c1) * lam + c0;
        const float dp = (4.0f * lam * lam + 2.0f * c2) * lam + c1;
        const float next = lam - p / (fabsf(dp) > 1e-12f ? dp : 1e-12f);
        const unsigned bits = __float_as_uint(next);
        const bool repeats =
            bits == __float_as_uint(lam) || bits == __float_as_uint(prev);
        prev = lam;
        lam = next;
        if (__all_sync(solving, repeats)) {
            if ((kNewtonIters - 1 - it) & 1) lam = prev;
            break;
        }
    }
"""
WITH_EXIT = [("qcp.cuh", NEWTON_LOOP, EXIT_LOOP)]
R_LAST = "    R[8] = 1.0f - 2.0f * (x * x + y * y);\n"
# K1 (csrc/kabsch.cu kabsch_qcp_kernel), (file, old, new) edits
REMOVE_K1 = {
    "body": [("kabsch.cu", "    const float* ct = C + b0 * 9;\n",
              "    const float* ct = C + b0 * 9;\n    if (T > 0) return;\n")],
    "solve": [("kabsch.cu", "            cvf::qcp_rotation(c, r);\n",
               "            cvf::identity9(r);\n")],
    "reciprocal": [("kabsch.cu",
                    "            for (int i = 0; i < 9; ++i) c[i] *= inv;\n",
                    "            for (int i = 0; i < 9; ++i) c[i] = c[i] / norm;"
                    "\n")],
}
# copies that write in place of R: the early exit's step at which each
# frame's lam first repeats (R[0][0]: k for a fixed point, -k for a 2-cycle,
# 0 never) and its final lam (R[0][1]); the 16-step loop's lam after steps
# 8..16 (R[0][0]..R[2][2])
EXIT_TRACE = WITH_EXIT + [
    ("qcp.cuh", "    float prev = lam;\n",
     "    float prev = lam;\n    int steps = 0;\n"),
    ("qcp.cuh", "        prev = lam;\n",
     "        if (repeats && steps == 0)\n"
     "            steps = bits == __float_as_uint(lam) ? it + 1 : -(it + 1);\n"
     "        prev = lam;\n"),
    ("qcp.cuh", R_LAST,
     R_LAST + "    R[0] = (float)steps;\n    R[1] = lam;\n"),
]
FULL_TRACE = [
    ("qcp.cuh", "    float lam = 2.0f * sqrtf(fro2);\n",
     "    float trace[9];\n    float lam = 2.0f * sqrtf(fro2);\n"),
    ("qcp.cuh", "        lam = lam - p / (fabsf(dp) > 1e-12f ? dp : 1e-12f);\n",
     "        lam = lam - p / (fabsf(dp) > 1e-12f ? dp : 1e-12f);\n"
     "        if (it >= 7) trace[it - 7] = lam;\n"),
    ("qcp.cuh", R_LAST,
     R_LAST + "    for (int i = 0; i < 9; ++i) R[i] = trace[i];\n"),
]


def build(tmp: Path, source="fused_eigen", removals=None) -> dict:
    """The source as it is ("kernel") and one copy per removal of a line of
    the source, one nvcc each, all started together."""
    removals = REMOVE if removals is None else removals
    edits = {"kernel": []}
    for name, (old, new) in removals.items():
        edits[name] = [(f"{source}.cu", old, new)]
    return _cuda.build_copies(source, edits, tmp)


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


@functools.lru_cache(maxsize=1)
def _main_data():
    return cs.make_data(0)


def main_path_covariances(B):
    """Covariances of the main path's first B frames (chip_smoke's
    make_data(0), repeated past its 120,000 frames) with its reference, all
    atoms aligned, as chip_smoke phase 2 forms them."""
    ref, traj, _ = _main_data()
    x = np.concatenate([traj] * -(-B // len(traj)))[:B]
    xc = x - x.mean(1, keepdims=True)
    C = np.einsum("bmi,mj->bij", xc, ref - ref.mean(0))
    return torch.from_numpy(C.astype(np.float32))


def kabsch_launcher(lib, C, tile):
    R = torch.empty_like(C)

    def run():
        err = lib.cvf_kabsch_qcp(C.data_ptr(), R.data_ptr(), C.shape[0], tile,
                                 _cuda.stream_handle())
        _cuda.check(err, "cvf_kabsch_qcp")
        return R

    return run


def qcp_degenerate_covariances(n, seed=12):
    """Covariances whose QCP key matrix has its top two eigenvalues nearly
    equal (det < 0 with s2 ~ s3, or nearly collinear atoms), where the
    Newton loop converges slowly."""
    rng = np.random.default_rng(seed)
    svals = [(1.0, 0.5, -(0.5 - e)) for e in (1e-1, 1e-2, 1e-3, 1e-4)]
    svals += [(1.0, e, e) for e in (1e-2, 1e-3, 1e-4)]
    s = np.asarray(svals)[rng.integers(len(svals), size=n)]
    U, V = (np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
            for _ in range(2))
    C = np.einsum("bij,bj,bkj->bik", U, s, V)
    return torch.from_numpy(C.astype(np.float32))


def k1_exactness(libs, sets):
    """Frames where the early exit's rotation differs from the 16-step
    kernel's, and whether their lam differs."""
    tile = kc.KABSCH_TILE
    for label, C in sets:
        B = C.shape[0]
        full = kabsch_launcher(libs["kernel"], C, tile)().clone()
        ex = kabsch_launcher(libs["early exit"], C, tile)().clone()
        tr = kabsch_launcher(libs["exit trace"], C, tile)().clone()
        steps = tr[:, 0, 0].cpu().numpy().astype(int)
        lam_ex = tr[:, 0, 1].cpu().numpy()
        lam16 = kabsch_launcher(libs["full trace"], C, tile)().reshape(
            B, 9).cpu().numpy()
        diff = (full != ex).reshape(B, 9).any(1).cpu().numpy()
        lam_diff = lam_ex.view(np.uint32) != lam16[:, 8].view(np.uint32)
        err = float((full - ex).abs().max())
        print(f"  early exit, {label}: {int(diff.sum())} of {B} frames differ "
              f"from the 16-step kernel (max |dR| {err:.3e}); lam differs "
              f"from the 16-step loop's in {int(lam_diff.sum())} frames, "
              f"{int((diff & lam_diff).sum())} of them among those",
              flush=True)
        for b in np.flatnonzero(diff | lam_diff)[:6]:
            print(f"    frame {b}: repeats at step {steps[b]} (negative: a "
                  f"2-cycle), exit lam {lam_ex[b]:.9g}, 16-step lam after "
                  f"steps 8..16 {[f'{v:.9g}' for v in lam16[b]]}; max |dR| "
                  f"{float((full[b] - ex[b]).abs().max()):.3e}", flush=True)


def k1_float_ops(tmp: Path, copy: str) -> list:
    """The f32 arithmetic of K1's entry in the PTX of one copy that
    build_copies wrote under tmp, in order."""
    d = tmp / copy.replace(" ", "_")
    flags = [f for f in _cuda.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_cuda._nvcc(), *flags, "-ptx", "-I", str(_cuda.CSRC),
                    "-o", str(d / "kabsch.ptx"), str(d / "kabsch.cu")],
                   check=True)
    text = (d / "kabsch.ptx").read_text()
    start = text.index("kabsch_qcp_kernel", text.index(".entry"))
    body = text[start:text.index("\n}\n", start)]
    return re.findall(r"^\s+(fma\.rn\.f32|mul\.f32|add\.f32|sub\.f32|"
                      r"div\.rn\.f32)\s", body, re.M)


def k1_fusion(tmp: Path):
    """Where the early exit changes which multiply-adds nvcc fuses into one
    FMA: K1's PTX with and without it, split at the Newton loop (its first
    and last division)."""
    a, b = k1_float_ops(tmp, "kernel"), k1_float_ops(tmp, "early exit")
    for name, ops in (("16-step", a), ("early exit", b)):
        print(f"  K1 PTX, {name}: " + ", ".join(
            f"{ops.count(op)} {op}" for op in sorted(set(ops))), flush=True)
    lo = a.index("div.rn.f32")
    hi = len(a) - a[::-1].index("div.rn.f32")
    where = {"before the loop": 0, "in the loop": 0, "after the loop": 0}
    for tag, i1, i2, _, _ in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            key = ("before the loop" if i2 <= lo else
                   "after the loop" if i1 >= hi else "in the loop")
            where[key] += max(i2 - i1, 1)
    print(f"  f32 instructions of the 16-step build that the early exit "
          f"compiles otherwise: {where}", flush=True)


def k1_section(tmp: Path, dev):
    libs = _cuda.build_copies(
        "kabsch", {"kernel": [], **REMOVE_K1, "early exit": WITH_EXIT,
                   "exit trace": EXIT_TRACE, "full trace": FULL_TRACE}, tmp)
    tile = kc.KABSCH_TILE
    C = main_path_covariances(cs.BATCH).to(dev)
    full = cs.device_ms(kabsch_launcher(libs["kernel"], C, tile)) * 1e3
    print(f"K1 at B={cs.BATCH}, tile {tile} ({-(-cs.BATCH // tile)} blocks "
          f"of {tile} threads): {full:.2f} us", flush=True)
    for name in REMOVE_K1:
        us = cs.device_ms(kabsch_launcher(libs[name], C, tile)) * 1e3
        print(f"  without the {name:10s}: {us:8.2f} us (the phase: "
              f"{full - us:6.2f} us)", flush=True)
    us = cs.device_ms(kabsch_launcher(libs["early exit"], C, tile)) * 1e3
    print(f"  with the early exit: {us:8.2f} us (saves {full - us:6.2f} us)",
          flush=True)
    # each frame's Newton steps; a warp of 32 consecutive frames leaves the
    # loop at the step where its last lane repeats (16 if one never does)
    steps = kabsch_launcher(libs["exit trace"], C, tile)()[:, 0, 0]
    steps = steps.cpu().numpy().astype(int)
    at = np.where(steps == 0, 16, np.abs(steps))
    warp = at.reshape(-1, 32).max(1)
    for what, sel in (("a fixed point", steps > 0), ("a 2-cycle", steps < 0),
                      ("neither", steps == 0)):
        hist = np.bincount(at[sel], minlength=17)[1:]
        print(f"  frames whose lam repeats at {what}: {int(sel.sum())}, by "
              f"step 1..16: {hist.tolist()}", flush=True)
    print(f"  Newton steps a warp runs with the early exit: mean "
          f"{warp.mean():.2f} of 16, {np.mean(warp == 16) * 100:.1f}% of "
          "warps run all 16", flush=True)
    k1_exactness(libs, (("main path", C),
                        ("QCP-degenerate frames",
                         qcp_degenerate_covariances(20000).to(dev))))
    k1_fusion(tmp)
    # each tile twice, in turns, to show the spread between repeats
    for t in kc.KABSCH_TILES + kc.KABSCH_TILES[::-1]:
        us = cs.device_ms(kabsch_launcher(libs["kernel"], C, t)) * 1e3
        print(f"  tile {t:3d} ({-(-cs.BATCH // t):4d} blocks): {us:8.2f} us",
              flush=True)
    for B in (1_000, 5_000, 10_000, 20_000, 40_000, 80_000, 160_000):
        CB = main_path_covariances(B).to(dev)
        us = cs.device_ms(kabsch_launcher(libs["kernel"], CB, tile)) * 1e3
        print(f"  B={B:7d} ({-(-B // tile):5d} blocks): {us:8.2f} us "
              f"({2 * B * 9 * 4 / (us * 1e-6) / 1e12:.3f} TB/s of covariances "
              "in and rotations out)", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_ablation: needs an NVIDIA card")
    sections = sys.argv[1:] or ["k3k4", "k2", "k1"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    if "k1" in sections:
        with tempfile.TemporaryDirectory() as tmp:
            k1_section(Path(tmp), dev)
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
