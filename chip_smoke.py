#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 1-5,13 # chosen phases, while iterating

``--phases`` runs phases 1-3 always, and with a chosen phase the phases it
takes results from (phase 4 for 5, 8-12, 14 and 15, phase 9 for 11); the
kernels line then counts the launches of the phases that ran.

Phases (each raises on failure; nothing is caught):

1. the card's name and power limit, the torch and CUDA versions, and the
   build of the CUDA kernels from ``colvarsfinder_tpu_torch/csrc``;
2. kernels K1-K6 against their plain PyTorch versions on the card, at the
   main path's shapes (B = 20,000 frames of 10 atoms, dims [30,20,20,20,1],
   k = 2; K5 on frames of CLN025's 93 atoms and all 4,278 pairs of them,
   PAIR_ATOMS), at a ragged B = 37 and at one sample past a multiple of
   K3's and K4's tiles (there with a seeded cotangent, see EDGE_B; it is
   one frame past a multiple of K1's tile too); K4 takes the head outputs Y
   that K3 returns, Y is held against the plain head outputs, and K3/K4
   must repeat bit for bit; K2 also on frames of the dipeptide's 22 atoms
   with 10 unsorted align indices; K1 also on a view 4 bytes into its
   buffer, a zero frame (exactly the identity) and frames with two nearly
   equal singular values; K6 (the quaternion layer's rotation solve) bit
   for bit equal to the plain chain, there and on zero, sub-1e-12,
   reflected, near-degenerate, huge and tiny frames and with 18 Newton
   steps;
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
   K4), held against the plain step with AlignmentLayer
   (method='quaternion') on the card, whose rotation solve is K6, itself
   held bit for bit against the same run aligned by align_frames, in
   PyTorch's own kernels alone (no launch); then a short run through
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
   torch.profiler;
8. export and deploy: phase 4's trained fused CV saved with export_cv=True
   (the first save traces its programs, a second one reuses them), both
   programs loaded on the card and run on 20,000 of phase 4's frames, K2
   launched once per call, the forward program's values equal to the live
   CV's bit for bit, the gradient program's Jacobian [20000, 2, 10, 3]
   against the live autograd Jacobian; the same directory loaded on the CPU
   (K2's plain version) against the card; the plain run's directory
   through the native C++ evaluator (built by g++ here) against the numpy
   evaluator, and through write_plumed_cv / write_plumed_metad, whose
   TorchScript model must agree with the CV; frames/s and device time per
   call of the programs, the live CV and the native evaluator;
9. the replica sweep, bench.py's workload (bench.py:255-305): the main
   path's task (plain step, 12 epochs) swept over an 8 x 8 grid of
   learning rates and alphas, R = 64 replicas with models from seeds
   0-63, through (a) AlignmentLayer('quaternion'), (b) FusedAlignmentLayer
   (K2 twice per step at any R) and (c) (b) in bfloat16 'pure'; each
   called twice, the second call timed: aggregate and device-window
   samples/s, the ratio to phase 4's solo steps, the busy share of one
   profiled epoch, peak memory, K2 per captured epoch, the bound of a
   sweep epoch, the task left untouched; replicas 0, 27 and 63 of (b)
   against their solo runs in float32 (the training bar where two correct
   float32 solo versions agree) and in float64 (every epoch); (c) against
   (b) (the replicas' order by final loss, and their final losses at the
   bf16 bar); an R = 8 sweep captured against eager, bit for bit, with K2
   per captured epoch equal to R = 64's; R = 4 sweeps of the generator
   (Gram), the committor, the AE and the RegAE (transfer) through K2, each
   replica against its solo run the same way;
10. streaming from host memory (``streaming=True``): the fused and the plain
   run streamed from phase 4's frames in RAM against phase 4's resident
   runs, and the fused run against its eager twin, bit for bit, with the
   resident launch schedule; bench.py's streaming workload (bench.py:
   308-350), a 4 GiB float32 memmap made as benchmarks/streaming_bench.py:
   40-68 makes it, batch 20,000, lag 5, test_ratio 1e-4, through (a) the
   plain step and (b) the fused step (K2, K3, K4): one warm call, then
   timed calls (one for (a), whose epoch takes seconds); samples/s beside
   phase 5's resident rates; per batch the gather's host ms, the copy's
   device ms and GB/s, the step's device ms, the calling thread's ms, the
   device busy share and the stage that sets the pace; peak device memory
   of (b) within 10% of the same run on the memmap's first 120,000 frames;
   pinned host memory; (b) with one and eight gather threads, prefetch 0
   and a float16 wire. The memmap is deleted at the end of the phase;
11. the data mesh (``mesh=``) at one rank of an NCCL group (``file://``
   init, ``make_data_mesh()``; NCCL puts no two ranks on one card): the
   main path's task with the plain step through FusedAlignmentLayer (K2),
   30 epochs captured, on the mesh against the same run without it, bit for
   bit (metric rows, parameters, K2 launches); the same step streamed, with
   and without the mesh, against that run, bit for bit; bench.py's R = 64
   sweep through
   K2 with ``mesh=`` against phase 9's (b), bit for bit. Beside each run:
   samples/s with and without the mesh, NCCL's kernels and their device
   microseconds per train step under torch.profiler (the gather of each
   batch and the gradient sum of each train step, inside the replayed
   graph), and graph replays per epoch;
12. the samplers (``utils/sampling.py``, ``utils/enhanced.py``), each report
   or deposition block one captured CUDA graph, at the examples' sizes:
   (a) overdamped Euler–Maruyama on TripleWellCircle (beta 8, 200,000
   steps, reports every 100) at 1 and 1,024 chains, (b) BAOAB at 1,024
   chains, (c) well-tempered metadynamics of 64 walkers along phase 4's
   trained fused CV (K2 in every step, forward and backward) on flattened
   frames in a harmonic well around phase 4's reference (4,000 steps, hills
   every 50), held over its first two deposition blocks against the same
   walkers through the CV rebuilt with AlignmentLayer('quaternion') within
   twice the gap of two plain versions ('svd' against 'quaternion'), (d) a
   steered pull and 16 umbrella windows along the triple well's angle
   (30,000 steps each), then MBAR, (e) replica exchange (betas 8, 4, 2,
   0.8, 200,000 steps). Each run against its eager twin bit for bit over
   its first blocks; chain-steps/s over the call's wall time (and without
   its output files), the fixed seconds per call and the steady time per
   block, and under torch.profiler the device time, activities and graph
   replays per block and the busy share; K2 launches per step for (c);
13. MD trajectory input, the reference's workflow (examples/dipeptide.py:
   214-246): a 22-atom ACE-ALA-NME topology written with write_gro and
   1,000,000 frames made from seed 0 written with write_xtc as a restart
   chain of two files of 500,000 frames at 1 ps; Universe(gro, [a, b]) (both
   files through the native decoder built from native/fastio.cpp),
   select_atoms of the 10 heavy atoms, WeightedTrajectory with seeded
   weights, and phase 4's fused task (K2, K3, K4) on them, 4 epochs
   captured. Held: the native decode bit for bit the pure-Python decoder on
   each file's first 2,000 frames; every frame within half an XTC step of
   the frame written; segment_starts [0, 500000] and dt from the files; the
   Universe-fed run bit for bit its twin on the array branch (the decoded
   array, the same weights, segment_starts and seed); launches per train
   step as phase 4's; backbone_dihedrals' phi/psi and their FeatureLayer on
   the card against the CPU on 20,000 frames. Seconds to write each file
   and its MB, decode frames/s and MB/s, WeightedTrajectory seconds and
   training samples/s beside the card's name. Nothing is cut: on an H100
   the phase takes about 13 s;
14. analysis, autotune and the adaptive loop on phase 4's task: (a)
   ``tune.autotune`` over the plain step, the fused step (K2, K3, K4), K1's
   weighted route, bf16 activations and TF32 matmuls, reps 2: no variant
   skipped, the config restored, each variant's launches per batch equal
   to phase 4's for its route, the fused step ranked above the plain one;
   (b) ``workflow.adaptive_cv_discovery`` in phase 12's harmonic well
   along phase 4's fused task (flat states), three rounds with warm starts
   and the first two again: K2 per metadynamics step by phase 12's rule,
   training launches per batch as phase 4's, ``segment_starts`` the
   cumulative segment lengths, each segment's weights of mean one, every
   warm start bit for bit the previous round's trained parameters, the
   rerun bit for bit; (c) ``analysis.cv_sensitivity`` of phase 4's fused
   CV on 20,000 frames (K2 once a chunk) against the same heads behind the
   quaternion layer on the card and against the CPU, within K2's gradient
   bar; (d) the host battery (validate_cv, tica, msm with pcca and mfpt,
   msm_ck_test, free_energy_profile with a bootstrap) on phase 4's CV
   values, timed;
15. ``mesh=`` of the four enhanced samplers at one rank of an NCCL group
   (a fresh ``file://`` rendezvous): (a) phase 12 (c)'s metadynamics of
   64 walkers along phase 4's fused CV (K2 in every step), cut to 1,000
   steps; (b) 16 umbrella windows along the triple well's angle, then
   MBAR, and (c) 16 steered pulls, both cut to 5,000 steps; (d) replica
   exchange on phase 12 (e)'s
   ladder, exchanges every 200 steps. Each runs meshed and unmeshed with
   the same seed, bit for bit (arrays and output files), timed, with the
   meshed call's graph replays per block; a short meshed call of each
   under torch.profiler gives the NCCL kernels and device copies of its
   final all-gather (and each exchange's, beside the same call unmeshed);
   the meshed replica exchange's first blocks (its all-gather inside each
   captured exchange block) bit for bit its eager twin.

The second-to-last line lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import gc
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
# K5 on the CLN025 cell's frames: 93 heavy atoms, all pairs
PAIR_ATOMS = 93

# H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the CPU tests' tolerances, kernel against plain version
TOL = {
    "kabsch_qcp": dict(atol=2e-5, rtol=0.0),
    "fused_align": dict(atol=2e-4, rtol=0.0),
    "stats_fwd": dict(atol=1e-4, rtol=5e-6),
    "stats_bwd": dict(atol=1e-3, rtol=2e-3),
    "pair_distances": dict(atol=1e-6, rtol=3e-7),
    # K6 repeats the plain chain's operations in PyTorch's order: every bit
    "kabsch_exact": dict(atol=0.0, rtol=0.0),
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
# phase 8: the exported gradient program evaluates the batch stacked k times
# (so its values part from the live CV's in the last bits), and its Jacobian
# is held against the live autograd Jacobian relative to the largest entry;
# the CPU program runs K2's plain version, within K2's bar of the card's
EXPORT_VALUE_ATOL = 2e-6
EXPORT_JAC_RTOL = 1e-5
# the native evaluator (float64) against the numpy evaluator (float64)
NATIVE_ATOL = 1e-8
# the vjp and Gram steps of the RegAE's generator regularizer against each
# other in float64: on these frames the step amplifies rounding ~6e4-fold
# (float32 gradients sit ~3.6e-3 of their scale from float64's), so
# float64's 1.1e-16 becomes ~7e-12; 1e-9 leaves two orders of margin
F64_STEP_RTOL = 1e-9

# phase 9: bench.py's sweep workload (bench.py:255-305): R = 64 replicas
# of the main path's task, 12 epochs, an 8 x 8 grid of learning rates and
# alphas, replica r's model from seed r; the replicas held against their
# solo runs, the bf16 sweep against the float32 one at the JAX package's
# bf16 bar (tests/test_compute_dtype.py:144,172), a narrower sweep captured
# against eager, and R = 4 sweeps of the other families
SWEEP_R, SWEEP_SIDE, SWEEP_EPOCHS, SWEEP_NARROW = 64, 8, 12, 8
SWEEP_HELD = (0, 27, 63)
SWEEP_BF16_TOL = dict(rtol=0.1, atol=0.05)
# JAX's bf16 bar comes from a 3-epoch toy; at bench.py's scale a
# replica's bf16 run may leave its float32 run's basin (the JAX package's
# bf16 trajectories part by a median 33%, max 48% on hardware,
# benchmarks/RESULTS.md:593-598). Held per sweep: the replicas' order by
# final loss (Spearman correlation with the float32 sweep) and the share of
# replicas whose final-epoch loss is within SWEEP_BF16_TOL
SWEEP_BF16_RANK, SWEEP_BF16_SHARE = 0.9, 0.9
# sweep replicas against their solo runs in float64 over every epoch:
# replica 63's two correct float32 solo versions part by 9.7e-2 after its
# loss blows up in epoch 4 (PERF.md §6, PR 12), ~1.6e6 float32 roundings,
# so float64's ~1e-16 grows to ~2e-10; 1e-8 leaves margin (a run whose
# float32 versions part further gets 100 x that gap x 2**-29)
SWEEP_F64_RTOL = 1e-8
FAMILY_R, FAMILY_EPOCHS = 4, 3

# phase 10: bench.py's streaming workload (bench.py:308-350): the
# main path's task with streaming=True on a 4 GiB float32 memmap of [n, 10,
# 3] frames made as benchmarks/streaming_bench.py:40-68 makes it (seed 0),
# batch 20,000, lag 5, test_ratio 1e-4; the streamed run's peak device
# memory there within 10% of the same run on the memmap's first N_FRAMES
# frames
STREAM_GIB, STREAM_TEST_RATIO, STREAM_MEMORY_RTOL = 4.0, 1e-4, 0.10
# phase 11: the meshed runs' NCCL kernels (a W = 1 group runs NCCL's
# one-rank reduce kernel, a W > 1 group its ncclDevKernel_*), found by name
NCCL_KERNEL_NAMES = ("nccl", "onerank")
# phase 12: the samplers at the examples' sizes. (a) overdamped EM and (b)
# BAOAB on TripleWellCircle at beta 8, 200,000 steps
# (examples/enhanced_sampling.py:40-52,69-80), reports every 100 steps,
# one chain and 1,024; (c) well-tempered metadynamics of 64 walkers along
# phase 4's trained fused CV on flattened frames in a harmonic well around
# phase 4's reference, at examples/adaptive_umbrella.py:63-78's settings
# (hills every 50 steps of 0.005, height 0.6, bias factor 8, width 0.35 CV
# standard deviations, colvarsfinder_tpu/workflow.py:280,303), its 40,000
# steps cut to 4,000: through K2's backward (the plain alignment's recorded
# vjp) a step runs ~2,500 kernels; (d) a steered
# pull and 16 umbrella windows seeded by it along the triple well's angle,
# 30,000 steps each (examples/adaptive_umbrella.py:114-138), then MBAR;
# (e) replica exchange at examples/replica_exchange.py:65-70's ladder
SAMPLER_BETA, SAMPLER_STEPS, SAMPLER_REPORT, SAMPLER_DT = 8.0, 200_000, 100, 1e-3
SAMPLER_CHAINS, BAOAB_FRICTION = 1024, 1.0
METAD_WALKERS, METAD_STEPS, METAD_DEPOSIT, METAD_DT = 64, 4_000, 50, 5e-3
METAD_BETA, METAD_KAPPA = 1.0, 1.0 / 0.09
METAD_HEIGHT, METAD_WIDTH_STD, METAD_GAMMA = 0.6, 0.35, 8.0
UMB_WINDOWS, UMB_STEPS, UMB_PRE, UMB_DT = 16, 30_000, 3_000, 3e-3
UMB_REPORT, PULL_REPORT, UMB_RANGE = 20, 50, (-2.5, 2.5)
REMD_BETAS, REMD_STEPS, REMD_DT = (8.0, 4.0, 2.0, 0.8), 200_000, 4e-3
REMD_REPORT, REMD_EXCHANGE = 20, 200
# blocks of each captured run held bit for bit against its eager twin; blocks
# of each short (timed, then profiled) call
TWIN_BLOCKS, PROFILE_BLOCKS, METAD_PROFILE_BLOCKS = 3, 4, 2
# (c) is profiled over two deposition blocks of 10 steps (a block of 50
# steps is ~127,000 kernel events), its device time scaled to 50 steps
METAD_PROFILE_DEPOSIT = 10
# chains whose files are written again to time a call's output files
WRITE_CHAINS = 128
# (c) against the same walkers through the CV rebuilt with the quaternion
# layer over the first METAD_HELD_BLOCKS deposition blocks, relative to
# each array's largest magnitude: within twice the gap of two plain
# versions of the run (the svd layer against the quaternion layer, measured
# in the same call), and never below METAD_RTOL_FLOOR (8 float32 ulps)
METAD_HELD_BLOCKS, METAD_RTOL_FLOOR = 2, 1e-6
# phase 15: phase 12's samplers with mesh= at one rank, cut to fit 45 s:
# (a) metadynamics 4,000 -> 1,000 steps (20 depositions), (b) umbrella
# and (c) steered 30,000 -> 5,000 steps, (d) replica exchange 200,000 ->
# 20,000 steps (100 exchanges); the profiled calls: (a) two deposition
# blocks of one step, (b) PROFILE_BLOCKS report blocks, (c) two blocks of
# 20 steps, (d) MESH_REMD_EXCHANGES exchanges, one every other block
MESH_METAD_STEPS, MESH_UMB_STEPS, MESH_REMD_STEPS = 1_000, 5_000, 20_000
MESH_REMD_EXCHANGES = 2

# phase 13: the reference's MD workflow (examples/dipeptide.py:214-246,
# SURVEY.md row 11): a 22-atom ACE-ALA-NME topology (the atoms and residues
# of examples/dipeptide.py:55-100), 1,000,000 frames at 1 ps (1 us, the
# upper end of SURVEY.md:395's 1e5-1e6 frames) written as a restart chain
# of two XTC files of 500,000 frames each; the heavy atoms are make_data's
# noise around the topology's reference, the hydrogens ride on their heavy
# atoms with small noise. XTC stores 0.001 nm steps, so a frame read back
# is within half a step (plus float32 rounding) of the frame written
MD_FILES, MD_FRAMES_PER_FILE, MD_DT_PS, MD_PRECISION = 2, 500_000, 1.0, 1000.0
MD_H_NOISE, MD_EPOCHS, MD_PY_FRAMES, MD_FEATURE_FRAMES = 0.01, 4, 2_000, 20_000
MD_FEATURE_ATOL = 1e-6
MD_NAMES = ["HH31", "CH3", "HH32", "HH33", "C", "O",
            "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O",
            "N", "H", "CH3", "HH31", "HH32", "HH33"]
MD_RESIDS = [1] * 6 + [2] * 10 + [3] * 6
MD_RESNAMES = ["ACE"] * 6 + ["ALA"] * 10 + ["NME"] * 6
# the Ramachandran quadruples of the full topology (examples/dipeptide.py:
# 48-49)
MD_PHI, MD_PSI = (4, 6, 8, 14), (6, 8, 14, 16)

# phase 14: the analysis and driver slice. (a) autotune on phase 4's task,
# TUNE_EPOCHS a train() call, reps 2: the plain step, the fused step (K2,
# K3, K4), K1's route (phase 4's weighted alignment), bf16 activations and
# TF32 matmuls; (b) adaptive_cv_discovery in phase 12's harmonic well along
# phase 4's fused task (flat states, batches of WF_BATCH), three rounds with
# warm starts at phase 12's metadynamics settings (hills every 50 steps of
# 0.005, height 0.6, bias factor 8), cut to WF_UNBIASED unbiased and
# WF_METAD biased steps a round (a biased step runs ~2,500 kernels); (c)
# cv_sensitivity of phase 4's fused CV on SENS_FRAMES frames, against the
# plain quaternion layer on the card and against the CPU within K2's
# gradient bar (tests/test_torch_alignment.py GRAD_TOL: rtol 1e-3, atol
# 1e-4 of the largest entry); (d) the host battery on phase 4's CV values
TUNE_EPOCHS, TUNE_REPS = 3, 2
TUNE_VARIANTS = ({}, {"fused_step": True},
                 {"method": "cuda", "fused_step": True},
                 {"compute_dtype": "bfloat16"},
                 {"matmul_precision": "default"})
WF_ROUNDS, WF_UNBIASED, WF_METAD, WF_EPOCHS, WF_BATCH = 3, 20_000, 1_500, 4, 100
SENS_FRAMES, SENS_BATCH = 20_000, 8192
SENS_RTOL, SENS_ATOL = 1e-3, 1e-4

# the fused run's settings tried besides the defaults (one call each)
STREAM_VARIANTS = (("1 gather thread", dict(stream_transfer_workers=1)),
                   ("8 gather threads", dict(stream_transfer_workers=8)),
                   ("prefetch 0", dict(stream_prefetch=0)),
                   ("float16 wire", dict(stream_wire_dtype="float16")))

KERNELS = {
    "kabsch_qcp": ("colvarsfinder_tpu_torch/csrc/kabsch.cu",
                   "colvarsfinder_tpu/ops/kabsch_pallas.py:48"),
    "fused_align": ("colvarsfinder_tpu_torch/csrc/kabsch.cu",
                    "colvarsfinder_tpu/ops/kabsch_pallas.py:140"),
    "stats_fwd": ("colvarsfinder_tpu_torch/csrc/fused_eigen.cu",
                  "colvarsfinder_tpu/ops/fused_eigen.py:146"),
    "stats_bwd": ("colvarsfinder_tpu_torch/csrc/fused_eigen.cu",
                  "colvarsfinder_tpu/ops/fused_eigen.py:230"),
    # no TPU kernel: there each bond is its own XLA computation
    "pair_distances": ("colvarsfinder_tpu_torch/csrc/pair_distances.cu",
                       "colvarsfinder_tpu/ops/features.py:310"),
    # no TPU kernel: there XLA fuses the quaternion chain
    "kabsch_exact": ("colvarsfinder_tpu_torch/csrc/kabsch_exact.cu",
                     "colvarsfinder_tpu/ops/alignment.py:102"),
}


def eager_twin(on: bool = True, blocks=None):
    """Every captured program run eagerly inside, when ``on``: a captured
    run's eager twin (``graphs.eager``; ``blocks=m`` also stops a sampler
    after m report blocks)."""
    from colvarsfinder_tpu_torch import graphs

    return graphs.eager(blocks) if on else contextlib.nullcontext()


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


def k6_cases(C, dev):
    """K6 against the plain chain, every bit, beyond the main path's
    shapes: zero and sub-1e-12 frames, reflected, near-degenerate, huge and
    tiny scales, and 18 Newton steps (``newton_diff_mode(2)``)."""
    from colvarsfinder_tpu_torch.ops.alignment import (
        kabsch_rotations_quat,
        newton_diff_mode,
    )
    from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
        NEWTON_ITERS,
        kabsch_exact_launch,
    )

    zero = C[:EDGE_B].clone()
    zero[0] = 0.0
    zero[1] *= 1e-13
    near = torch.from_numpy(near_degenerate_covariances(4096)).to(dev)
    for what, Ck, extra in (("zero and sub-1e-12 frames", zero, 0),
                            ("reflected frames", -C, 0),
                            ("near-degenerate frames", near, 0),
                            ("frames scaled by 1e15", 1e15 * C, 0),
                            ("frames scaled by 1e-10", 1e-10 * C, 0),
                            ("18 Newton steps", C, 2)):
        got = kabsch_exact_launch(Ck.contiguous(), NEWTON_ITERS + extra)
        with newton_diff_mode(extra):
            want = kabsch_rotations_quat(Ck)
        torch.cuda.synchronize()
        check_close("kabsch_exact", got, want)
        log(f"  kabsch_exact B={Ck.shape[0]:6d}, {what}: bit for bit equal "
            "to the plain chain")
    if not torch.equal(kabsch_exact_launch(zero, NEWTON_ITERS)[0],
                       torch.eye(3, device=dev)):
        raise AssertionError("K6: a zero frame is not exactly the identity")


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
    from colvarsfinder_tpu_torch.ops.features import pair_distances
    from colvarsfinder_tpu_torch.ops.kabsch_cuda import (
        KABSCH_TILE,
        NEWTON_ITERS,
        AlignShape,
        align_launch_shape,
        align_resident_blocks,
        fused_align_launch,
        kabsch_exact_launch,
        kabsch_qcp_launch,
        kabsch_resident_blocks,
    )
    from colvarsfinder_tpu_torch.ops.pair_cuda import pair_distances_launch

    ref = torch.from_numpy(ref_np - ref_np.mean(0)).to(dev)
    # K5's frames: a seeded structure of PAIR_ATOMS atoms, perturbed
    gen = torch.Generator().manual_seed(PAIR_ATOMS)
    x_pairs = (torch.randn(PAIR_ATOMS, 3, generator=gen) * 1.5
               + 0.3 * torch.randn(BATCH, PAIR_ATOMS, 3, generator=gen)
               ).to(dev)
    pairs = torch.triu_indices(PAIR_ATOMS, PAIR_ATOMS, offset=1,
                               device=dev).T.to(torch.int32).contiguous()
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
        Xp = x_pairs[:B]
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
            "pair_distances": (lambda: pair_distances_launch(Xp, pairs),
                               lambda: pair_distances(Xp, pairs)),
            "kabsch_exact": (lambda: kabsch_exact_launch(C, NEWTON_ITERS),
                             lambda: kabsch_rotations_quat(C)),
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
            # frames in once, distances out once (the pair list stays in
            # L2); 3 subtractions, 3 products, 2 sums and a root a pair
            "pair_distances": (4 * B * (3 * PAIR_ATOMS + len(pairs)),
                               9 * B * len(pairs)),
            # K1's work, without FMAs
            "kabsch_exact": (2 * B * 9 * 4, B * (16 * 12 + 450)),
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
    k6_cases(C_main, dev)

    k1 = results["kabsch_qcp"]["ms"] * 1e3
    log(f"  K1 {k1:.2f} us (before its redesign: {K1_BEFORE_US} us)")
    log(f"  K6 {results['kabsch_exact']['ms'] * 1e3:.2f} us, every bit the "
        f"plain chain's ({results['kabsch_exact']['plain_ms'] * 1e3:.2f} us "
        "of its kernels)")
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
              save_every=0, align_weights=None, model_seed=0, lr=LR,
              alpha=ALPHA, test_ratio=TEST_RATIO, dt=DT, batch=BATCH,
              flat=False, **kw):
    if method == "fused":
        align = cvf.FusedAlignmentLayer(ref, list(range(N_ATOMS)))
    elif method == "plain chain":
        # the quaternion layer's alignment as align_frames computes it, in
        # PyTorch's own kernels alone: the reference of the K6 route
        from colvarsfinder_tpu_torch.ops.alignment import align_frames

        layer = cvf.AlignmentLayer(ref, list(range(N_ATOMS)),
                                   align_weights=align_weights)
        align = cvf.ops.Lambda(lambda x: align_frames(
            x, layer.ref_centered, layer.align_idx, layer.align_weights))
        align.layer = layer  # moves with the model
    else:
        align = cvf.AlignmentLayer(ref, list(range(N_ATOMS)), method=method,
                                   align_weights=align_weights)
    if flat:
        # states of the samplers, [B, 3 N]: frames again before aligning
        align = torch.nn.Sequential(
            cvf.ops.Lambda(lambda x: x.reshape(x.shape[0], N_ATOMS, 3)),
            align)
    pp = cvf.PreprocessingANN(
        align,
        cvf.FeatureLayer([cvf.Feature("p", "position",
                                      list(range(N_ATOMS)))]),
    )
    return cvf.EigenFunctionTask(
        traj_obj, pp, cvf.EigenFunctions(list(DIMS), K, seed=model_seed),
        path, alpha=alpha, eig_weights=EIG_W, lag_tau=LAG * dt,
        learning_rate=lr, save_model_every_step=save_every, k=K,
        batch_size=batch, num_epochs=epochs, test_ratio=test_ratio,
        verbose=False, tensorboard=False, seed=0, debug_mode=False,
        fused_step=fused, progress_interval=1, **kw,
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
            ("plain ref", False, "plain chain", EPOCHS),
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
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            # the comparison run: every epoch eager
            with eager_twin(label == "fused eager"):
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
            # every batch's metric row and the final parameters, which
            # phase 10's streamed runs must equal
            runs[label] = dict(task=task, counts=counts, wall=wall,
                               sps=sps, epochs=epochs,
                               rows=loss_rows(task),
                               params=[p.detach().clone()
                                       for p in task.model.parameters()])
            if (not task._graphs) != (label == "fused eager"):
                raise AssertionError(f"{label}: captured graph "
                                     f"{bool(task._graphs)}")
            log(f"  {label:11s}: {epochs} epochs in {wall:.2f} s, loss "
                f"{loss[0]:.5f} -> {loss[-1]:.5f}, eig_1 "
                f"{task.train_loss[-1, 3]:.4f}; launches {counts}")
            if label == "plain":
                check_scripted_cv(task, f"{tmp}/{label}/latest", traj_np)

    # the schedule: per epoch nb_train steps and nb_test test batches; each
    # batch aligns X and X_l (K2, K1, or the quaternion layer's K6; the
    # plain reference launches nothing) and, with the fused step, computes
    # the stats (K3); each fused train step runs the stats backward (K4)
    for label, align_kernel in (("fused", "fused_align"),
                                ("fused eager", "fused_align"),
                                ("k1", "kabsch_qcp"),
                                ("k1 plain", "kabsch_exact"),
                                ("plain", "kabsch_exact"),
                                ("plain ref", None)):
        r = runs[label]
        e = r["epochs"]
        want = dict.fromkeys(r["counts"], 0)
        if align_kernel:
            want[align_kernel] = 2 * e * (nb_train + nb_test)
        if not label.startswith("plain"):
            want.update(stats_fwd=e * (nb_train + nb_test),
                        stats_bwd=e * nb_train)
        if r["counts"] != want:
            raise AssertionError(f"{label}: launches {r['counts']}, the "
                                 f"schedule implies {want}")

    # the K6 route against PyTorch's own kernels: bit for bit
    k6, chain = runs["plain"], runs["plain ref"]
    same = np.array_equal(k6["rows"], chain["rows"]) and all(
        torch.equal(a, b) for a, b in zip(k6["params"], chain["params"]))
    log(f"  plain (K6) vs plain ref (align_frames), {EPOCHS} epochs: every "
        f"batch's metric row and every final parameter bit for bit equal: "
        f"{same}")
    if not same:
        raise AssertionError("the plain route through K6 differs from the "
                             "plain chain")

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


def loss_rows(task):
    """Every batch's metric row of every epoch, train then test."""
    return np.stack([np.concatenate(epoch) for epoch in task.loss_list])


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
                   method="fused", **kw):
    """A generator EigenFunctionTask (``gen_*``) or a CommittorTask
    (``com_*``) through FusedAlignmentLayer and position features, on the
    Gram path unless ``kind`` ends in ``vjp``; ``method`` other than
    'fused' takes AlignmentLayer(method=method); ``kw`` overrides the
    task's arguments."""
    atoms = list(range(N_ATOMS))
    align = (cvf.FusedAlignmentLayer(ref, atoms) if method == "fused"
             else cvf.AlignmentLayer(ref, atoms, method=method))
    pp = cvf.PreprocessingANN(
        align, cvf.FeatureLayer([cvf.Feature("p", "position", atoms)]))
    args = dict(learning_rate=LR, save_model_every_step=0,
                batch_size=BATCH, num_epochs=epochs, test_ratio=TEST_RATIO,
                verbose=False, tensorboard=False, seed=0, debug_mode=False,
                progress_interval=1, diag_coeff=GEN_DIAG, beta=GEN_BETA,
                gram_pp=not kind.endswith("vjp"), alpha=ALPHA)
    args.update(kw)
    if kind.startswith("gen"):
        return cvf.EigenFunctionTask(
            traj_obj, pp, cvf.EigenFunctions(list(DIMS), K, seed=0), path,
            eig_weights=EIG_W, lag_tau=0.0, k=K,
            gram_dtype="bfloat16" if kind == "gen_bf16" else None, **args)
    return cvf.CommittorTask(
        traj_obj, pp, cvf.create_sequential_nn(list(DIMS), seed=0), path,
        region_a=regions[0], region_b=regions[1], **args)


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


def committor_regions(ref, traj_np):
    """The committor's sets A and B: the frames below and above the
    COMMITTOR_Q quantiles of the first aligned coordinate."""
    from colvarsfinder_tpu_torch.ops.alignment import align_frames

    dev = torch.device("cuda")
    with torch.no_grad():
        first = align_frames(torch.from_numpy(traj_np).to(dev),
                             torch.from_numpy(ref - ref.mean(0)).to(dev),
                             torch.arange(N_ATOMS, device=dev))[:, 0, 0]
    c = first.cpu().numpy()
    lo, hi = np.quantile(c, COMMITTOR_Q)
    regions = (c < lo, c > hi)
    log(f"  committor regions: {int(regions[0].sum())} frames in A, "
        f"{int(regions[1].sum())} in B")
    return regions


def phase_dirichlet(card, ref, traj_np, w_np, cvf):
    """Phase 6: the generator and the committor on phase 4's frames."""
    from colvarsfinder_tpu_torch.ops import _cuda

    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    regions = committor_regions(ref, traj_np)
    runs, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("gen_gram", "gen_vjp", "gen_bf16", "com_gram",
                     "com_vjp"):
            pair = []
            for eager in (False, True):
                label = kind + (" eager" if eager else "")
                task = make_dirichlet(cvf, kind, traj_obj, ref,
                                      f"{tmp}/{label}", EPOCHS, regions)
                torch.cuda.synchronize()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                data = task._prepare_data()
                torch.cuda.synchronize()
                prep_s = time.perf_counter() - t0
                prep_counts = _cuda.launch_counts()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                with eager_twin(eager):
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
                if (not task._graphs) != eager:
                    raise AssertionError(f"{label}: captured graph "
                                         f"{bool(task._graphs)}")
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
            save_every=0, align_weights=None, seed=0, **hyper):
    """An AutoEncoderTask (``ae``) or a RegAutoEncoderTask with all six
    terms: transfer regularizer (``reg``, ``freeze`` with the encoder
    frozen) or generator regularizer on the Gram or vjp path (``gen_gram``,
    ``gen_vjp``); the alignment is FusedAlignmentLayer, or
    AlignmentLayer(method=method); the model's weights from ``seed``;
    ``hyper`` overrides the learning rate and term weights."""
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
                                   **{**args, **hyper})
    gen = kind.startswith("gen")
    return cvf.RegAutoEncoderTask(
        traj_obj, pp, cvf.RegAutoEncoder(*AE_DIMS, AE_REG_DIMS, K, seed=seed),
        path, lag_tau_ae=LAG * DT, lag_tau_reg=0.0 if gen else LAG * DT,
        gram_pp=(kind == "gen_gram") if gen else None,
        freeze_encoder=kind == "freeze", **{**REG_TERMS, **args, **hyper})


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
    with eager_twin(eager):
        task.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    tl = task.train_loss
    if not np.isfinite(tl).all():
        raise AssertionError(f"{label}: non-finite training metrics")
    if epochs > 2 and not tl[-1, 0] < tl[0, 0]:
        raise AssertionError(f"{label}: loss did not fall: {tl[:, 0]}")
    if (not task._graphs) != eager:
        raise AssertionError(f"{label}: captured graph "
                             f"{bool(task._graphs)}")
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
                               {"fused_align": 1 if fused else 0,
                                "kabsch_exact": 0 if fused else 1})
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
                    "fused_align" if fused else "kabsch_exact":
                    per_batch * epochs * nb})
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
                           {"kabsch_qcp" if method == "cuda" else
                            "kabsch_exact": 1})
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


def host_ms(fn, calls=5):
    """Wall time of one call that ends in a synchronize, median of
    ``calls`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


def live_jacobian(cv, x):
    """The live CV and its input Jacobian by autograd: one reverse pass per
    output."""
    xt = x.detach().requires_grad_()
    y = cv(xt)
    rows = [torch.autograd.grad(y[:, i].sum(), xt, retain_graph=True)[0]
            for i in range(y.shape[1])]
    return y.detach(), torch.stack(rows, dim=1)


def phase_export(card, runs, traj_np, cvf):
    """Phase 8: export and deploy the trained main-path CV."""
    from colvarsfinder_tpu_torch.ops import _cuda

    fused, plain = runs["fused"]["task"], runs["plain"]["task"]
    out = {"card": card}
    x = torch.from_numpy(traj_np[:BATCH]).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        fused.model_path = plain.model_path = tmp
        saves = []
        for description in ("fused", "fused again"):
            t0 = time.perf_counter()
            fused.save_model(EPOCHS, description)
            saves.append(time.perf_counter() - t0)
        out["save_model_s"] = {"first (traced)": saves[0],
                               "again (cached)": saves[1]}
        log(f"  save_model with export_cv=True: first {saves[0]:.2f} s "
            f"(traces both programs), again {saves[1]:.3f} s (cached)")
        fdir = f"{tmp}/fused"
        names = sorted(os.listdir(fdir))
        log(f"  fused: latest/ holds {names}")
        for name in ("cv_exported.bin", "cv_grad_exported.bin"):
            if name not in names:
                raise AssertionError(f"save_model wrote no {name}")
            if (open(f"{fdir}/{name}", "rb").read()
                    != open(f"{tmp}/fused again/{name}", "rb").read()):
                raise AssertionError(f"{name} differs between the saves")
        t0 = time.perf_counter()
        fwd = cvf.load_colvar(fdir)
        grad = cvf.load_colvar(fdir, with_grad=True)
        out["load_colvar_s"] = time.perf_counter() - t0
        cv = fused.colvar_model()

        launches = {}
        for label, fn in (("forward", lambda: fwd(x)),
                          ("gradient", lambda: grad(x))):
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            got = fn()
            torch.cuda.synchronize()
            launches[label] = _cuda.launch_counts()
            want = dict.fromkeys(_cuda.LAUNCHES, 0)
            want["fused_align"] = 1
            if launches[label] != want:
                raise AssertionError(f"{label} program launched "
                                     f"{launches[label]}, want {want}")
            if label == "forward":
                value = got
            else:
                gval, gjac = got
        out["launches_per_call"] = {k: v["fused_align"]
                                    for k, v in launches.items()}
        live, live_jac = live_jacobian(cv, x)
        if gjac.shape != (BATCH, K, N_ATOMS, 3):
            raise AssertionError(f"Jacobian shape {tuple(gjac.shape)}")
        if not (torch.isfinite(gval).all() and torch.isfinite(gjac).all()):
            raise AssertionError("non-finite program output")
        same = torch.equal(value, live)
        val_err = max_err(gval, live)
        scale = float(live_jac.abs().max())
        jac_err = max_err(gjac, live_jac)
        log(f"  programs on the card, {BATCH} frames: K2 launches per call "
            f"{out['launches_per_call']}; forward == live CV bit for bit: "
            f"{same}; gradient program values {val_err:.3e} from it "
            f"(tolerance {EXPORT_VALUE_ATOL}), Jacobian "
            f"{tuple(gjac.shape)} {jac_err:.3e} from the live autograd "
            f"Jacobian, of its largest entry {scale:.3e} (tolerance "
            f"{EXPORT_JAC_RTOL} of it)")
        if not same:
            raise AssertionError("the forward program differs from the CV")
        torch.testing.assert_close(gval, live, atol=EXPORT_VALUE_ATOL,
                                   rtol=0)
        if jac_err > EXPORT_JAC_RTOL * scale:
            raise AssertionError("the program's Jacobian differs")
        out.update(forward_equal_live=same, gradient_values_max_abs_err=val_err,
                   jacobian_max_abs_err=jac_err, jacobian_scale=scale)

        # the directory written on the card, loaded on the CPU: the programs
        # moved there run K2's plain version
        n_cpu = 2000
        xc = x[:n_cpu].cpu()
        _cuda.reset_launch_counts()
        cpu_val = cvf.load_colvar(fdir, device="cpu")(xc)
        cpu_gval, cpu_jac = cvf.load_colvar(fdir, with_grad=True,
                                            device="cpu")(xc)
        if any(_cuda.launch_counts().values()):
            raise AssertionError("the CPU programs launched a kernel")
        cpu_err = max_err(cpu_val, value[:n_cpu].cpu())
        cpu_jac_err = max_err(cpu_jac, gjac[:n_cpu].cpu())
        log(f"  programs on the CPU, {n_cpu} frames: values {cpu_err:.3e} "
            f"from the card's (tolerance {TOL['fused_align']['atol']}), "
            f"Jacobian {cpu_jac_err:.3e} (tolerance {EXPORT_JAC_RTOL} of "
            f"{scale:.3e})")
        torch.testing.assert_close(cpu_val, value[:n_cpu].cpu(),
                                   **TOL["fused_align"])
        torch.testing.assert_close(cpu_gval, cpu_val,
                                   atol=EXPORT_VALUE_ATOL, rtol=0)
        if cpu_jac_err > EXPORT_JAC_RTOL * scale:
            raise AssertionError("the CPU program's Jacobian differs")
        out.update(cpu_values_max_abs_err=cpu_err,
                   cpu_jacobian_max_abs_err=cpu_jac_err)

        # the plain run's CV through the native evaluator and PLUMED
        plain.save_model(EPOCHS, "plain")
        pdir = f"{tmp}/plain"
        t0 = time.perf_counter()
        if not cvf.native_available():
            raise AssertionError("the native evaluator did not build")
        out["native_build_s"] = time.perf_counter() - t0
        xn = traj_np[:BATCH].astype(np.float64)
        native = cvf.load_native_cv(pdir)
        native_grad = cvf.load_native_cv(pdir, with_grad=True)
        nv, nj = native_grad(xn[:200])
        rv, rj = cvf.load_numpy_cv(pdir, with_grad=True)(xn[:200])
        nerr = max(float(np.abs(nv - rv).max()), float(np.abs(nj - rj).max()))
        log(f"  native evaluator (g++ build {out['native_build_s']:.2f} s) "
            f"vs numpy evaluator, float64, 200 frames: {nerr:.3e} "
            f"(tolerance {NATIVE_ATOL})")
        if not nerr <= NATIVE_ATOL:
            raise AssertionError("the native evaluator differs")
        out["native_max_abs_err"] = nerr
        plumed = cvf.write_plumed_cv(pdir)
        metad = cvf.write_plumed_metad(pdir, sigma=0.05, height=1.2,
                                       pace=500, biasfactor=10.0, temp=300.0)
        frame = torch.from_numpy(traj_np[7:8])
        with torch.no_grad():
            got = torch.jit.load(plumed.model_path)(frame.reshape(1, -1))
            want = plain.colvar_model()(frame.cuda()).cpu()
        perr = max_err(got, want)
        log(f"  write_plumed_cv: mode {plumed.mode}, {len(plumed.arg_names)}"
            f" arguments, components {plumed.components}; its TorchScript "
            f"model vs the CV on the card {perr:.3e} (tolerance "
            f"{SCRIPTED_ATOL}); write_plumed_metad: "
            f"{os.path.basename(metad.dat_path)}, {len(metad.lines)} lines")
        if plumed.mode != "positions" or "METAD" not in open(
                metad.dat_path).read():
            raise AssertionError("unexpected PLUMED output")
        torch.testing.assert_close(got, want, atol=SCRIPTED_ATOL, rtol=0)
        out["plumed_max_abs_err"] = perr

        # CV evaluation on BATCH frames: frames/s from the host's clock
        # around a call that ends in a synchronize, and device time per call
        # (the summed durations of its device activities)
        def live_fwd():
            with torch.no_grad():
                return cv(x)

        timing = {}
        for label, fn in (("program forward", lambda: fwd(x)),
                          ("program forward+jacobian", lambda: grad(x)),
                          ("live forward", live_fwd),
                          ("live forward+jacobian",
                           lambda: live_jacobian(cv, x))):
            ms = host_ms(fn)
            timing[label] = dict(frames_per_s=BATCH / ms * 1e3, host_ms=ms,
                                 device_us=busy_ms(fn, calls=3) * 1e3)
        for label, fn in (("native forward (CPU, float64)",
                           lambda: native(xn)),
                          ("native forward+jacobian (CPU, float64)",
                           lambda: native_grad(xn))):
            ms = host_ms(fn, calls=3)
            timing[label] = dict(frames_per_s=BATCH / ms * 1e3, host_ms=ms,
                                 device_us=None)
        for label, t in timing.items():
            dev = ("" if t["device_us"] is None
                   else f", device {t['device_us']:.1f} us/call")
            log(f"  {label:40s} {t['frames_per_s']:>14,.0f} frames/s "
                f"({t['host_ms']:.3f} ms/call{dev}; {card})")
        out["timing"] = timing
    return out


def sweep_grid(R):
    """bench.py's lr x alpha grid: replica r takes the (r mod side)-th
    learning rate and the (r div side)-th alpha."""
    side = SWEEP_SIDE
    lrs = np.geomspace(5e-4, 2e-2, side)
    alphas = np.geomspace(5.0, 80.0, side)
    return {"learning_rate": [float(lrs[r % side]) for r in range(R)],
            "alpha": [float(alphas[r // side]) for r in range(R)]}


def task_state(task):
    """What a sweep must leave as it was: the parameters and optimizer
    state (values), and the task's attributes (objects)."""
    sd = task.optimizer.state_dict()["state"]
    return ([p.detach().clone() for p in task.model.parameters()],
            {i: {k: v.clone() for k, v in st.items()} for i, st in sd.items()},
            dict(task.__dict__))


def check_untouched(label, task, before):
    params, state, attrs = before
    ok = all(torch.equal(a, b.detach())
             for a, b in zip(params, task.model.parameters()))
    now = task.optimizer.state_dict()["state"]
    ok &= now.keys() == state.keys() and all(
        torch.equal(state[i][k], now[i][k]) for i in state for k in state[i])
    changed = sorted(k for k in task.__dict__
                     if k not in attrs or task.__dict__[k] is not attrs[k])
    # the one attribute a sweep may fill, as train() would: the prepared
    # batches (and the Gram path decision made with them)
    changed = [k for k in changed if k not in ("_prepared", "_gram")]
    if not ok or changed:
        raise AssertionError(f"{label}: the sweep changed the task "
                             f"(parameters and optimizer state equal: {ok}, "
                             f"attributes replaced: {changed})")


def sweep_bound(R, nb_train, nb_test, epochs):
    """The least time of one sweep epoch on the card: the larger of the
    bytes it must move (the features of X and X_l and the weights of each
    batch read once, the parameters read and written once per step) over
    the HBM rate, and its f32 operations over the f32 peak: per replica and
    sample the heads' products forward (2 x sum d_in d_out per head, for X
    and X_l) on every batch, and twice that backward on the train batches
    (the input gradient of the first layer is not needed: about 2x)."""
    macs = sum(a * b for a, b in zip(DIMS[:-1], DIMS[1:]))
    fwd = 2.0 * macs * K * 2 * BATCH  # X and X_l, per replica and batch
    flops = R * fwd * (3 * nb_train + nb_test)
    n_params = K * sum(a * b + b for a, b in zip(DIMS[:-1], DIMS[1:]))
    nbytes = 4.0 * ((nb_train + nb_test) * BATCH * (2 * 3 * N_ATOMS + 2)
                    + nb_train * R * n_params * 2 * 4)
    t, by = bound(nbytes, flops)
    return t * epochs, by, flops, nbytes


def phase_sweep(card, ref, traj_np, w_np, cvf, runs):
    """Phase 9: the replica sweep at the main path's width."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    R = SWEEP_R
    grid = sweep_grid(R)
    models = [cvf.EigenFunctions(list(DIMS), K, seed=r) for r in range(R)]
    out, sweeps = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, method, cdt in (("a quaternion f32", "quaternion", None),
                                   ("b fused f32", "fused", None),
                                   ("c fused bf16", "fused", "bfloat16")):
            task = make_task(cvf, traj_obj, ref, f"{tmp}/{label[0]}", False,
                             method, SWEEP_EPOCHS)
            before = task_state(task)
            ensemble.release_sweeps()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kw = dict(models=models, compute_dtype=cdt)
            t0 = time.perf_counter()
            train_hyperparameter_sweep(task, grid, **kw)
            first_s = time.perf_counter() - t0
            reps = next(reversed(ensemble._SWEEPS.values()))
            graph = reps.graphs["epoch"]
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            res = train_hyperparameter_sweep(task, grid, **kw)
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            device_s = ensemble.last_run_seconds
            if reps.graphs["epoch"] is not graph:
                raise AssertionError(f"{label}: the second call captured "
                                     "again")
            check_untouched(label, task, before)
            nb_train, nb_test = reps.nb_train, len(reps.test[0])
            samples = R * SWEEP_EPOCHS * nb_train * BATCH
            # one profiled epoch (a replay) for the busy share
            task.num_epochs = 1
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                train_hyperparameter_sweep(task, grid, **kw)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            task.num_epochs = SWEEP_EPOCHS
            acts = device_activities(prof)
            busy = sum(e.self_device_time_total for e in acts) * 1e-6
            for r in res:
                if not np.isfinite(r.train_loss).all():
                    raise AssertionError(f"{label}: non-finite metrics")
            k2_epoch = reps.graphs["epoch"].launches["fused_align"]
            row = dict(
                aggregate_samples_per_s=samples / wall,
                device_window_samples_per_s=samples / device_s,
                first_call_s=first_s, second_call_s=wall,
                device_window_s=device_s,
                vs_solo_plain=samples / wall / runs["plain"]["sps"],
                vs_solo_fused=samples / wall / runs["fused"]["sps"],
                busy_share=busy / prof_wall,
                steady_busy_share=busy / (device_s / SWEEP_EPOCHS),
                device_ms_per_epoch=busy * 1e3,
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                k2_per_captured_epoch=k2_epoch,
                k2_launches=counts["fused_align"])
            log(f"  {label}: R={R}, {SWEEP_EPOCHS} epochs x {nb_train} steps "
                f"of {BATCH}: first call {first_s:.3f} s (eager epoch + "
                f"capture), second {wall:.4f} s -> "
                f"{row['aggregate_samples_per_s']:,.0f} samples/s aggregate "
                f"(device window {device_s:.4f} s: "
                f"{row['device_window_samples_per_s']:,.0f}); "
                f"{row['vs_solo_plain']:.2f}x phase 4's solo plain step, "
                f"{row['vs_solo_fused']:.2f}x its fused step; one profiled "
                f"epoch: device {busy * 1e3:.3f} ms of {prof_wall * 1e3:.3f} "
                f"ms wall, the call's host work included (busy "
                f"{100 * row['busy_share']:.1f}%; of the unprofiled epoch in "
                f"the device window: {100 * row['steady_busy_share']:.1f}%); "
                f"peak memory "
                f"{row['peak_memory_gib']:.2f} GiB; K2 {k2_epoch} per "
                f"captured epoch, {counts['fused_align']} in the second call "
                f"({card})")
            top = sorted(acts, key=lambda e: -e.self_device_time_total)[:5]
            for e in top:
                log(f"    {e.self_device_time_total / 1e3:9.3f} ms/epoch "
                    f"{e.count:6d}x  {e.key[:70]}")
            want = 2 * SWEEP_EPOCHS * (nb_train + nb_test)
            if counts != {**dict.fromkeys(counts, 0),
                          "fused_align" if method == "fused" else
                          "kabsch_exact": want}:
                raise AssertionError(f"{label}: launches {counts}")
            out[label] = row
            sweeps[label] = (task, res)
        t_bound, by, flops, nbytes = sweep_bound(R, nb_train, nb_test, 1)
        act_mb = R * K * BATCH * DIMS[1] * 4 / 1e6
        log(f"  bound of one sweep epoch at R={R}: {t_bound:.4f} ms by "
            f"{by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); one "
            f"[R, k, B, {DIMS[1]}] f32 activation is {act_mb:.1f} MB")
        out["bound_ms_per_epoch"] = t_bound

        # the replicas of run (b) against their solo runs
        btask, bres = sweeps["b fused f32"]
        out["held"] = held_replicas(cvf, traj_obj, ref, tmp, grid, bres)
        # (c) against (b), replica by replica, over the epochs where the
        # two float32 versions of the replica, (a) and (b), agree within
        # the training bar (past them float32 rounding alone parts a run)
        ares = sweeps["a quaternion f32"][1]
        cres = sweeps["c fused bf16"][1]
        out["bf16_vs_f32"] = bf16_hold(ares, bres, cres)
        # a narrower sweep: captured against eager, K2 per captured epoch
        n = SWEEP_NARROW
        sub = {k: v[:n] for k, v in grid.items()}
        ensemble.release_sweeps()
        cap = train_hyperparameter_sweep(btask, sub, models=models[:n])
        reps = next(reversed(ensemble._SWEEPS.values()))
        with eager_twin():
            eager = train_hyperparameter_sweep(btask, sub,
                                               models=models[:n])
        same = all(np.array_equal(a.train_loss, b.train_loss)
                   and np.array_equal(a.test_loss, b.test_loss)
                   and all(torch.equal(a.model[k], b.model[k])
                           for k in a.model)
                   for a, b in zip(cap, eager))
        k2_narrow = reps.graphs["epoch"].launches["fused_align"]
        log(f"  R={n} sweep, captured vs eager, {SWEEP_EPOCHS} epochs: every "
            f"replica's curves and final parameters bit for bit equal: "
            f"{same}; K2 per captured epoch {k2_narrow} (R={R}: "
            f"{out['b fused f32']['k2_per_captured_epoch']})")
        if not same:
            raise AssertionError("the captured sweep differs from the eager "
                                 "one")
        if k2_narrow != out["b fused f32"]["k2_per_captured_epoch"]:
            raise AssertionError("K2 launches per sweep epoch depend on R")
        out["k2_per_captured_epoch_narrow"] = k2_narrow
        ensemble.release_sweeps()
        torch.cuda.empty_cache()
        out["families"] = family_sweeps(card, ref, traj_np, traj_obj, cvf,
                                        tmp)
    return out, bres


def bf16_hold(ares, bres, cres):
    """The bf16 sweep (c) against the float32 one (b). Held: the share of
    replicas whose final-epoch loss (what a sweep ranks by) is within
    SWEEP_BF16_TOL of its float32 value at least SWEEP_BF16_SHARE, the
    replicas' order by final loss kept (Spearman correlation at least
    SWEEP_BF16_RANK), and the curves not equal (the mode engaged).
    Reported: the replicas within the bar at every epoch; at a high
    learning rate the loss spikes in the first epochs, and bf16 rounding
    changes the spikes."""
    def ratio(c, b):
        return np.abs(c - b) / (SWEEP_BF16_TOL["atol"]
                                + SWEEP_BF16_TOL["rtol"] * np.abs(b))

    fb = np.stack([b.train_loss[:, 0] for b in bres])
    fc = np.stack([c.train_loss[:, 0] for c in cres])
    fa = np.stack([a.train_loss[:, 0] for a in ares])
    per_epoch = ratio(fc, fb)  # [R, epochs], <= 1 within the bar
    final = per_epoch[:, -1]
    # replicas whose two float32 sweeps agree within the training bar at
    # every epoch: float32 rounding alone does not part them
    f32_gap = np.abs(fa - fb) / np.abs(fb)
    for r in np.flatnonzero(final > 1):
        log(f"    replica {r} {bres[r].hyperparams}: final-epoch bf16 "
            f"{fc[r, -1]:.3f} vs f32 {fb[r, -1]:.3f} ({final[r]:.3f} of the "
            f"bar); its two float32 sweeps part by {f32_gap[r].max():.3e}")
    whole = int((per_epoch <= 1).all(axis=1).sum())
    rank_b = np.argsort(np.argsort(fb[:, -1]))
    rank_c = np.argsort(np.argsort(fc[:, -1]))
    rho = float(np.corrcoef(rank_b, rank_c)[0, 1])
    f32_versions = float(np.max(np.abs(fa - fb) / np.abs(fb)))
    worst_r, worst_e = np.unravel_index(per_epoch.argmax(), per_epoch.shape)
    log(f"  bf16 vs f32 sweep: final-epoch loss within the bar "
        f"{SWEEP_BF16_TOL} for {int((final <= 1).sum())} of {len(final)} "
        f"replicas (largest {final.max():.3f} of the bar); every epoch "
        f"within it for {whole} of {len(final)} (largest "
        f"{per_epoch.max():.3f} of the bar, replica {int(worst_r)}, epoch "
        f"{int(worst_e)}); Spearman correlation of the final losses "
        f"{rho:.4f} (at least "
        f"{SWEEP_BF16_RANK}); the two float32 sweeps (a, b) part by at most "
        f"{f32_versions:.3e}; parameters "
        f"{sorted({str(v.dtype) for v in cres[0].model.values()})}")
    for r in np.argsort(-per_epoch.max(axis=1))[:4]:
        log(f"    replica {r} {bres[r].hyperparams}: f32 "
            f"{np.round(fb[r], 2).tolist()}, bf16 "
            f"{np.round(fc[r], 2).tolist()}")
    if np.array_equal(fb, fc):
        raise AssertionError("the bf16 sweep equals the float32 one")
    if (final <= 1).mean() < SWEEP_BF16_SHARE:
        raise AssertionError(f"bf16: the final-epoch loss of only "
                             f"{int((final <= 1).sum())} replicas within "
                             f"{SWEEP_BF16_TOL}")
    if rho < SWEEP_BF16_RANK:
        raise AssertionError(f"bf16 reorders the replicas: Spearman {rho}")
    return dict(final_within_bar=int((final <= 1).sum()),
                every_epoch_within_bar=whole,
                largest_bar_ratio=float(per_epoch.max()),
                spearman_final=rho, f32_versions_max_rel=f32_versions)


def hold_against_solo(label, res, replicas, make_solo, cols, sweep_f64):
    """Sweep replicas against their solo runs. ``res[i]`` is replica
    ``replicas[i]``; ``make_solo(r, method)`` builds replica r's solo task
    through K2 ('fused') or the plain layer ('quaternion'); ``sweep_f64()``
    sweeps the same replicas again (run in float64).

    In float32 each replica is held to the training bar over the epochs
    where its solo runs through K2 and through the plain layer, two correct
    float32 versions, agree within it (possibly none): past them float32
    rounding alone parts a run (a loss that blows up amplifies it). Over
    every epoch the float64 sweep is held against the float64 solo runs
    within
    SWEEP_F64_RTOL, or, where the float32 versions part by g, within 100 g
    times the ratio of float64's unit roundoff to float32's (the same
    amplification of a rounding 2**29 times smaller), and equal final
    cvec."""
    from colvarsfinder_tpu_torch.config import set_default_dtype

    out, gaps = {}, {}
    for i, r in enumerate(replicas):
        solo, plain = make_solo(r, "fused"), make_solo(r, "quaternion")
        solo.train()
        plain.train()
        held, row = len(solo.train_loss), {}
        for col, name in cols:
            rtol = CURVE_RTOL["loss"] if col == 0 else CURVE_RTOL["eig_1"]
            b, c = solo.train_loss[:, col], plain.train_loss[:, col]
            over = np.flatnonzero(np.abs(c - b) / np.abs(b) > rtol)
            held = min(held, int(over[0]) if over.size else len(b))
        row["held_epochs"] = held
        gap = 0.0
        for col, name in cols:
            rtol = CURVE_RTOL["loss"] if col == 0 else CURVE_RTOL["eig_1"]
            a = res[i].train_loss[:, col]
            b, c = solo.train_loss[:, col], plain.train_loss[:, col]
            rel = np.abs(a - b) / np.abs(b)
            versions = float(np.max(np.abs(c - b) / np.abs(b)))
            gap = max(gap, versions)
            row[name] = float(rel.max())
            row[name + "_solo_versions"] = versions
            held_rel = float(rel[:held].max()) if held else float("nan")
            log(f"  {label} replica {r}, {name}: sweep vs solo max relative "
                f"difference {held_rel:.3e} over the {held} "
                f"epochs where the solo runs through K2 and through the "
                f"plain layer agree within the training bar ({rtol}), "
                f"{row[name]:.3e} over all {len(a)}; the two solo runs part "
                f"by {versions:.3e}")
            np.testing.assert_allclose(a[:held], b[:held], rtol=rtol)
        if held == len(solo.train_loss) and res[i].cvec is not None and \
                not np.array_equal(res[i].cvec, solo._cvec):
            raise AssertionError(f"{label} replica {r}: cvec {res[i].cvec} "
                                 f"!= {solo._cvec}")
        gaps[r] = gap
        out[r] = row

    set_default_dtype("float64")
    try:
        res64 = sweep_f64()
        for i, r in enumerate(replicas):
            solo = make_solo(r, "fused")
            solo.train()
            bar = max(SWEEP_F64_RTOL, 100.0 * gaps[r] * 2.0**-29)
            rel = float(np.max(np.abs(res64[i].train_loss - solo.train_loss)
                               / np.abs(solo.train_loss)))
            log(f"  {label} replica {r} in float64, sweep vs solo: max "
                f"relative difference {rel:.3e} over every metric of every "
                f"epoch (tolerance {bar:.3e})")
            np.testing.assert_allclose(res64[i].train_loss, solo.train_loss,
                                       rtol=bar)
            if res64[i].cvec is not None and not np.array_equal(
                    res64[i].cvec, solo._cvec):
                raise AssertionError(f"{label} replica {r} (float64): cvec "
                                     f"{res64[i].cvec} != {solo._cvec}")
            out[r]["f64_max_rel"] = rel
    finally:
        set_default_dtype("float32")
    return out


def held_replicas(cvf, traj_obj, ref, tmp, grid, bres):
    """Replicas SWEEP_HELD of run (b) against their solo runs: the same
    model seed, learning rate and alpha (:func:`hold_against_solo`)."""
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    def make_solo(r, method):
        return make_task(cvf, traj_obj, ref, f"{tmp}/solo {method}{r}", False,
                         method, SWEEP_EPOCHS, model_seed=r,
                         lr=grid["learning_rate"][r], alpha=grid["alpha"][r])

    def sweep_f64():
        sub = {k: [v[r] for r in SWEEP_HELD] for k, v in grid.items()}
        task = make_task(cvf, traj_obj, ref, f"{tmp}/f64", False, "fused",
                         SWEEP_EPOCHS)
        models = [cvf.EigenFunctions(list(DIMS), K, seed=r)
                  for r in SWEEP_HELD]
        res = train_hyperparameter_sweep(task, sub, models=models)
        ensemble.release_sweeps()
        return res

    return hold_against_solo("sweep (b)", [bres[r] for r in SWEEP_HELD],
                             SWEEP_HELD, make_solo,
                             ((0, "loss"), (3, "eig_1")), sweep_f64)


def family_sweeps(card, ref, traj_np, traj_obj, cvf, tmp):
    """R = 4 sweeps of the other families through FusedAlignmentLayer, each
    replica against its solo run within the training bar."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        train_hyperparameter_sweep,
    )

    regions = committor_regions(ref, traj_np)
    R, E = FAMILY_R, FAMILY_EPOCHS
    lrs = [float(v) for v in np.geomspace(1e-3, 4e-3, R)]
    cases = {
        "generator gram": (
            lambda p, **h: make_dirichlet(cvf, "gen_gram", traj_obj, ref, p,
                                          E, **h),
            {"learning_rate": lrs, "alpha": [5.0, 10.0, 20.0, 40.0]},
            ((0, "loss"), (3, "eig_1"))),
        "committor": (
            lambda p, **h: make_dirichlet(cvf, "com_gram", traj_obj, ref, p,
                                          E, regions, **h),
            {"learning_rate": lrs, "beta": [0.5, 1.0, 2.0, 4.0]},
            ((0, "loss"), (1, "dirichlet"))),
        "autoencoder": (
            lambda p, **h: make_ae(cvf, "ae", traj_obj, ref, p, E, **h),
            {"learning_rate": lrs}, ((0, "loss"),)),
        "regae transfer": (
            lambda p, **h: make_ae(cvf, "reg", traj_obj, ref, p, E, **h),
            {"learning_rate": lrs,
             "gamma": [[0.7, 3.0], [0.5, 2.0], [1.0, 1.0], [0.7, 4.0]]},
            ((0, "loss"), (4, "eig_0"))),
    }
    attr = {"learning_rate": "learning_rate", "alpha": "alpha",
            "beta": "beta", "gamma": "gamma"}
    out = {}
    for name, (make, grid, cols) in cases.items():
        task = make(f"{tmp}/{name}")
        before = task_state(task)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_hyperparameter_sweep(task, grid)
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        check_untouched(name, task, before)
        ensemble.release_sweeps()
        log(f"  {name}: R={R} sweep, {E} epochs in {wall:.3f} s (first call, "
            f"capture included), {counts['fused_align']} K2 launches "
            f"({card})")

        def make_solo(r, method, make=make, grid=grid, name=name):
            hyper = {attr[k]: v[r] for k, v in grid.items()}
            return make(f"{tmp}/{name} solo {method}{r}", method=method,
                        **hyper)

        def sweep_f64(make=make, grid=grid, name=name):
            res = train_hyperparameter_sweep(make(f"{tmp}/{name} f64"), grid)
            ensemble.release_sweeps()
            return res

        out[name] = dict(
            wall_s=wall, k2_launches=counts["fused_align"],
            replicas=hold_against_solo(name, res, range(R), make_solo, cols,
                                       sweep_f64))
    return out


def make_stream_memmap(path, gib, seed=0):
    """The dipeptide-shaped float32 memmap of benchmarks/streaming_bench.py:
    40-68 (its make_memmap_traj, copied: this script imports nothing of the
    JAX package's tree): a 1M-frame block of a perturbed reference, tiled
    with a scale per block, ~``gib`` GiB; returned opened read-only."""
    n = int(gib * (1 << 30) / (N_ATOMS * 3 * 4))
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, N_ATOMS, 3))
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((N_ATOMS, 3)).astype(np.float32)
    block = (ref[None] + 0.3 * rng.standard_normal((1_000_000, N_ATOMS, 3))
             ).astype(np.float32)
    for c, s in enumerate(range(0, n, len(block))):
        e = min(s + len(block), n)
        mm[s:e] = block[:e - s] * np.float32(1.0 + 0.02 * (c % 7))
    mm.flush()
    del mm
    return np.memmap(path, dtype=np.float32, mode="r", shape=(n, N_ATOMS, 3))


def stage_times(st, workers):
    """Per batch, from a train() call with stream_timing: the gather's host
    ms on its thread, and over the gather threads; the copy's device ms and
    GB/s; the step's device ms (its slot's arrival to its metric row); the
    calling thread's ms, and of it the ms issuing the copies and the ms in
    the steps (the graph replay and the metric row's copy); the share of the
    wall time the card spent in steps and the share the calling thread
    waited for gathers; the stage that sets the pace (the largest per-batch
    time)."""
    n = st["gather_s"].size
    gather_ms = float(np.median(st["gather_s"])) * 1e3
    h2d_ms = float(np.median(st["h2d_ms"]))
    wall_ms = st["wall_s"] * 1e3
    host_ms = (wall_ms - 1e3 * (st["wait_gather_s"] + st["wait_host_s"])) / n
    row = {
        "batches": n,
        "gather_ms": gather_ms,
        "gather_ms_over_threads": gather_ms / max(1, workers),
        "h2d_ms": h2d_ms,
        "h2d_gb_per_s": float(np.median(st["h2d_bytes"])) / h2d_ms * 1e-6,
        "h2d_mb_per_batch": float(np.median(st["h2d_bytes"])) / 1e6,
        "step_ms": float(np.median(st["step_ms"])),
        "host_ms": host_ms,
        "host_copy_ms": st["copy_s"] * 1e3 / n,
        "host_step_ms": st["step_s"] * 1e3 / n,
        "wall_ms_per_batch": wall_ms / n,
        "device_busy_share": float(st["step_ms"].sum()) / wall_ms,
        "wait_gather_share": st["wait_gather_s"] * 1e3 / wall_ms,
        "pinned_host_mb": st["host_bytes"] / 1e6,
    }
    stages = {"gather": row["gather_ms_over_threads"], "copy": h2d_ms,
              "step": row["step_ms"], "calling thread": host_ms}
    row["pace"] = max(stages, key=stages.get)
    return row


def phase_streaming(card, ref, traj_np, w_np, cvf, runs):
    """Phase 10: the streaming layout. The fused and plain streamed runs
    on phase 4's frames against phase 4's resident runs, and the fused
    captured run against its eager twin, bit for bit; bench.py's 4 GiB
    memmap through (a) the plain step and (b) the fused step: samples/s
    beside phase 5's resident rates, the time of each stage, peak device
    memory against the same run on 120,000 frames, pinned host memory."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.parallel import ensemble

    t_phase = time.perf_counter()
    # the earlier phases' device data goes, so that peak memory reads this
    # phase's runs
    for r in runs.values():
        r["task"].release_device_data()
    ensemble.release_sweeps()
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)

    def train(task, label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        task.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        for name, n in counts.items():
            launches[name] += n
        if not np.isfinite(task.train_loss).all():
            raise AssertionError(f"{label}: non-finite training metrics")
        peak = torch.cuda.max_memory_allocated()
        return dict(wall=wall, counts=counts, peak=peak,
                    peak_increment=peak - before)

    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # bit for bit against phase 4's resident runs (in-RAM frames keep
        # the resident gather order)
        for label, fused, method, eager in (
            ("fused", True, "fused", False),
            ("fused eager", True, "fused", True),
            ("plain", False, "quaternion", False),
        ):
            task = make_task(cvf, traj_obj, ref, f"{tmp}/{label}", fused,
                             method, EPOCHS, streaming=True)
            with eager_twin(eager):
                r = train(task, f"streamed {label}")
            resident = runs["plain" if method == "quaternion" else "fused"]
            rows = loss_rows(task)
            same = np.array_equal(rows, resident["rows"]) and all(
                torch.equal(a, b) for a, b in zip(task.model.parameters(),
                                                  resident["params"]))
            graphs = sorted(task._graphs)
            log(f"  streamed {label:11s} ({EPOCHS} epochs of phase 4's "
                f"frames, {r['wall']:.2f} s, step graphs {graphs}): every "
                f"batch's metric row and every final parameter bit for bit "
                f"equal to phase 4's resident {resident['task'].model_name} "
                f"run ({'fused' if fused else 'plain'}): {same}; launches "
                f"{r['counts']}")
            if not same:
                gap = float(np.max(np.abs(rows - resident["rows"])))
                raise AssertionError(f"streamed {label} differs from the "
                                     f"resident run (max gap {gap:.3e})")
            if r["counts"] != resident["counts"]:
                raise AssertionError(f"streamed {label}: launches "
                                     f"{r['counts']}, resident "
                                     f"{resident['counts']}")
            if graphs != ([] if eager else ["test", "train"]):
                raise AssertionError(f"streamed {label}: graphs {graphs}")

        path = os.path.join(tempfile.gettempdir(),
                            f"cvf_stream_{STREAM_GIB:g}gib_{os.getpid()}.f32")
        try:
            t0 = time.perf_counter()
            mm = make_stream_memmap(path, STREAM_GIB)
            log(f"  memmap: {mm.shape[0]:,} frames of [{N_ATOMS}, 3] float32 "
                f"({mm.nbytes / 2**30:.2f} GiB) written in "
                f"{time.perf_counter() - t0:.1f} s at {path}")
            big = cvf.WeightedTrajectory(trajectory=mm, dt=DT, verbose=False)
            small = cvf.WeightedTrajectory(trajectory=mm[:N_FRAMES], dt=DT,
                                           verbose=False)
            if not (isinstance(big.trajectory, np.memmap)
                    and isinstance(small.trajectory, np.memmap)):
                raise AssertionError("the trajectory left the memmap")

            def stream_task(traj, label, fused):
                task = make_task(cvf, traj, ref, f"{tmp}/{label}", fused,
                                 "fused" if fused else "quaternion", 1,
                                 streaming=True,
                                 test_ratio=STREAM_TEST_RATIO)
                if not task._sorted_gather(task._traj_np):
                    raise AssertionError(f"{label}: unsorted memmap gather")
                return task

            small_r = train(stream_task(small, "b small", True), "b 120k")
            for label, fused, resident in (("b", True, "fused"),
                                           ("a", False, "plain")):
                task = stream_task(big, label, fused)
                nb_train = len(task._prepare_data()[2])
                samples = nb_train * BATCH
                warm = train(task, f"{label} warm")
                timed = []
                for timing in ((False, True) if fused else (True,)):
                    task.stream_timing = timing
                    r = train(task, label)
                    r["sps"] = samples / task.epoch_times[-1]
                    timed.append(r)
                st = stage_times(task.stream_stats, task._stream_config()[1])
                row = dict(
                    samples_per_s=max(r["sps"] for r in timed),
                    samples_per_s_each_call=[r["sps"] for r in timed],
                    resident_samples_per_s=runs[resident]["sps"],
                    warm_call_s=warm["wall"], peak_gib=warm["peak"] / 2**30,
                    peak_increment_mb=warm["peak_increment"] / 1e6,
                    frames=mm.shape[0], nb_train=nb_train, stages=st,
                    launches_per_call=timed[0]["counts"])
                row["vs_resident"] = (row["samples_per_s"]
                                      / row["resident_samples_per_s"])
                calls = ", ".join(f"{r['sps']:,.0f}" for r in timed)
                log(f"  ({label}) {'fused' if fused else 'plain'} step, "
                    f"{mm.shape[0]:,} frames, {nb_train} train batches: "
                    f"{row['samples_per_s']:,.0f} samples/s streamed "
                    f"(calls after the warm one: {calls}; the last with "
                    f"stage timing) on {card}; phase 5's "
                    f"resident {row['resident_samples_per_s']:,.0f} "
                    f"({100 * row['vs_resident']:.1f}%); warm call "
                    f"{warm['wall']:.1f} s; launches per call "
                    f"{timed[0]['counts']}")
                log(f"      per batch: gather {st['gather_ms']:.3f} ms on "
                    f"its thread ({st['gather_ms_over_threads']:.3f} over "
                    f"the threads), copy {st['h2d_ms']:.3f} ms "
                    f"({st['h2d_mb_per_batch']:.2f} MB, "
                    f"{st['h2d_gb_per_s']:.1f} GB/s), step "
                    f"{st['step_ms']:.3f} ms on the card, calling thread "
                    f"{st['host_ms']:.3f} ms (copies {st['host_copy_ms']:.3f}"
                    f", steps {st['host_step_ms']:.3f}), wall "
                    f"{st['wall_ms_per_batch']:.3f} ms; device busy "
                    f"{100 * st['device_busy_share']:.1f}%, calling thread "
                    f"waiting for gathers {100 * st['wait_gather_share']:.1f}"
                    f"%; pace set by: {st['pace']}; pinned host "
                    f"{st['pinned_host_mb']:.1f} MB")
                if fused:
                    log(f"      peak device memory {warm['peak'] / 2**20:.1f}"
                        f" MiB ({warm['peak_increment'] / 2**20:.1f} MiB over "
                        f"the call's start); the same run on the memmap's "
                        f"first {N_FRAMES:,} frames "
                        f"{small_r['peak'] / 2**20:.1f} MiB "
                        f"({small_r['peak_increment'] / 2**20:.1f} MiB) "
                        f"(tolerance {STREAM_MEMORY_RTOL:.0%})")
                    if (abs(warm["peak"] - small_r["peak"])
                            > STREAM_MEMORY_RTOL * small_r["peak"]):
                        raise AssertionError(
                            "streamed peak device memory grew with the "
                            f"trajectory: {warm['peak']} vs {small_r['peak']}")
                    row["peak_small_gib"] = small_r["peak"] / 2**30
                    row["peak_increment_small_mb"] = \
                        small_r["peak_increment"] / 1e6
                    variants = {}
                    for name, attrs in STREAM_VARIANTS:
                        for k, v in attrs.items():
                            setattr(task, k, v)
                        # a changed setting rebuilds the buffers: this call
                        # captures its two steps again
                        train(task, f"{label} {name}")
                        vst = stage_times(task.stream_stats,
                                          task._stream_config()[1])
                        variants[name] = dict(
                            samples_per_s=samples / task.epoch_times[-1],
                            stages=vst)
                        for k in attrs:
                            delattr(task, k)
                        log(f"      {name}: "
                            f"{variants[name]['samples_per_s']:,.0f} "
                            "samples/s (one call with stage timing, its "
                            f"steps captured anew): gather "
                            f"{vst['gather_ms']:.3f} ms per batch on its "
                            f"thread, calling thread {vst['host_ms']:.3f} ms "
                            f"(copies {vst['host_copy_ms']:.3f}, steps "
                            f"{vst['host_step_ms']:.3f}), waiting for gathers "
                            f"{100 * vst['wait_gather_share']:.1f}%, step "
                            f"{vst['step_ms']:.3f} ms on the card; pace: "
                            f"{vst['pace']}")
                    row["variants_samples_per_s"] = variants
                out[label] = row
                del task
        finally:
            if os.path.exists(path):
                os.remove(path)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 10 took {out['phase_s']:.1f} s")
    return out


def nccl_kernels(prof, steps):
    """NCCL's kernels under torch.profiler: per name, launches and device
    microseconds per train step."""
    return {e.key: (e.count / steps, e.self_device_time_total / steps)
            for e in device_activities(prof)
            if any(n in e.key.lower() for n in NCCL_KERNEL_NAMES)}


def same_sweeps(a, b):
    """Two sweeps' results equal bit for bit: curves, parameters, optimizer
    state."""
    def state(r):
        return [t for st in r.opt_state["state"].values()
                for t in st.values()]

    return all(np.array_equal(x.train_loss, y.train_loss)
               and np.array_equal(x.test_loss, y.test_loss)
               and all(torch.equal(x.model[k], y.model[k]) for k in x.model)
               and all(torch.equal(s, t) for s, t in zip(state(x), state(y)))
               for x, y in zip(a, b)) and len(a) == len(b)


def phase_mesh(card, ref, traj_np, w_np, cvf, runs, sweep, sweep_b):
    """Phase 11: the data mesh at one rank of an NCCL group. The plain step
    through K2, resident and streamed, on the mesh against the same run
    without it, bit for bit; bench.py's R = 64 sweep with mesh= against
    phase 9's (b); samples/s, NCCL kernels per train step and graph replays
    per epoch beside each."""
    import torch.distributed as dist

    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.parallel import (
        ensemble,
        make_data_mesh,
        train_hyperparameter_sweep,
    )

    t_phase = time.perf_counter()
    for r in runs.values():
        r["task"].release_device_data()
    ensemble.release_sweeps()
    torch.cuda.empty_cache()
    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    init = os.path.join(tempfile.gettempdir(), f"cvf_mesh_{os.getpid()}")
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    out = {}
    try:
        mesh = make_data_mesh()
        log(f"  {mesh}: backend {dist.get_backend()}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}, world size "
            f"{dist.get_world_size()}")
        with tempfile.TemporaryDirectory() as tmp:
            res = {}
            for label, kw in (("unmeshed", {}), ("meshed", dict(mesh=mesh)),
                              ("unmeshed streamed", dict(streaming=True)),
                              ("meshed streamed",
                               dict(mesh=mesh, streaming=True))):
                task = make_task(cvf, traj_obj, ref, f"{tmp}/{label}", False,
                                 "fused", EPOCHS, **kw)
                torch.cuda.synchronize()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                task.train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _cuda.launch_counts()
                if label.startswith("meshed"):
                    for name, n in counts.items():
                        launches[name] += n
                if not np.isfinite(task.train_loss).all():
                    raise AssertionError(f"{label}: non-finite metrics")
                if not task._graphs:
                    raise AssertionError(f"{label}: nothing captured")
                nb_train = len(task._prepare_data()[2])
                nb_test = len(task._prepare_data()[3])
                sps = nb_train * BATCH / statistics.median(
                    task.epoch_times[2:])
                res[label] = dict(task=task, counts=counts, wall=wall,
                                  sps=sps, rows=loss_rows(task),
                                  params=[p.detach().clone()
                                          for p in task.model.parameters()])
            base = res["unmeshed"]
            for label in ("meshed", "unmeshed streamed", "meshed streamed"):
                r = res[label]
                same = np.array_equal(r["rows"], base["rows"]) and all(
                    torch.equal(a, b) for a, b in zip(r["params"],
                                                      base["params"]))
                log(f"  {label} vs unmeshed, plain step through K2, {EPOCHS} "
                    f"epochs captured: every batch's metric row and every "
                    f"final parameter bit for bit equal: {same}; launches "
                    f"{r['counts']} vs {base['counts']}")
                if not same:
                    gap = float(np.max(np.abs(r["rows"] - base["rows"])))
                    raise AssertionError(f"{label} differs from the unmeshed "
                                         f"run (max gap {gap:.3e})")
                if r["counts"] != base["counts"]:
                    raise AssertionError(f"{label}: launches {r['counts']}")
            # two more epochs of each under torch.profiler (replays)
            for label, r in res.items():
                task = r["task"]
                task.num_epochs = 2
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    task.train()
                    torch.cuda.synchronize()
                    prof_wall = time.perf_counter() - t0
                steps = 2 * nb_train
                nccl = nccl_kernels(prof, steps)
                # with and without the mesh: the same layout's unmeshed run
                twin = res[label.replace("meshed", "unmeshed")
                           if label.startswith("meshed") else label]
                replays = sum(e.count for e in prof.key_averages()
                              if e.key == "cudaGraphLaunch")
                acts = device_activities(prof)
                busy = sum(e.self_device_time_total for e in acts) * 1e-6
                row = dict(
                    samples_per_s=r["sps"],
                    vs_unmeshed=r["sps"] / twin["sps"],
                    wall_s=r["wall"],
                    nccl_kernels_per_train_step=sum(
                        n for n, _ in nccl.values()),
                    nccl_us_per_train_step=sum(us for _, us in nccl.values()),
                    nccl_kernels={k[:90]: v for k, v in nccl.items()},
                    device_ms_per_train_step=busy * 1e3 / steps,
                    graph_replays_per_epoch=replays / 2,
                    launches=r["counts"])
                out[label] = row
                log(f"  {label}: {r['sps']:,.0f} samples/s "
                    f"({100 * row['vs_unmeshed']:.1f}% of the same layout "
                    f"unmeshed), "
                    f"{EPOCHS} epochs in {r['wall']:.2f} s; profiled 2 "
                    f"epochs ({prof_wall * 1e3:.1f} ms): NCCL "
                    f"{row['nccl_kernels_per_train_step']:.2f} kernels and "
                    f"{row['nccl_us_per_train_step']:.2f} device us per "
                    f"train step (test batches' gathers included), device "
                    f"{row['device_ms_per_train_step']:.4f} ms per train "
                    f"step, {row['graph_replays_per_epoch']:g} graph replays "
                    f"per epoch ({card})")
                for name, (n, us) in nccl.items():
                    log(f"    {us:8.2f} us/step {n:5.2f}x/step  {name[:80]}")
                meshed = label.startswith("meshed")
                # the gather of each batch and the gradient sum of each
                # train step: at least one NCCL kernel per train step
                if meshed and row["nccl_kernels_per_train_step"] < 1:
                    raise AssertionError(f"{label}: no NCCL kernel in the "
                                         f"replayed steps: {nccl}")
                if not meshed and nccl:
                    raise AssertionError(f"unmeshed run launched {nccl}")
                want_replays = (nb_train + nb_test if "streamed" in label
                                else 1)
                if row["graph_replays_per_epoch"] != want_replays:
                    raise AssertionError(
                        f"{label}: {row['graph_replays_per_epoch']} graph "
                        f"replays per epoch, expected {want_replays}")
                task.release_device_data()
            del res

            # bench.py's R = 64 sweep through K2 on the mesh: every replica
            # on this rank, then gathered; against phase 9's (b)
            task = make_task(cvf, traj_obj, ref, f"{tmp}/sweep", False,
                             "fused", SWEEP_EPOCHS)
            grid = sweep_grid(SWEEP_R)
            models = [cvf.EigenFunctions(list(DIMS), K, seed=r)
                      for r in range(SWEEP_R)]
            kw = dict(models=models, mesh=mesh)
            t0 = time.perf_counter()
            train_hyperparameter_sweep(task, grid, **kw)
            first_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            got = train_hyperparameter_sweep(task, grid, **kw)
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            for name, n in counts.items():
                launches[name] += n
            same = same_sweeps(got, sweep_b)
            nb_train = len(task._prepare_data()[2])
            samples = SWEEP_R * SWEEP_EPOCHS * nb_train * BATCH
            b = sweep["b fused f32"]
            row = dict(aggregate_samples_per_s=samples / wall,
                       device_window_samples_per_s=(
                           samples / ensemble.last_run_seconds),
                       unmeshed_aggregate_samples_per_s=(
                           b["aggregate_samples_per_s"]),
                       first_call_s=first_s, second_call_s=wall,
                       k2_launches=counts["fused_align"], bitwise=same)
            row["vs_unmeshed"] = (row["aggregate_samples_per_s"]
                                  / row["unmeshed_aggregate_samples_per_s"])
            out["sweep R=64 meshed"] = row
            log(f"  R={SWEEP_R} sweep through K2 on the mesh: first call "
                f"{first_s:.3f} s, second {wall:.4f} s -> "
                f"{row['aggregate_samples_per_s']:,.0f} samples/s aggregate "
                f"(device window {row['device_window_samples_per_s']:,.0f})"
                f", phase 9's (b) unmeshed "
                f"{row['unmeshed_aggregate_samples_per_s']:,.0f} "
                f"({100 * row['vs_unmeshed']:.1f}%); K2 "
                f"{counts['fused_align']} in the second call; every "
                f"replica's curves, parameters and Adam state bit for bit "
                f"equal to phase 9's (b): {same} ({card})")
            if not same:
                raise AssertionError("the meshed R=64 sweep differs from "
                                     "phase 9's (b)")
            if counts["fused_align"] != b["k2_launches"]:
                raise AssertionError(f"meshed sweep K2 {counts}, phase 9's "
                                     f"{b['k2_launches']}")
            ensemble.release_sweeps()
    finally:
        dist.destroy_process_group()
        if os.path.exists(init):
            os.remove(init)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the samplers on the card


class TripleWellCircle:
    """examples/enhanced_sampling.py:40-52: three wells on the unit circle,
    radial confinement."""

    dim = 2

    def __init__(self, beta=SAMPLER_BETA):
        self.beta = beta

    def V(self, x):
        theta = torch.atan2(x[1], x[0])
        r = torch.sqrt(x[0] ** 2 + x[1] ** 2)
        return 1.0 + torch.cos(3.0 * theta) + 8.0 * (r - 1.0) ** 2


class DoubleWell2D:
    """examples/replica_exchange.py:44-52: barrier 1 at x1 = 0."""

    dim, beta = 2, REMD_BETAS[0]

    def V(self, x):
        return (x[0] ** 2 - 1.0) ** 2 + 4.0 * x[1] ** 2


class HarmonicWell:
    """``0.5 kappa |x - ref|^2`` on flattened frames around phase 4's
    reference (its frames scatter by 0.3 around it: kappa = 1 / 0.09 at
    beta 1)."""

    def __init__(self, ref):
        self.ref = torch.as_tensor(ref.reshape(-1), device="cuda")
        self.dim, self.beta = self.ref.numel(), METAD_BETA

    def V(self, x):
        return 0.5 * METAD_KAPPA * torch.sum((x - self.ref.to(x.device)) ** 2)


def angle_cv(x):
    """The triple well's angle, a CV of the chain batch [c, 2]."""
    return torch.atan2(x[:, 1], x[:, 0])


def result_arrays(res):
    """Every array of a sampler's result, by name."""
    if isinstance(res, tuple):
        return {str(i): a for i, a in enumerate(res)}
    return {k: v for k, v in vars(res).items() if isinstance(v, np.ndarray)}


def sampler_run(label, call, blocks, chains, steps, prefix, card,
                short_over, twin_blocks=TWIN_BLOCKS, twin_over=None,
                writer=None, short_blocks=PROFILE_BLOCKS, profile_over=None,
                profile_scale=1):
    """Phase 12's measurements of one sampler configuration.

    ``call(**over)`` runs the sampler on the card; ``prefix(res, m)`` gives
    the arrays of its first ``m`` report (or deposition) blocks. The call is
    timed: chain-steps/s over its wall time, and over the wall time less
    the seconds ``writer(res)`` gives for the output files. Its eager twin
    (``eager_twin(blocks=...)``, with ``twin_over``) must equal the first
    ``twin_blocks`` blocks bit for bit. A short call with ``short_over``
    (``short_blocks`` blocks), timed, splits the call's time into a fixed
    part and a steady time per block. A call with ``profile_over`` (by
    default the short call) under torch.profiler gives the device time and
    activities per block (a profiled block times ``profile_scale``: a
    profiled call of shorter blocks keeps the trace small) and the graph
    replays per profiled block; the busy share is the device time of a
    block over its steady time."""
    from colvarsfinder_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    write_s = 0.0 if writer is None else writer(res)
    for name, a in result_arrays(res).items():
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite {name}")
    stages = {}
    t0 = time.perf_counter()
    with eager_twin(blocks=twin_blocks):
        twin = call(**(twin_over or {}))
    stages["eager twin"] = time.perf_counter() - t0
    got, want = prefix(res, twin_blocks), prefix(twin, twin_blocks)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    if not same:
        gaps = [float(np.abs(np.asarray(a, np.float64)
                             - np.asarray(b, np.float64)).max())
                for a, b in zip(got, want)]
        raise AssertionError(f"{label}: the captured run's first "
                             f"{twin_blocks} blocks differ from its eager "
                             f"twin's (max gaps {gaps})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(**short_over)
    torch.cuda.synchronize()
    short_s = time.perf_counter() - t0
    profile_over = short_over if profile_over is None else profile_over
    n_prof = short_blocks if profile_over is short_over else 2
    # the card's activities only: the host-side operator events of the eager
    # first block and the capture would swamp the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call(**profile_over)
        torch.cuda.synchronize()
    kernels = device_activities(prof)
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6
    replays = sum(e.count for e in prof.key_averages()
                  if e.key == "cudaGraphLaunch")
    stages["short call"] = short_s
    stages["profiled call and its tables"] = time.perf_counter() - t0
    block_s = (wall - write_s - short_s) / (blocks - short_blocks)
    device_s = busy_s / n_prof * profile_scale
    row = dict(
        chains=chains, steps=steps, blocks=blocks, wall_s=wall,
        write_s=write_s,
        chain_steps_per_s=chains * steps / wall,
        chain_steps_per_s_integration=chains * steps / (wall - write_s),
        steady_ms_per_block=block_s * 1e3,
        steady_chain_steps_per_s=chains * steps / blocks / block_s,
        fixed_s=short_s - short_blocks * block_s,
        device_ms_per_block=device_s * 1e3,
        device_activities_per_block=sum(e.count for e in kernels)
        / n_prof * profile_scale,
        graph_replays_per_profiled_block=replays / n_prof,
        busy_share=device_s / block_s,
        launches=counts, eager_twin_blocks=twin_blocks, bitwise=same,
        check_s=stages,
    )
    log(f"  {label}: {chains} x {steps:,} steps in {wall:.2f} s -> "
        f"{row['chain_steps_per_s']:,.0f} chain-steps/s (files "
        f"{write_s:.2f} s; integration "
        f"{row['chain_steps_per_s_integration']:,.0f}; steady "
        f"{row['steady_ms_per_block']:.3f} ms per block, "
        f"{row['steady_chain_steps_per_s']:,.0f} chain-steps/s, fixed "
        f"{row['fixed_s']:.2f} s per call); device "
        f"{row['device_ms_per_block']:.3f} ms and "
        f"{row['device_activities_per_block']:.1f} activities per block, "
        f"{row['graph_replays_per_profiled_block']:.3f} graph replays per "
        f"block in a profiled call of {n_prof} blocks (the first captured), "
        f"busy share {100 * row['busy_share']:.1f}% of a steady block; "
        f"first {twin_blocks} blocks bit for bit equal to the eager twin: "
        f"{same}; launches {counts}; checks {stages} ({card})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    for e in top:
        log(f"    {e.self_device_time_total / n_prof * profile_scale:9.1f} "
            f"us/block {e.count / n_prof * profile_scale:7.1f}x/block  "
            f"{e.key[:70]}")
    return res, row


def metad_gaps(a, b, blocks):
    """Relative gaps of two metadynamics runs over their first ``blocks``
    deposition blocks: frames, CV values and hill heights, each over its
    largest magnitude."""
    out = {}
    for name in ("frames", "cv_values", "hill_heights"):
        x = np.asarray(getattr(a, name)[:, :blocks], np.float64)
        y = np.asarray(getattr(b, name)[:, :blocks], np.float64)
        out[name] = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
    return out


def phase_samplers(card, ref, traj_np, runs, cvf):
    """Phase 12: the samplers at the examples' sizes, each report or
    deposition block one captured CUDA graph."""
    from colvarsfinder_tpu_torch.utils import (
        integrate_sde_langevin,
        integrate_sde_metadynamics,
        integrate_sde_overdamped,
        integrate_sde_remd,
        integrate_sde_steered,
        integrate_sde_umbrella,
    )
    from colvarsfinder_tpu_torch.utils.sampling import _write_chains

    t_phase = time.perf_counter()
    for r in runs.values():
        r["task"].release_device_data()
    torch.cuda.empty_cache()
    out = {}
    dev = torch.device("cuda")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    n_rep = (SAMPLER_STEPS - 1) // SAMPLER_REPORT + 1

    def chain_writer(label):
        """The seconds a call spent on its files: the first WRITE_CHAINS
        chains' files written again, scaled to all chains."""
        def write(res):
            frames = res[0] if res[0].ndim == 3 else res[0][None]
            energies = res[1] if res[1].ndim == 2 else res[1][None]
            t0 = time.perf_counter()
            _write_chains(f"{tmp}/{label}-again", "traj.txt", "output.csv",
                          frames[:WRITE_CHAINS], np.arange(n_rep)
                          * SAMPLER_REPORT * SAMPLER_DT,
                          energies[:WRITE_CHAINS])
            return ((time.perf_counter() - t0) * len(frames)
                    / min(len(frames), WRITE_CHAINS))
        return write

    # (a) overdamped EM, (b) BAOAB: TripleWellCircle at beta 8
    for label, fn, chains in (
        ("a overdamped 1 chain", integrate_sde_overdamped, 1),
        ("a overdamped", integrate_sde_overdamped, SAMPLER_CHAINS),
        ("b baoab", integrate_sde_langevin, SAMPLER_CHAINS),
    ):
        def call(fn=fn, chains=chains, label=label, **over):
            kw = dict(n_steps=SAMPLER_STEPS, report_interval=SAMPLER_REPORT,
                      step_size=SAMPLER_DT, X0=[0.5, -0.866], seed=7,
                      n_chains=chains, verbose=False, device=dev)
            if fn is integrate_sde_langevin:
                kw["friction"] = BAOAB_FRICTION
            kw.update(over)
            return fn(TripleWellCircle(), sampling_output_path=f"{tmp}/{label}",
                      **kw)

        if chains == 1:
            def prefix(res, m):
                return res[0][:m], res[1][:m]
        else:
            def prefix(res, m):
                return res[0][:, :m], res[1][:, :m]
        # the eager twin integrates the first blocks only: nothing in a
        # block depends on the number of reports
        _, out[label] = sampler_run(
            label, call, n_rep, chains, SAMPLER_STEPS, prefix, card,
            dict(n_steps=PROFILE_BLOCKS * SAMPLER_REPORT),
            twin_over=dict(n_steps=TWIN_BLOCKS * SAMPLER_REPORT),
            writer=chain_writer(label))

    # (c) well-tempered metadynamics along phase 4's trained fused CV (K2 in
    # every step, forward and backward), 64 walkers on flattened frames
    cv = runs["fused"]["task"].colvar_model()

    def flat_cv(model):
        return lambda x: model(x.reshape(-1, N_ATOMS, 3))

    with torch.no_grad():
        sample = torch.from_numpy(traj_np[:BATCH]).cuda()
        width = METAD_WIDTH_STD * float(cv(sample).std())
    rng = np.random.default_rng(12)
    x0 = (ref.reshape(-1)[None] + 0.3 * rng.standard_normal(
        (METAD_WALKERS, 3 * N_ATOMS))).astype(np.float32)
    n_hills = METAD_STEPS // METAD_DEPOSIT

    def metad(model, **over):
        kw = dict(n_steps=METAD_STEPS, deposit_interval=METAD_DEPOSIT,
                  step_size=METAD_DT, hill_height=METAD_HEIGHT,
                  hill_width=width, bias_factor=METAD_GAMMA,
                  n_chains=METAD_WALKERS, X0=x0, seed=11, verbose=False,
                  device=dev)
        kw.update(over)
        return integrate_sde_metadynamics(HarmonicWell(ref), flat_cv(model),
                                          **kw)

    def metad_prefix(res, m):
        return (res.frames[:, :m], res.cv_values[:, :m],
                res.hill_centers[:, :m], res.hill_heights[:, :m])

    fused_res, row = sampler_run(
        "c metadynamics through K2", lambda **o: metad(cv, **o), n_hills,
        METAD_WALKERS, METAD_STEPS, metad_prefix, card,
        dict(n_steps=METAD_PROFILE_BLOCKS * METAD_DEPOSIT),
        short_blocks=METAD_PROFILE_BLOCKS,
        profile_over=dict(n_steps=2 * METAD_PROFILE_DEPOSIT,
                          deposit_interval=METAD_PROFILE_DEPOSIT),
        profile_scale=METAD_DEPOSIT // METAD_PROFILE_DEPOSIT)
    row["k2_per_step"] = row["launches"]["fused_align"] / METAD_STEPS
    log(f"  c: K2 {row['launches']['fused_align']} launches, "
        f"{row['k2_per_step']:.4f} per step (one a step, one a deposition, "
        f"one to size the CV)")
    if row["k2_per_step"] < 1:
        raise AssertionError("metadynamics along the fused CV did not launch "
                             "K2 in every step")
    # the same walkers through the CV rebuilt with the plain layers and the
    # same heads, over the first METAD_HELD_BLOCKS deposition blocks
    plain = {}
    t0 = time.perf_counter()
    for method in ("quaternion", "svd"):
        pp = cvf.PreprocessingANN(
            cvf.AlignmentLayer(ref, list(range(N_ATOMS)), method=method),
            cvf.FeatureLayer([cvf.Feature("p", "position",
                                          list(range(N_ATOMS)))]))
        plain[method] = metad(cvf.ColvarModel(pp, cv.head).cuda(),
                              n_steps=METAD_HELD_BLOCKS * METAD_DEPOSIT)
    fused_held = metad_gaps(fused_res, plain["quaternion"], METAD_HELD_BLOCKS)
    plain_pair = metad_gaps(plain["svd"], plain["quaternion"],
                            METAD_HELD_BLOCKS)
    bars = {name: max(2 * gap, METAD_RTOL_FLOOR)
            for name, gap in plain_pair.items()}
    row["check_s"]["plain layers"] = time.perf_counter() - t0
    row.update(hill_width=width, vs_quaternion=fused_held,
               svd_vs_quaternion=plain_pair, bars=bars)
    log(f"  c against the quaternion layer over {METAD_HELD_BLOCKS} "
        f"deposition blocks: {fused_held}; two plain versions (svd against "
        f"quaternion): {plain_pair}; bars {bars}")
    for name, bar in bars.items():
        if not fused_held[name] <= bar:
            raise AssertionError(f"c: {name} parts from the quaternion twin "
                                 f"by {fused_held[name]:.3e} > {bar}")
    out["c metadynamics through K2"] = row

    # (d) a steered pull, then umbrella windows seeded by it, then MBAR:
    # adaptive_umbrella.py:114-138 on the triple well, along its angle
    centers = np.linspace(*UMB_RANGE, UMB_WINDOWS)
    spacing = centers[1] - centers[0]
    kappa = 4.0 / (SAMPLER_BETA * spacing**2)

    def pull(**over):
        kw = dict(n_steps=UMB_STEPS, n_realizations=UMB_WINDOWS,
                  X0=[1.0, 0.0], pre_steps=UMB_PRE, step_size=UMB_DT,
                  report_interval=PULL_REPORT, seed=7, verbose=False,
                  device=dev)
        kw.update(over)
        return integrate_sde_steered(TripleWellCircle(), angle_cv, UMB_RANGE[0],
                                     UMB_RANGE[1], 10 * kappa, **kw)

    pulled, out["d steered"] = sampler_run(
        "d steered", pull, UMB_STEPS // PULL_REPORT, UMB_WINDOWS, UMB_STEPS,
        lambda r, m: (r.frames[:, :m], r.cv_values[:, :m], r.works[:, :m],
                      r.schedule[:m]),
        card, dict(n_steps=PROFILE_BLOCKS * PULL_REPORT, pre_steps=0,
                   X0=np.tile([1.0, 0.0], (UMB_WINDOWS, 1))))
    starts = pulled.window_starts(centers)

    def umbrella(**over):
        kw = dict(n_steps=UMB_STEPS, X0=starts, pre_steps=UMB_PRE,
                  step_size=UMB_DT, report_interval=UMB_REPORT, seed=11,
                  verbose=False, device=dev,
                  sampling_output_path=f"{tmp}/umbrella")
        kw.update(over)
        return integrate_sde_umbrella(TripleWellCircle(), angle_cv, centers,
                                      kappa, **kw)

    umb, row = sampler_run(
        "d umbrella", umbrella, (UMB_STEPS - 1) // UMB_REPORT + 1,
        UMB_WINDOWS, UMB_STEPS,
        lambda r, m: (r.frames[:, :m], r.cv_values[:, :m]), card,
        dict(n_steps=PROFILE_BLOCKS * UMB_REPORT, pre_steps=0))
    t0 = time.perf_counter()
    mb = umb.mbar()
    row["mbar_s"] = time.perf_counter() - t0
    w = np.concatenate(mb.weights)
    means = umb.cv_values.mean(axis=1)[:, 0]
    row.update(mbar_converged=bool(mb.converged), mbar_iterations=mb.n_iter,
               window_free_energies=mb.free_energies.tolist(),
               mean_abs_cv_minus_center=float(np.abs(means - centers).mean()))
    log(f"  d: MBAR over {w.size} frames in {row['mbar_s']:.2f} s, "
        f"{mb.n_iter} iterations, converged {mb.converged}; window free "
        f"energies {np.round(mb.free_energies, 2).tolist()} kT; mean |CV - "
        f"center| {row['mean_abs_cv_minus_center']:.3f}")
    if not (mb.converged and np.isfinite(w).all() and abs(w.mean() - 1) < 1e-9):
        raise AssertionError("d: MBAR did not give finite weights of mean 1")
    out["d umbrella"] = row

    # (e) replica exchange: replica_exchange.py:65-70
    eeb = REMD_EXCHANGE // REMD_REPORT

    def remd(**over):
        kw = dict(n_steps=REMD_STEPS, X0=[-1.0, 0.0], step_size=REMD_DT,
                  report_interval=REMD_REPORT, exchange_interval=REMD_EXCHANGE,
                  seed=1, verbose=False, device=dev,
                  sampling_output_path=f"{tmp}/remd")
        kw.update(over)
        return integrate_sde_remd(DoubleWell2D(), list(REMD_BETAS), **kw)

    rem, row = sampler_run(
        "e remd", remd, (REMD_STEPS - 1) // REMD_REPORT + 1,
        len(REMD_BETAS), REMD_STEPS,
        lambda r, m: (r.frames[:, :m], r.energies[:, :m],
                      r.swap_history[:m]),
        card, dict(n_steps=PROFILE_BLOCKS * REMD_REPORT),
        twin_blocks=2 * eeb + 1)
    cold = float((rem.frames[0, :, 0] > 0).mean())
    row.update(pair_acceptance=rem.pair_acceptance.tolist(),
               cold_right_well_fraction=cold)
    log(f"  e: pair acceptance {np.round(rem.pair_acceptance, 3).tolist()}, "
        f"cold slot right-well fraction {cold:.3f}")
    if not 0.1 < cold < 0.9:
        raise AssertionError("e: the cold slot did not visit both wells")
    out["e remd"] = row
    out["launches"] = {"fused_align":
                       out["c metadynamics through K2"]["launches"]
                       ["fused_align"]}
    tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {out['phase_s']:.1f} s")
    return out


def md_topology(seed):
    """The 22-atom ACE-ALA-NME topology: a bent backbone with jittered
    substituents (the geometry of examples/dipeptide.py:55-82)."""
    from colvarsfinder_tpu_torch.utils.io import Topology

    rng = np.random.default_rng(seed)
    pos = np.zeros((22, 3), dtype=np.float32)
    backbone = {1: 0, 4: 1, 6: 2, 8: 3, 14: 4, 16: 5, 18: 6}
    for i in range(22):
        if i in backbone:
            b = backbone[i]
            pos[i] = [0.14 * b, 0.05 * ((-1) ** b), 0.02 * b]
        else:
            anchor = max((a for a in backbone if a <= i), default=1)
            pos[i] = pos[anchor] + 0.1 * rng.standard_normal(3)
    return Topology(names=list(MD_NAMES), resids=list(MD_RESIDS),
                    resnames=list(MD_RESNAMES), positions=pos,
                    title="ACE-ALA-NME, chip_smoke phase 13")


def md_frames(top, n, seed):
    """n frames [n, 22, 3]: the heavy atoms (C, N, O) as make_data's
    noise around the topology's positions, each hydrogen at its fixed
    offset from the heavy atom before it, with small noise."""
    rng = np.random.default_rng(seed)
    heavy = np.array([not name.startswith("H") for name in top.names])
    pos = top.positions
    frames = np.empty((n, 22, 3), dtype=np.float32)
    frames[:, heavy] = pos[heavy] + 0.3 * rng.standard_normal(
        (n, int(heavy.sum()), 3), dtype=np.float32)
    hyd = np.nonzero(~heavy)[0]
    # a hydrogen's heavy atom: the nearest heavy atom before it in the file
    # (the methyl hydrogen before the ACE carbon takes that carbon)
    host = np.array([max((j for j in np.nonzero(heavy)[0] if j < h),
                         default=1) for h in hyd])
    frames[:, hyd] = (frames[:, host] + (pos[hyd] - pos[host])
                      + MD_H_NOISE * rng.standard_normal(
                          (n, hyd.size, 3), dtype=np.float32))
    return frames


def xtc_head(path, out_path, n_frames):
    """Copy an XTC file's first n_frames frames into out_path, by walking
    the frame headers."""
    from colvarsfinder_tpu_torch.utils import xtc

    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    for _ in range(n_frames):
        off, _natoms, _t = xtc._skip_frame(buf, off)
    with open(out_path, "wb") as f:
        f.write(buf[:off])


def python_read_xtc(path):
    """The pure-Python XTC decoder (the native one switched off)."""
    from colvarsfinder_tpu_torch.utils import native_io, xtc

    real = native_io.decode_xtc
    native_io.decode_xtc = lambda *a, **k: None
    try:
        return xtc.read_xtc(path)
    finally:
        native_io.decode_xtc = real


def phase_md_input(card, cvf):
    """Phase 13: the reference's MD workflow, gro + a chain of XTC files ->
    Universe -> select_atoms -> WeightedTrajectory -> the fused task (K2,
    K3, K4), on frames decoded by the native reader."""
    from colvarsfinder_tpu_torch.ops import _cuda
    from colvarsfinder_tpu_torch.utils import (
        Universe,
        native_io,
        write_gro,
        write_xtc,
    )

    t_phase = time.perf_counter()
    n_total = MD_FILES * MD_FRAMES_PER_FILE
    # (a) the native reader builds here, and decodes both files
    if not native_io.available():
        raise AssertionError("the native IO library did not build "
                             "(native/fastio.cpp, g++)")
    native_decodes = []
    real_decode = native_io.decode_xtc

    def recording_decode(filename, *a, **k):
        got = real_decode(filename, *a, **k)
        native_decodes.append((filename, got is not None))
        return got

    top = md_topology(0)
    t0 = time.perf_counter()
    frames = md_frames(top, n_total, seed=0)
    log(f"  {n_total:,} frames of {top.n_atoms} atoms made from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        gro = os.path.join(tmp, "top.gro")
        write_gro(gro, top)
        paths, write_s, file_mb = [], [], []
        for i in range(MD_FILES):
            path = os.path.join(tmp, f"md_{i}.xtc")
            lo = i * MD_FRAMES_PER_FILE
            t0 = time.perf_counter()
            write_xtc(path, frames[lo:lo + MD_FRAMES_PER_FILE],
                      dt_ps=MD_DT_PS, precision=MD_PRECISION,
                      t0_ps=lo * MD_DT_PS, step_interval=1)
            write_s.append(time.perf_counter() - t0)
            file_mb.append(os.path.getsize(path) / 1e6)
            paths.append(path)
            log(f"  write_xtc {path.rsplit('/', 1)[1]}: "
                f"{MD_FRAMES_PER_FILE:,} frames, {file_mb[-1]:.2f} MB in "
                f"{write_s[-1]:.3f} s ({card})")

        native_io.decode_xtc = recording_decode
        try:
            t0 = time.perf_counter()
            u = Universe(gro, paths)
            universe_s = time.perf_counter() - t0
        finally:
            native_io.decode_xtc = real_decode
        if [p for p, native in native_decodes] != paths or not all(
                native for _p, native in native_decodes):
            raise AssertionError(f"not every file decoded natively: "
                                 f"{native_decodes}")
        mb = sum(file_mb)
        log(f"  Universe(gro, [{MD_FILES} xtc]) in {universe_s:.3f} s: "
            f"{n_total / universe_s:,.0f} frames/s, {mb / universe_s:.1f} "
            f"MB/s of XTC, both files through the native decoder ({card})")
        decoded = u.trajectory.timeseries(order="fac")
        if decoded.shape != (n_total, 22, 3):
            raise AssertionError(f"decoded shape {decoded.shape}")

        # (b) bit for bit the Python decoder on each file's first frames
        for i, path in enumerate(paths):
            head = os.path.join(tmp, f"head_{i}.xtc")
            xtc_head(path, head, MD_PY_FRAMES)
            py, py_dt, _times = python_read_xtc(head)
            lo = i * MD_FRAMES_PER_FILE
            if not np.array_equal(py, decoded[lo:lo + MD_PY_FRAMES]):
                raise AssertionError(f"{path}: the native decode differs "
                                     "from the Python decoder")
            if py_dt != MD_DT_PS:
                raise AssertionError(f"Python decoder's dt {py_dt}")
        log(f"  native decode bit for bit the Python decoder on the first "
            f"{MD_PY_FRAMES:,} frames of each file: True")

        # (c) within half an XTC step (and float32 rounding) of the input
        err = float(np.abs(decoded - frames).max())
        bar = (0.5 / MD_PRECISION
               + 2 * np.finfo(np.float32).eps * float(np.abs(frames).max()))
        log(f"  read vs written: max |error| {err:.3e} nm over {n_total:,} "
            f"frames (bar {bar:.3e})")
        if not err <= bar:
            raise AssertionError(f"XTC round trip error {err} > {bar}")
        del frames

    # (d) the restart chain's boundary and the files' frame spacing
    seg = u.trajectory.segment_starts
    if seg is None or list(seg) != [0, MD_FRAMES_PER_FILE]:
        raise AssertionError(f"segment_starts {seg}")
    if u.trajectory.dt != MD_DT_PS:
        raise AssertionError(f"Universe dt {u.trajectory.dt} ps")

    sel = u.select_atoms("type C or type O or type N")
    if len(sel) != N_ATOMS:
        raise AssertionError(f"{len(sel)} heavy atoms selected")
    w = np.random.default_rng(3).uniform(0.5, 1.5, n_total)
    t0 = time.perf_counter()
    traj = cvf.WeightedTrajectory(universe=u, input_ag=sel, weights=w,
                                  verbose=False)
    wt_s = time.perf_counter() - t0
    log(f"  WeightedTrajectory(universe=u, input_ag=10 heavy atoms) in "
        f"{wt_s:.3f} s, trajectory {traj.trajectory.shape} ({card})")
    if traj.dt != MD_DT_PS * 1e-3:
        raise AssertionError(f"trajectory dt {traj.dt} ns")
    if list(traj.segment_starts) != [0, MD_FRAMES_PER_FILE]:
        raise AssertionError(f"segment_starts {traj.segment_starts}")
    twin_traj = cvf.WeightedTrajectory(
        trajectory=decoded[:, sel.ix, :], weights=w, dt=traj.dt,
        segment_starts=[0, MD_FRAMES_PER_FILE], verbose=False)

    # (e), (f): the fused task on the Universe's frames and on the array
    n_pairs = len(traj.valid_lagged_starts(LAG))
    n_test = math.ceil(TEST_RATIO * n_pairs)
    nb_train = (n_pairs - n_test) // BATCH
    nb_test = 1 if n_test < BATCH else n_test // BATCH
    ref = sel.positions
    tasks = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, obj in (("universe", traj), ("array", twin_traj)):
            task = make_task(cvf, obj, ref, f"{tmp}/{label}", True, "fused",
                             MD_EPOCHS, dt=obj.dt)
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            task.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            want = {**dict.fromkeys(counts, 0),
                    "fused_align": 2 * MD_EPOCHS * (nb_train + nb_test),
                    "stats_fwd": MD_EPOCHS * (nb_train + nb_test),
                    "stats_bwd": MD_EPOCHS * nb_train}
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, the "
                                     f"schedule implies {want}")
            if not np.isfinite(task.train_loss).all():
                raise AssertionError(f"{label}: non-finite metrics")
            if "epoch" not in task._graphs:
                raise AssertionError(f"{label}: no captured epoch")
            steady = statistics.median(task.epoch_times[2:])
            sps = nb_train * BATCH / steady
            loss = task.train_loss[:, 0]
            log(f"  fused task on the {label} branch: {MD_EPOCHS} epochs in "
                f"{wall:.2f} s, loss {loss[0]:.5f} -> {loss[-1]:.5f}, "
                f"{sps:,.0f} samples/s steady ({card}); launches {counts}, "
                f"per train step K2 {2 * (nb_train + nb_test) / nb_train:.3f}"
                f", K3 {(nb_train + nb_test) / nb_train:.3f}, K4 1")
            tasks[label] = dict(task=task, counts=counts, sps=sps,
                                wall=wall)
    a, b = tasks["universe"]["task"], tasks["array"]["task"]
    same = np.array_equal(loss_rows(a), loss_rows(b)) and all(
        torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                          b.model.parameters()))
    log(f"  Universe-fed task vs its array-fed twin: every metric row and "
        f"final parameter bit for bit equal: {same}")
    if not same:
        raise AssertionError("the Universe-fed task differs from its twin")
    for r in tasks.values():
        r["task"].release_device_data()

    # (g) the backbone torsions of the topology, as features of the
    # selection, on the card against the CPU
    feats = cvf.ops.backbone_dihedrals(u.atoms)
    found = {f.name: f.atom_indices for f in feats}
    if found != {"phi_2": MD_PHI, "psi_2": MD_PSI}:
        raise AssertionError(f"backbone_dihedrals found {found}")
    layer = cvf.FeatureLayer(feats, input_ag=sel)
    x = torch.from_numpy(np.ascontiguousarray(
        traj.trajectory[:MD_FEATURE_FRAMES]))
    on_card = layer.to("cuda")(x.cuda()).cpu()
    on_cpu = layer.to("cpu")(x)
    feat_err = max_err(on_card, on_cpu)
    log(f"  backbone_dihedrals: {found}; FeatureLayer on {MD_FEATURE_FRAMES:,}"
        f" frames, card vs CPU max |diff| {feat_err:.3e} (bar "
        f"{MD_FEATURE_ATOL})")
    if on_card.shape != (MD_FEATURE_FRAMES, 4) or not feat_err <= \
            MD_FEATURE_ATOL:
        raise AssertionError(f"features {tuple(on_card.shape)}, card vs "
                             f"CPU {feat_err}")
    launches = {name: tasks["universe"]["counts"][name]
                for name in ("fused_align", "stats_fwd", "stats_bwd")}
    sps = tasks["universe"]["sps"]
    del decoded, traj, twin_traj, u, tasks, a, b
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(
        frames=n_total, files=MD_FILES, write_s=write_s, file_mb=file_mb,
        universe_s=universe_s, decode_frames_per_s=n_total / universe_s,
        decode_mb_per_s=mb / universe_s, weighted_trajectory_s=wt_s,
        train_samples_per_s=sps, max_abs_xtc_err=err,
        feature_max_abs_diff=feat_err, launches=launches)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 13 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: analysis, autotune and the adaptive loop on the card


def per_batch(counts, task, epochs):
    """Launches per batch (K1, K2, K3, K6) and per train step (K4) of
    ``epochs`` epochs of ``task``."""
    nb_train = len(task.loss_list[0][0])
    nb_all = nb_train + len(task.loss_list[0][1])
    return {"kabsch_qcp": counts["kabsch_qcp"] / (epochs * nb_all),
            "kabsch_exact": counts["kabsch_exact"] / (epochs * nb_all),
            "fused_align": counts["fused_align"] / (epochs * nb_all),
            "stats_fwd": counts["stats_fwd"] / (epochs * nb_all),
            "stats_bwd": counts["stats_bwd"] / (epochs * nb_train)}


def counting_train(task, log_to):
    """Wrap ``task.train`` to append each call's launches to ``log_to``."""
    from colvarsfinder_tpu_torch.ops import _cuda

    real = task.train

    def train():
        before = _cuda.launch_counts()
        real()
        after = _cuda.launch_counts()
        log_to.append({k: after[k] - before[k] for k in after})

    task.train = train
    return task


def phase_drivers(card, ref, traj_np, w_np, cvf, runs):
    """Phase 14: autotune over the kernel knobs, the adaptive loop, input
    sensitivities through K2 and the host-side validation battery."""
    from colvarsfinder_tpu_torch import analysis, config, tune, workflow
    from colvarsfinder_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    out = {}
    _cuda.reset_launch_counts()
    phase4 = {label: per_batch(runs[label]["counts"], runs[label]["task"],
                               runs[label]["epochs"])
              for label in ("fused", "k1", "plain")}
    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=DT, verbose=False)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name

    # (a) autotune: each variant's launches per batch against phase 4's
    # route, the config restored, nothing skipped
    t0 = time.perf_counter()
    tune_counts = {}

    def factory(fused_step=False, method=None):
        method = method or ("fused" if fused_step else "quaternion")
        key = (bool(fused_step), method)
        task = make_task(cvf, traj_obj, ref, f"{tmp}/tune{len(tune_counts)}",
                         fused_step, method, TUNE_EPOCHS,
                         align_weights=ALIGN_WEIGHTS if method == "cuda"
                         else None)
        return counting_train(task, tune_counts.setdefault(key, []))

    before = (config.matmul_precision(), config.compute_dtype_name(),
              config.bf16_style())
    ranking = tune.autotune(factory, TUNE_VARIANTS, reps=TUNE_REPS)
    after = (config.matmul_precision(), config.compute_dtype_name(),
             config.bf16_style())
    if after != before:
        raise AssertionError(f"autotune left the config {after}, not {before}")
    if len(ranking) != len(TUNE_VARIANTS):
        raise AssertionError(f"autotune skipped a variant: {len(ranking)} of "
                             f"{len(TUNE_VARIANTS)} ran")
    routes = {(False, "quaternion"): "plain", (True, "fused"): "fused",
              (True, "cuda"): "k1"}
    for key, calls in tune_counts.items():
        # every train() call of every variant on this route, a fresh task
        # per variant: TUNE_REPS + 1 calls of TUNE_EPOCHS each
        task_calls = len(calls)
        total = {k: sum(c[k] for c in calls) for k in calls[0]}
        nb_task = runs[routes[key]]["task"]
        got = per_batch(total, nb_task, TUNE_EPOCHS * task_calls)
        if got != phase4[routes[key]]:
            raise AssertionError(f"autotune route {key}: launches per batch "
                                 f"{got}, phase 4's {phase4[routes[key]]}")
    order = [r.overrides for r in ranking]
    if not order.index({"fused_step": True}) < order.index({}):
        raise AssertionError(f"the fused step ranks below the plain one: "
                             f"{order}")
    out["autotune"] = dict(
        ranking=[dict(overrides=r.overrides, best_s=r.best_seconds,
                      speedup=r.speedup, final_loss=r.final_train_loss)
                 for r in ranking],
        launches_per_batch={routes[k]: phase4[routes[k]] for k in tune_counts},
        seconds=time.perf_counter() - t0)
    log(f"  a autotune ({TUNE_EPOCHS} epochs a call, reps {TUNE_REPS}) on "
        f"{card}, fastest first:")
    for r in ranking:
        log(f"    {r.speedup:6.2f}x  {r.best_seconds:.4f} s  loss "
            f"{r.final_train_loss:.5f}  {r.overrides or '{plain}'}")
    log(f"  a launches per batch equal to phase 4's route for every variant; "
        f"config restored {after}; {out['autotune']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the adaptive loop along phase 4's fused task in the harmonic well
    t0 = time.perf_counter()
    # every round's task in order (both runs), its train() launches and the
    # parameters it entered train() with
    tasks, calls, entry, metad_counts = [], [], [], []

    def wf_task(traj, r):
        task = make_task(cvf, traj, ref, f"{tmp}/wf{len(tasks)}", True,
                         "fused", WF_EPOCHS, dt=traj.dt, batch=WF_BATCH,
                         test_ratio=0.2, flat=True, model_seed=r)
        tasks.append(task)
        calls.append([])
        counting_train(task, calls[-1])
        counted = task.train

        def train():
            entry.append([p.detach().clone() for p in task.model.parameters()])
            counted()

        task.train = train
        return task

    real_metad = workflow.integrate_sde_metadynamics

    def counted_metad(*a, **k):
        before = _cuda.launch_counts()["fused_align"]
        res = real_metad(*a, **k)
        metad_counts.append((_cuda.launch_counts()["fused_align"] - before,
                             k["n_steps"], k["deposit_interval"]))
        return res

    wf_kw = dict(X0=ref.reshape(-1).astype(np.float64),
                 unbiased_steps=WF_UNBIASED, metad_steps=WF_METAD,
                 step_size=METAD_DT, frame_interval=METAD_DEPOSIT,
                 hill_height=METAD_HEIGHT, bias_factor=METAD_GAMMA,
                 warm_start=True, seed=5, verbose=True, device="cuda")
    workflow.integrate_sde_metadynamics = counted_metad
    try:
        res = workflow.adaptive_cv_discovery(
            HarmonicWell(ref), wf_task, n_rounds=WF_ROUNDS,
            output_path=f"{tmp}/adaptive", **wf_kw)
        rerun = workflow.adaptive_cv_discovery(
            HarmonicWell(ref), wf_task, n_rounds=2,
            output_path=f"{tmp}/adaptive_again", **wf_kw)
    finally:
        workflow.integrate_sde_metadynamics = real_metad
    wf_s = time.perf_counter() - t0
    for n_k2, steps, deposit in metad_counts:
        # one a step, one a deposition, one to size the CV (phase 12)
        if n_k2 != steps + steps // deposit + 1:
            raise AssertionError(f"b metadynamics: K2 {n_k2} launches over "
                                 f"{steps} steps")
    k2_per_step = metad_counts[0][0] / metad_counts[0][1]
    for task, task_calls in zip(tasks, calls):
        got = per_batch(task_calls[0], task, WF_EPOCHS)
        if got != phase4["fused"]:
            raise AssertionError(f"b training launches per batch {got}, "
                                 f"phase 4's {phase4['fused']}")
    lengths = [r.segment.n_frames for r in res.rounds]
    if list(res.pooled.segment_starts) != list(np.cumsum([0] + lengths[:-1])):
        raise AssertionError(f"pooled segment_starts "
                             f"{res.pooled.segment_starts}, lengths {lengths}")
    means = [float(r.segment.weights.mean()) for r in res.rounds]
    if not all(abs(m - 1.0) < 1e-5 for m in means):
        raise AssertionError(f"segment weights' means {means}")
    # rounds 1.. of each run start from the previous round's trained
    # parameters (tasks WF_ROUNDS and WF_ROUNDS + 1 are the rerun's)
    warm_pairs = [(i, i - 1) for i in range(1, len(tasks)) if i != WF_ROUNDS]
    warm = all(torch.equal(a, b) for i, j in warm_pairs
               for a, b in zip(entry[i], tasks[j].model.parameters()))
    if not warm:
        raise AssertionError("a warm-started round did not start from the "
                             "previous round's trained parameters")
    same = all(
        np.array_equal(a.segment.trajectory, b.segment.trajectory)
        and np.array_equal(a.segment.weights, b.segment.weights)
        and np.array_equal(a.task.train_loss, b.task.train_loss)
        and all(torch.equal(p, q) for p, q in zip(a.task.model.parameters(),
                                                  b.task.model.parameters()))
        for a, b in zip(res.rounds[:2], rerun.rounds))
    if not same:
        raise AssertionError("the adaptive loop's rerun differs")
    spans = res.cv_range_per_round()
    if not np.isfinite(spans).all():
        raise AssertionError(f"cv_range_per_round {spans}")
    out["adaptive"] = dict(
        rounds=WF_ROUNDS, frames=lengths, seconds=wf_s,
        k2_per_metad_step=k2_per_step, phase12_k2_per_step=(
            METAD_STEPS + METAD_STEPS // METAD_DEPOSIT + 1) / METAD_STEPS,
        launches_per_batch=phase4["fused"], cv_range_per_round=spans.tolist(),
        final_losses=[float(r.task.train_loss[-1, 0]) for r in res.rounds])
    log(f"  b adaptive_cv_discovery, {WF_ROUNDS} rounds ({WF_UNBIASED:,} "
        f"unbiased, {WF_METAD:,} biased steps a round, warm starts) and the "
        f"first two again: {wf_s:.1f} s on {card}; frames {lengths}; K2 "
        f"{k2_per_step:.4f} per metadynamics step (phase 12's rule, "
        f"{out['adaptive']['phase12_k2_per_step']:.4f} at its 4,000 steps); "
        f"training launches per batch as phase 4's; segment_starts "
        f"{res.pooled.segment_starts.tolist()}; weight means {means}; warm "
        f"starts bit for bit: {warm}; rerun bit for bit: {same}; CV range "
        f"per round {np.round(spans[:, 0], 4).tolist()}")
    for task in tasks:
        task.release_device_data()
    del rerun, res, tasks, entry
    gc.collect()
    torch.cuda.empty_cache()

    # (c) input sensitivities of phase 4's fused CV through K2, against
    # the plain layer on the card and against the CPU
    cv = runs["fused"]["task"].colvar_model()
    frames = traj_np[:SENS_FRAMES]
    weights = w_np[:SENS_FRAMES]
    before = _cuda.launch_counts()["fused_align"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sens = analysis.cv_sensitivity(cv, frames, weights=weights,
                                   aggregate="xyz", batch_size=SENS_BATCH)
    sens_s = time.perf_counter() - t0
    k2 = _cuda.launch_counts()["fused_align"] - before
    chunks = -(-SENS_FRAMES // SENS_BATCH)
    if k2 != chunks:
        raise AssertionError(f"c: K2 launched {k2} times, {chunks} chunks")
    pp = cvf.PreprocessingANN(
        cvf.AlignmentLayer(ref, list(range(N_ATOMS)), method="quaternion"),
        cvf.FeatureLayer([cvf.Feature("p", "position",
                                      list(range(N_ATOMS)))]))
    plain_cv = cvf.ColvarModel(pp, cv.head).cuda()
    plain = analysis.cv_sensitivity(plain_cv, frames, weights=weights,
                                    aggregate="xyz", batch_size=SENS_BATCH)
    cpu = analysis.cv_sensitivity(copy.deepcopy(cv).cpu(), frames,
                                  weights=weights, aggregate="xyz",
                                  batch_size=SENS_BATCH)
    gaps = {}
    for label, other in (("plain layer", plain), ("cpu", cpu)):
        scale = float(np.abs(other.sensitivity).max())
        err = np.abs(sens.sensitivity - other.sensitivity)
        gaps[label] = float((err / (SENS_ATOL * scale
                                    + SENS_RTOL * np.abs(other.sensitivity)))
                            .max())
        if not gaps[label] <= 1.0:
            raise AssertionError(f"c: sensitivities against the {label} "
                                 f"reach {gaps[label]:.3f} of the bar")
    out["sensitivity"] = dict(frames=SENS_FRAMES, seconds=sens_s,
                              k2_launches=k2, bar_fraction=gaps,
                              top=sens.top(0, 3))
    log(f"  c cv_sensitivity of phase 4's fused CV on {SENS_FRAMES:,} frames "
        f"(xyz): {sens_s:.3f} s on {card}, K2 launched {k2} times (one a "
        f"chunk of {SENS_BATCH}); largest gap as a fraction of the bar "
        f"(rtol {SENS_RTOL}, atol {SENS_ATOL} of the largest entry): "
        f"{gaps}; top atoms of CV 1 {sens.top(0, 3)}")

    # (d) the host battery on phase 4's CV values, timed
    y = analysis._cv_on_numpy(cv, traj_np)
    battery = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        res = fn()
        battery[name] = time.perf_counter() - t1
        return res

    val = timed("validate_cv", lambda: analysis.validate_cv(
        y, lag=LAG, dt=DT, weights=w_np))
    timed("tica", lambda: analysis.tica(y, lag=LAG, weights=w_np))
    assign, _ = timed("discretize", lambda: analysis.discretize(y[:, 0], 40))
    model = timed("msm", lambda: analysis.msm(assign, lag=LAG, n_states=40,
                                             weights=w_np))
    timed("pcca", lambda: model.pcca(2))
    mfpt = timed("mfpt", lambda: model.mfpt(
        [int(np.argmax(model.stationary))], dt=DT))
    timed("msm_ck_test", lambda: analysis.msm_ck_test(
        assign, lag=LAG, n_sets=2, n_states=40, weights=w_np))
    fes = timed("free_energy_profile", lambda: analysis.free_energy_profile(
        y[:, 0], weights=w_np, bins=40, n_bootstrap=16, block_frames=100))
    if not (np.isfinite(fes[1]).any() and np.isfinite(mfpt).any()):
        raise AssertionError("d: no finite free energy or MFPT")
    out["battery_s"] = battery
    log(f"  d host battery on {len(y):,} CV values (seconds, host numpy): "
        + ", ".join(f"{k} {v:.3f}" for k, v in battery.items())
        + f"; validate_cv {val!r}".replace("\n", " "))
    tmp_dir.cleanup()
    out["launches"] = _cuda.launch_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the enhanced samplers on a mesh of one NCCL rank


def same_dirs(a, b):
    """Two directories hold the same files, byte for byte."""
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        open(os.path.join(a, n), "rb").read()
        == open(os.path.join(b, n), "rb").read() for n in names)


def mesh_twins(label, call, chains, steps, blocks, mesh, card, short_over,
               tmp=None, exchanges=0):
    """Phase 15's measurements of one sampler: ``call(**over)`` unmeshed
    and with ``mesh=`` (the same seed), each timed; every array of the two
    results, and the files they wrote under ``tmp``, bit for bit equal; K2
    launches and graph replays (``graphs.replay`` calls) of the meshed call
    over its ``blocks`` blocks. A short meshed call with ``short_over``
    under torch.profiler: NCCL's kernels and the device copies of its one
    final all-gather (and its ``exchanges`` exchange blocks' all-gathers).
    With exchanges, the same short call unmeshed too: what the mesh adds
    (device copies, activities and device time), per exchange."""
    from colvarsfinder_tpu_torch import graphs
    from colvarsfinder_tpu_torch.ops import _cuda

    replay, replays = graphs.replay, [0]

    def counted(graph, launches):
        replays[0] += 1
        replay(graph, launches)

    got = {}
    for tag, over in (("unmeshed", {}), ("meshed", {"mesh": mesh})):
        if tmp is not None:
            over["sampling_output_path"] = f"{tmp}/{label}-{tag}"
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        graphs.replay = counted if tag == "meshed" else replay
        try:
            t0 = time.perf_counter()
            res = call(**over)
            torch.cuda.synchronize()
        finally:
            graphs.replay = replay
        got[tag] = (res, time.perf_counter() - t0, _cuda.launch_counts())
    a, b = (result_arrays(got[t][0]) for t in ("unmeshed", "meshed"))
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    files = tmp is None or same_dirs(f"{tmp}/{label}-unmeshed",
                                     f"{tmp}/{label}-meshed")
    if not (same and files):
        gaps = {k: float(np.abs(np.asarray(a[k], np.float64)
                                - np.asarray(b[k], np.float64)).max())
                for k in a if k in b}
        raise AssertionError(f"{label}: the meshed run differs from the "
                             f"unmeshed one (files equal: {files}; max gaps "
                             f"{gaps})")
    prof_rows = {}
    t0 = time.perf_counter()
    for tag in ("meshed", "unmeshed") if exchanges else ("meshed",):
        over = {"mesh": mesh} if tag == "meshed" else {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call(**over, **short_over)
            torch.cuda.synchronize()
        acts = device_activities(prof)
        prof_rows[tag] = dict(
            nccl={e.key: [e.count, e.self_device_time_total] for e in acts
                  if any(n in e.key.lower() for n in NCCL_KERNEL_NAMES)},
            copies={e.key: [e.count, e.self_device_time_total] for e in acts
                    if "memcpy dtod" in e.key.lower()},
            device_us=sum(e.self_device_time_total for e in acts),
            activities=sum(e.count for e in acts))
    profiled_s = time.perf_counter() - t0
    pm = prof_rows["meshed"]
    walls = {t: got[t][1] for t in got}
    row = dict(
        chains=chains, steps=steps, blocks=blocks, wall_s=walls,
        chain_steps_per_s={t: chains * steps / w for t, w in walls.items()},
        launches=got["meshed"][2], bitwise=same, files_bitwise=files,
        graph_replays_per_block=replays[0] / blocks,
        nccl_kernels_per_call=sum(c for c, _ in pm["nccl"].values()),
        nccl_us_per_call=sum(u for _, u in pm["nccl"].values()),
        profiled=prof_rows, profiled_s=profiled_s,
        profiled_call={k: v for k, v in short_over.items()
                       if np.isscalar(v)})
    row["vs_unmeshed"] = (row["chain_steps_per_s"]["meshed"]
                          / row["chain_steps_per_s"]["unmeshed"])
    log(f"  {label}: {chains} x {steps:,} steps, unmeshed "
        f"{row['chain_steps_per_s']['unmeshed']:,.0f} chain-steps/s "
        f"({walls['unmeshed']:.2f} s), meshed "
        f"{row['chain_steps_per_s']['meshed']:,.0f} ({walls['meshed']:.2f} "
        f"s, {100 * row['vs_unmeshed']:.1f}%); arrays bit for bit: {same}, "
        f"files bit for bit: {files}; meshed call: launches "
        f"{got['meshed'][2]}, {replays[0]} graph replays over {blocks} "
        f"blocks ({row['graph_replays_per_block']:.3f} per block) ({card})")
    log(f"    profiled meshed call {row['profiled_call']} ({profiled_s:.2f} "
        f"s): NCCL kernels {pm['nccl']} (count, device us), device copies "
        f"{pm['copies']}")
    if exchanges:
        pu = prof_rows["unmeshed"]
        added = dict(
            nccl_kernels=row["nccl_kernels_per_call"],
            copies=(sum(c for c, _ in pm["copies"].values())
                    - sum(c for c, _ in pu["copies"].values())),
            copies_us=(sum(u for _, u in pm["copies"].values())
                       - sum(u for _, u in pu["copies"].values())),
            activities=pm["activities"] - pu["activities"],
            device_us=pm["device_us"] - pu["device_us"])
        row["added_by_mesh_per_exchange"] = {k: v / exchanges
                                             for k, v in added.items()}
        log(f"    what the mesh adds to the profiled call, per exchange "
            f"(with the call's one final gather and each block's copy of "
            f"its increments): {row['added_by_mesh_per_exchange']}")
    return got["meshed"][0], row


def phase_mesh_samplers(card, ref, traj_np, runs, cvf):
    """Phase 15: the four enhanced samplers with ``mesh=`` at one rank of
    an NCCL group, each bit for bit its unmeshed twin."""
    import torch.distributed as dist

    from colvarsfinder_tpu_torch.parallel import make_data_mesh
    from colvarsfinder_tpu_torch.utils import (
        integrate_sde_metadynamics,
        integrate_sde_remd,
        integrate_sde_steered,
        integrate_sde_umbrella,
    )

    t_phase = time.perf_counter()
    for r in runs.values():
        r["task"].release_device_data()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    out = {}
    init = os.path.join(tempfile.gettempdir(), f"cvf_mesh15_{os.getpid()}")
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    try:
        mesh = make_data_mesh()
        log(f"  {mesh}: backend {dist.get_backend()}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}")

        # (a) metadynamics along phase 4's fused CV, phase 12 (c)'s settings
        cv = runs["fused"]["task"].colvar_model()

        def flat_cv(x):
            return cv(x.reshape(-1, N_ATOMS, 3))

        with torch.no_grad():
            sample = torch.from_numpy(traj_np[:BATCH]).cuda()
            width = METAD_WIDTH_STD * float(cv(sample).std())
        x0 = (ref.reshape(-1)[None] + 0.3 * np.random.default_rng(
            12).standard_normal((METAD_WALKERS, 3 * N_ATOMS))).astype(
                np.float32)

        def metad(**over):
            kw = dict(n_steps=MESH_METAD_STEPS, deposit_interval=METAD_DEPOSIT,
                      step_size=METAD_DT, hill_height=METAD_HEIGHT,
                      hill_width=width, bias_factor=METAD_GAMMA,
                      n_chains=METAD_WALKERS, X0=x0, seed=11, verbose=False,
                      device=dev)
            kw.update(over)
            return integrate_sde_metadynamics(HarmonicWell(ref), flat_cv,
                                              **kw)

        _, row = mesh_twins(
            "a metadynamics through K2", metad, METAD_WALKERS,
            MESH_METAD_STEPS, MESH_METAD_STEPS // METAD_DEPOSIT, mesh, card,
            dict(n_steps=2, deposit_interval=1), tmp=tmp)
        row["k2_per_step"] = row["launches"]["fused_align"] / MESH_METAD_STEPS
        log(f"  a: K2 {row['launches']['fused_align']} launches in the "
            f"meshed call, {row['k2_per_step']:.4f} per step")
        if row["k2_per_step"] < 1:
            raise AssertionError("meshed metadynamics along the fused CV did "
                                 "not launch K2 in every step")
        out["a metadynamics"] = row

        # (b) umbrella windows and MBAR, (c) steered pulls: phase 12 (d)
        centers = np.linspace(*UMB_RANGE, UMB_WINDOWS)
        kappa = 4.0 / (SAMPLER_BETA * (centers[1] - centers[0]) ** 2)
        starts = np.stack([np.cos(centers), np.sin(centers)], axis=1)

        def umbrella(**over):
            kw = dict(n_steps=MESH_UMB_STEPS, X0=starts, pre_steps=UMB_PRE,
                      step_size=UMB_DT, report_interval=UMB_REPORT, seed=11,
                      verbose=False, device=dev)
            kw.update(over)
            return integrate_sde_umbrella(TripleWellCircle(), angle_cv,
                                          centers, kappa, **kw)

        umb, row = mesh_twins(
            "b umbrella", umbrella, UMB_WINDOWS, MESH_UMB_STEPS,
            (UMB_PRE + MESH_UMB_STEPS) // UMB_REPORT, mesh, card,
            dict(n_steps=PROFILE_BLOCKS * UMB_REPORT, pre_steps=0), tmp=tmp)
        t0 = time.perf_counter()
        mb = umb.mbar()
        row["mbar_s"] = time.perf_counter() - t0
        w = np.concatenate(mb.weights)
        row.update(mbar_converged=bool(mb.converged),
                   window_free_energies=mb.free_energies.tolist())
        log(f"  b: MBAR over the meshed windows' {w.size} frames in "
            f"{row['mbar_s']:.2f} s, converged {mb.converged}, free "
            f"energies {np.round(mb.free_energies, 2).tolist()} kT")
        if not (mb.converged and np.isfinite(w).all()):
            raise AssertionError("b: MBAR of the meshed windows failed")
        out["b umbrella"] = row

        def pull(**over):
            kw = dict(n_steps=MESH_UMB_STEPS, n_realizations=UMB_WINDOWS,
                      X0=[1.0, 0.0], pre_steps=UMB_PRE, step_size=UMB_DT,
                      report_interval=PULL_REPORT, seed=7, verbose=False,
                      device=dev)
            kw.update(over)
            return integrate_sde_steered(TripleWellCircle(), angle_cv,
                                         UMB_RANGE[0], UMB_RANGE[1],
                                         10 * kappa, **kw)

        pulled, row = mesh_twins(
            "c steered", pull, UMB_WINDOWS, MESH_UMB_STEPS,
            (UMB_PRE + MESH_UMB_STEPS) // PULL_REPORT, mesh, card,
            dict(n_steps=2 * UMB_REPORT, report_interval=UMB_REPORT,
                 pre_steps=0, X0=np.tile([1.0, 0.0], (UMB_WINDOWS, 1))))
        row["jarzynski_end"] = float(pulled.jarzynski()[-1])
        if not np.isfinite(pulled.jarzynski()).all():
            raise AssertionError("c: non-finite Jarzynski estimate")
        out["c steered"] = row

        # (d) replica exchange: phase 12 (e)'s ladder and exchanges
        eeb = REMD_EXCHANGE // REMD_REPORT

        def remd(**over):
            kw = dict(n_steps=MESH_REMD_STEPS, X0=[-1.0, 0.0],
                      step_size=REMD_DT, report_interval=REMD_REPORT,
                      exchange_interval=REMD_EXCHANGE, seed=1, verbose=False,
                      device=dev)
            kw.update(over)
            return integrate_sde_remd(DoubleWell2D(), list(REMD_BETAS), **kw)

        rem, row = mesh_twins(
            "d remd", remd, len(REMD_BETAS), MESH_REMD_STEPS,
            MESH_REMD_STEPS // REMD_REPORT, mesh, card,
            dict(n_steps=2 * MESH_REMD_EXCHANGES * REMD_REPORT,
                 exchange_interval=2 * REMD_REPORT), tmp=tmp,
            exchanges=MESH_REMD_EXCHANGES)
        # the first blocks captured (the all-gather inside each exchange
        # block's graph) against the same blocks run eagerly
        m = 2 * eeb + 1
        t0 = time.perf_counter()
        with eager_twin(blocks=m):
            twin = remd(mesh=mesh)
        row["eager_twin_s"] = time.perf_counter() - t0
        same = (np.array_equal(twin.frames[:, :m], rem.frames[:, :m])
                and np.array_equal(twin.swap_history[:m],
                                   rem.swap_history[:m]))
        row.update(eager_twin_blocks=m, captured_vs_eager_bitwise=same,
                   pair_acceptance=rem.pair_acceptance.tolist(),
                   swaps=int(rem.swap_history.sum()))
        log(f"  d: the meshed run's first {m} blocks ({m // eeb + 1} exchange "
            f"blocks captured with their all-gather) bit for bit the eager "
            f"twin's: {same}; pair acceptance "
            f"{np.round(rem.pair_acceptance, 3).tolist()}, "
            f"{row['swaps']} slot moves")
        if not same:
            raise AssertionError("d: the captured meshed exchange blocks "
                                 "differ from their eager twin")
        if not rem.swap_history.any():
            raise AssertionError("d: no exchange was accepted")
        out["d remd"] = row
    finally:
        dist.destroy_process_group()
        if os.path.exists(init):
            os.remove(init)
        tmp_dir.cleanup()
    out["launches"] = {"fused_align":
                       out["a metadynamics"]["launches"]["fused_align"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {out['phase_s']:.1f} s")
    return out


# what each phase takes from an earlier one: phase 4's runs, phase 9's sweeps
PHASE_NEEDS = {5: {4}, 8: {4}, 9: {4}, 10: {4}, 11: {4, 9}, 12: {4},
               14: {4}, 15: {4}}
ALL_PHASES = tuple(range(1, 16))


def parse_phases(spec):
    """The phases a ``--phases`` list names (``1-5,13``), with the phases
    they need and phases 1-3, which always run."""
    chosen = {1, 2, 3}
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        chosen.update(range(int(lo), int(hi or lo) + 1))
    unknown = chosen - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: no phase {sorted(unknown)}")
    for phase in sorted(chosen, reverse=True):
        chosen |= PHASE_NEEDS.get(phase, set())
    return chosen


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="run only these phases, e.g. 1-5,13 (phases 1-3 "
                    "and the phases a chosen one needs always run); the "
                    "default runs every phase")
    args = ap.parse_args()
    phases = (set(ALL_PHASES) if args.phases is None
              else parse_phases(args.phases))
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
    results = {"card": card}
    launches = {name: 0 for name in KERNELS}
    sources = {}

    def add_launches(label, counts):
        for name, n in counts.items():
            launches[name] += n
        sources[label] = counts

    if 4 in phases:
        log("phase 4: training")
        runs = phase_training(ref, traj_np, w_np, cvf)
        add_launches("main path", {
            "kabsch_qcp": runs["k1"]["counts"]["kabsch_qcp"],
            "kabsch_exact": runs["plain"]["counts"]["kabsch_exact"],
            **{name: runs["fused"]["counts"][name]
               for name in ("fused_align", "stats_fwd", "stats_bwd")}})
        results["throughput_samples_per_s"] = {
            "fused": runs["fused"]["sps"], "plain": runs["plain"]["sps"]}
    if 5 in phases:
        log(f"phase 5: steady-state training throughput on {card}: fused "
            f"step (K2+K3+K4) {runs['fused']['sps']:,.0f} samples/s, plain "
            f"step {runs['plain']['sps']:,.0f} samples/s")
        results["profile"] = phase_profile(runs)
    if 6 in phases:
        log("phase 6: the generator and the committor (Dirichlet form)")
        results["dirichlet"] = phase_dirichlet(card, ref, traj_np, w_np, cvf)
    if 7 in phases:
        log("phase 7: the autoencoder and the regularized autoencoder")
        results["autoencoders"] = phase_autoencoders(card, ref, traj_np,
                                                     w_np, cvf)
    if 8 in phases:
        log("phase 8: export and deploy")
        results["export"] = phase_export(card, runs, traj_np, cvf)
    if 9 in phases:
        log("phase 9: the replica sweep")
        sweep, sweep_b = phase_sweep(card, ref, traj_np, w_np, cvf, runs)
        results["sweep"] = sweep
        # K2 on the sweep's (run b's second call)
        add_launches("sweep", {
            "fused_align": sweep["b fused f32"]["k2_launches"]})
    if 10 in phases:
        log("phase 10: streaming from host memory")
        results["streaming"] = phase_streaming(card, ref, traj_np, w_np,
                                               cvf, runs)
        add_launches("streamed", results["streaming"]["launches"])
    if 11 in phases:
        log("phase 11: the data mesh, one rank of an NCCL group")
        results["mesh"] = phase_mesh(card, ref, traj_np, w_np, cvf, runs,
                                     sweep, sweep_b)
        add_launches("meshed", results["mesh"]["launches"])
    if 12 in phases:
        log("phase 12: the samplers")
        results["samplers"] = phase_samplers(card, ref, traj_np, runs, cvf)
        # the metadynamics along the fused CV
        add_launches("samplers", results["samplers"]["launches"])
    if 13 in phases:
        log("phase 13: MD trajectory input")
        results["md_input"] = phase_md_input(card, cvf)
        add_launches("MD input", results["md_input"]["launches"])
    if 14 in phases:
        log("phase 14: analysis, autotune and the adaptive loop")
        results["drivers"] = phase_drivers(card, ref, traj_np, w_np, cvf,
                                           runs)
        add_launches("drivers", results["drivers"]["launches"])
    if 15 in phases:
        log("phase 15: the enhanced samplers on a mesh of one NCCL rank")
        results["mesh_samplers"] = phase_mesh_samplers(card, ref, traj_np,
                                                       runs, cvf)
        add_launches("meshed samplers", results["mesh_samplers"]["launches"])
    log("launches by phase: " + "; ".join(
        f"{label} {counts}" for label, counts in sources.items()))
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
    log(f"phases {sorted(phases)}: total {time.perf_counter() - t_start:.1f}"
        " s")
    print(json.dumps(results))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
