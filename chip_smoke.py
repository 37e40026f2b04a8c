#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (montecarlo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script exits non-zero on the first
failure and prints no result line then):

  1. device   require CUDA; print nvidia-smi's name and power limit
  2. build    compile the CUDA kernels from csrc/ (nvcc, sm_90a)
  3. parity   each kernel against its plain PyTorch version on the card, at
              the shapes of the simulations below, with both times, the
              time of one library call computing the same function where
              there is one, and the kernel's bound; K1 (float32) and K8 bit
              for bit, K8 also at chain128's N = 128 (a row of its own in
              the kernels line); K5 also against K1 on
              the same inputs, bit for bit, with both times (wall and
              device) in turns; K13
              (the site sweep with the wrap fused in) in both directions,
              its up direction's decisions also against K1's, bit for bit,
              beside the unfused visit's time (K1 and the separate wrap);
              K11, K13, K5, K1 in float64, K4 and K14 (at N = 64 and 128)
              also REPEATS launches more, each bit-equal to the first (a
              race check);
              K14 (the QR emitting V and tau) with max|Q^T Q - I| of its
              WY-assembled Q and of K4's; K12 (one chain); K6 and K9 also
              at WAVE_CHAINS chains (more than one wave of clusters), each
              case printing the layout cluster_plan gave it, and every
              layout of theirs that fits timed and held against the
              plan's ([layouts] lines); K17 (the Ising checkerboard sweep)
              at bench.py's ising_flips shape (262,144 chains of the 8x8),
              at the 3x3 (four color classes), on the cubic L = 4 and at
              the 32x32 (N = 1024), and K18 (a batch of Wolff BFS levels)
              through a whole move from seeds at the Wolff run's shape
              against the move on its plain version from the same stream,
              then as one launch holding the whole search, each bit for bit
              and REPEATS launches more, with the move's bound, its time a
              level and the levels' torch.rand bytes;
              K6-f64 at (64, 1, 256, 256) and (32, 2, 256, 256) with
              dk = 32 and at (64, 1, 144, 144) with dk = 1, K8-c128 at
              (256, 1, 64, 64), (256, 2, 64, 64) and (256, 1, 128, 128),
              K9-c128 at (64, 1, 256, 256) with dk = 32: decisions
              identical, max|dG| within TOL_G_FP64 (each line says whether
              G is bit-equal), REPEATS launches more; K6-f64's negative-
              weight magnitudes on random F = 2 G; the shapes of ROADMAP
              Queue 1 item 4 in both precisions, each bit-equal to its
              plain version with REPEATS launches more and its wall,
              device and plain ms and bound printed: K6 and K6-f64 at
              (64, 1, 169, 169) (G padded to 176), K6-f64 at (64, 1, 225,
              225), K9 and K9-c128 at (64, 1, 196, 196) (G padded to 200),
              K8 and K8-c128 at F = 2, N = 100 (256 chains) and N = 128,
              K8-c128 also at F = 1, N = 100 (256 chains), K9 and K9-c128
              at (64, 2, 256, 256) with dk = 32 (complex128 in the flavor
              layout: a cluster of 2 blocks per chain, one flavor each);
              K6-f64 and K9-c128 at dk = 1 and K8-c128 past N = 64 run the
              rank-1 layout (G on chip; K8-c128's every row in registers),
              and the four redesigned rows and K8-c128 at F = 2, N = 128
              also time the other layouts that fit ([layouts] lines, in
              turns); the four shapes of the 4r runs are rows of their
              own in the kernels line
  4. slice    DQMC(...).run() through the public entry point at the headline
              configuration (8x8 attractive Hubbard, beta=10, 256 chains,
              float32), counting each kernel's launches during the run
  4b. l16     the same at 16x16 (N=256, 64 chains, delayed updates in
              blocks of 32: kernels K6 and K7)
  4c. complex the same at the complex configuration: 8x8 with pure-gauge
              Peierls phases, safe_mult=5, complex64 (kernels K8 and K10);
              the average weight phase <s> must stay 1
  4d. f64     the headline model in strict float64 (DQMC's default dtype),
              128 chains (bench.py's f64 row): K1 in float64 and K11; the
              window-end drift must stay below bench.py's 1e-6
  4e. mixed   the same with float32 updates over float64 stacks (K1, K11)
  4f. colscaled the headline with stab_method="qr_colscaled" (K1, K4)
  4g. repulsive the repulsive model at the headline's settings (bench.py's
              repulsive row: 8x8, U=4, beta=10, 256 chains, float32): K5,
              K2, K3; measures the z spin correlations and magnetization,
              and holds each flavor's occupation to 0.5, the mean m_z to 0
              and the local moment above its U=0 value of 0.5
  4h. complex16 the complex configuration at 16x16 (N=256, 64 chains,
              delay auto = 32): K9 and the library QR, as the JAX package
              runs XLA's QR past N = 128; <s> within PHASE_TOL_CX16 of 1
  4i. chain128 a 128-site periodic chain with pure-gauge Peierls phases
              (twisted-boundary rings), the complex row's settings, 256
              chains: K8 at N = 128 and the wide K10
  4j. fusewrap the headline with fuse_wrap=True: K13 on every slice visit
              but the measurement point's (K1 and the separate wrap), K2,
              K3
  4k. colscaled_wy the colscaled run with qr_wy=True: K1 and K14 (with Q
              assembled outside), no K4
  4l. single  the headline with one chain (1 + 1 sweeps): K12 on every
              slice visit, K2, K3; its occupation is printed, not held (one
              chain's few sweeps need not average to 0.5)
  4m. refresh bench.py's refresh row: the headline model, float32, 256
              chains, safe_mult 5, g_refresh (G recomputed at every slice),
              1 + 2 sweeps: K1 per slice visit, K2 per stack extension, K3
              2M + 1 per pair (core.pair_udt_launches); prop_err_n 2M per
              chain and pair; wall and device ms per pair beside the
              headline's
  4n. refresh_complex the complex run's settings with g_refresh: K8, K10;
              <s> within PHASE_TOL of 1
  4o. checkerboard the headline with checkerboard=True (K1, K2, K3), 1 + 2
              sweeps; the session's hopping operators against a fresh
              assemble_dense_operator on the CPU (TOL_CB_OPS) and max|B_cb -
              B_dense| of one slice below TOL_CB_TROTTER
  4p. libqr   L = 10 (N = 100: 8 does not divide N, the library QR) in
              float32 (K1), float64 (K1-f64; drift max below 1e-6) and
              complex64 (pure gauge, safe_mult 5: K8; <s> within
              PHASE_TOL_LIBQR of 1), 64 chains, 1 + 1
              sweeps: each run's QR route (linalg.qr_route), its library-QR
              calls (counted as the kernels' launches) and the wall and
              device ms of one call at its shape. K1, K1-f64 and K8 at N =
              100 are rows of their own in the kernels line, each held
              against its plain version at (64, 1, 100, 100) in phase 1
  4q. l16_f64, complex_c128, complex16_c128: DQMC's default dtype
              (float64; complex128 for the Peierls models), 1 + 1 sweeps:
              bench.py's l16 row under BENCH_DTYPE=float64 (16x16, safe_mult
              10, 64 chains, delay 32: K6-f64, the library QR; drift max
              below 1e-6, acceptance in (0.3, 0.95)), the complex row's
              model (8x8, safe_mult 5, 256 chains: K8-c128, the library
              QR) and complex16's (64 chains, delay 32: K9-c128, the
              library QR); the complex runs' <s> within PHASE_TOL of 1 with
              no imaginary probability
  4r. l15_f64, flux14_c128, rep_flux10_c128, rep_flux16_c128: item 4's
              sessions at the default dtype, 1 + 1 sweeps, each with its
              chain-sweeps/s beside the card's name and power limit:
              15x15 attractive, 64 chains (K6-f64 on G padded to 232; drift
              max below 1e-6); 14x14 attractive with the complex row's
              pure-gauge phases, 64 chains (K9-c128 on G padded to 200);
              10x10 repulsive with them, 256 chains (K8-c128 at F = 2 in
              the rank-1 layout); 16x16 repulsive with them, 64 chains,
              delay 32 (K9-c128 at F = 2 in the flavor layout); each beside
              the library QR, the complex runs' <s> within PHASE_TOL_C128 of
              1 with no imaginary probability, the repulsive runs held to
              the repulsive anchors; after each run its first slice visit
              on the kernel path against the plain path, agreeing in every
              chain
  Every run of phase 4 holds its launches to the schedule: one site sweep
  per slice visit, one QR of the session's route (qr_route) per stack
  extension and Green's recomputation, the library QR's calls as
  "library_qr".
  5. paths    the kernel path against the plain path (use_kernels=False)
              from the same state and uniforms: the headline's first slice
              visit at its safe_mult=10 and one whole sweep_pair at
              safe_mult=1 (on the first 64 chains, as every safe_mult=1
              comparison); colscaled, fusewrap and colscaled_wy as the
              headline (the kernel path's first visit is K13's for
              fusewrap), and so the
              repulsive run, whose whole pair at safe_mult=10 prints the
              plain path's negative detratios; at 16x16 the first slice
              visit; complex: the first visit at safe_mult=5 and the whole
              pair at safe_mult=1; f64: the whole pair at safe_mult=10;
              complex16: the first visit at safe_mult=5; chain128: the
              first visit at safe_mult=5 and the whole pair at
              safe_mult=1; refresh: the first visit at safe_mult=5 and the
              whole pair at safe_mult=1, and refresh against the wrap mode
              in float64 at safe_mult 5 on the f64 run's first 64 chains
              from one state and one set of uniforms (accept sequences
              equal; G_meas within TOL_REFRESH_WRAP, which both modes
              recompute from the same stacks at the pair's end, so the
              accept sequences carry the check); libqr: the first visit of
              each run (the same library QR on both paths, so the
              decisions must agree in every chain) and f64's whole pair;
              l16_f64, complex_c128 and complex16_c128: the first visit,
              agreeing in every chain (the four 4r runs' right after
              each run, in phase 4r)
  5b. phase   a second witness for the phase statistics of the complex,
              complex16 and libqr complex64 runs (complex16: its first 16
              chains): one sweep
              pair from each run's final configuration with the same
              uniforms on the kernel path, the kernel path over complex128
              stacks, the plain path, the kernel path in complex128
              (K8-c128, K9-c128) and, but for complex16, the plain path in
              complex128 (both complex128 paths must end in the same
              configuration), each with its imaginary-probability count,
              max |Im det|, drift and <s>

  6. timedisp the time-displaced path at the headline's width (8x8,
              beta=10, float32): (a) one combined_greens_apply on the
              kernel path and on the plain path from the headline run's
              final field (its first 64 chains) at safe_mult 10 and 1,
              every G(0,l), G(l,0), G(l,l) and the CDS, PS, SDSz and CCS
              accumulators held together, and K2 on every matrix the
              iteration hands udt_dirty against its plain version; (b)
              combined_accuracy on the kernel path at both safe_mults, and
              greens_kl at tests/test_ed_time_displaced.py's (k, l) pairs in
              float32 on the kernel path against float64 on the plain path;
              (c) DQMC.run() with CDS, PS, SDS x/y/z, CCS and two greens_at
              (256 chains, 1 + 2 sweeps, measure_rate 1): every observable
              finite, CDS at the largest distance positive, K2's and K3's
              launches in each measurement pass equal to the schedule's, and
              the pass's wall and device ms per measured sweep beside the
              sweep pair's; (d) validation.pooled_run over seeds (123, 321)
              at 8 chains each (2 + 2 sweeps): 16 rows per observable, and
              compare_pools of the pool with itself passes (the statistical
              gate is `python3 -m montecarlo_tpu_torch.validation
              headline`, not a smoke phase)

  7. classical the Ising flavor and the checkpoints, through MC(...).run(),
              save, resume and replay: (a) ising, bench.py's ising_flips
              row (8x8, beta 0.44, 262,144 chains, no measurements, 20 +
              100 sweeps): K17 once per sweep, acceptance, spin flips/s;
              (b) wolff, 8x8 at beta = 1/IsingTc, 4096 chains, a global
              move every 2 sweeps (50 + 100): acc_global > 0, <|m|> in
              (0.3, 0.8), K18 once per batch of BFS levels, levels and
              batches per move; the same run at one level a batch
              bit-equal in conf, counters and generator; moves alone from
              each run's state: wall ms, levels and host synchronizations
              per move (torch's sync debug mode: one a batch); (c) enum,
              the 3x3 (four color classes) at beta 0.3, 64 chains, 200 +
              800 sweeps: E and M within max(4 sigma, 0.05) of exact
              enumeration; (d) io, an MC
              run saved at sweep 30 and resumed to 60 bit-equal in conf to
              an uninterrupted one, the f64 DQMC configuration 1 + 1 sweeps
              against 1 saved + 1 resumed (conf in every chain, last_sweep,
              the observables' means), and a headline-width float32 run
              with ConfigRecorder replayed (K2, K3 per recorded field as
              greens_from_scratch schedules them, occupation near 0.5)

  8. item9   ALPS lattices, custom measurements, post-processing and the
              timers at the headline (256 chains, float32, 1 + 2 sweeps):
              (a) alps, the 8x8 written as an ALPS GRAPH file and run on
              ALPSLattice(file) and on SquareLattice(8) with one seed: conf
              and G bit-equal, K1, K2 and K3 launches equal; the ALPS
              session saved and loaded, conf bit-equal; (b) custom, a custom
              CDC (EachSitePairByDistance), PC (selection_matrices,
              EachLocalQuadByDistance(4)), CDS (CombinedGreensIterator) and
              GreensAt(50, 0) beside the shipped ones, float64 binner means
              within TOL_CUSTOM relative; K2/K3 per measurement pass
              against the schedule; wall and device ms per measured sweep
              with and without the custom set; (c) postproc, S(q) of the
              CDC mean over reciprocal_discretization (64 q points), S(q =
              0) within TOL_SQ0 of uniform_fourier, the PC's s-wave
              apply_symmetry finite; (d) timers, enable_benchmarks():
              dqmc_block counted once per chunk, its total in (0, the wall
              around run], print_timer's lines, and the wall of the run
              with the timers off and on, in turns

  9. chains  chain sharding (montecarlo_tpu_torch.parallel): each session
              once in this process, then (a) the headline (256 chains,
              float32, 1 + 2 sweeps) on a one-rank NCCL mesh here, bit-
              identical, and cross_chain_mean's NCCL all-reduce of its
              occupation equal to the plain mean; (b) CH_RANKS ranks of this
              card over gloo (parallel.launch.spawn; NCCL refuses two ranks
              on one GPU), each running its block of the headline, of the
              10x10 attractive model in the complex row's flux in
              complex128 (128 chains, 1 + 1 sweeps: a rank's 64 chains take
              K8-c128's rank-1 layout, one process's 128 the tiles) and of
              Ising 8x8 at beta 0.44 with Wolff moves (4096 chains, 10 + 20
              sweeps): every rank's configuration, G, counters and
              observables bit-identical to one process's, each session's
              kernels launched in every rank; (c) the wall seconds and
              chain-sweeps/s of one process and of the ranks (two processes
              on one card: not a scaling number). Its launches are on its
              own lines, not in the kernels line

Each phase ends with a [time] line: the seconds since the script started.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is nvidia-smi's, and before that a {"kernels": [...]}
line with each kernel's launches, error and times.

A kernel's bound (bound_ms) is the least time the card could take for its
work: the larger of the bytes it must move (each input read once, each
output written once) over the HBM rate and the least FP32 operations that
compute its function on these inputs (for the site sweeps: the rank-1
updates of the accepted sites of this run; for the QRs: Householder with Q
accumulated backward) over the peak rate of their type, the published
peaks of one H100 SXM (NVIDIA's data sheet: 3.35 TB/s; 67 TFLOP/s FP32
outside the tensor cores, since TF32 would lose precision; 67 TFLOP/s
FP64 on the tensor cores, which keep full IEEE double precision).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# headline configuration (bench.py's bench_dqmc defaults)
L, U, MU, BETA, DTAU, SAFE_MULT, CHAINS = 8, 4.0, 0.0, 10.0, 0.1, 10, 256
THERM, SWEEPS = 2, 4
K1_F2_CHAINS = 128
# the repulsive configuration (bench.py's repulsive row, bench_dqmc(
# repulsive=True)): the headline's settings, 1 + 2 sweeps
REP_THERM, REP_SWEEPS = 1, 2
# |mean m_z| at half filling (spin symmetry), and the local moment's U=0
# value at half filling, which any U > 0 raises
MZ_TOL, MOMENT_U0 = 0.02, 0.5
# the large-lattice configuration (bench.py's bench_dqmc(lattice_L=16,
# chains=64)): N=256, delay auto = 32
L16, L16_CHAINS, L16_F2_CHAINS, L16_THERM, L16_SWEEPS = 16, 64, 32, 1, 2
# K6 and K9 are also held against their plain versions at this many chains
# of the 16x16 configurations: 320 blocks at CS = 2, more than one wave of
# clusters on the H100's 132 SMs
WAVE_CHAINS = 160
# the complex configuration (bench.py's complex row, its CPLX_SM = 5, and
# benchmarks/complex_bench.py): the headline model with pure-gauge Peierls
# phases theta_ij = phi_i - phi_j, phi from default_rng(0) on [0, 2 pi)
CPLX_SM, CPLX_THERM, CPLX_SWEEPS = 5, 1, 2
# ... at 16x16 with 64 chains (complex16), and on a 128-site chain with 256
# chains (chain128)
CHAIN_L = 128
# every safe_mult=1 path comparison (phase 5) runs on the first 64 chains:
# its plain path recomputes G from the stack at each slice, and the library
# QR's time grows with the chains
SM1_PATH_CHAINS = 64
# the complex16 phase witness (5b) on the run's first chains
CX16_WITNESS_CHAINS = 16
# K14's tau against its plain version's, entry by entry: float32 sums in
# another order, over columns graded across 32 e-folds
TOL_TAU = 1e-4
# the strict-float64 configuration (bench.py's f64 row: bench_dqmc(dtype=
# "float64", chains=128)), its mixed-precision variant, and the headline
# with the column-scaled stabilization; 1 + 2 sweeps each
F64_CHAINS, X_THERM, X_SWEEPS = 128, 1, 2
K1_F64_F2_CHAINS = 64
TOL_G, TOL_QR, TOL_D = 1e-5, 1e-5, 1e-5
# repeated launches of K11, K13, K5, K1 in float64, K4 and K14, held
# bit-equal to the first (a race check: the card's sanitizers refuse the
# device)
REPEATS = 50
# float64 kernels against their plain versions (K11: tests/test_pallas_qr.py's
# strict-f64 contract for Q^T Q - I)
TOL_G64, TOL_QR64, TOL_ORTH64 = 1e-13, 1e-12, 1e-13
# K1-f64's negative-weight log-magnitudes against its plain version's: the
# same float64 operations in the same order, log10 from two libraries
TOL_NEG64 = 1e-12
# K6-f64, K8-c128 and K9-c128 against their plain versions: max|dG| (every
# operation a __d*_rn intrinsic in the plain version's order, bit-equal in
# practice; the printed lines say whether it was)
TOL_G_FP64 = 1e-10
# the float64 and complex128 runs through DQMC.run at the default dtype:
# l16_f64 (bench.py's l16 row under BENCH_DTYPE=float64: 16x16, safe_mult
# 10, 64 chains, delay 32; K6-f64 and the library float64 QR),
# complex_c128 (the complex row's model in complex128: 8x8, safe_mult 5,
# 256 chains; K8-c128 and the library complex128 QR) and complex16_c128
# (the same model at 16x16, 64 chains, delay 32; K9-c128 and the library
# QR). bench.py's float64 sanity bounds the acceptance of l16_f64
# (bench.py:534-535)
F64_ACC_RANGE = (0.3, 0.95)
FP64_THERM, FP64_SWEEPS = 1, 1
# the item 4 runs (phase 4r) at the default dtype, 1 + 1 sweeps: l15_f64
# (15x15 attractive, 64 chains: K6-f64 on G padded to 232), flux14_c128
# (14x14 attractive with the complex row's pure-gauge phases, 64 chains:
# K9-c128 on G padded to 200), rep_flux10_c128 (10x10 repulsive with
# them, 256 chains: K8-c128 at F = 2 in the rank-1 layout) and
# rep_flux16_c128 (16x16 repulsive with them, 64 chains, delay auto 32:
# K9-c128 at F = 2 in the flavor layout); the complex128 runs' |<s> - 1|
# (complex16_c128 read 3.8e-13 on an H100 80GB HBM3 at 700 W)
ITEM4_CHAINS, ITEM4_REP10_CHAINS = 64, 256
PHASE_TOL_C128 = 1e-9
# bench.py's f64 criterion: max window-end drift (reference alarm 1e-7 per
# stabilization, stack.jl:530-550)
F64_DRIFT_MAX = 1e-6
# float64 rounding does not grow to O(1) within a window: the two paths
# keep the same Markov chain over a whole sweep pair
MIN_CONF_AGREE_F64 = 0.99
OCC_TOL = 0.02           # |mean occupation - 0.5| at mu = 0
# |<s> - 1|: a pure gauge keeps every weight real. complex128 reads ~1e-13
# on the card; both complex64 paths read float32 rounding, up to 1.4e-4 at
# this configuration, so 1e-3 leaves a factor of 7 for rounding and catches
# a kernel that biases the phases beyond it
PHASE_TOL = 1e-3
# ... at 16x16 (complex16): float32 rounding of G at N = 256 reaches |Im det|
# of O(10) (84% of proposals above 1e-6), and the running phase of three
# sweeps drifted by 8.2e-3 on an H100 80GB HBM3 (the sign observable by
# 1.7e-3), which the plain complex64 path reproduces and complex128 does
# not. Phase 5b traces it to the complex64 stabilization: with complex128
# stacks under the same K9 and complex64 wraps, one pair's mean per-chain
# phase error falls from 1.5e-2 to 5.3e-4. 2e-2 catches a kernel that
# biases the phases beyond that
PHASE_TOL_CX16 = 2e-2
IMAG_SHARE_RATIO = 1.5   # kernel / plain imaginary-probability share
MIN_CONF_AGREE = 0.9
MIN_CONF_AGREE_CX_FIRST = 0.95
# phase 6 (timedisp): the iterator's kernel and plain paths and its
# accuracy on the headline run's first chains; greens_kl at the (k, l)
# pairs of tests/test_ed_time_displaced.py; a headline-width run with the
# susceptibilities and two greens_at (1 + 2 sweeps); the gate's pooled run
# (seeds (123, 321), 8 chains each, 2 + 2 sweeps)
TD_CHAINS = 64
# phase 4p (libqr): L = 10 (N = 100, 8 does not divide N: the library QR
# beside K1, K1-f64 and K8), 64 chains, 1 + 1 sweeps
LIBQR_L, LIBQR_CHAINS = 10, 64
# ... its complex64 run's |<s> - 1|: with the library QR and complex64
# stacks at N = 100 a pair's per-chain phase error read 4.95e-3 in the
# mean (max 2.76e-2), K8 and its plain version alike (bit-equal), and
# 3.72e-4 over complex128 stacks, so the stabilization's rounding sets it
# (phase 5b on this run; K10 at N = 64: 1.35e-3); the run's 64 chains
# read 1.49e-3 after 1 + 1 sweeps (an H100 80GB HBM3 at 700 W). 1e-2
# catches a kernel that biases the phases beyond twice the per-chain mean
# error; 5b holds the kernel path's imaginary share to the plain path's
PHASE_TOL_LIBQR = 1e-2
# phase 4o (checkerboard): the session's four hopping operators (and the
# update dtype's copies) against assemble_dense_operator's on the CPU, cast
# alike (the CPU tests hold that to the JAX package's within 1e-14)
TOL_CB_OPS = 1e-6
# ... and max|B_cb - B_dense| of one slice: the Trotter error read 3.26e-4
# on an H100 80GB HBM3 at 700 W; a dropped hopping group or swapped half
# and full coefficients moves B by about dtau |t| = 0.1
TOL_CB_TROTTER = 1e-2
# phase 5, refresh against wrap in float64 from one state and one set of
# uniforms (tests/test_g_refresh.py's test_refresh_matches_wrap_f64): the
# accept sequences equal, G_meas within this. Both modes recompute G_meas
# from the same stacks at the pair's end, so once the accept sequences are
# equal it reads 0 by construction: the accept sequences test refresh's
# per-slice G
TOL_REFRESH_WRAP = 1e-9
TD_KL_PAIRS = ((1, 0), (7, 3), (5, 5), (2, 7), (1, 3), (10, 0))
TD_GREENS_AT = ((50, 0), (20, 70))
TD_THERM, TD_SWEEPS = 1, 2
GATE_SEEDS, GATE_CHAINS, GATE_THERM, GATE_SWEEPS = (123, 321), 8, 2, 2
# The float32 iterator at beta = 10 is accurate to O(1) at safe_mult=10:
# against the float64 plain path from the same field, the median over 64
# chains of each chain's max |G - G64| over l was 1.42 on the kernel path
# and 11.7 on the plain path (G0l the worst; 0.047 and 0.51 at
# safe_mult=1), the JAX package's float32 iterator reads the same on the
# CPU (combined_accuracy 186 and 0.28 on two random fields, float64
# 2.7e-8), so the two float32 paths are held against float64, not against
# each other: the kernel path's per-chain median error over the plain
# path's, for each of G0l, Gl0, Gll (every l) and each accumulator,
# measured 0.09-1.6 (Gll at safe_mult=1: 4.44e-4 against 2.72e-4; my chip
# runs, NVIDIA H100 80GB HBM3, 700 W)
TOL_TD_RATIO = 4.0
# combined_accuracy (max|iterator - greens_kl|) per chain on the kernel
# path, median over chains, by safe_mult: measured 1.13 (max 55.2) and
# 0.047 (max 1.16); the plain path 11.7 and 0.51, float64 0 to 2.2e-5
TOL_TD_ACC = {10: 10.0, 1: 0.5}
# greens_kl in float32 on the kernel path against float64 on the plain
# path, max|d| over max|float64|: measured up to 2.0e-3 (G(5, 5))
TOL_TD_KL = 1e-2
# K2 on the matrices the iterator hands udt_dirty: reconstruction
# max|Q diag(d) R - A| / max|A| and max|Q^T Q - I|, measured 8.1e-7 and
# 1.7e-6 (its plain version 1.0e-6 and 2.0e-6)
TOL_TD_REC = 1e-5
# phase 7 (classical) and K17/K18 in phase 3: bench.py's ising_flips row
# (bench.py:352-366: 8x8 square, beta 0.44, 262,144 chains, no
# measurements), 20 + 100 sweeps; the Wolff run at beta = 1/IsingTc (4096
# chains, a global move every 2 sweeps, 50 + 100 sweeps; tests/
# test_ising_mc.py's test_wolff_accelerates_near_tc with more chains); the
# 3x3 run against exact enumeration (test_ising_vs_exact_enumeration at
# beta 0.3: 64 chains, 200 + 800 sweeps)
ISING_L, ISING_BETA, ISING_CHAINS, ISING_THERM, ISING_SWEEPS = (
    8, 0.44, 262144, 20, 100)
WOLFF_CHAINS, WOLFF_THERM, WOLFF_SWEEPS, WOLFF_RATE = 4096, 50, 100, 2
# <|m|> of the Wolff run: tests/test_ising_mc.py's window (the JAX package
# reads 0.782 on the CPU at 32 chains)
WOLFF_M_RANGE = (0.3, 0.8)
ENUM_L, ENUM_BETA, ENUM_CHAINS, ENUM_THERM, ENUM_SWEEPS = 3, 0.3, 64, 200, 800
# E and M within max(4 sigma, 0.05) of exact enumeration (the JAX test's)
ENUM_SIGMAS, ENUM_ABS = 4.0, 0.05
# K17 also at the 3x3 (an odd L: the greedy site coloring gives four
# classes), on the cubic L = 4 (z = 6) and at the 32x32 (N = 1024, the
# shared-memory layout), each at this many chains; K18 through a whole
# move at the Wolff run's shape, its levels drawn from a generator with
# this seed
ISING_SMALL_CHAINS, ISING_LARGE_L = 4096, 32
# bytes written between timed calls to leave none of a call's inputs in
# the card's L2 (50 MB on the H100)
L2_OVERWRITE_BYTES = 256 << 20
WOLFF_PARITY_SEED = 24
# 7b: Wolff moves timed alone from the run's final state (wall per move,
# batched and level by level), and moves under torch's sync debug mode
# (host synchronizations per move)
WOLFF_TIMED_MOVES, WOLFF_SYNC_MOVES = 20, 4
# 7d: an MC run saved at sweep 30 and resumed to 60 against an
# uninterrupted one (8x8, Wolff moves every 3 sweeps, default
# measurements); the f64 DQMC configuration saved after 1 sweep and resumed
# for 1 more; a headline-width float32 DQMC run (1 + 2 sweeps) recording
# every measured sweep, then replayed
IO_MC_CHAINS, IO_MC_SPLIT, IO_MC_SWEEPS, IO_MC_RATE = 1024, 30, 60, 3
# phase 8 (item9): headline sessions of 1 + 2 sweeps: on an ALPS file of
# the 8x8 and on SquareLattice(8) with one seed (8a); custom measurements
# beside the shipped ones (8b: CDC, PC with K = 4, CDS and G(k, l) at
# ITEM9_GREENS_AT); the timers (8d: two runs with the timers off and two
# with them on, in turns)
ITEM9_THERM, ITEM9_SWEEPS, ITEM9_K = 1, 2, 4
ITEM9_GREENS_AT = (50, 0)
# a custom measurement's float64 binner mean against the shipped one's,
# max|a - b| / max|b|: the same float32 kernel arithmetic in both
TOL_CUSTOM = 1e-6
# S(q = 0) against uniform_fourier: both sum the same float64 values
TOL_SQ0 = 1e-10
# phase 9 (chains): sessions sharded over ranks, each held bit for bit to
# the same session in this process: the headline (1 + 2 sweeps, seed
# CH_SEED) on a one-rank NCCL mesh here (9a) and, with the others, on
# CH_RANKS ranks of one card over gloo (9b; NCCL refuses two ranks on one
# GPU): the 10x10 attractive model in the complex row's flux in complex128
# at CH_FLUX_CHAINS chains, 1 + 1 sweeps (a rank's 64 chains are within
# ops/site_sweep_cx.py's CLUSTERS_AT_ONCE = 66, so plan_layout gives its
# K8-c128 the rank-1 layout, the 128 chains of one process the tiles), and
# Ising 8x8 at beta CH_ISING_BETA with a Wolff move every 2 sweeps
CH_RANKS, CH_SEED = 2, 9
CH_FLUX_L, CH_FLUX_CHAINS = 10, 128
CH_ISING_CHAINS, CH_ISING_BETA, CH_ISING_THERM, CH_ISING_SWEEPS = (
    4096, 0.44, 10, 20)
DEVICE = "cuda"
# published peaks of one H100 SXM (dense): HBM bytes/s, FP32 FLOP/s outside
# the tensor cores (TF32 is not float32) and FP64 FLOP/s on the tensor
# cores (DMMA rounds as IEEE double; 34e12 outside them)
HBM_BYTES_PER_S, FP32_FLOP_PER_S, FP64_FLOP_PER_S = 3.35e12, 67e12, 67e12

KERNEL_INFO = {
    "site_sweep": ("montecarlo_tpu_torch/csrc/site_sweep.cu",
                   "montecarlo_tpu/ops/pallas_site_sweep.py:191"),
    "udt_qr": ("montecarlo_tpu_torch/csrc/udt_qr.cu",
               "montecarlo_tpu/ops/pallas_qr.py:334"),
    "udt_qr_solve": ("montecarlo_tpu_torch/csrc/udt_qr.cu",
                     "montecarlo_tpu/ops/pallas_qr.py:395"),
    "site_sweep_delayed": ("montecarlo_tpu_torch/csrc/site_sweep_delayed.cu",
                           "montecarlo_tpu/ops/pallas_site_sweep.py:545"),
    "qr_blocked": ("montecarlo_tpu_torch/csrc/qr_blocked.cu",
                   "montecarlo_tpu/ops/pallas_qr.py:889"),
    "site_sweep_cx": ("montecarlo_tpu_torch/csrc/site_sweep_cx.cu",
                      "montecarlo_tpu/ops/pallas_site_sweep.py:1274"),
    # K8 at N = 128 (chain128), a row of its own
    "site_sweep_cx_128": ("montecarlo_tpu_torch/csrc/site_sweep_cx.cu",
                          "montecarlo_tpu/ops/pallas_site_sweep.py:1274"),
    "qr_cx": ("montecarlo_tpu_torch/csrc/qr_cx.cu",
              "montecarlo_tpu/ops/pallas_qr.py:706"),
    # K10 at N = 128 (chain128), a row of its own
    "qr_cx_128": ("montecarlo_tpu_torch/csrc/qr_cx.cu",
                  "montecarlo_tpu/ops/pallas_qr.py:706"),
    # K1, K1-f64 and K8 at N = 100 (libqr: padded rows, beside the library
    # QR), rows of their own
    "site_sweep_100": ("montecarlo_tpu_torch/csrc/site_sweep.cu",
                       "montecarlo_tpu/ops/pallas_site_sweep.py:191"),
    "site_sweep_f64_100": ("montecarlo_tpu_torch/csrc/site_sweep.cu",
                           "montecarlo_tpu/dqmc/core.py:560"),
    "site_sweep_cx_100": ("montecarlo_tpu_torch/csrc/site_sweep_cx.cu",
                          "montecarlo_tpu/ops/pallas_site_sweep.py:1274"),
    "qr_f32": ("montecarlo_tpu_torch/csrc/udt_qr.cu",
               "montecarlo_tpu/ops/pallas_qr.py:52"),
    "qr_f64": ("montecarlo_tpu_torch/csrc/qr_f64.cu",
               "montecarlo_tpu/ops/pallas_qr.py:1389"),
    # no TPU kernel: the JAX package's float64 XLA site loop
    "site_sweep_f64": ("montecarlo_tpu_torch/csrc/site_sweep.cu",
                       "montecarlo_tpu/dqmc/core.py:560"),
    "site_sweep_pair": ("montecarlo_tpu_torch/csrc/site_sweep.cu",
                        "montecarlo_tpu/ops/pallas_site_sweep.py:341"),
    "site_sweep_delayed_cx": (
        "montecarlo_tpu_torch/csrc/site_sweep_delayed_cx.cu",
        "montecarlo_tpu/ops/pallas_site_sweep.py:1413"),
    # _batched_kernel's wrap_dir branch (its MXU wrap: :160)
    "site_sweep_wrap": ("montecarlo_tpu_torch/csrc/site_sweep_wrap.cu",
                        "montecarlo_tpu/ops/pallas_site_sweep.py:227"),
    "qr_vtau": ("montecarlo_tpu_torch/csrc/udt_qr.cu",
                "montecarlo_tpu/ops/pallas_qr.py:203"),
    # K1's launch for one chain
    "site_sweep_single": ("montecarlo_tpu_torch/csrc/site_sweep.cu",
                          "montecarlo_tpu/ops/pallas_site_sweep.py:51"),
    # no TPU kernel: the JAX package's float64 XLA delayed loop (at dk = 1
    # its rank-1 loop, :560) and its complex128 rank-1 and delayed loops
    "site_sweep_delayed_f64": (
        "montecarlo_tpu_torch/csrc/site_sweep_delayed.cu",
        "montecarlo_tpu/dqmc/core.py:595"),
    "site_sweep_cx_c128": ("montecarlo_tpu_torch/csrc/site_sweep_cx.cu",
                           "montecarlo_tpu/dqmc/core.py:560"),
    "site_sweep_delayed_cx_c128": (
        "montecarlo_tpu_torch/csrc/site_sweep_delayed_cx.cu",
        "montecarlo_tpu/dqmc/core.py:595"),
    # the shapes of the item 4 runs (phase 4r), rows of their own: K6-f64
    # at N = 225 (G padded to 232; at dk = 1 the JAX package's rank-1
    # loop), K9-c128 at N = 196 (G padded to 200), K8-c128 at F = 2, N = 100
    # (the rank-1 layout) and K9-c128 at F = 2, N = 256,
    # dk = 32 (64 chains: the flavor layout)
    "site_sweep_delayed_f64_225": (
        "montecarlo_tpu_torch/csrc/site_sweep_delayed.cu",
        "montecarlo_tpu/dqmc/core.py:560"),
    "site_sweep_delayed_cx_c128_196": (
        "montecarlo_tpu_torch/csrc/site_sweep_delayed_cx.cu",
        "montecarlo_tpu/dqmc/core.py:560"),
    "site_sweep_cx_c128_f2_100": ("montecarlo_tpu_torch/csrc/site_sweep_cx.cu",
                                  "montecarlo_tpu/dqmc/core.py:560"),
    "site_sweep_delayed_cx_c128_f2": (
        "montecarlo_tpu_torch/csrc/site_sweep_delayed_cx.cu",
        "montecarlo_tpu/dqmc/core.py:595"),
    # no TPU kernel: the JAX package's XLA Metropolis sweep and Wolff BFS
    # body inside its jitted scan
    "ising_sweep": ("montecarlo_tpu_torch/csrc/ising.cu",
                    "montecarlo_tpu/models/ising.py:88"),
    "wolff_step": ("montecarlo_tpu_torch/csrc/ising.cu",
                   "montecarlo_tpu/models/ising.py:131"),
}


def log(*args):
    print(*args, flush=True)


def import_port():
    """Import the port from this checkout (never from elsewhere)."""
    if not (ROOT / "montecarlo_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no montecarlo_tpu_torch package next "
                         f"to {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import montecarlo_tpu_torch
    if Path(montecarlo_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit("chip_smoke: montecarlo_tpu_torch imported from "
                         f"{montecarlo_tpu_torch.__file__}, not this checkout")
    return montecarlo_tpu_torch


def timed(fn, reps):
    """Mean seconds per call of fn() on the card (warmed up, synchronized)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def device_ms(fn, reps=20, tries=3, only=None):
    """Mean device time per call of fn() in ms from torch.profiler's device
    events of reps calls (no host time between launches; only: of the
    kernels whose name holds that string); None where the profiler
    recorded no such event in tries attempts.

    Late in a long process the profiler drops some device events (seen on
    the H100: 15 of 20 launches of K17 recorded, each of the right length),
    so a plain sum over reps reads low. The trace is taken after a warm-up
    step, and each kernel's count must be a multiple of reps; where it is
    not in any attempt, a call's time is each kernel's mean time over the
    events recorded times its launches per call (its count over reps,
    rounded up), and the loss is logged."""
    from collections import defaultdict
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def once():
        fn()
        torch.cuda.synchronize()

    once()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            once()                          # warm-up step: not recorded
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        times = defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (only is None
                                                     or only in e.name):
                times[e.name].append(e.time_range.elapsed_us())
        if times and all(len(t) % reps == 0 for t in times.values()):
            return sum(map(sum, times.values())) / reps / 1e3
    if not times:
        return None
    got = sum(map(len, times.values()))
    per_call = {k: math.ceil(len(t) / reps) for k, t in times.items()}
    ms = sum(per_call[k] * sum(t) / len(t) for k, t in times.items()) / 1e3
    log(f"[profiler] {reps * sum(per_call.values()) - got} of "
        f"{reps * sum(per_call.values())} device events lost in each of "
        f"{tries} traces: {ms:.4f} ms a call from each kernel's mean (the "
        f"recorded events' sum over {reps} calls: "
        f"{sum(map(sum, times.values())) / reps / 1e3:.4f} ms)")
    return ms


def ms_text(ms):
    """A time in ms for a log line, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def zero_launches(**extra):
    """Set every kernel's launch count, and those of the counted functions in
    extra (name=function), to 0; returns a function that reads them."""
    from montecarlo_tpu_torch.ops import KERNELS
    counted = {**KERNELS, **extra}
    for fn in counted.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in counted.items()}


def bound(nbytes, flops, fp64=False):
    """bound_ms and bound_by of work that moves nbytes and does flops FP32
    (fp64: FP64) operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (FP64_FLOP_PER_S if fp64 else FP32_FLOP_PER_S)
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def householder_flops(N, complex_=False, with_q=True):
    """FP32 operations of the least work of a column-by-column Householder
    QR with Q formed (LAPACK's geqrf, then ungqr accumulating Q backward):
    per column j the tail norm, the dot and update of the N-j-1 trailing
    columns over N-j rows, and (with_q) the dot and update of Q's N-j
    trailing columns over its N-j trailing rows. A complex multiply-add is
    8 real operations, a real one 2."""
    ma = 8 if complex_ else 2
    return sum((2 if complex_ else 1) * 2 * (N - j - 1)
               + 2 * ma * (N - j) * (N - j - 1)
               + (2 * ma * (N - j) ** 2 if with_q else 0)
               for j in range(N))


def sweep_bound(C, F, N, n_acc, complex_=False, fp64=False, wrap=False):
    """The bound of a site sweep over (C, F, N, N): G read and written once,
    sigma in and out, u, and the per-chain counts (K1, K6) or the per-site
    accept flags and complex detratios (K8); n_acc accepted sites each
    update G (2 operations per element, 8 complex), the work of the
    sequential rank-1 sweep (the delayed sweep computes the same function,
    so its slab work is not counted). fp64: G and u in float64 (complex
    G: complex128). wrap (K13):
    the two (N, N) wrap operands read once, and the wrap's two products,
    4 N^3 operations per flavor block."""
    el = (8 if complex_ else 4) * (2 if fp64 else 1)
    nbytes = 2 * C * F * N * N * el + C * N * (1 + 1 + (8 if fp64 else 4)) + (
        C * N * (1 + el) if complex_ else 2 * C * 4)
    per_acc = F * ((8 * N * N + 7 * N + 8) if complex_
                   else (2 * N * N + 2 * N))
    per_site = (7 * F + 8) if complex_ else (5 * F + 4)
    ops = n_acc * per_acc + C * N * per_site
    if wrap:
        nbytes += 2 * N * N * el
        ops += C * F * 4 * N ** 3
    return bound(nbytes, ops, fp64)


def ab_modes(ctx):
    """The A/B modes and session switches a session runs, each with a
    leading space (" fuse_wrap", " qr_wy", " g_refresh", " checkerboard"),
    or none."""
    return "".join(f" {m}" for m in ("fuse_wrap", "qr_wy", "g_refresh",
                                     "checkerboard") if getattr(ctx, m))


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build():
    from montecarlo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[build] {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s ({lib._name})")


def headline_model(repulsive=False, L=L):
    from montecarlo_tpu_torch import (HubbardModelAttractive,
                                      HubbardModelRepulsive)
    if repulsive:
        return HubbardModelRepulsive(dims=2, L=L, U=U)
    return HubbardModelAttractive(dims=2, L=L, U=U, mu=MU)


def complex_model(repulsive=False, L=L, dims=2):
    """The complex configuration's model: 8x8 (or L^dims sites: 16x16, the
    128-site chain) with pure-gauge Peierls phases drawn as
    benchmarks/complex_bench.py draws them."""
    import numpy as np
    from montecarlo_tpu_torch import (HubbardModelAttractive,
                                      HubbardModelRepulsive)
    phi = np.random.default_rng(0).uniform(0.0, 2 * np.pi, L ** dims)
    theta = phi[:, None] - phi[None, :]
    if repulsive:
        return HubbardModelRepulsive(dims=dims, L=L, U=U, peierls=theta)
    return HubbardModelAttractive(dims=dims, L=L, U=U, mu=MU, peierls=theta)


def real_state(model, chains, seed, use_kernels, safe_mult=SAFE_MULT,
               **session):
    """A chain state at beta=10 on the card: float32 (complex64 for complex
    hopping) unless session (make_context's dtype, update_dtype,
    stab_method) says otherwise."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=safe_mult)
    session = {"dtype": torch.float32, **session}
    ctx, consts = core.make_context(model, params, device=DEVICE,
                                    use_kernels=use_kernels, **session)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    conf = model.rand_conf(gen, chains, params.slices, DEVICE)
    return ctx, consts, core.init_state(ctx, consts, conf), gen


def slice_inputs(model, chains, seed, safe_mult=SAFE_MULT, **session):
    """A site sweep's inputs at model (real_state's session): G of a
    plain-path init_state at beta=10, the last slice's sigma and fresh
    uniforms in the update dtype. Returns (G, sigma, u, the sweep's
    keywords, ctx)."""
    import torch
    ctx, _, state, gen = real_state(model, chains, seed, use_kernels=False,
                                    safe_mult=safe_mult, **session)
    sigma = state["conf"][:, :, ctx.M - 1].contiguous()
    u = torch.rand(chains, ctx.N, generator=gen, device=DEVICE,
                   dtype=ctx.urdtype)
    kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
              use_boson=ctx.use_boson)
    return state["G"], sigma, u, kw, ctx


def sweep_inputs(complex_=False, repulsive=False, chains=CHAINS, L=L,
                 dims=2):
    """Inputs of K1 (complex_: K8) at the headline's (complex_: the complex
    configuration's; L=CHAIN_L, dims=1: chain128's) model
    (``slice_inputs``)."""
    if complex_:
        return slice_inputs(complex_model(repulsive, L, dims), chains, 1,
                            safe_mult=CPLX_SM)
    return slice_inputs(headline_model(repulsive, L), chains, 1)


def pair_sweep_inputs(repulsive=True, chains=CHAINS):
    """Inputs of K5 (and of K1 beside it) at the headline's model
    (repulsive: the repulsive run's, F = 2; ``slice_inputs``)."""
    return slice_inputs(headline_model(repulsive), chains, 12)


def f64_sweep_inputs(repulsive=False, chains=F64_CHAINS):
    """Inputs of K1 in float64 at the f64 run's model (repulsive: F = 2;
    ``slice_inputs``)."""
    import torch
    return slice_inputs(headline_model(repulsive), chains, 9,
                        dtype=torch.float64)


def libqr_sweep_inputs(kind):
    """Inputs of the libqr runs' site sweeps at (LIBQR_CHAINS, 1, N, N),
    N = LIBQR_L**2 = 100 (``slice_inputs``): kind "f32" (K1) and "f64"
    (K1-f64) at the headline's model, "c64" (K8) at the complex one."""
    import torch
    if kind == "c64":
        return slice_inputs(complex_model(L=LIBQR_L), LIBQR_CHAINS, 24,
                            safe_mult=CPLX_SM)
    dtype = torch.float64 if kind == "f64" else torch.float32
    return slice_inputs(headline_model(L=LIBQR_L), LIBQR_CHAINS, 24,
                        dtype=dtype)


def wrap_inputs(repulsive=False, chains=CHAINS):
    """Inputs of K13 at the headline's model (repulsive: F = 2): G of a
    plain-path init_state at beta=10, the last slice's sigma, fresh
    uniforms and the session's wrap operands per direction, {+1: (Ml, Mr),
    -1: (Ml, Mr)}. Returns (G, sigma, u, the sweep's keywords, the
    operands, ctx, consts)."""
    import torch
    ctx, consts, state, gen = real_state(headline_model(repulsive), chains,
                                         15, use_kernels=False)
    sigma = state["conf"][:, :, ctx.M - 1].contiguous()
    u = torch.rand(chains, ctx.N, generator=gen, device=DEVICE)
    kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
              use_boson=ctx.use_boson)
    ops = {1: (consts["eT2_u"], consts["eT2inv_u"]),
           -1: (consts["eT2inv_u"], consts["eT2_u"])}
    return state["G"], sigma, u, kw, ops, ctx, consts


def qr64_input(gen, B=F64_CHAINS, N=L * L):
    """K11's input at the f64 run's shape: graded, prescaled, pivoted
    float64 matrices (B, N, N), contiguous."""
    import torch
    from montecarlo_tpu_torch.ops.linalg import _prescale_pivot
    Ap, _, _ = _prescale_pivot(graded(gen, B, N, dtype=torch.float64))
    return Ap.contiguous()


def delayed_inputs(complex_=False, repulsive=False, chains=None):
    """Inputs of K6 (complex_: K9) at a 16x16 configuration (chains:
    L16_CHAINS by default): G of a plain-path init_state at beta=10, the
    last slice's sigma and fresh uniforms. Returns (G, sigma, u, the
    sweep's keywords with dk = the session's delay, ctx, the generator)."""
    import torch
    chains = chains or L16_CHAINS
    if complex_:
        ctx, _, state, gen = real_state(complex_model(repulsive, L16), chains,
                                        13, use_kernels=False,
                                        safe_mult=CPLX_SM)
    else:
        ctx, _, state, gen = real_state(headline_model(repulsive, L16),
                                        chains, 5, use_kernels=False)
    sigma = state["conf"][:, :, ctx.M - 1].contiguous()
    u = torch.rand(chains, ctx.N, generator=gen, device=DEVICE)
    kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
              use_boson=ctx.use_boson, dk=max(ctx.delay, 1))
    return state["G"], sigma, u, kw, ctx, gen


def more_chains(G, sigma, gen):
    """(G, sigma, u) of WAVE_CHAINS chains from a run's: its chains' G and
    sigma repeated in turn, with fresh uniforms, so that each copy decides
    otherwise."""
    import torch
    idx = torch.arange(WAVE_CHAINS, device=G.device) % G.shape[0]
    u = torch.rand(WAVE_CHAINS, G.shape[-1], generator=gen, device=DEVICE)
    return G[idx].contiguous(), sigma[idx].contiguous(), u


def graded(gen, B, N, decades=16.0, dtype=None):
    """Columns scaled over 2*decades e-folds, as tests/test_pallas_qr.py::
    _graded scales them, of a well-conditioned core I + 0.3 randn / sqrt(N)
    (complex randn for a complex dtype). A plain Gaussian core at N=64 has
    condition numbers up to ~1e4 over 256 draws, which turns any float32
    rounding-order difference into ~1e-3 in d (plain float32 against plain
    float64 on such input: 1.9e-3 on the CPU), so the bounds would measure
    the input instead of the kernel."""
    import torch
    core = (torch.eye(N, device=DEVICE) + 0.3 / math.sqrt(N) * torch.randn(
        B, N, N, generator=gen, device=DEVICE, dtype=dtype))
    grade = torch.exp((torch.rand(B, N, generator=gen, device=DEVICE) * 2 - 1)
                      * decades)
    return core * grade[:, None, :]


def check_sweep(name, out_k, out_p, shape, relative, tol=TOL_G):
    """Decisions (the second to fourth results) identical, G within tol
    (times max|G| when relative); returns max|dG|."""
    import torch
    torch.cuda.synchronize()
    err = (out_k[0] - out_p[0]).abs().max().item()
    gmax = out_p[0].abs().max().item()
    same = [torch.equal(a.to(b.dtype), b) for a, b in
            zip(out_k[1:4], out_p[1:4])]
    acc = out_k[2].sum().item() / (shape[0] * shape[-1])
    log(f"[parity] {name} {shape}: decisions (sigma, acc/accept, nneg/det) "
        f"equal {same}, max|dG| "
        f"{err:.3e} (max|G| {gmax:.3g}), acceptance {acc:.3f}")
    if not all(same) or not err <= tol * (gmax if relative else 1.0):
        raise AssertionError(f"{name} kernel disagrees with plain at {shape}")
    return err


def qr_parity(name, kernel, plain, Ap, library=None, normalize=None,
              tol=TOL_QR):
    """Q and R of kernel(Ap) against plain(Ap) within tol of their largest
    entries (after normalize, where given), R exactly upper triangular;
    returns the result dict with the kernel's, the plain version's and the
    library call's times."""
    import torch
    outs_k, outs_p = kernel(Ap), plain(Ap)
    torch.cuda.synchronize()
    if normalize is not None:
        raw = (outs_k[0] - outs_p[0]).abs().max().item()
        log(f"[parity] {name}: raw max|dQ| {raw:.3e} before the "
            "normalization")
        outs_k, outs_p = normalize(*outs_k), normalize(*outs_p)
    eq = (outs_k[0] - outs_p[0]).abs().max().item()
    er = (outs_k[1] - outs_p[1]).abs().max().item()
    rmax = outs_p[1].abs().max().item()
    upper = bool((torch.tril(outs_k[1], -1) == 0).all())
    log(f"[parity] {name} {tuple(Ap.shape)} {str(Ap.dtype)[6:]}: max|dQ| "
        f"{eq:.3e}, max|dR| {er:.3e} (max|R| {rmax:.3g}), R lower zero "
        f"{upper}")
    if not (eq <= tol * outs_p[0].abs().max().item() and er <= tol * rmax
            and upper):
        raise AssertionError(f"{name} kernel disagrees with plain")
    return dict(max_abs_err=max(eq, er),
                ms=1e3 * timed(lambda: kernel(Ap), 20),
                plain_ms=1e3 * timed(lambda: plain(Ap), 3),
                library_ms=(1e3 * timed(lambda: library(Ap), 20)
                            if library else None))


def repeats_equal(name, fn, reps=REPEATS):
    """fn() reps more times, every output bit-equal to the first call's: a
    race between a kernel's threads (a buffer read while another warp
    rewrites it) would show as a difference from run to run."""
    import torch
    first = fn()
    same = all(all(torch.equal(a, b) for a, b in zip(first, fn()))
               for _ in range(reps))
    log(f"[parity] {name}: {reps} repeats bit-equal to the first {same}")
    if not same:
        raise AssertionError(f"{name} differs from run to run")


def degenerate_columns(name, fn, Ap, scale, tol_rec, tol_orth):
    """fn on Ap with its last four columns zero and column 1 scaled by
    scale (a subnormal v.v): finite, an exactly zero R block, A = QR and
    Q^H Q = I. The Q columns of (near-)zero R_jj are not determined by the
    input, so the factorization is held to these, not to the plain
    version's Q."""
    import torch
    Az = Ap.clone()
    Az[:, :, -4:] = 0.0
    Az[:, :, 1] = Az[:, :, 1] * scale
    Qz, Rz = fn(Az)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(Qz).all()) and bool(torch.isfinite(Rz).all())
    zero = bool((Rz[:, -4:, -4:] == 0).all())
    wide = torch.complex128 if Az.is_complex() else torch.float64
    Qd, Rd, Ad = Qz.to(wide), Rz.to(wide), Az.to(wide)
    rec = ((Qd @ Rd - Ad).abs().max() / Ad.abs().max()).item()
    eye = torch.eye(Az.shape[-1], device=DEVICE, dtype=wide)
    orth = (Qd.mH @ Qd - eye).abs().max().item()
    log(f"[parity] {name} zero and subnormal columns: finite {finite}, zero "
        f"R block {zero}, max|QR - A|/max|A| {rec:.3e}, max|Q^H Q - I| "
        f"{orth:.3e}")
    if not (finite and zero and rec <= tol_rec and orth <= tol_orth):
        raise AssertionError(f"{name} fails on zero or subnormal columns")


def phase_parity():
    """Each kernel against its plain version on the same card inputs."""
    import torch
    from montecarlo_tpu_torch.ops import qr, qr_blocked as qb, qr_cx as qcx
    from montecarlo_tpu_torch.ops import qr_householder as qh
    from montecarlo_tpu_torch.ops import site_sweep as ss
    from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
    from montecarlo_tpu_torch.ops.linalg import _library_qr, _prescale_pivot
    results = {}

    # ---- K1 at (256, 1, 64, 64) and (128, 2, 64, 64), on real Green's
    # functions (plain-path init_state) and the sweeps' uniform draws; K8 at
    # the same shapes in complex64, on the complex configuration's, and at
    # (256, 1, 128, 128), on chain128's (a row of its own in the kernels
    # line); all bit for bit
    for kname, fn, plain, cx, repulsive, chains, where in (
            ("site_sweep", ss.site_sweep, ss.site_sweep_plain, False, False,
             CHAINS, {}),
            ("site_sweep", ss.site_sweep, ss.site_sweep_plain, False, True,
             K1_F2_CHAINS, {}),
            ("site_sweep_cx", sscx.site_sweep_cx, sscx.site_sweep_cx_plain,
             True, False, CHAINS, {}),
            ("site_sweep_cx", sscx.site_sweep_cx, sscx.site_sweep_cx_plain,
             True, True, K1_F2_CHAINS, {}),
            ("site_sweep_cx_128", sscx.site_sweep_cx,
             sscx.site_sweep_cx_plain, True, False, CHAINS,
             dict(L=CHAIN_L, dims=1))):
        G, sigma, u, kw, ctx = sweep_inputs(cx, repulsive, chains, **where)
        out_k = fn(G, sigma, u, **kw)
        err = check_sweep(kname, out_k, plain(G, sigma, u, **kw),
                          tuple(G.shape), relative=False, tol=0.0)
        if not repulsive:
            results[kname] = dict(
                max_abs_err=err,
                ms=1e3 * timed(lambda: fn(G, sigma, u, **kw), 50),
                plain_ms=1e3 * timed(lambda: plain(G, sigma, u, **kw), 5),
                library_ms=None,
                **sweep_bound(chains, ctx.F, ctx.N, out_k[2].sum().item(),
                              complex_=cx))
            dev = device_ms(lambda: fn(G, sigma, u, **kw))
            if dev is not None:
                results[kname]["device_ms"] = dev

    # ---- K5 at (256, 2, 64, 64), the repulsive run's shape, and at
    # (256, 1, 64, 64), on real Green's functions (plain-path init_state),
    # against its plain version and against K1 on the same inputs, bit for
    # bit, and REPEATS launches more, each bit-equal to the first; K5's and
    # K1's times (wall, then device) in turns on the F=2 inputs
    for repulsive in (True, False):
        G, sigma, u, kw, ctx = pair_sweep_inputs(repulsive)
        pair = lambda: ss.site_sweep_pair(G, sigma, u, **kw)
        k1 = lambda: ss.site_sweep(G, sigma, u, **kw)
        out_k = pair()
        shape = tuple(G.shape)
        err = check_sweep("site_sweep_pair", out_k,
                          ss.site_sweep_pair_plain(G, sigma, u, **kw), shape,
                          relative=False, tol=0.0)
        err = max(err, check_sweep("site_sweep_pair vs K1", out_k, k1(),
                                   shape, relative=False, tol=0.0))
        repeats_equal(f"site_sweep_pair {shape}", pair)
        flips = (out_k[1] != sigma).reshape(CHAINS, -1, 2)
        counts = [int(((flips[..., 0] == a) & (flips[..., 1] == b)).sum())
                  for a, b in ((False, False), (True, False), (False, True),
                               (True, True))]
        log(f"[parity] site_sweep_pair {shape}: site pairs with neither, "
            f"only the first, only the second, both accepted: {counts}")
        if not repulsive:
            continue
        t_pair, t_k1, d_pair, d_k1 = [], [], [], []
        for _ in range(2):
            t_pair.append(1e3 * timed(pair, 50))
            t_k1.append(1e3 * timed(k1, 50))
        for _ in range(2):
            d_pair.append(device_ms(pair))
            d_k1.append(device_ms(k1))
        log(f"[parity] site_sweep_pair {shape}: K5 {t_pair[0]:.4f}, "
            f"{t_pair[1]:.4f} ms; K1 on the same inputs {t_k1[0]:.4f}, "
            f"{t_k1[1]:.4f} ms (in turns); device K5 "
            f"{', '.join(map(ms_text, d_pair))}, K1 "
            f"{', '.join(map(ms_text, d_k1))} (in turns)")
        results["site_sweep_pair"] = dict(
            max_abs_err=err, ms=min(t_pair),
            plain_ms=1e3 * timed(lambda: ss.site_sweep_pair_plain(
                G, sigma, u, **kw), 5),
            library_ms=None,
            **sweep_bound(CHAINS, ctx.F, ctx.N, out_k[2].sum().item()))
        if d_pair[0] is not None:
            results["site_sweep_pair"]["device_ms"] = d_pair[0]

    # ---- K13 at (256, 1, 64, 64), the fusewrap run's shape, and at
    # (128, 2, 64, 64), in both directions, on real Green's functions
    # (plain-path init_state) with the session's wrap operands; the up
    # direction's decisions also against K1's on the same inputs, bit for
    # bit; K13's times in turns with the unfused visit's (K1 and the
    # separate wrap_up / wrap_down); then K12 on the first chain
    from montecarlo_tpu_torch.dqmc import core
    for repulsive, chains in ((False, CHAINS), (True, K1_F2_CHAINS)):
        G, sigma, u, kw, ops, ctx, consts = wrap_inputs(repulsive, chains)
        shape = tuple(G.shape)
        errs, fused = [], {}
        for d, (Ml, Mr) in ops.items():
            fused[d] = (lambda Ml=Ml, Mr=Mr, d=d: ss.site_sweep_wrap(
                G, sigma, u, Ml, Mr, wrap_dir=d, **kw))
            out_k = fused[d]()
            errs.append(check_sweep(
                f"site_sweep_wrap dir={d:+d}", out_k,
                ss.site_sweep_wrap_plain(G, sigma, u, Ml, Mr, wrap_dir=d,
                                         **kw), shape, relative=True))
            repeats_equal(f"site_sweep_wrap dir={d:+d} {shape}", fused[d])
            if d > 0:
                out_1 = ss.site_sweep(G, sigma, u, **kw)
                same = all(torch.equal(a, b)
                           for a, b in zip(out_k[1:], out_1[1:]))
                log(f"[parity] site_sweep_wrap dir=+1 {shape}: sigma, acc, "
                    f"nneg bit-equal to K1's {same}")
                if not same:
                    raise AssertionError("K13's up decisions differ from K1's")
                n_acc = out_k[2].sum().item()
        if repulsive:
            continue
        ctx_k = dataclasses.replace(ctx, use_kernels=True)   # K1, unfused
        unfused = {d: (lambda d=d: core.visit_slice(ctx_k, consts, G, sigma,
                                                    u, d)) for d in (1, -1)}
        t = {k: [] for k in ("k+", "k-", "u+", "u-")}
        for _ in range(2):
            t["k+"].append(1e3 * timed(fused[1], 50))
            t["u+"].append(1e3 * timed(unfused[1], 50))
            t["k-"].append(1e3 * timed(fused[-1], 50))
            t["u-"].append(1e3 * timed(unfused[-1], 50))
        log(f"[parity] site_sweep_wrap {shape}: K13 up {t['k+'][0]:.4f}, "
            f"{t['k+'][1]:.4f} ms, down {t['k-'][0]:.4f}, {t['k-'][1]:.4f} "
            f"ms; the unfused visit (K1 + wrap_up) {t['u+'][0]:.4f}, "
            f"{t['u+'][1]:.4f} ms, (wrap_down + K1) {t['u-'][0]:.4f}, "
            f"{t['u-'][1]:.4f} ms (in turns)")
        results["site_sweep_wrap"] = dict(
            max_abs_err=max(errs),
            ms=(min(t["k+"]) + min(t["k-"])) / 2,
            plain_ms=1e3 * timed(lambda: ss.site_sweep_wrap_plain(
                G, sigma, u, *ops[1], wrap_dir=1, **kw), 5),
            library_ms=None,
            **sweep_bound(chains, ctx.F, ctx.N, n_acc, wrap=True))
        G1, s1, u1 = G[0], sigma[0], u[0]
        out_k = ss.site_sweep_single(G1, s1, u1, **kw)
        err = check_sweep("site_sweep_single", [x[None] for x in out_k],
                          ss.site_sweep_plain(G1[None], s1[None], u1[None],
                                              **kw), (1,) + shape[1:],
                          relative=False, tol=0.0)
        results["site_sweep_single"] = dict(
            max_abs_err=err,
            ms=1e3 * timed(lambda: ss.site_sweep_single(G1, s1, u1, **kw),
                           50),
            plain_ms=1e3 * timed(lambda: ss.site_sweep_plain(
                G1[None], s1[None], u1[None], **kw), 5),
            library_ms=None,
            **sweep_bound(1, ctx.F, ctx.N, out_k[2].item()))

    # ---- K2, K3 at (256, 64, 64) on graded, prescaled, pivoted input
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    B, N = CHAINS, L * L
    Ap, mx, _ = _prescale_pivot(graded(gen, B, N))
    Ap, mx = Ap.contiguous(), mx.reshape(-1).contiguous()
    Z = torch.randn(B, N, N, generator=gen, device=DEVICE)

    Qk, Rk, dk = qr.udt_qr(Ap, mx)
    Qp, Rp, dp = qr.udt_qr_plain(Ap, mx)
    torch.cuda.synchronize()
    eq = (Qk - Qp).abs().max().item()
    er = (Rk - Rp).abs().max().item()
    ed = ((dk - dp).abs() / dp).max().item()
    log(f"[parity] udt_qr ({B}, {N}, {N}): max|dQ| {eq:.3e}, max|dRs| "
        f"{er:.3e} (max|Rs| {Rp.abs().max().item():.3g}), max rel dd {ed:.3e}")
    if not (eq <= TOL_QR * Qp.abs().max().item()
            and er <= TOL_QR * Rp.abs().max().item() and ed <= TOL_D):
        raise AssertionError("udt_qr kernel disagrees with plain")
    results["udt_qr"] = dict(
        max_abs_err=max(eq, er),
        ms=1e3 * timed(lambda: qr.udt_qr(Ap, mx), 50),
        plain_ms=1e3 * timed(lambda: qr.udt_qr_plain(Ap, mx), 5),
        library_ms=1e3 * timed(lambda: torch.linalg.qr(Ap), 20),
        **bound(B * (3 * N * N * 4 + 4 + N * 4),
                B * (householder_flops(N) + N * N)))

    Qk, Xk = qr.udt_qr_solve(Ap, Z, mx)
    Qp, Xp = qr.udt_qr_solve_plain(Ap, Z, mx)
    torch.cuda.synchronize()
    eq = (Qk - Qp).abs().max().item()
    ex = (Xk - Xp).abs().max().item()
    xmax = Xp.abs().max().item()
    log(f"[parity] udt_qr_solve ({B}, {N}, {N}): max|dQ| {eq:.3e}, "
        f"max|dX| {ex:.3e} (max|X| {xmax:.3g})")
    if not (eq <= TOL_QR * Qp.abs().max().item() and ex <= TOL_QR * xmax):
        raise AssertionError("udt_qr_solve kernel disagrees with plain")
    solve_flops = sum(2 * N + 2 * N * (N - j - 1) for j in range(N))
    results["udt_qr_solve"] = dict(
        max_abs_err=max(eq, ex),
        ms=1e3 * timed(lambda: qr.udt_qr_solve(Ap, Z, mx), 50),
        plain_ms=1e3 * timed(lambda: qr.udt_qr_solve_plain(Ap, Z, mx), 5),
        library_ms=None,
        **bound(B * (4 * N * N * 4 + 4),
                B * (householder_flops(N) + solve_flops)))

    # ---- K10 at (256, 64, 64), the complex run's shape, and (256, 128,
    # 128), the chain128 run's (its own row of the kernels line), complex64
    # on graded, prescaled, pivoted input, against its plain version (the
    # same panels) phase-normalized (qr_cx.phase_normalized: rounding turns
    # the phase of a small alpha), then with zero and subnormal columns
    for name, n in (("qr_cx", N), ("qr_cx_128", 2 * N)):
        Apc, _, _ = _prescale_pivot(graded(gen, B, n, dtype=torch.complex64))
        Apc = Apc.contiguous()
        results[name] = qr_parity(f"qr_cx N={n}", qcx.qr_cx,
                                  qcx.qr_cx_blocked_plain, Apc,
                                  library=torch.linalg.qr,
                                  normalize=qcx.phase_normalized)
        results[name].update(bound(3 * B * n * n * 8,
                                   B * householder_flops(n, complex_=True)))
        degenerate_columns(f"qr_cx N={n}", qcx.qr_cx, Apc, 1e-35, TOL_QR,
                           TOL_QR)
    # the library complex QR at (64, 256, 256), which the complex16 run
    # calls past N = 128 as the JAX package calls XLA's
    A16, _, _ = _prescale_pivot(graded(gen, L16_CHAINS, L16 * L16,
                                       dtype=torch.complex64))
    Q16, R16 = _library_qr(A16)
    if not (torch.isfinite(Q16).all() and torch.isfinite(R16).all()):
        raise AssertionError("the library complex QR is not finite")
    log(f"[parity] library complex QR ({L16_CHAINS}, {L16 * L16}, "
        f"{L16 * L16}): {1e3 * timed(lambda: _library_qr(A16), 5):.4f} ms")

    # ---- K4 at (256, 64, 64), the colscaled run's shape, and at
    # (64, 128, 128), the widest it takes; K11 at (128, 64, 64) float64, the
    # f64 run's shape; each on graded, prescaled, pivoted input (K4 also
    # REPEATS launches more, each bit-equal to the first), then with zero
    # and subnormal columns
    for b, n in ((B, N), (L16_CHAINS, 2 * N)):
        Ap, _, _ = _prescale_pivot(graded(gen, b, n))
        Ap = Ap.contiguous()
        r = qr_parity("qr_f32", qh.qr_f32, qh.householder_qr_plain, Ap,
                      library=torch.linalg.qr)
        repeats_equal(f"qr_f32 {tuple(Ap.shape)}", lambda: qh.qr_f32(Ap))
        r.update(bound(3 * b * n * n * 4, b * householder_flops(n)))
        log(f"[parity] qr_f32 ({b}, {n}, {n}): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library call "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
        if "qr_f32" in results:       # the kernels line keeps the N=64 row
            results["qr_f32"]["max_abs_err"] = max(
                results["qr_f32"]["max_abs_err"], r["max_abs_err"])
        else:
            results["qr_f32"] = r
    degenerate_columns("qr_f32", qh.qr_f32, Ap, 1e-35, TOL_QR, TOL_QR)
    # ---- K14 at (256, 64, 64), the colscaled_wy run's shape, and at
    # (256, 128, 128), the widest it takes: V, tau and R against its plain
    # version, max|Q^T Q - I| of Q assembled from them and of K4's Q; the
    # times of qr_wy (K14 with the assembly) and of K4 beside; REPEATS
    # launches more, each bit-equal to the first; then with zero and
    # subnormal columns
    for n in (N, 2 * N):
        Ap, _, _ = _prescale_pivot(graded(gen, B, n))
        Ap = Ap.contiguous()
        repeats_equal(f"qr_vtau {tuple(Ap.shape)}", lambda: qh.qr_vtau(Ap))
        Vk, tk, Rk = qh.qr_vtau(Ap)
        Vp, tp, Rp = qh.householder_qr_vtau_plain(Ap)
        torch.cuda.synchronize()
        ev = (Vk - Vp).abs().max().item()
        er = (Rk - Rp).abs().max().item()
        et = ((tk - tp).abs() / tp.abs().clamp_min(1e-38)).max().item()
        upper = bool((torch.tril(Rk, -1) == 0).all()
                     and (torch.triu(Vk, 1) == 0).all())
        eye = torch.eye(n, device=DEVICE)
        orth = {name: (Q.mT @ Q - eye).abs().max().item() for name, Q in (
            ("K14 + assembly", qh.qr_wy(Ap)[0]), ("K4", qh.qr_f32(Ap)[0]))}
        log(f"[parity] qr_vtau ({B}, {n}, {n}): max|dV| {ev:.3e} (max|V| "
            f"{Vp.abs().max().item():.3g}), max|dR| {er:.3e} (max|R| "
            f"{Rp.abs().max().item():.3g}), max rel dtau {et:.3e}, V and R "
            f"triangular {upper}; max|Q^T Q - I| " + ", ".join(
                f"{k} {v:.3e}" for k, v in orth.items()))
        if not (ev <= TOL_QR * Vp.abs().max().item()
                and er <= TOL_QR * Rp.abs().max().item() and et <= TOL_TAU
                and upper and max(orth.values()) <= TOL_QR):
            raise AssertionError("qr_vtau kernel disagrees with plain")
        r = dict(max_abs_err=max(ev, er),
                 ms=1e3 * timed(lambda: qh.qr_vtau(Ap), 20),
                 plain_ms=1e3 * timed(
                     lambda: qh.householder_qr_vtau_plain(Ap), 3),
                 library_ms=1e3 * timed(lambda: torch.linalg.qr(Ap), 20),
                 **bound(3 * B * n * n * 4 + B * n * 4,
                         B * householder_flops(n, with_q=False)))
        log(f"[parity] qr_vtau ({B}, {n}, {n}): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library call "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); qr_wy (K14 + assembly) "
            f"{1e3 * timed(lambda: qh.qr_wy(Ap), 20):.4f} ms, K4 "
            f"{1e3 * timed(lambda: qh.qr_f32(Ap), 20):.4f} ms")
        if "qr_vtau" in results:     # the kernels line keeps the N=64 row
            results["qr_vtau"]["max_abs_err"] = max(
                results["qr_vtau"]["max_abs_err"], r["max_abs_err"])
        else:
            results["qr_vtau"] = r
        degenerate_columns("qr_vtau", qh.qr_wy, Ap, 1e-35, TOL_QR, TOL_QR)
    B64 = F64_CHAINS
    Ap = qr64_input(gen, B64, N)
    results["qr_f64"] = qr_parity("qr_f64", qh.qr_f64,
                                  qh.householder_qr_plain, Ap,
                                  library=torch.linalg.qr, tol=TOL_QR64)
    results["qr_f64"].update(bound(3 * B64 * N * N * 8,
                                   B64 * householder_flops(N), fp64=True))
    Qk, _ = qh.qr_f64(Ap)
    orth = (Qk.mT @ Qk - torch.eye(N, device=DEVICE,
                                   dtype=torch.float64)).abs().max().item()
    log(f"[parity] qr_f64 max|Q^T Q - I| {orth:.3e}")
    if not orth <= TOL_ORTH64:
        raise AssertionError("qr_f64 kernel's Q is not orthogonal")
    repeats_equal(f"qr_f64 {tuple(Ap.shape)}", lambda: qh.qr_f64(Ap))
    # 1e-175 puts v.v of column 1 among the float64 subnormals
    degenerate_columns("qr_f64", qh.qr_f64, Ap, 1e-175, TOL_QR64, TOL_ORTH64)

    # ---- K1 in float64 at (128, 1, 64, 64) and (64, 2, 64, 64), on real
    # float64 Green's functions (plain-path init_state), and REPEATS
    # launches more, each bit-equal to the first
    errs = []
    for repulsive, chains in ((False, F64_CHAINS), (True, K1_F64_F2_CHAINS)):
        G, sigma, u, kw, ctx = f64_sweep_inputs(repulsive, chains)
        k64 = lambda: ss.site_sweep_f64(G, sigma, u, **kw)
        out_k = k64()
        errs.append(check_sweep("site_sweep_f64", out_k,
                                ss.site_sweep_plain(G, sigma, u, **kw),
                                tuple(G.shape), relative=False, tol=TOL_G64))
        repeats_equal(f"site_sweep_f64 {tuple(G.shape)}", k64)
        if not repulsive:
            results["site_sweep_f64"] = dict(
                ms=1e3 * timed(k64, 50),
                plain_ms=1e3 * timed(lambda: ss.site_sweep_plain(
                    G, sigma, u, **kw), 5),
                library_ms=None,
                **sweep_bound(chains, ctx.F, ctx.N, out_k[2].sum().item(),
                              fp64=True))
            dev = device_ms(k64)
            if dev is not None:
                results["site_sweep_f64"]["device_ms"] = dev
    results["site_sweep_f64"]["max_abs_err"] = max(errs)
    # ... and its negative-weight magnitudes against its plain version's, on
    # F=2 inputs with random G whose diagonal leaves [0, 1] (r_up r_dn < 0
    # happens there; the Green's functions of a half-filled run give none)
    genn = torch.Generator(device=DEVICE).manual_seed(14)
    C, Nn = K1_F64_F2_CHAINS, L * L
    f64 = dict(device=DEVICE, dtype=torch.float64)
    Gn = 0.5 * torch.eye(Nn, **f64) + 0.8 / math.sqrt(Nn) * torch.randn(
        C, 2, Nn, Nn, generator=genn, **f64) + torch.diag_embed(
            0.8 * torch.randn(C, 2, Nn, generator=genn, **f64))
    sn = (2 * torch.randint(0, 2, (C, Nn), generator=genn, device=DEVICE)
          - 1).to(torch.int8)
    un = torch.rand(C, Nn, generator=genn, **f64)
    kwn = dict(lamb=ctx.lamb, signs=(1.0, -1.0), det_power=1,
               use_boson=False)
    out_k = ss.site_sweep_f64(Gn, sn, un, **kwn)
    out_p = ss.site_sweep_plain(Gn, sn, un, **kwn)
    check_sweep("site_sweep_f64 on random G", out_k, out_p,
                tuple(Gn.shape), relative=False, tol=TOL_G64)
    has = out_p[3] > 0
    dneg = ((out_k[4][has] - out_p[4][has]).abs().max().item()
            if has.any() else math.inf)
    log(f"[parity] site_sweep_f64 negative detratios {int(out_p[3].sum())} "
        f"in {int(has.sum())} of {C} chains; log10 magnitudes (min, max, "
        f"sum) max|d| {dneg:.3e} against the plain version")
    if not (dneg <= TOL_NEG64
            and torch.equal(out_k[4][~has], out_p[4][~has])):
        raise AssertionError("site_sweep_f64's negative-weight magnitudes "
                             "disagree with the plain version's")

    # ---- K1, K1-f64 and K8 at the libqr runs' shape (64, 1, 100, 100),
    # padded rows: K1 and K8 bit for bit, K1-f64 within TOL_G64 (as at
    # N = 64); rows of their own in the kernels line
    for kname, fn, plain, kind, tol in (
            ("site_sweep_100", ss.site_sweep, ss.site_sweep_plain, "f32",
             0.0),
            ("site_sweep_f64_100", ss.site_sweep_f64, ss.site_sweep_plain,
             "f64", TOL_G64),
            ("site_sweep_cx_100", sscx.site_sweep_cx,
             sscx.site_sweep_cx_plain, "c64", 0.0)):
        G, sigma, u, kw, ctx = libqr_sweep_inputs(kind)
        out_k = fn(G, sigma, u, **kw)
        err = check_sweep(kname, out_k, plain(G, sigma, u, **kw),
                          tuple(G.shape), relative=False, tol=tol)
        results[kname] = dict(
            max_abs_err=err,
            ms=1e3 * timed(lambda: fn(G, sigma, u, **kw), 50),
            plain_ms=1e3 * timed(lambda: plain(G, sigma, u, **kw), 5),
            library_ms=None,
            **sweep_bound(LIBQR_CHAINS, ctx.F, ctx.N, out_k[2].sum().item(),
                          complex_=kind == "c64", fp64=kind == "f64"))
        dev = device_ms(lambda: fn(G, sigma, u, **kw))
        if dev is not None:
            results[kname]["device_ms"] = dev

    parity_delayed(results)
    parity_fp64(results)
    parity_item4(results)
    parity_ising(results)
    gen = torch.Generator(device=DEVICE).manual_seed(13)

    # ---- K7 at (64, 256, 256) on graded, prescaled, pivoted input
    B, N = L16_CHAINS, L16 * L16
    Ap, _, _ = _prescale_pivot(graded(gen, B, N))
    Ap = Ap.contiguous()
    results["qr_blocked"] = qr_parity("qr_blocked", qb.qr_blocked,
                                      qb.qr_blocked_plain, Ap,
                                      library=torch.linalg.qr)
    results["qr_blocked"].update(bound(3 * B * N * N * 4,
                                       B * householder_flops(N)))
    degenerate_columns("qr_blocked", qb.qr_blocked, Ap, 1e-35, TOL_QR, TOL_QR)
    for name, r in results.items():
        if r.get("device_ms", math.inf) < r["bound_ms"]:
            # below the least time the card could take: a measurement fault
            r["device_ms_below_bound"] = r.pop("device_ms")
            log(f"[check] {name}: the profiler's device time "
                f"{r['device_ms_below_bound']:.4f} ms is below the bound "
                f"{r['bound_ms']:.5f} ms; not recorded as its device time")
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        dev = (f" ({ms_text(r['device_ms'])} device)" if "device_ms" in r
               else "")
        log(f"[parity] {name}: kernel {r['ms']:.4f} ms{dev}, plain "
            f"{r['plain_ms']:.4f} ms per call, library call {lib}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    return results


def parity_delayed(results):
    """K6 and K9 against their plain versions (K9 also against K8's plain
    sweep) at the 16x16 configurations' shapes and at WAVE_CHAINS chains,
    each in the layout cluster_plan picks; their times and bounds into
    results."""
    import torch
    from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
    # ---- K6 at (64, 1, 256, 256) and (32, 2, 256, 256) with dk = 32, and
    # at dk = 1, on real 16x16 Green's functions (plain-path init_state), and
    # at 160 chains (more than one wave of clusters); each in the layout
    # cluster_plan picks
    errs = []
    for repulsive, chains in ((False, L16_CHAINS), (True, L16_F2_CHAINS)):
        G, sigma, u, kw, ctx, gen = delayed_inputs(repulsive=repulsive,
                                                   chains=chains)
        dks = (kw.pop("dk"), 1)[:1 if repulsive else 2]
        for dk in dks:
            out_k = ssd.site_sweep_delayed(G, sigma, u, dk=dk, **kw)
            errs.append(check_sweep(
                f"site_sweep_delayed dk={dk} [{ssd.layout(ctx.N, ctx.F, dk)}]",
                out_k, ssd.site_sweep_delayed_plain(G, sigma, u, dk=dk, **kw),
                tuple(G.shape), relative=True))
            if not repulsive and dk == dks[0]:
                n_acc = out_k[2].sum().item()
        if not repulsive:
            kw["dk"] = dks[0]
            wave = more_chains(G, sigma, gen)
            errs.append(check_sweep(
                f"site_sweep_delayed dk={dks[0]} at {WAVE_CHAINS} chains "
                f"[{ssd.layout(ctx.N, ctx.F, dks[0])}]",
                ssd.site_sweep_delayed(*wave, **kw),
                ssd.site_sweep_delayed_plain(*wave, **kw),
                tuple(wave[0].shape), relative=True))
            results["site_sweep_delayed"] = dict(
                ms=1e3 * timed(lambda: ssd.site_sweep_delayed(
                    G, sigma, u, **kw), 20),
                plain_ms=1e3 * timed(lambda: ssd.site_sweep_delayed_plain(
                    G, sigma, u, **kw), 3),
                library_ms=None,
                **sweep_bound(chains, ctx.F, ctx.N, n_acc))
            errs.append(time_layouts(ssd, G, sigma, u, kw))
    results["site_sweep_delayed"]["max_abs_err"] = max(errs)

    # ---- K9 at (64, 1, 256, 256) complex64 with dk = 32, on the complex16
    # configuration's Green's functions (plain-path init_state), against its
    # plain version and, decisions and det, K8's plain rank-1 sweep; and at
    # 160 chains
    G, sigma, u, kw, ctx, gen = delayed_inputs(complex_=True)
    out_k = ssdcx.site_sweep_delayed_cx(G, sigma, u, **kw)
    shape = tuple(G.shape)
    where = ssdcx.layout(ctx.N, ctx.F, kw["dk"], chains=shape[0])
    err = check_sweep(f"site_sweep_delayed_cx dk={kw['dk']} [{where}]", out_k,
                      ssdcx.site_sweep_delayed_cx_plain(G, sigma, u, **kw),
                      shape, relative=True)
    kw8 = {k: v for k, v in kw.items() if k != "dk"}
    err = max(err, check_sweep("site_sweep_delayed_cx vs K8 plain", out_k,
                               sscx.site_sweep_cx_plain(G, sigma, u, **kw8),
                               shape, relative=True))
    wave = more_chains(G, sigma, gen)
    err = max(err, check_sweep(
        f"site_sweep_delayed_cx dk={kw['dk']} at {WAVE_CHAINS} chains "
        f"[{where}]", ssdcx.site_sweep_delayed_cx(*wave, **kw),
        ssdcx.site_sweep_delayed_cx_plain(*wave, **kw), tuple(wave[0].shape),
        relative=True))
    results["site_sweep_delayed_cx"] = dict(
        max_abs_err=err,
        ms=1e3 * timed(lambda: ssdcx.site_sweep_delayed_cx(G, sigma, u,
                                                           **kw), 20),
        plain_ms=1e3 * timed(lambda: ssdcx.site_sweep_delayed_cx_plain(
            G, sigma, u, **kw), 3),
        library_ms=None,
        **sweep_bound(shape[0], ctx.F, ctx.N, out_k[2].sum().item(),
                      complex_=True))
    for dk in (kw["dk"], kw["dk"] // 2):
        err = max(err, time_layouts(ssdcx, G, sigma, u, {**kw, "dk": dk}))
    results["site_sweep_delayed_cx"]["max_abs_err"] = err


def fp64_row(results, kname, fn, plain, shapes):
    """A float64 or complex128 site sweep (fn) against its plain version on
    each (label, inputs, keywords) of shapes: decisions identical, max|dG|
    within TOL_G_FP64 (and whether it is bit-equal), REPEATS launches more
    bit-equal to the first; the first shape's times, device time and bound
    into results[kname]."""
    import torch
    errs = []
    for i, (label, (G, sigma, u, kw, ctx)) in enumerate(shapes):
        call = lambda: fn(G, sigma, u, **kw)
        out_k, out_p = call(), plain(G, sigma, u, **kw)
        err = check_sweep(f"{kname} {label}", out_k, out_p, tuple(G.shape),
                          relative=False, tol=TOL_G_FP64)
        log(f"[parity] {kname} {label} {tuple(G.shape)}: G bit-equal to the "
            f"plain version's {torch.equal(out_k[0], out_p[0])}")
        repeats_equal(f"{kname} {label} {tuple(G.shape)}", call)
        errs.append(err)
        if i == 0:
            results[kname] = dict(
                ms=1e3 * timed(call, 20),
                plain_ms=1e3 * timed(lambda: plain(G, sigma, u, **kw), 3),
                library_ms=None,
                **sweep_bound(G.shape[0], ctx.F, ctx.N,
                              out_k[2].sum().item(),
                              complex_=G.is_complex(), fp64=True))
            dev = device_ms(call)
            if dev is not None:
                results[kname]["device_ms"] = dev
    results[kname]["max_abs_err"] = max(errs)


def parity_fp64(results):
    """K6-f64, K8-c128 and K9-c128 against their plain versions at the
    float64 and complex128 runs' shapes, on plain-path init_state Green's
    functions at beta=10 (``slice_inputs``): K6-f64 at (64, 1, 256, 256) and
    (32, 2, 256, 256) with dk = 32 (l16_f64's model; F = 2 in two column
    passes) and at (64, 1, 144, 144) with dk = 1; K8-c128 at (256, 1, 64,
    64) and (256, 2, 64, 64) (complex_c128's model) and at (256, 1, 128,
    128) (the 128-site chain: the imaginary plane in shared memory); K9-c128
    at (64, 1, 256, 256) with dk = 32 (complex16_c128's). Then K6-f64's
    negative-weight magnitudes on random F = 2 Green's functions whose
    diagonal leaves [0, 1]."""
    import torch
    from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
    f64 = dict(dtype=torch.float64)

    def with_dk(inputs, dk):
        G, sigma, u, kw, ctx = inputs
        return G, sigma, u, dict(kw, dk=dk), ctx

    def layout(mod, inputs, dtype):
        ctx, dk = inputs[4], inputs[3]["dk"]
        return (f"dk={dk} [{mod.layout(ctx.N, ctx.F, dk, dtype=dtype,
                                        chains=inputs[0].shape[0])}]")

    k6 = [with_dk(slice_inputs(headline_model(False, L16), L16_CHAINS, 5,
                               **f64), 32),
          with_dk(slice_inputs(headline_model(True, L16), L16_F2_CHAINS, 6,
                               **f64), 32),
          with_dk(slice_inputs(headline_model(False, 12), L16_CHAINS, 7,
                               **f64), 1)]
    fp64_row(results, "site_sweep_delayed_f64", ssd.site_sweep_delayed_f64,
             ssd.site_sweep_delayed_plain,
             [(layout(ssd, x, torch.float64), x) for x in k6])
    cx = dict(safe_mult=CPLX_SM, **f64)
    k8 = [slice_inputs(complex_model(False), CHAINS, 1, **cx),
          slice_inputs(complex_model(True), CHAINS, 2, **cx),
          slice_inputs(complex_model(L=CHAIN_L, dims=1), CHAINS, 3, **cx)]
    fp64_row(results, "site_sweep_cx_c128", sscx.site_sweep_cx_c128,
             sscx.site_sweep_cx_plain,
             [(f"[{sscx.layout(x[4].N, x[4].F, torch.complex128)}]", x)
              for x in k8])
    k9 = [with_dk(slice_inputs(complex_model(L=L16), L16_CHAINS, 13, **cx),
                  32)]
    fp64_row(results, "site_sweep_delayed_cx_c128",
             ssdcx.site_sweep_delayed_cx_c128,
             ssdcx.site_sweep_delayed_cx_plain,
             [(layout(ssdcx, x, torch.complex128), x) for x in k9])

    # K6-f64's negative-weight magnitudes: random F = 2 G at N = 256
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    C, Nn = L16_F2_CHAINS, L16 * L16
    dev = dict(device=DEVICE, dtype=torch.float64)
    Gn = 0.5 * torch.eye(Nn, **dev) + 0.8 / math.sqrt(Nn) * torch.randn(
        C, 2, Nn, Nn, generator=gen, **dev) + torch.diag_embed(
            0.8 * torch.randn(C, 2, Nn, generator=gen, **dev))
    sn = (2 * torch.randint(0, 2, (C, Nn), generator=gen, device=DEVICE)
          - 1).to(torch.int8)
    un = torch.rand(C, Nn, generator=gen, **dev)
    kwn = dict(lamb=k6[0][3]["lamb"], signs=(1.0, -1.0), det_power=1,
               use_boson=False, dk=32)
    out_k = ssd.site_sweep_delayed_f64(Gn, sn, un, **kwn)
    out_p = ssd.site_sweep_delayed_plain(Gn, sn, un, **kwn)
    check_sweep("site_sweep_delayed_f64 on random G", out_k, out_p,
                tuple(Gn.shape), relative=False, tol=TOL_G_FP64)
    has = out_p[3] > 0
    dneg = ((out_k[4][has] - out_p[4][has]).abs().max().item()
            if has.any() else math.inf)
    log(f"[parity] site_sweep_delayed_f64 negative detratios "
        f"{int(out_p[3].sum())} in {int(has.sum())} of {C} chains; log10 "
        f"magnitudes (min, max, sum) max|d| {dneg:.3e}, bit-equal "
        f"{torch.equal(out_k[4], out_p[4])}")
    if not (dneg <= TOL_NEG64
            and torch.equal(out_k[4][~has], out_p[4][~has])):
        raise AssertionError("site_sweep_delayed_f64's negative-weight "
                             "magnitudes disagree with the plain version's")


def item4_row(label, fn, plain, inputs, layout):
    """One of item 4's site-sweep shapes (fn, on slice_inputs' inputs)
    against its plain version: decisions and G bit-equal (K6-f64: its
    negative-weight magnitudes too), REPEATS launches more bit-equal to the
    first; its wall, device and plain ms and its bound, printed. Returns
    the kernels line's fields."""
    import torch
    G, sigma, u, kw, ctx = inputs
    call = lambda: tuple(x for x in fn(G, sigma, u, **kw) if x is not None)
    out_k, out_p = fn(G, sigma, u, **kw), plain(G, sigma, u, **kw)
    shape = tuple(G.shape)
    err = check_sweep(f"{label} [{layout}]", out_k, out_p, shape,
                      relative=False, tol=0.0)
    same = torch.equal(out_k[0], out_p[0]) and all(
        torch.equal(a, b) for a, b in zip(out_k[4:], out_p[4:])
        if a is not None)
    log(f"[parity] {label} {shape}: G bit-equal to the plain version's "
        f"{same}")
    if not same:
        raise AssertionError(f"{label} is not bit-equal to its plain version")
    repeats_equal(f"{label} {shape}", call)
    row = dict(max_abs_err=err, ms=1e3 * timed(call, 20),
               plain_ms=1e3 * timed(lambda: plain(G, sigma, u, **kw), 3),
               library_ms=None,
               **sweep_bound(shape[0], ctx.F, ctx.N, out_k[2].sum().item(),
                             complex_=G.is_complex(),
                             fp64=G.dtype in (torch.float64,
                                              torch.complex128)))
    dev = device_ms(call)
    if dev is not None:
        row["device_ms"] = dev
    log(f"[parity] {label} {shape}: kernel {row['ms']:.4f} ms wall, "
        f"{ms_text(dev)} device, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def fp64_run_inputs(run, chains=ITEM4_CHAINS):
    """(G, sigma, u, keywords, ctx) of phase 3's row of an item 4 run (its
    seed): l15_f64 (64, 1, 225, 225) float64, flux14_c128 (64, 1, 196, 196)
    and rep_flux16_c128 (64, 2, 256, 256) complex128, and of the repulsive
    14x14 in a flux, rep_flux14_c128 (64, 2, 196, 196: the rank-1 layout in
    clusters of 8; no run of its own), at the session's delay (dk =
    max(delay, 1)) and the given chains; for parity_item4,
    chip_profile.py's stamps and chip_ab.py's cases."""
    import torch
    f64 = dict(dtype=torch.float64)
    if run == "l15_f64":
        x = slice_inputs(headline_model(False, 15), chains, 43, **f64)
    elif run == "flux14_c128":
        x = slice_inputs(complex_model(False, 14), chains, 45,
                         safe_mult=CPLX_SM, **f64)
    elif run == "rep_flux16_c128":
        x = slice_inputs(complex_model(True, L16), chains, 51,
                         safe_mult=CPLX_SM, **f64)
    elif run == "rep_flux14_c128":
        x = slice_inputs(complex_model(True, 14), chains, 52,
                         safe_mult=CPLX_SM, **f64)
    else:
        raise ValueError(f"fp64_run_inputs: no run {run!r}")
    G, sigma, u, kw, ctx = x
    return G, sigma, u, dict(kw, dk=max(ctx.delay, 1)), ctx


# K8-c128's shapes with the inputs of the runs they come from (phase 3's
# seeds; slice_inputs in complex128): case -> (repulsive, L, dims, seed,
# chains). rep_flux10_c128 (256, 2, 100, 100), the 128-site ring's
# repulsive model (64, 2, 128, 128), the attractive 10x10 in the same
# phases (256, 1, 100, 100), chain128 (256, 1, 128, 128) and the complex
# row's 8x8 (256, 1|2, 64, 64)
K8_C128_CASES = {"rep_flux10_c128": (True, 10, 2, 48, ITEM4_REP10_CHAINS),
                 "rep_chain128_c128": (True, CHAIN_L, 1, 49, ITEM4_CHAINS),
                 "flux10_c128": (False, 10, 2, 53, ITEM4_REP10_CHAINS),
                 "chain128_c128": (False, CHAIN_L, 1, 3, CHAINS),
                 "complex_c128": (False, L, 2, 1, CHAINS),
                 "rep_complex_c128": (True, L, 2, 2, CHAINS)}


def k8_c128_inputs(case, chains=None):
    """(G, sigma, u, keywords, ctx) of K8-c128 at one of K8_C128_CASES, at
    its chain count or the given one; for parity_item4, parity_fp64,
    chip_profile.py's stamps, chip_layouts.py and chip_ab.py."""
    import torch
    repulsive, L_, dims, seed, n = K8_C128_CASES[case]
    return slice_inputs(complex_model(repulsive, L_, dims), chains or n, seed,
                        safe_mult=CPLX_SM, dtype=torch.float64)


# phase 3's rows whose shapes run the layouts redesigned for the card: the
# rank-1 layout (K6-f64, K9-c128 at dk = 1; K8-c128 past N = 64) and
# K9-c128's flavor layout
REDESIGNED = ("site_sweep_delayed_f64_225", "site_sweep_delayed_cx_c128_196",
              "site_sweep_delayed_cx_c128_f2", "site_sweep_cx_c128_f2_100")


def parity_item4(results):
    """The site sweeps of ROADMAP Queue 1 item 4's shapes against their
    plain versions, in both precisions, on plain-path init_state Green's
    functions at beta=10 (``slice_inputs``): K6 and K6-f64 at
    (64, 1, 169, 169) (4 does not divide N: G padded to 176), K6-f64 also
    at (64, 1, 225, 225) (l15_f64's); K9 and K9-c128 at (64, 1, 196, 196)
    (8 does not divide N: G padded to 200; flux14_c128's); K8 and K8-c128
    at F = 2, N = 100 (256 chains, rep_flux10_c128's) and N = 128 (the
    128-site ring, 64 chains), K8-c128 also at F = 1, N = 100 (the
    attractive 10x10 in the same phases, 256 chains; complex128 past
    N = 64: the rank-1 layout, ``k8_c128_inputs``); K9 and K9-c128 at
    (64, 2, 256, 256) with dk = 32
    (rep_flux16_c128's; complex64 in two column passes, complex128 in the
    flavor layout), and K9-c128 at (64, 2, 196, 196) at dk = 1 (the
    repulsive 14x14 in a flux: the rank-1 layout in clusters of 8). The
    float32 and complex64 shapes' errors join their kernels' rows, as does
    the last; the four complex128 and float64 shapes of the runs get rows
    of their own. K6-f64 and K9-c128 at dk = 1 and K8-c128 past N = 64 run
    the rank-1 layout; the REDESIGNED rows, K8-c128 at F = 2, N = 128 and
    the last shape also time, in turns, the other layouts that fit
    (time_layouts)."""
    import torch
    from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
    f32, f64 = dict(dtype=torch.float32), dict(dtype=torch.float64)

    def real(L, seed, dtype, chains=ITEM4_CHAINS):
        G, sigma, u, kw, ctx = slice_inputs(headline_model(False, L), chains,
                                            seed, **dtype)
        return G, sigma, u, dict(kw, dk=max(ctx.delay, 1)), ctx

    def cx(repulsive, L, seed, dtype, chains=ITEM4_CHAINS, dims=2):
        G, sigma, u, kw, ctx = slice_inputs(
            complex_model(repulsive, L, dims), chains, seed,
            safe_mult=CPLX_SM, **dtype)
        if ctx.N > 128:
            kw = dict(kw, dk=max(ctx.delay, 1))
        return G, sigma, u, kw, ctx

    def lay(mod, x, dtype):
        ctx = x[4]
        if "dk" in x[3]:
            return mod.layout(ctx.N, ctx.F, x[3]["dk"], dtype=dtype,
                              chains=x[0].shape[0])
        return mod.layout(ctx.N, ctx.F, dtype)

    C64, C128 = torch.complex64, torch.complex128
    F32, F64 = torch.float32, torch.float64
    rep14 = fp64_run_inputs("rep_flux14_c128")
    rep128 = k8_c128_inputs("rep_chain128_c128")
    # (row: None joins the kernel's own row, label, wrapper, plain, inputs,
    # module, dtype)
    rows = [
        (None, "site_sweep_delayed", ssd.site_sweep_delayed,
         ssd.site_sweep_delayed_plain, real(13, 41, f32), ssd, F32),
        (None, "site_sweep_delayed_f64", ssd.site_sweep_delayed_f64,
         ssd.site_sweep_delayed_plain, real(13, 42, f64), ssd, F64),
        ("site_sweep_delayed_f64_225", "site_sweep_delayed_f64",
         ssd.site_sweep_delayed_f64, ssd.site_sweep_delayed_plain,
         fp64_run_inputs("l15_f64"), ssd, F64),
        (None, "site_sweep_delayed_cx", ssdcx.site_sweep_delayed_cx,
         ssdcx.site_sweep_delayed_cx_plain, cx(False, 14, 44, f32), ssdcx,
         C64),
        ("site_sweep_delayed_cx_c128_196", "site_sweep_delayed_cx_c128",
         ssdcx.site_sweep_delayed_cx_c128, ssdcx.site_sweep_delayed_cx_plain,
         fp64_run_inputs("flux14_c128"), ssdcx, C128),
        (None, "site_sweep_cx", sscx.site_sweep_cx, sscx.site_sweep_cx_plain,
         cx(True, 10, 46, f32, ITEM4_REP10_CHAINS), sscx, C64),
        (None, "site_sweep_cx", sscx.site_sweep_cx, sscx.site_sweep_cx_plain,
         cx(True, CHAIN_L, 47, f32, dims=1), sscx, C64),
        ("site_sweep_cx_c128_f2_100", "site_sweep_cx_c128",
         sscx.site_sweep_cx_c128, sscx.site_sweep_cx_plain,
         k8_c128_inputs("rep_flux10_c128"), sscx, C128),
        (None, "site_sweep_cx_c128", sscx.site_sweep_cx_c128,
         sscx.site_sweep_cx_plain, rep128, sscx, C128),
        (None, "site_sweep_cx_c128", sscx.site_sweep_cx_c128,
         sscx.site_sweep_cx_plain, k8_c128_inputs("flux10_c128"), sscx,
         C128),
        (None, "site_sweep_delayed_cx", ssdcx.site_sweep_delayed_cx,
         ssdcx.site_sweep_delayed_cx_plain, cx(True, L16, 50, f32), ssdcx,
         C64),
        ("site_sweep_delayed_cx_c128_f2", "site_sweep_delayed_cx_c128",
         ssdcx.site_sweep_delayed_cx_c128, ssdcx.site_sweep_delayed_cx_plain,
         fp64_run_inputs("rep_flux16_c128"), ssdcx, C128),
        (None, "site_sweep_delayed_cx_c128", ssdcx.site_sweep_delayed_cx_c128,
         ssdcx.site_sweep_delayed_cx_plain, rep14, ssdcx, C128)]
    for row, label, fn, plain, x, mod, dtype in rows:
        r = item4_row(label, fn, plain, x, lay(mod, x, dtype))
        if row in REDESIGNED or x is rep14 or x is rep128:
            # the redesigned layout against the delayed one it replaced
            time_layouts(mod, *x[:4])
        if row is not None:
            results[row] = r
        else:
            results[label]["max_abs_err"] = max(
                results[label]["max_abs_err"], r["max_abs_err"])


def ising_sweep_bound(C, tabs):
    """K17's bound: each spin read and written once (1 byte each), its
    float64 uniform read once, the per-chain int64 count read and written,
    the tables read once; z + 3 integer operations per site (the neighbor
    sum, the product, the compare, the flip) at the FP32 issue rate."""
    N, z = tabs.N, tabs.z
    nbytes = (C * N * (1 + 8 + 1) + 16 * C
              + 4 * (N * z + N + len(tabs.bounds)) + 8 * (z + 1))
    return bound(nbytes, C * N * (z + 3))


def wolff_move_bound(C, tabs, cluster_sites):
    """K18's bound for a whole Wolff move (the per-level bound of the
    level-by-level kernel it replaced): conf, the seed spins, the cluster
    and frontier read once and written once, the status, the reverse
    table, and the float64 uniforms of the frontier's bonds, 8z bytes per
    site that joins a cluster (each site is on the frontier once; no other
    uniform decides a bond); a compare and an OR per frontier bond. The
    batch's torch.rand writes are the stream's, not K18's (counted apart)."""
    N, z = tabs.N, tabs.z
    nbytes = (C * N + C + 4 * C * N + 8 + 4 * tabs.rev.numel()
              + 8 * z * cluster_sites)
    return bound(nbytes, 2 * z * cluster_sites)


def parity_ising(results):
    """K17 against its plain version (conf and counts bit for bit) at
    bench.py's ising_flips shape (262,144 chains of the 8x8), at the 3x3
    (four color classes), on the cubic L = 4 and at the 32x32 (N = 1024:
    the shared-memory layout); K18 through a whole Wolff move from seeds at
    the Wolff run's shape, against the move on its plain version from the
    same stream (flipped conf, cluster sizes, levels and the generator's
    state after the move equal), then one launch on a batch holding the
    whole search against its plain version; each relaunched REPEATS times,
    bit-equal to the first; the bench shape's and K18's times and bounds
    into results."""
    import torch
    from montecarlo_tpu_torch import IsingModel, IsingTc, SquareLattice
    from montecarlo_tpu_torch.mc.mc import level_uniforms
    from montecarlo_tpu_torch.ops import ising as kis
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    f64 = dict(device=DEVICE, dtype=torch.float64)
    for tag, model, C, beta in (
            ("8x8", IsingModel(dims=2, L=ISING_L), ISING_CHAINS, ISING_BETA),
            ("3x3", IsingModel(l=SquareLattice(3)),
             ISING_SMALL_CHAINS, ISING_BETA),
            ("cubic L=4", IsingModel(dims=3, L=4), ISING_SMALL_CHAINS,
             ISING_BETA),
            ("32x32", IsingModel(dims=2, L=ISING_LARGE_L),
             ISING_SMALL_CHAINS, ISING_BETA)):
        tabs = kis.make_tables(model.lattice, beta, DEVICE)
        conf = model.rand_conf(gen, C, DEVICE)
        u = torch.rand(C, tabs.N, generator=gen, **f64)
        zero = lambda: torch.zeros(C, dtype=torch.int64, device=DEVICE)
        sweep = lambda: kis.ising_sweep(conf, u, tabs, zero())
        out_k = sweep()
        out_p = kis.ising_sweep_plain(conf, u, tabs, zero())
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(out_k, out_p)]
        err = max((out_k[0].int() - out_p[0].int()).abs().max().item(),
                  (out_k[1] - out_p[1]).abs().max().item())
        acc = out_p[1].sum().item() / (C * tabs.N)
        dev = device_ms(lambda: kis.ising_sweep(conf, u, tabs, out_k[1]))
        log(f"[parity] ising_sweep {tag} ({C}, {tabs.N}), z={tabs.z}, "
            f"{len(tabs.bounds) - 1} color classes: conf and counts equal "
            f"{same}, acceptance {acc:.4f}; device {ms_text(dev)}, bound "
            f"{ising_sweep_bound(C, tabs)['bound_ms']:.5f} ms")
        if not all(same):
            raise AssertionError(f"ising_sweep disagrees with plain ({tag})")
        repeats_equal(f"ising_sweep {tag}", sweep)
        if tag == "8x8":
            read = device_ms(lambda: u.sum())
            log(f"[parity] ising_sweep 8x8: torch's u.sum() reads the "
                f"sweep's {u.numel() * 8 / 1e6:.1f} MB of uniforms in "
                f"{ms_text(read)} (device)")
            # the same with the card's 50 MB L2 written over before each
            # call: none of the sweep's inputs left in it from the last
            over = torch.empty(L2_OVERWRITE_BYTES, dtype=torch.uint8,
                               device=DEVICE)
            cold = device_ms(lambda: (over.zero_(), kis.ising_sweep(
                conf, u, tabs, out_k[1])), only="ising_sweep")
            log(f"[parity] ising_sweep 8x8 with {L2_OVERWRITE_BYTES >> 20} "
                f"MB written over before each call: device {ms_text(cold)}")
            del over
            results["ising_sweep"] = dict(
                max_abs_err=float(err),
                ms=1e3 * timed(sweep, 50),
                plain_ms=1e3 * timed(lambda: kis.ising_sweep_plain(
                    conf, u, tabs, zero()), 5),
                library_ms=None, **ising_sweep_bound(C, tabs))
            if dev is not None:
                results["ising_sweep"]["device_ms"] = dev

    # ---- K18: a whole move from seeds at the Wolff run's shape, on the
    # kernel and on its plain version, each drawing its levels from a
    # generator seeded alike
    model = IsingModel(dims=2, L=ISING_L)
    C, N, z = WOLFF_CHAINS, len(model.lattice), model.lattice.coordination
    tabs = kis.make_tables(model.lattice, 1.0 / IsingTc, DEVICE)
    conf = model.rand_conf(gen, C, DEVICE)
    seeds = torch.randint(0, N, (C,), generator=gen, device=DEVICE)
    moves = []
    for use in (True, False):
        g = torch.Generator(device=DEVICE).manual_seed(WOLFF_PARITY_SEED)
        move = model.make_global_move_fn(1.0 / IsingTc, DEVICE,
                                         use_kernels=use)
        out = move(conf, seeds, lambda k: level_uniforms(g, (C, N, z), k))
        moves.append((*out, g.get_state(), move.batches))
    torch.cuda.synchronize()
    (fk, sk, lk, gk, bk), (fp, sp, lp, gp, _) = moves
    same = [torch.equal(fk, fp), torch.equal(sk, sp), lk == lp,
            torch.equal(gk, gp)]
    log(f"[parity] wolff_step: a move of {C} chains of the 8x8 from seeds, "
        f"{lk} levels in {bk} launch(es) against {lp} plain levels: flipped "
        f"conf, sizes, levels and the stream after it equal {same}; "
        f"{int(sk.sum())} sites in clusters")
    if not all(same):
        raise AssertionError("wolff_step's move disagrees with plain")
    # one launch on a batch holding the whole search (the move's levels)
    g = torch.Generator(device=DEVICE).manual_seed(WOLFF_PARITY_SEED)
    u, _ = level_uniforms(g, (C, N, z), lk)
    inc = torch.zeros(C, N, dtype=torch.bool, device=DEVICE).scatter_(
        1, seeds[:, None], True)
    spin = conf.gather(1, seeds[:, None])
    step = lambda: kis.wolff_step(conf, inc, inc, spin, u, tabs)
    out_k = step()
    out_p = kis.wolff_step_plain(conf, inc, inc, spin, u, tabs)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(out_k, out_p)]
    same.append(torch.equal(torch.where(out_k[0], -conf, conf), fk))
    log(f"[parity] wolff_step one launch of {lk} levels ({C}, {N}, {z}): "
        f"cluster, frontier, status {out_k[2].tolist()} and the move's "
        f"flipped conf equal {same}")
    if not all(same):
        raise AssertionError("wolff_step disagrees with plain")
    repeats_equal("wolff_step", step)
    err = max((a.int() - b.int()).abs().max().item()
              for a, b in zip(out_k, out_p))
    results["wolff_step"] = dict(
        max_abs_err=float(err), ms=1e3 * timed(step, 50),
        plain_ms=1e3 * timed(lambda: kis.wolff_step_plain(
            conf, inc, inc, spin, u, tabs), 5),
        library_ms=None,
        **wolff_move_bound(C, tabs, int(sk.sum())))
    dev = device_ms(step)
    if dev is not None:
        results["wolff_step"]["device_ms"] = dev
    rand_bytes = 8 * lk * C * N * z
    log(f"[parity] wolff_step per move: device {ms_text(dev)} for {lk} "
        f"levels = {ms_text(None if dev is None else dev / lk)} a level "
        f"(each a dependent gather of the frontier's uniforms); byte bound "
        f"{results['wolff_step']['bound_ms']:.5f} ms; the levels' torch.rand "
        f"writes {rand_bytes / 1e6:.1f} MB = "
        f"{1e3 * rand_bytes / HBM_BYTES_PER_S:.5f} ms at the HBM rate")


def time_layouts(mod, G, sigma, u, kw):
    """Every layout of K6, K9 or K8 (mod) that takes this shape in G's
    dtype (``mod.layouts``: the plan's first, then the others that fit),
    held against the plan's (decisions identical, G within TOL_G of its
    largest entry) and timed in turns (the plan's layout first and last);
    returns the largest max|dG|."""
    import torch
    C, F, N, _ = G.shape
    dk, dtype = kw.get("dk"), G.dtype
    if dk is None:          # K8: the one-block or the rank-1 layout
        lays = mod.layouts(N, F, dtype, C)
        at_once = lambda lay: (mod.max_clusters(N, F, lay)
                               if lay.kind == "rank1" else None)
    else:
        lays = mod.layouts(N, F, dk, dtype, C)
        at_once = lambda lay: (mod.max_clusters(N, F, dk, lay, dtype)
                               if lay.kind != "slab" else None)
    plan = lays[0]
    ref = mod.launch(G, sigma, u, plan, **kw)
    worst, ms = 0.0, {}
    for lay in lays + lays[:1]:
        call = lambda: mod.launch(G, sigma, u, lay, **kw)
        out = call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out[1:4], ref[1:4])):
            raise AssertionError(f"{mod.__name__}: the {lay.kind} layout "
                                 f"with {lay.cs} blocks per chain decides "
                                 f"otherwise than the plan's {plan.kind}")
        worst = max(worst, (out[0] - ref[0]).abs().max().item())
        ms.setdefault(lay, []).append(1e3 * timed(call, 20))
    times = []
    for lay in lays:
        times.append(f"{lay.kind} CS={lay.cs} {list(lay.geometry)} "
                     + ", ".join(f"{t:.4f}" for t in ms[lay]) + " ms"
                     + (f" ({at_once(lay)} clusters at once)"
                        if at_once(lay) is not None else ""))
    name = mod.__name__.rsplit(".", 1)[-1]
    log(f"[layouts] {name} {tuple(G.shape)} {str(dtype)[6:]} dk={dk or 1}, "
        f"plan {plan.kind} CS={plan.cs}: " + "; ".join(times)
        + f"; max|dG| against the plan's {worst:.3e}")
    if worst > TOL_G * ref[0].abs().max().item():
        raise AssertionError(f"{name}: the layouts' G disagree")
    return worst


def sweep_kernel(ctx, chains):
    """The site-sweep kernel a session's main path launches (besides K13
    under fuse_wrap): K8 for complex G (K9 past N = 128; K8-c128 and
    K9-c128 for complex128 updates), K6 past N = 128 (K6-f64 for float64
    updates), K1 in float64 for float64 updates, K5 for float32 updates
    with F >= 2 at even N, else K1 (K12 for one chain)."""
    import torch
    if ctx.is_complex:
        name = "site_sweep_cx" if ctx.N <= 128 else "site_sweep_delayed_cx"
        return name + ("_c128" if ctx.udtype == torch.complex128 else "")
    if ctx.N > 128:
        return "site_sweep_delayed" + (
            "_f64" if ctx.udtype == torch.float64 else "")
    if ctx.udtype == torch.float64:
        return "site_sweep_f64"
    if ctx.F >= 2 and ctx.N % 2 == 0:
        return "site_sweep_pair"
    return "site_sweep_single" if chains == 1 else "site_sweep"


def phase_slice(L=L, chains=CHAINS, therm=THERM, sweeps=SWEEPS, tag="slice",
                complex_=False, session=None, repulsive=False, dims=2,
                phase_tol=PHASE_TOL, hold_occ=True, safe_mult=None,
                acc_range=(0.05, 0.95), no_imag=False, smi=None):
    """A simulation through DQMC(...).run(), with launch counts: the
    headline (8x8: K1-K3), the 16x16 one (K6, K7), the complex one (8x8
    with pure-gauge Peierls phases at safe_mult=5: K8, K10; at 16x16: K9
    and the library QR; on the 128-site chain, dims=1: K8, K10), with
    session
    (DQMC's dtype, update_dtype, stab_method, fuse_wrap and qr_wy; None:
    float32) the f64 (DQMC's defaults: K1 in float64, K11), mixed (K1,
    K11), colscaled (K1, K4), fusewrap (K13, K1, K2, K3) and colscaled_wy
    (K1, K14) ones, the one-chain one (K12, K2, K3; hold_occ False: its
    occupation is printed, not held), or the repulsive one (K5, K2, K3),
    which also measures the z spin correlations and magnetization and is
    held to its anchors (``repulsive_anchors``); session may also hold
    g_refresh and checkerboard (refresh, refresh_complex, checkerboard) and
    L = 10 takes the library QR (libqr); session {} (DQMC's default dtype,
    float64) at L16 runs K6-f64 (l16_f64), with complex_ K8-c128
    (complex_c128) and at L16 K9-c128 (complex16_c128), each beside the
    library QR; the item 4 runs (phase 4r) take session {} at L = 15 (K6-
    f64 on padded G), with complex_ at L = 14 (K9-c128 on padded G) and with
    complex_ and repulsive at L = 10 (K8-c128 at F = 2) and L16 (K9-c128 at
    F = 2). safe_mult None: the complex row's CPLX_SM for complex
    hopping, else the headline's. acc_range bounds the acceptance; no_imag
    holds a complex run to no imaginary probability. The library QR's calls
    (``linalg._library_qr.launches``) are counted as "library_qr" beside the
    kernels' launches. smi (nvidia-smi's name and power limit) goes into the
    chain-sweeps/s line where given."""
    import torch
    from montecarlo_tpu_torch import (DQMC, magnetization,
                                      spin_density_correlation)
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.ops.linalg import _library_qr, qr_route
    read = zero_launches(library_qr=_library_qr)
    session = dict(dtype=torch.float32) if session is None else session
    model = (complex_model(repulsive, L, dims) if complex_
             else headline_model(repulsive=repulsive, L=L))
    if safe_mult is None:
        safe_mult = CPLX_SM if complex_ else SAFE_MULT
    sim = DQMC(model, beta=BETA, delta_tau=DTAU, safe_mult=safe_mult,
               n_chains=chains, measure_rate=1, seed=0, device=DEVICE,
               **session)
    if repulsive:
        sim["sdc_z"] = spin_density_correlation(sim, model, "z")
        sim["m_z"] = magnetization(sim, model, "z")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(thermalization=therm, sweeps=sweeps, verbose=False)
    torch.cuda.synchronize()
    dur = time.perf_counter() - t0
    launches = read()

    ctx = sim.ctx
    n_pairs = therm + sweeps
    expected = dict.fromkeys(launches, 0)
    # one site sweep per slice visit (under fuse_wrap K13 for every visit
    # but the measurement point's); every stack extension and Green's
    # recomputation (pair_udt_launches; init_state: n_seg extensions and
    # one G) runs one QR of the session's route: fused, one K2 per
    # extension and one K3 per recomputation
    if ctx.fuse_wrap:
        expected["site_sweep_wrap"] = (2 * ctx.M - 1) * n_pairs
        expected[sweep_kernel(ctx, chains)] = n_pairs
    else:
        expected[sweep_kernel(ctx, chains)] = 2 * ctx.M * n_pairs
    n_udt, n_greens = core.pair_udt_launches(ctx)
    n_udt, n_greens = n_udt * n_pairs + ctx.n_seg, n_greens * n_pairs + 1
    route = qr_route(ctx.N, ctx.dtype)
    if route == "K2/K3" and ctx.stab_method == "qr":
        expected.update(udt_qr=n_udt, udt_qr_solve=n_greens)
    else:
        expected[{"K7": "qr_blocked", "K11": "qr_f64", "K10": "qr_cx",
                  "library": "library_qr"}.get(
            route, "qr_vtau" if ctx.qr_wy else "qr_f32")] = n_udt + n_greens
    log(f"[{tag}] QR route {route}; launches {launches}, expected "
        f"{expected}")
    if launches != expected:
        raise AssertionError("kernel launch counts differ from the path's")
    if not bool(torch.isfinite(sim.state["G"]).all()):
        raise AssertionError("G has non-finite entries")
    acc = sim.analysis.acc_rate
    occ = float(sim.observables()["occ"]["occ"].mean.mean())
    rate = chains * n_pairs / dur
    log(f"[{tag}] N={ctx.N} beta={BETA} M={ctx.M} safe_mult={ctx.sm} delay="
        f"{ctx.delay} {chains} chains {str(ctx.dtype)[6:]} updates "
        f"{str(ctx.udtype)[6:]} stab {ctx.stab_method}{ab_modes(ctx)}: "
        f"{n_pairs} sweeps "
        f"in {dur:.3f} s = {rate:.1f} "
        f"chain-sweeps/s{f' ({smi})' if smi else ''}; acceptance "
        f"{acc:.4f}; occ {occ:.5f}; "
        f"prop_err_max {sim.analysis.propagation_error.max:.3e}, mean "
        f"{sim.analysis.prop_err_mean:.3e}")
    drift = (sim.analysis.propagation_error.max, sim.analysis.prop_err_mean)
    if not all(map(math.isfinite, drift)):
        raise AssertionError(f"propagation drift max/mean {drift} not finite")
    if ctx.udtype == torch.float64 and not drift[0] < F64_DRIFT_MAX:
        raise AssertionError(f"float64 drift max {drift[0]} not below "
                             f"bench.py's {F64_DRIFT_MAX}")
    if not acc_range[0] < acc < acc_range[1]:
        raise AssertionError(f"acceptance {acc} outside {acc_range}")
    if hold_occ and not abs(occ - 0.5) <= OCC_TOL:
        raise AssertionError(f"occupation {occ} not within 0.5 +- {OCC_TOL}")
    if repulsive:
        repulsive_anchors(sim, tag)
    if ctx.is_complex:
        sign = complex(sim.observables()["sign"]["sign"].mean)
        a = sim.analysis
        log(f"[{tag}] <s> = {sign.real:.7f}{sign.imag:+.3e}i (sign "
            f"observable), {a.avg_phase.real:.7f}{a.avg_phase.imag:+.3e}i "
            f"(running phase at the end); imaginary probabilities "
            f"{a.imaginary_probability.count} (|Im det| > 1e-6) of "
            f"{a.prop_local}, max |Im det| {a.imaginary_probability.max:.3e}")
        if not (abs(sign - 1) < phase_tol
                and abs(a.avg_phase - 1) < phase_tol):
            raise AssertionError(f"average phase {sign} (sign), {a.avg_phase} "
                                 f"(running) not within 1 +- {phase_tol}")
        if no_imag and a.imaginary_probability.count:
            raise AssertionError(f"{a.imaginary_probability.count} imaginary "
                                 "probabilities")
    return sim, launches, rate


def repulsive_anchors(sim, tag):
    """The repulsive run's physics at half filling: each flavor's
    occupation 0.5, the mean z magnetization 0 (spin symmetry), the local
    moment (the distance-0 bin of the z spin correlation, <(n_up -
    n_dn)^2>) above its U=0 value 0.5. The nearest-neighbor z correlation
    and the negative-detratio count are printed, not held: three sweeps
    need not show antiferromagnetic order, and at half filling the exact
    detratio is >= 0. A complex run's observables are held by their real
    parts (a pure gauge keeps the weights real)."""
    import numpy as np
    obs = sim.observables()
    occ_f = np.real(np.mean(obs["occ"]["occ"].mean, axis=-1))  # (F,)
    mz = float(np.real(np.mean(obs["m_z"]["m_z"].mean)))
    sdc = np.real(obs["sdc_z"]["sdc_z"].mean)                  # (n_dirs,)
    dirs = sim.model.lattice.directions
    nn = np.isclose(np.linalg.norm(dirs, axis=-1), 1.0)
    moment, sdc_nn = float(sdc[0]), float(np.mean(sdc[nn]))
    log(f"[{tag}] occupation per flavor {occ_f.round(5).tolist()}; mean m_z "
        f"{mz:.3e}; local moment <m_z^2> {moment:.5f} (U=0: {MOMENT_U0}); "
        f"nearest-neighbor z spin correlation {sdc_nn:.5f} (mean of "
        f"{int(nn.sum())} bins); negative detratios "
        f"{sim.analysis.negative_probability.count} of "
        f"{sim.analysis.prop_local}")
    if not np.all(np.abs(occ_f - 0.5) <= OCC_TOL):
        raise AssertionError(f"flavor occupations {occ_f} not within "
                             f"0.5 +- {OCC_TOL}")
    if not abs(mz) <= MZ_TOL:
        raise AssertionError(f"mean m_z {mz} not within 0 +- {MZ_TOL}")
    if not moment > MOMENT_U0:
        raise AssertionError(f"local moment {moment} not above its U=0 "
                             f"value {MOMENT_U0}")


def compare_paths(ctx_k, consts, state, seed, whole_pair=True):
    """The kernel path against the plain path (use_kernels=False: the plain
    site sweeps, torch.linalg.qr and solve_triangular) from the same state
    and the same uniforms: the decisions of the first slice visit (l = M-1,
    taken from the boundary's freshly recomputed G before any wrap has
    amplified the two paths' rounding differences; K13's fused visit under
    fuse_wrap) and, with whole_pair, those of one whole sweep pair."""
    import dataclasses
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.ops.linalg import calculate_greens
    ctx_p = dataclasses.replace(ctx_k, use_kernels=False)
    C, F, N, n = state["conf"].shape[0], ctx_k.F, ctx_k.N, ctx_k.n_seg
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = torch.rand(C, 2 * ctx_k.M, N, generator=gen, device=DEVICE,
                   dtype=ctx_k.urdtype)
    eye = torch.eye(N, device=DEVICE, dtype=ctx_k.dtype).expand(C, F, N, N)
    ones = torch.ones(C, F, N, device=DEVICE, dtype=ctx_k.rdtype)
    sigma = state["conf"][:, :, -1]
    first, whole, secs = [], [], []
    for ctx in (ctx_k, ctx_p):
        t0 = time.perf_counter()
        G = calculate_greens(state["S_U"][:, n], state["S_D"][:, n],
                             state["S_T"][:, n], eye, ones, eye,
                             ctx.use_kernels, ctx.greens_udt_fn)
        first.append(core.visit_slice(ctx, consts, G.to(ctx.udtype), sigma,
                                      u[:, 0], -1)[1])
        if whole_pair:
            whole.append(core.sweep_pair(ctx, consts, state, u=u)[0])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    share_first = (first[0] == first[1]).all(1).float().mean().item()
    tag = (f"N={N} F={F} {str(ctx_k.dtype)[6:]} {ctx_k.stab_method}"
           f"{ab_modes(ctx_k)} "
           f"safe_mult={ctx_k.sm} ({secs[0]:.1f} s kernel path, "
           f"{secs[1]:.1f} s plain path)")
    if not whole_pair:
        log(f"[paths] {tag} delay={ctx_k.delay}: first slice visit agrees in "
            f"{share_first:.4f} of {C} chains")
        return share_first, None
    sk, sp = whole
    same = (sk["conf"] == sp["conf"]).flatten(1).all(1)
    dG = (sk["G"] - sp["G"]).abs().flatten(1).amax(1)
    drift = {name: (s["prop_err_max"].max().item(),
                    (s["prop_err_sum"].sum() / s["prop_err_n"].sum()).item())
             for name, s in (("kernel", sk), ("plain", sp))}
    neg = [int((s["neg_prob"] - state["neg_prob"]).sum()) for s in whole]
    # |detratio| of the negative ones, where the path records it (the plain
    # path does; the float32 kernels count them only)
    mags = ["not recorded" if not math.isfinite(s["ls_neg_max"].max().item())
            else (f"{10 ** s['ls_neg_min'].min().item():.3e}.."
                  f"{10 ** s['ls_neg_max'].max().item():.3e}")
            for s in whole]
    log(f"[paths] {tag}: first slice visit agrees in "
        f"{share_first:.4f} of {C} chains, the whole sweep pair in "
        f"{same.float().mean().item():.4f}; median max|dG| after it "
        f"{dG.median().item():.3e}; drift max/mean kernel "
        f"{drift['kernel'][0]:.3e}/{drift['kernel'][1]:.3e}, plain "
        f"{drift['plain'][0]:.3e}/{drift['plain'][1]:.3e}; negative "
        f"detratios kernel {neg[0]}, plain {neg[1]} of "
        f"{C * 2 * ctx_k.M * N}, |det| kernel {mags[0]}, plain {mags[1]}")
    return share_first, same.float().mean().item()


def pair_times(sim):
    """Wall and device ms of one sweep pair of a run's session from its
    final state (its generator's uniforms), and the busy share."""
    from montecarlo_tpu_torch.dqmc import core
    pair = lambda: core.sweep_pair(sim.ctx, sim.consts, sim.state,
                                   generator=sim.generator)
    wall, dev = 1e3 * timed(pair, 2), device_ms(pair, reps=2)
    busy = "not measured" if dev is None else f"{dev / wall:.3f}"
    return f"wall {wall:.2f} ms, device {ms_text(dev)}, busy {busy}"


def phase_refresh(sim):
    """4m refresh: bench.py's refresh row (the headline model, float32, 256
    chains, the conservative mode's safe_mult validation.REFRESH_SM = 5,
    g_refresh, 1 + 2 sweeps): K1 per slice visit, K2 per stack extension,
    K3 per slice (2M + 1 per pair); prop_err_n = 2M per chain and pair; the
    wall and device ms per pair beside the headline's (sim, phase 4)."""
    import torch
    from montecarlo_tpu_torch.validation import REFRESH_SM
    simr, launches, _ = phase_slice(
        therm=X_THERM, sweeps=X_SWEEPS, tag="refresh", safe_mult=REFRESH_SM,
        session=dict(dtype=torch.float32, g_refresh=True))
    a, M = simr.analysis, simr.ctx.M
    n_checks = 2 * M * CHAINS * (X_THERM + X_SWEEPS)
    log(f"[refresh] drift max {a.propagation_error.max:.3e}, mean "
        f"{a.prop_err_mean:.3e}, prop_err_n {a.prop_err_n} (2M per chain "
        f"and pair: {n_checks}); per sweep pair of {CHAINS} chains: refresh "
        f"(safe_mult {REFRESH_SM}) {pair_times(simr)}; headline (safe_mult "
        f"{SAFE_MULT}, wrap) {pair_times(sim)}")
    if a.prop_err_n != n_checks:
        raise AssertionError(f"refresh drift checks {a.prop_err_n}, "
                             f"expected {n_checks}")
    return simr, launches


def phase_checkerboard(sim):
    """4o checkerboard: the headline with checkerboard=True (K1, K2, K3),
    1 + 2 sweeps; the session's hopping operators on the card against
    assemble_dense_operator's on the CPU (TOL_CB_OPS), and max|B_cb -
    B_dense| of one slice on the card (TOL_CB_TROTTER, well inside the
    2 dtau Trotter envelope of tests/test_checkerboard.py)."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.checkerboard import assemble_dense_operator
    simc, launches, _ = phase_slice(
        therm=X_THERM, sweeps=X_SWEEPS, tag="checkerboard",
        session=dict(dtype=torch.float32, checkerboard=True))
    ctx, consts, model = simc.ctx, simc.consts, simc.model
    T = model.hopping_matrix()
    ops = {}
    for dt, names in ((DTAU, ("eT2", "eT2inv")),
                      (0.5 * DTAU, ("eThalf", "eThalfinv"))):
        ops.update(zip(names, assemble_dense_operator(model.lattice, T, dt)))
    ops.update(eT2_u=ops["eT2"], eT2inv_u=ops["eT2inv"])
    dops = max((consts[k].cpu().double() - v).abs().max().item()
               for k, v in ops.items())
    sigma = simc.state["conf"][:, :, 0]
    N = ctx.N
    eye = torch.eye(N, device=DEVICE).expand(CHAINS, 1, N, N)
    dB = (core.mult_B_left(ctx, consts, sigma, eye)
          - core.mult_B_left(sim.ctx, sim.consts, sigma, eye)).abs().max()
    log(f"[checkerboard] {sorted(ops)} on the card against "
        f"assemble_dense_operator on the CPU: max|d| {dops:.3e} (limit "
        f"{TOL_CB_OPS}); max|B_cb - B_dense| of slice 0 over {CHAINS} chains: "
        f"{dB.item():.4e} (limit {TOL_CB_TROTTER})")
    if not dops <= TOL_CB_OPS:
        raise AssertionError(f"checkerboard session operators {dops} off "
                             "the assembled ones")
    if not dB.item() < TOL_CB_TROTTER:
        raise AssertionError(f"checkerboard slice matrix {dB.item()} off "
                             f"the dense one by {TOL_CB_TROTTER} or more")
    return launches


def phase_libqr():
    """4p libqr: L = 10 (N = 100) in float32 (K1), float64 (K1-f64) and
    complex64 (pure gauge, safe_mult 5: K8; <s> within PHASE_TOL_LIBQR of
    1), 64 chains, 1 + 1 sweeps, each QR on the library route (qr_route),
    as the JAX package runs XLA's QR where 8 does not divide N. Prints each
    run's route, its library-QR calls per pair and the wall and device ms
    of one call at its shape. Returns {tag: (sim, launches)}."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.ops.linalg import (_library_qr, _prescale_pivot,
                                                 qr_route)
    out = {}
    for tag, session, complex_ in (
            ("libqr_f32", dict(dtype=torch.float32), False),
            ("libqr_f64", {}, False),
            ("libqr_c64", dict(dtype=torch.float32), True)):
        simq, launches, _ = phase_slice(
            LIBQR_L, LIBQR_CHAINS, 1, 1, tag=tag, complex_=complex_,
            session=session, phase_tol=PHASE_TOL_LIBQR)
        ctx = simq.ctx
        gen = torch.Generator(device=DEVICE).manual_seed(23)
        A = _prescale_pivot(graded(gen, LIBQR_CHAINS * ctx.F, ctx.N,
                                   dtype=ctx.dtype))[0]
        call = lambda: _library_qr(A)
        per_pair = sum(core.pair_udt_launches(ctx))
        log(f"[{tag}] route {qr_route(ctx.N, ctx.dtype)}: library QR "
            f"{launches['library_qr']} calls in the run, {per_pair} per "
            f"pair; one call at ({LIBQR_CHAINS}, {ctx.N}, {ctx.N}) "
            f"{str(ctx.dtype)[6:]}: wall {1e3 * timed(call, 5):.4f} ms, "
            f"device {ms_text(device_ms(call, reps=5))}")
        out[tag] = simq, launches
    return out


def phase_paths_libqr(runs):
    """Phase 5 for the libqr runs (phase_libqr's {tag: (sim, launches)}):
    the kernel path against the plain path from each run's final state.
    Both paths take the same library QR at N = 100, so the first slice
    visit starts from the same G and only the site sweep differs (K1 and
    K8 bit-equal to their plain versions, K1-f64 to rounding): its
    decisions must agree in every chain. float64 also holds the whole pair
    to MIN_CONF_AGREE_F64, as the f64 run at N = 64."""
    for tag, seed in (("libqr_f32", 25), ("libqr_f64", 26),
                      ("libqr_c64", 27)):
        s = runs[tag][0]
        first, whole = compare_paths(s.ctx, s.consts, s.state, seed,
                                     whole_pair=tag == "libqr_f64")
        if not first == 1.0:
            raise AssertionError(f"{tag}: kernel and plain paths agree on the "
                                 f"first slice visit in only {first:.4f} of "
                                 "the chains")
        if whole is not None and not whole >= MIN_CONF_AGREE_F64:
            raise AssertionError(f"{tag}: kernel and plain paths agree in "
                                 f"only {whole:.3f} of the chains")


def phase_paths_refresh(simr, sim64):
    """Phase 5 for the conservative mode: the refresh kernel path against
    its plain path (the first slice visit at the run's safe_mult 5, and the
    whole pair at safe_mult 1 on the first SM1_PATH_CHAINS chains), and the
    refresh mode against the wrap mode in float64 at safe_mult 5 from one
    state and one set of uniforms (the f64 run's first chains): the accept
    sequences equal and G_meas within TOL_REFRESH_WRAP."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    from montecarlo_tpu_torch.validation import REFRESH_SM
    first, _ = compare_paths(simr.ctx, simr.consts, simr.state, 21,
                             whole_pair=False)
    if not first >= MIN_CONF_AGREE:
        raise AssertionError(f"refresh kernel and plain paths agree on the "
                             f"first slice visit in only {first:.3f} of the "
                             "chains")
    for sm, dtype in ((1, torch.float32), (REFRESH_SM, torch.float64)):
        params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=sm)
        ctx, consts = core.make_context(headline_model(), params, dtype=dtype,
                                        device=DEVICE, g_refresh=True)
        src = simr if dtype == torch.float32 else sim64
        state = core.init_state(ctx, consts,
                                src.state["conf"][:SM1_PATH_CHAINS])
        if dtype == torch.float32:
            _, whole = compare_paths(ctx, consts, state, 22)
            if not whole >= MIN_CONF_AGREE:
                raise AssertionError(f"refresh kernel and plain paths agree "
                                     f"in only {whole:.3f} of the chains at "
                                     "safe_mult=1")
            continue
        gen = torch.Generator(device=DEVICE).manual_seed(23)
        u = torch.rand(SM1_PATH_CHAINS, 2 * ctx.M, ctx.N, generator=gen,
                       device=DEVICE, dtype=torch.float64)
        wrap = dataclasses.replace(ctx, g_refresh=False)
        sr, Gr, cr = core.sweep_pair(ctx, consts, state, u=u)
        sw, Gw, cw = core.sweep_pair(wrap, consts, state, u=u)
        same = (cr == cw).flatten(1).all(1).float().mean().item()
        dG = (Gr - Gw).abs().max().item()
        log(f"[paths] refresh against wrap, float64, safe_mult {sm}, "
            f"{SM1_PATH_CHAINS} chains, one pair: accept sequences equal in "
            f"{same:.4f} of the chains, max|G_meas diff| {dG:.3e}; drift max "
            f"refresh {sr['prop_err_max'].max().item():.3e}, wrap "
            f"{sw['prop_err_max'].max().item():.3e}")
        if not (same == 1.0 and dG <= TOL_REFRESH_WRAP):
            raise AssertionError("refresh and wrap modes part in float64")


def phase_paths(sim, sim16, simcx, sim64, simcs, simrep, simcx16, simch,
                simfw, simwy):
    """The kernel path against the plain path.

    At the slice's safe_mult=10 in float32, each 10-slice window of wraps
    amplifies rounding differences to O(1): the drift monitor reads O(1) at
    window ends on both paths (as it did on the TPU for this mode), so two
    float32 paths whose QRs round differently part ways within the first
    window. There the decisions of the first slice visit are held to the
    bound; the whole sweep pair is held to it at safe_mult=1, where G is
    recomputed from the stack at every slice (on the first SM1_PATH_CHAINS
    chains). The column-scaled headline (K4), the fused-wrap one (K13) and
    the column-scaled one with the (V, tau) QR (K14) are held the same way.
    In
    float64 rounding stays far below O(1), so the whole pair is held at the
    configuration's safe_mult=10."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=1)
    for s, stab, seed in ((sim, "qr", 3), (simcs, "qr_colscaled", 10),
                          (simrep, "qr", 12), (simfw, "qr", 17),
                          (simwy, "qr_colscaled", 19)):
        repulsive = s.ctx.F == 2
        modes = dict(fuse_wrap=s.ctx.fuse_wrap, qr_wy=s.ctx.qr_wy)
        # the repulsive pair prints the plain path's negative detratios
        first, _ = compare_paths(s.ctx, s.consts, s.state, seed,
                                 whole_pair=repulsive)
        if not first >= MIN_CONF_AGREE:
            raise AssertionError(f"kernel and plain paths ({stab}, F="
                                 f"{s.ctx.F}, {modes}) agree on the first "
                                 f"slice visit in only {first:.3f} of the "
                                 "chains")
        ctx1, consts1 = core.make_context(headline_model(repulsive), params,
                                          dtype=torch.float32, device=DEVICE,
                                          stab_method=stab, **modes)
        state1 = core.init_state(ctx1, consts1,
                                 s.state["conf"][:SM1_PATH_CHAINS])
        _, whole = compare_paths(ctx1, consts1, state1, seed + 1)
        if not whole >= MIN_CONF_AGREE:
            raise AssertionError(f"kernel and plain paths ({stab}, F="
                                 f"{s.ctx.F}, {modes}) agree in only "
                                 f"{whole:.3f} of the chains at safe_mult=1")
    # f64: K1 in float64 + K11 against site_sweep_plain + torch.linalg.qr
    _, whole = compare_paths(sim64.ctx, sim64.consts, sim64.state, 11)
    if not whole >= MIN_CONF_AGREE_F64:
        raise AssertionError(f"float64 kernel and plain paths agree in only "
                             f"{whole:.3f} of the chains at safe_mult="
                             f"{SAFE_MULT}")
    # 16x16: K7 Green's function + K6 against torch.linalg.qr +
    # sweep_slice_delayed
    first, _ = compare_paths(sim16.ctx, sim16.consts, sim16.state, 5,
                             whole_pair=False)
    if not first >= MIN_CONF_AGREE:
        raise AssertionError(f"kernel and plain paths agree on the first "
                             f"16x16 slice visit in only {first:.3f} of the "
                             "chains")
    # complex: K10 Green's function + K8 against torch.linalg.qr + the plain
    # complex sweep, at the configuration's safe_mult=5 and at safe_mult=1
    first, _ = compare_paths(simcx.ctx, simcx.consts, simcx.state, 6,
                             whole_pair=False)
    if not first >= MIN_CONF_AGREE_CX_FIRST:
        raise AssertionError(f"kernel and plain paths agree on the first "
                             f"complex slice visit in only {first:.3f} of "
                             "the chains")
    ctx1, consts1 = core.make_context(complex_model(), params,
                                      dtype=torch.float32, device=DEVICE)
    state1 = core.init_state(ctx1, consts1,
                             simcx.state["conf"][:SM1_PATH_CHAINS])
    _, whole = compare_paths(ctx1, consts1, state1, 7)
    if not whole >= MIN_CONF_AGREE:
        raise AssertionError(f"kernel and plain paths agree in only "
                             f"{whole:.3f} of the complex chains at "
                             "safe_mult=1")
    # complex16: K9 + the library QR against the plain complex rank-k sweep;
    # chain128: K8 at N = 128 + the wide K10 against the plain path, the
    # whole pair at safe_mult=1
    for s, seed in ((simcx16, 13), (simch, 15)):
        first, _ = compare_paths(s.ctx, s.consts, s.state, seed,
                                 whole_pair=False)
        if not first >= MIN_CONF_AGREE_CX_FIRST:
            raise AssertionError(f"kernel and plain paths agree on the first "
                                 f"complex N={s.ctx.N} slice visit in only "
                                 f"{first:.3f} of the chains")
    ctx1, consts1 = core.make_context(complex_model(L=CHAIN_L, dims=1),
                                      params, dtype=torch.float32,
                                      device=DEVICE)
    state1 = core.init_state(ctx1, consts1,
                             simch.state["conf"][:SM1_PATH_CHAINS])
    _, whole = compare_paths(ctx1, consts1, state1, 16)
    if not whole >= MIN_CONF_AGREE:
        raise AssertionError(f"kernel and plain paths agree in only "
                             f"{whole:.3f} of the chain128 chains at "
                             "safe_mult=1")


def phase_paths_fp64(runs):
    """The float64 and complex128 runs' kernel paths (K6-f64, K8-c128,
    K9-c128 beside the library QR) against their plain paths
    (sweep_slice_delayed or the plain rank-1 sweep, the same library QR)
    from each run's final state and the same uniforms: the first slice
    visit's decisions agree on every chain."""
    for s, seed in runs:
        first, _ = compare_paths(s.ctx, s.consts, s.state, seed,
                                 whole_pair=False)
        if first != 1.0:
            raise AssertionError(
                f"kernel and plain paths ({str(s.ctx.udtype)[6:]}, N="
                f"{s.ctx.N}) agree on the first slice visit in only "
                f"{first:.4f} of the chains")


def phase_witness(simcx, model, phase_tol=PHASE_TOL, chains=None,
                  plain_c128=True):
    """One complex sweep pair at safe_mult=5 from a complex run's final
    configuration (its first chains, where given; the complex run: K8, K10;
    complex16: K9, the library QR; libqr's complex64 run at N = 100: K8,
    the library QR), with the same uniforms, on the kernel
    path, the kernel path with complex128 stacks (the site sweep kernel and
    the wraps in complex64, the QR and the Green's recomputation in
    complex128), the plain path (use_kernels=False), the kernel path in
    complex128 (K8-c128 or K9-c128 with the library QR) and, with
    plain_c128, the plain path in complex128 (its per-site launches take
    most of a minute at complex16's N = 256, which runs without it), each
    from its own fresh init_state. A pure gauge keeps every weight real, so
    in complex128 no proposal may count as an imaginary probability and the
    running phase must stay 1 to 1e-9; the two complex128 paths must end
    the pair in the same configuration in MIN_CONF_AGREE_F64 of the chains.
    What the complex64 paths read there is float32 rounding, which the
    kernel and the plain path must read alike. The complex128 stacks tell
    the rounding of the stabilization (QR, recomputation) from that of the
    updates (site sweep, wraps)."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    conf = simcx.state["conf"][:chains]
    C, N, M = conf.shape
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    u = torch.rand(C, 2 * M, N, generator=gen, device=DEVICE)
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=CPLX_SM)
    f32, f64 = torch.float32, torch.float64
    out, conf_out = {}, {}
    arms = [("kernel complex64", dict(dtype=f32), True),
            ("kernel complex64 over complex128 stacks",
             dict(dtype=f64, update_dtype=f32), True),
            ("plain complex64", dict(dtype=f32), False),
            ("kernel complex128", dict(dtype=f64), True)]
    if plain_c128:
        arms.append(("plain complex128", dict(dtype=f64), False))
    for name, session, use_kernels in arms:
        t0 = time.perf_counter()
        ctx, consts = core.make_context(model, params, device=DEVICE,
                                        use_kernels=use_kernels, **session)
        s, _, _ = core.sweep_pair(ctx, consts, core.init_state(ctx, consts,
                                                               conf),
                                  u=u.to(ctx.urdtype))
        n_imag = s["ls_imag_count"].sum().item()
        r = dict(share=n_imag / (C * 2 * M * N),
                 imag_max=(10 ** s["ls_imag_max"].max().item()
                           if n_imag else 0.0),
                 drift_max=s["prop_err_max"].max().item(),
                 drift_mean=(s["prop_err_sum"].sum()
                             / s["prop_err_n"].sum()).item(),
                 s_dev=abs(complex(s["phase_meas"].mean().item()) - 1),
                 chain_dev=(s["ls_phase"] - 1).abs().max().item(),
                 chain_mean=(s["ls_phase"] - 1).abs().mean().item(),
                 acc=s["acc"].sum().item() / (C * 2 * M * N))
        out[name], conf_out[name] = r, s["conf"]
        torch.cuda.synchronize()
        log(f"[phase] N={N} {name} ({time.perf_counter() - t0:.1f} s): "
            f"imaginary probabilities {n_imag} of "
            f"{C * 2 * M * N} proposals ({r['share']:.4f}), max |Im det| "
            f"{r['imag_max']:.3e}; drift max/mean {r['drift_max']:.3e}/"
            f"{r['drift_mean']:.3e}; |<s> - 1| {r['s_dev']:.3e} over "
            f"{C} chains, |phase - 1| max {r['chain_dev']:.3e}, mean "
            f"{r['chain_mean']:.3e} over chains; acceptance {r['acc']:.4f}")
    k, x, p = (out[n] for n in (
        "kernel complex64", "kernel complex64 over complex128 stacks",
        "plain complex64"))
    for name in ("kernel complex128", "plain complex128")[:1 + plain_c128]:
        d = out[name]
        if not (d["share"] == 0 and d["s_dev"] < 1e-9
                and d["chain_dev"] < 1e-9):
            raise AssertionError(f"{name} path reads a non-real weight for a "
                                 "pure gauge")
    if plain_c128:
        agree = (conf_out["kernel complex128"]
                 == conf_out["plain complex128"]).flatten(1).all(1)
        agree = agree.float().mean().item()
        log(f"[phase] N={N} complex128 kernel and plain paths end the pair "
            f"in the same configuration in {agree:.4f} of {C} chains")
        if not agree >= MIN_CONF_AGREE_F64:
            raise AssertionError(f"complex128 kernel and plain paths agree "
                                 f"in only {agree:.4f} of the chains")
    if not all(r["s_dev"] < phase_tol for r in (k, x, p)):
        raise AssertionError(f"<s> off 1 by {k['s_dev']} (kernel), "
                             f"{x['s_dev']} (kernel over complex128 stacks), "
                             f"{p['s_dev']} (plain), bound {phase_tol}")
    if not k["share"] <= IMAG_SHARE_RATIO * p["share"]:
        raise AssertionError(f"kernel path's imaginary-probability share "
                             f"{k['share']} above {IMAG_SHARE_RATIO} times "
                             f"the plain path's {p['share']}")


def td_measurements(ctx, model):
    """CDS, PS (K = 4), SDSz and CCS (K = 4): the step functions the
    iterator comparison accumulates."""
    from types import SimpleNamespace
    from montecarlo_tpu_torch.measurements import dqmc_measurements as dm
    mc = SimpleNamespace(ctx=ctx)
    return {"CDS": dm.charge_density_susceptibility(mc, model),
            "PS": dm.pairing_susceptibility(mc, model, K=4),
            "SDSz": dm.spin_density_susceptibility(mc, model, "z"),
            "CCS": dm.current_current_susceptibility(mc, model, K=4)}


def td_iterate(ctx, consts, conf, model, udt_inputs=None):
    """One combined_greens_apply over conf from the path's own G00
    (greens_from_scratch) with td_measurements' step functions: (every
    (G0l, Gl0, Gll) stacked (M, 3, C, F, N, N), the accumulators, seconds).
    udt_inputs: a list that collects every matrix the iteration hands
    udt_dirty."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc import unequal_time as ut
    meas = td_measurements(ctx, model)
    G00 = core.greens_from_scratch(ctx, consts, conf, 0)
    G00p = core.unwrap_greens(ctx, consts, G00)
    hist = []

    def step(acc, G0l, Gl0, Gll):
        hist.append(torch.stack([G0l, Gl0, Gll]))
        out = {}
        for k, m in meas.items():
            c = m.measure_fn(G00=G00p, G0l=G0l, Gl0=Gl0, Gll=Gll)
            out[k] = {n: acc[k][n] + c[n] for n in c}
        return out

    acc0 = {k: {n: torch.zeros((conf.shape[0],) + s, dtype=ctx.dtype,
                               device=DEVICE)
                for n, s in m.combined_acc_shapes.items()}
            for k, m in meas.items()}
    udt = core.udt
    if udt_inputs is not None:
        def record(ctx_, A):
            udt_inputs.append(A)
            return udt(ctx_, A)
        core.udt = record
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = ut.combined_greens_apply(ctx, consts, conf, G00, acc0, step)
        torch.cuda.synchronize()
    finally:
        core.udt = udt
    return torch.stack(hist), acc, time.perf_counter() - t0


def rel_err(a, b):
    """max|a - b| / max|b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def chain_err(a, b, chain_dim=0, relative=False):
    """Per-chain max|a - b| (relative: over the chain's max|b|), the chain
    axis of a and b at chain_dim."""
    a, b = a.movedim(chain_dim, 0).double(), b.movedim(chain_dim, 0).double()
    e = (a - b).abs().flatten(1).amax(1)
    return e / b.abs().flatten(1).amax(1) if relative else e


def td_paths(conf, sm):
    """(a) and (b) at safe_mult sm: the iterator on the kernel path and on
    the plain path in float32, each against the float64 plain path from the
    same field, every G (0,l), G(l,0), G(l,l) and accumulator (per-chain
    errors, medians over chains); K2 on the matrices the kernel path's
    iteration hands udt_dirty (reconstruction and orthogonality); and
    combined_accuracy on the kernel path."""
    import dataclasses
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc import unequal_time as ut
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    from montecarlo_tpu_torch.ops import qr
    from montecarlo_tpu_torch.ops.linalg import _prescale_pivot
    model = headline_model()
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=sm)
    ctx_k, consts = core.make_context(model, params, dtype=torch.float32,
                                      device=DEVICE)
    ctx_p = dataclasses.replace(ctx_k, use_kernels=False)
    ctx_64, consts_64 = core.make_context(model, params, dtype=torch.float64,
                                          device=DEVICE, use_kernels=False)
    inputs = []
    hk, ak, tk = td_iterate(ctx_k, consts, conf, model, inputs)
    hp, ap, tp = td_iterate(ctx_p, consts, conf, model)
    h64, a64, t64 = td_iterate(ctx_64, consts_64, conf, model)
    med = lambda e: e.median().item()
    errs = {}                             # name: (kernel, plain) medians
    for i, name in enumerate(("G0l", "Gl0", "Gll")):
        errs[name] = (med(chain_err(hk[:, i], h64[:, i], 1)),
                      med(chain_err(hp[:, i], h64[:, i], 1)))
    direct = med(chain_err(hk.flatten(0, 1), hp.flatten(0, 1), 1))
    del hk, hp, h64
    for k in ak:
        for n in ak[k]:
            errs[k] = (med(chain_err(ak[k][n], a64[k][n], relative=True)),
                       med(chain_err(ap[k][n], a64[k][n], relative=True)))
    rec = orth = 0.0
    for A in inputs:
        n = A.shape[-1]
        Ap, mx, _ = _prescale_pivot(A.reshape(-1, n, n))
        Ap, mx = Ap.contiguous(), mx.reshape(-1).contiguous()
        Q, R, d = qr.udt_qr(Ap, mx)
        scale = Ap.abs().amax((-2, -1))
        rec = max(rec, ((Q @ ((d / mx[:, None])[..., None] * R) - Ap).abs()
                        .amax((-2, -1)) / scale).max().item())
        orth = max(orth, (Q.mT @ Q - torch.eye(n, device=DEVICE)).abs()
                   .max().item())
    t0 = time.perf_counter()
    acc = ut.combined_accuracy(ctx_k, consts, conf,
                               core.greens_from_scratch(ctx_k, consts, conf,
                                                        0))
    t_acc = time.perf_counter() - t0
    acc_med, acc_max = acc.median().item(), acc.max().item()
    ratios = {k: e[0] / max(e[1], 1e-30) for k, e in errs.items()}
    log(f"[timedisp] safe_mult={sm}, {conf.shape[0]} chains, per-chain "
        f"errors against the float64 plain path, median over chains, kernel "
        f"/ plain path (G: max over l = 1..{ctx_k.M}; accumulators: "
        f"relative): " + ", ".join(
            f"{k} {e[0]:.3e} / {e[1]:.3e}" for k, e in errs.items())
        + f"; worst ratio {max(ratios.values()):.3f} (bound "
        f"{TOL_TD_RATIO:g}); kernel vs plain G directly {direct:.3e} "
        f"({tk:.1f} s kernel path, {tp:.1f} s plain, {t64:.1f} s float64); "
        f"K2 on the iteration's {len(inputs)} udt_dirty inputs: "
        f"reconstruction {rec:.3e}, orthogonality {orth:.3e} (bound "
        f"{TOL_TD_REC:g}); combined_accuracy median {acc_med:.3e}, max "
        f"{acc_max:.3e} (bound on the median {TOL_TD_ACC[sm]:g}, "
        f"{t_acc:.1f} s)")
    if not max(ratios.values()) <= TOL_TD_RATIO:
        raise AssertionError(f"the float32 kernel path is less accurate than "
                             f"the plain path at safe_mult={sm}: {ratios}")
    if not (rec <= TOL_TD_REC and orth <= TOL_TD_REC):
        raise AssertionError(f"K2 on the iterator's matrices: reconstruction "
                             f"{rec:.3e}, orthogonality {orth:.3e}")
    if not acc_med <= TOL_TD_ACC[sm]:
        raise AssertionError(f"combined_accuracy median {acc_med:.3e} above "
                             f"{TOL_TD_ACC[sm]} at safe_mult={sm}")


def td_greens_kl(conf):
    """(b) greens_kl at TD_KL_PAIRS: float32 on the kernel path against
    float64 on the plain path."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc import unequal_time as ut
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    model = headline_model()
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=SAFE_MULT)
    ctx_k, consts_k = core.make_context(model, params, dtype=torch.float32,
                                        device=DEVICE)
    ctx_p, consts_p = core.make_context(model, params, dtype=torch.float64,
                                        device=DEVICE, use_kernels=False)
    errs = {kl: rel_err(ut.greens_kl(ctx_k, consts_k, conf, *kl).double(),
                        ut.greens_kl(ctx_p, consts_p, conf, *kl))
            for kl in TD_KL_PAIRS}
    log("[timedisp] greens_kl float32 kernel path vs float64 plain path, "
        "max|d|/max|float64|: " + ", ".join(
            f"G{kl} {e:.3e}" for kl, e in errs.items())
        + f" (bound {TOL_TD_KL:g})")
    if not max(errs.values()) <= TOL_TD_KL:
        raise AssertionError("greens_kl float32 kernel path off float64")


def td_run():
    """(c) DQMC.run() at the headline's width with CDS, PS, SDS x/y/z, CCS
    and two greens_at: finite observables, CDS at the largest distance
    positive, and K2's and K3's launches inside each measurement pass equal
    to the schedule's; the measurement pass's wall and device ms per
    measured sweep beside the sweep pair's. Returns the run's launches."""
    import numpy as np
    import torch
    import montecarlo_tpu_torch as mt
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc import unequal_time as ut
    from montecarlo_tpu_torch.ops import KERNELS
    model = headline_model()
    sim = mt.DQMC(model, beta=BETA, delta_tau=DTAU, safe_mult=SAFE_MULT,
                  n_chains=CHAINS, measure_rate=1, seed=4, device=DEVICE,
                  dtype=torch.float32)
    sim["CDS"] = mt.charge_density_susceptibility(sim, model)
    for d in ("x", "y", "z"):
        sim[f"SDS{d}"] = mt.spin_density_susceptibility(sim, model, d)
    sim["PS"] = mt.pairing_susceptibility(sim, model, K=4)
    sim["CCS"] = mt.current_current_susceptibility(sim, model, K=4)
    for i, kl in enumerate(TD_GREENS_AT):
        sim[f"UTG{i}"] = mt.greens_measurement(sim, model, greens_at=kl)
    names = ("udt_qr", "udt_qr_solve")
    passes, measure_all = [], sim._measure_all

    def counted(*args):
        before = [KERNELS[k].launches for k in names]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        measure_all(*args)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0, [
            KERNELS[k].launches - b for k, b in zip(names, before)]))

    sim._measure_all = counted
    read = zero_launches()
    sim.run(thermalization=TD_THERM, sweeps=TD_SWEEPS, verbose=False)
    torch.cuda.synchronize()
    launches = read()
    ctx = sim.ctx
    n_udt, n_greens = ut.combined_udt_launches(ctx)
    n_udt += sum(ut.greens_kl_udts(ctx, *kl) for kl in TD_GREENS_AT)
    counts = [c for _, c in passes]
    log(f"[timedisp] run {CHAINS} chains, {TD_THERM} + {TD_SWEEPS} sweeps: "
        f"launches {launches}; K2, K3 per measurement pass {counts}, "
        f"schedule {[n_udt, n_greens]}")
    if not (len(passes) == TD_SWEEPS
            and all(c == [n_udt, n_greens] for c in counts)):
        raise AssertionError("K2/K3 launches of the measurement pass differ "
                             "from the schedule's")
    obs = sim.observables()
    bad = [f"{k}/{n}" for k, r in obs.items() for n, x in r.items()
           if not np.isfinite(np.asarray(x.mean)).all()]
    if bad:
        raise AssertionError(f"non-finite observables {bad}")
    cds = np.asarray(obs["CDS"]["cds"].mean)
    dirs = np.linalg.norm(model.lattice.directions, axis=-1)
    far = float(cds[np.argmax(dirs)])
    log(f"[timedisp] CDS {np.round(cds, 5).tolist()}; at the largest "
        f"distance {far:.6f} (> 0); PS[0] {np.round(np.asarray(obs['PS']['ps'].mean)[0], 5).tolist()}; "
        f"SDSz[0] {float(np.asarray(obs['SDSz']['sds_z'].mean)[0]):.5f}, "
        f"CCS[0] {np.round(np.asarray(obs['CCS']['ccs'].mean)[0], 5).tolist()}")
    if not far > 0:
        raise AssertionError(f"CDS at the largest distance {far} not > 0")
    # one more measurement pass and one sweep pair, wall and device
    state = sim.state
    G = core.greens_from_scratch(ctx, sim.consts, state["conf"], 0)
    conf = state["conf"]
    meas = lambda: measure_all(sim.measurements, G, conf)
    pair = lambda: core.sweep_pair(ctx, sim.consts, state,
                                   generator=sim.generator)
    wall_m, dev_m = 1e3 * timed(meas, 1), device_ms(meas, reps=1)
    wall_p, dev_p = 1e3 * timed(pair, 2), device_ms(pair, reps=2)
    log(f"[timedisp] measurement pass per measured sweep ({CHAINS} chains, "
        f"CDS + SDS x/y/z + PS + CCS + 2 greens_at): wall "
        f"{wall_m:.1f} ms, device {ms_text(dev_m)} (in the run: "
        + ", ".join(f"{1e3 * w:.1f}" for w, _ in passes)
        + f" ms); sweep pair: wall {wall_p:.1f} ms, device "
        f"{ms_text(dev_p)}")
    return launches


def td_gate():
    """(d) the gate's machinery: pooled_run with GATE_SEEDS at GATE_CHAINS
    chains each on the card, every default observable, and compare_pools
    of the pool with itself."""
    import numpy as np
    from montecarlo_tpu_torch import validation as v
    t0 = time.perf_counter()
    pool = v.pooled_run(safe_mult=SAFE_MULT, device=DEVICE,
                        n_chains=GATE_CHAINS, seeds=GATE_SEEDS,
                        thermalization=GATE_THERM, sweeps=GATE_SWEEPS,
                        measure_rate=1)
    rows = {k: x.shape for k, x in pool.items() if not k.startswith("_")}
    ok, zs, _ = v.compare_pools(pool, pool)
    log(f"[timedisp] pooled_run seeds {GATE_SEEDS} x {GATE_CHAINS} chains, "
        f"{GATE_THERM} + {GATE_SWEEPS} sweeps ({time.perf_counter() - t0:.1f}"
        f" s): {rows}; acceptance {pool['_acc'][0]:.4f}; compare_pools with "
        f"itself ok={ok}, max z {max(zs.values()):.3g}")
    n = len(GATE_SEEDS) * GATE_CHAINS
    if not (set(rows) >= {f"{k}/{n_}" for k, n_ in (
            ("occ", "occ"), ("greens", "greens"), ("CDC", "cdc"),
            ("PC", "pc"), ("SDCz", "sdc_z"), ("CDS", "cds"), ("PS", "ps"))}
            and all(r[0] == n for r in rows.values()) and ok):
        raise AssertionError("pooled_run's rows or compare_pools are off")
    bad = [k for k, x in pool.items()
           if not k.startswith("_") and not np.isfinite(x).all()]
    if bad:
        raise AssertionError(f"non-finite pooled observables {bad}")


def phase_timedisp(sim):
    """Phase 6: the time-displaced path at the headline's width, from the
    headline run's final state (sim, phase 4)."""
    conf = sim.state["conf"][:TD_CHAINS]
    for sm in (SAFE_MULT, 1):
        td_paths(conf, sm)
    td_greens_kl(conf)
    launches = td_run()
    td_gate()
    return launches


def classical_ising():
    """(7a) bench.py's ising_flips row through MC(...).run(): K17 once per
    sweep and nothing else; acceptance, energy per site and spin flips/s
    (attempted flips of the measured sweeps over their wall seconds)."""
    import torch
    import montecarlo_tpu_torch as mt
    read = zero_launches()
    sim = mt.MC(mt.IsingModel(dims=2, L=ISING_L), beta=ISING_BETA,
                n_chains=ISING_CHAINS, seed=0, measurements={},
                device=DEVICE)
    sim.run(thermalization=ISING_THERM, sweeps=0, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(thermalization=ISING_THERM, sweeps=ISING_SWEEPS, verbose=False)
    torch.cuda.synchronize()
    dur = time.perf_counter() - t0
    launches = read()
    N = len(sim.model.lattice)
    flips = ISING_SWEEPS * ISING_CHAINS * N / dur
    e = float(sim.model.make_energy_fn()(sim.conf).mean()) / N
    acc = sim.analysis.acc_rate
    log(f"[ising] 8x8 beta={ISING_BETA} {ISING_CHAINS} chains, "
        f"{ISING_THERM} + {ISING_SWEEPS} sweeps: ising_sweep launches "
        f"{launches['ising_sweep']}; acceptance {acc:.5f}; e {e:.5f}; "
        f"{ISING_SWEEPS} sweeps in {dur:.4f} s = {flips:.4e} spin flips/s")
    expected = dict.fromkeys(launches, 0)
    expected["ising_sweep"] = ISING_THERM + ISING_SWEEPS
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    vals = torch.unique(sim.conf).tolist()
    if not (0.0 < acc < 1.0 and -2.0 < e < 0.0 and vals == [-1, 1]):
        raise AssertionError(f"acceptance {acc}, e {e}, spins {vals}")
    return launches


def wolff_session():
    """The Wolff run's session: 8x8 at beta = 1/IsingTc, WOLFF_CHAINS
    chains, a global move every WOLFF_RATE sweeps."""
    import montecarlo_tpu_torch as mt
    return mt.MC(mt.IsingModel(dims=2, L=ISING_L), beta=1.0 / mt.IsingTc,
                 n_chains=WOLFF_CHAINS, seed=1, global_moves=True,
                 global_rate=WOLFF_RATE, device=DEVICE)


@contextlib.contextmanager
def fixed_batch(levels):
    """Wolff moves run in batches of this many BFS levels (None: the
    model's rule): the move reads models.ising.batch_levels at each batch."""
    from montecarlo_tpu_torch.models import ising
    rule = ising.batch_levels
    if levels is not None:
        ising.batch_levels = lambda *_: levels
    try:
        yield
    finally:
        ising.batch_levels = rule


def count_syncs(fn):
    """fn()'s result and the host synchronizations it made (torch's sync
    debug mode: one warning each)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def wolff_moves(sim):
    """Wolff moves alone from sim's state, on its stream: wall ms per move
    over WOLFF_TIMED_MOVES moves, their levels per move, and the host
    synchronizations per move over WOLFF_SYNC_MOVES more (count_syncs),
    and the batches (host reads) per move of those."""
    import torch
    _, move = sim._moves()
    C, N = sim.conf.shape
    z = sim.model.lattice.coordination
    draw = lambda k: sim._level_uniforms((C, N, z), k)
    conf, levels = sim.conf, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WOLFF_TIMED_MOVES):
        conf, _, n = move(conf, sim._seed_sites(N), draw)
        levels += n
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / WOLFF_TIMED_MOVES
    batches = move.batches

    def more():
        c = conf
        for _ in range(WOLFF_SYNC_MOVES):
            c, _, _ = move(c, sim._seed_sites(N), draw)

    _, syncs = count_syncs(more)
    return (wall, levels / WOLFF_TIMED_MOVES, syncs / WOLFF_SYNC_MOVES,
            (move.batches - batches) / WOLFF_SYNC_MOVES)


def classical_wolff():
    """(7b) Wolff moves at beta = 1/IsingTc through MC(...).run(): clusters
    flip (acc_global > 0), <|m|> in WOLFF_M_RANGE; K18 launched once per
    batch of BFS levels (one host read each); the same run at one level a
    batch (fixed_batch(1), the level-by-level loop) from the same seed
    bit-equal in conf and counters; then moves alone from each run's state:
    wall ms, levels and host synchronizations per move."""
    import torch
    batching = {"batched": None, "level by level": 1}
    runs = {}
    for tag, lb in batching.items():
        read = zero_launches()
        sim = wolff_session()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fixed_batch(lb):
            sim.run(thermalization=WOLFF_THERM, sweeps=WOLFF_SWEEPS,
                    verbose=False)
        torch.cuda.synchronize()
        runs[tag] = (sim, read(), time.perf_counter() - t0,
                     sim._moves()[1].batches)
    (sim, launches, dur, batches), (sim1, launches1, dur1, batches1) = (
        runs["batched"], runs["level by level"])
    a, a1 = sim.analysis, sim1.analysis
    moves = (WOLFF_THERM + WOLFF_SWEEPS) // WOLFF_RATE
    m = float(sim.observables()["Magn"]["m"].mean)
    log(f"[wolff] 8x8 beta=1/Tc {WOLFF_CHAINS} chains, {WOLFF_THERM} + "
        f"{WOLFF_SWEEPS} sweeps, a global move every {WOLFF_RATE}: launches "
        f"ising_sweep {launches['ising_sweep']}, wolff_step "
        f"{launches['wolff_step']}; {moves} moves, {a.levels_global} BFS "
        f"levels = {a.levels_global / moves:.2f} levels per move in "
        f"{batches / moves:.2f} batches (launches, host reads) per move; "
        f"acc_global {a.acc_global} of {a.prop_global}; local acceptance "
        f"{a.acc_rate:.5f}; <|m|> {m:.5f}; {dur:.3f} s (one level a batch: "
        f"{batches1} launches, {dur1:.3f} s)")
    fields = ("acc_local", "prop_local", "acc_global", "prop_global",
              "levels_global")
    same = (torch.equal(sim.conf, sim1.conf)
            and all(getattr(a, f) == getattr(a1, f) for f in fields)
            and torch.equal(sim.generator.get_state(),
                            sim1.generator.get_state()))
    log(f"[wolff] batched run bit-equal to one level a batch (conf, "
        f"counters, the generator after the run): {same}")
    expected = dict.fromkeys(launches, 0)
    expected.update(ising_sweep=WOLFF_THERM + WOLFF_SWEEPS,
                    wolff_step=batches)
    expected1 = dict(expected, wolff_step=a1.levels_global)
    if (launches != expected or launches1 != expected1
            or batches1 != a1.levels_global
            or a.prop_global != moves * WOLFF_CHAINS):
        raise AssertionError(f"launches {launches} / {launches1}, expected "
                             f"{expected} / {expected1}; prop_global "
                             f"{a.prop_global}")
    if not same:
        raise AssertionError("the batched Wolff run differs from the "
                             "level-by-level run")
    lo, hi = WOLFF_M_RANGE
    if not (a.acc_global > 0 and lo < m < hi):
        raise AssertionError(f"acc_global {a.acc_global}, <|m|> {m}")
    per_move = {}
    for tag, r in runs.items():
        with fixed_batch(batching[tag]):
            per_move[tag] = wolff_moves(r[0])
    for tag, (wall, levels, syncs, reads) in per_move.items():
        log(f"[wolff] moves alone, {tag}: {wall:.4f} ms wall a move, "
            f"{levels:.2f} levels a move, {syncs:.2f} host synchronizations "
            f"a move (sync debug mode) for {reads:.2f} batches a move")
    # each batch's one status read is the move's only synchronization (the
    # generator's state is read and set on the host)
    if any(syncs != reads for _, _, syncs, reads in per_move.values()):
        raise AssertionError("a Wolff move synchronizes other than once a "
                             "batch")
    # the level-by-level run is the batched run's reference: its launches
    # are checked above and not counted as the main path's
    return launches


def exact_ising(L, beta):
    """Exact <E> and <|M|> of the periodic L x L Ising model by enumeration
    of its 2^(L*L) states (tests/test_ising_mc.py::exact_ising_3x3)."""
    import itertools
    import numpy as np
    from montecarlo_tpu_torch import SquareLattice
    bonds = SquareLattice(L).bonds[:, :2]
    s = np.array(list(itertools.product([-1, 1], repeat=L * L)))
    E = -np.sum(s[:, bonds[:, 0]] * s[:, bonds[:, 1]], axis=1)
    M = np.abs(s.sum(axis=1))
    w = np.exp(-beta * (E - E.min()))
    return (E * w).sum() / w.sum(), (M * w).sum() / w.sum()


def classical_enum():
    """(7c) the 3x3 (four color classes) at beta 0.3 through
    MC(...).run(): E and M within max(4 sigma, 0.05) of exact
    enumeration."""
    import montecarlo_tpu_torch as mt
    read = zero_launches()
    sim = mt.MC(mt.IsingModel(dims=2, L=ENUM_L), beta=ENUM_BETA,
                n_chains=ENUM_CHAINS, seed=42, device=DEVICE)
    sim.run(thermalization=ENUM_THERM, sweeps=ENUM_SWEEPS, verbose=False)
    launches = read()
    obs = sim.observables()
    E, M = obs["Energy"]["E"], obs["Magn"]["M"]
    E_x, M_x = exact_ising(ENUM_L, ENUM_BETA)
    log(f"[enum] 3x3 beta={ENUM_BETA} {ENUM_CHAINS} chains, {ENUM_THERM} + "
        f"{ENUM_SWEEPS} sweeps ({len(sim.model.lattice.site_colors)} color "
        f"classes): E {E.mean:.5f} +- {E.std_error:.5f} (exact {E_x:.5f}), "
        f"M {M.mean:.5f} +- {M.std_error:.5f} (exact {M_x:.5f}); "
        f"ising_sweep launches {launches['ising_sweep']}")
    if launches["ising_sweep"] != ENUM_THERM + ENUM_SWEEPS:
        raise AssertionError(f"launches {launches}")
    for name, r, x in (("E", E, E_x), ("M", M, M_x)):
        if not abs(r.mean - x) < max(ENUM_SIGMAS * r.std_error, ENUM_ABS):
            raise AssertionError(f"{name} {r.mean} +- {r.std_error} against "
                                 f"exact {x}")
    return launches


def classical_io(tmp):
    """(7d) checkpoints on the card: an MC run saved at sweep IO_MC_SPLIT
    and resumed to IO_MC_SWEEPS, bit-equal in conf (and its binner means)
    to an uninterrupted one; the f64 DQMC configuration saved after one
    sweep and resumed for one more, bit-equal in conf in every chain, with
    last_sweep and the observables' means equal; a headline-width float32
    run with ConfigRecorder, replayed: K2 and K3 per recorded field as
    greens_from_scratch schedules them (n_seg and 1), the replayed
    occupation finite and within OCC_TOL of 0.5. Returns the kernels'
    launches of its runs (the recorded run's excepted), summed."""
    import numpy as np
    import torch
    import montecarlo_tpu_torch as mt
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def mc():
        return mt.MC(mt.IsingModel(dims=2, L=ISING_L), beta=ISING_BETA,
                     n_chains=IO_MC_CHAINS, seed=5, global_moves=True,
                     global_rate=IO_MC_RATE, device=DEVICE)

    read = zero_launches()
    full = mc()
    full.run(sweeps=IO_MC_SWEEPS, verbose=False, chunk=IO_MC_SPLIT)
    part = mc()
    part.run(sweeps=IO_MC_SPLIT, verbose=False, chunk=IO_MC_SPLIT)
    fn = mt.save(str(tmp / "mc.mctorch"), part)
    ok, part2 = mt.resume(fn, device=DEVICE, sweeps=IO_MC_SWEEPS,
                          verbose=False, chunk=IO_MC_SPLIT)
    add(read())
    same = torch.equal(full.conf, part2.conf)
    e_same = all(np.array_equal(full[k][n].mean, part2[k][n].mean)
                 for k, n in (("Energy", "E"), ("Magn", "M")))
    log(f"[io] MC {IO_MC_CHAINS} chains, saved at {IO_MC_SPLIT}, resumed to "
        f"{part2.last_sweep}: conf bit-equal to the uninterrupted run "
        f"{same}, binner means equal {e_same}; levels "
        f"{full.analysis.levels_global} / {part2.analysis.levels_global}")
    if not (ok and same and e_same and part2.last_sweep == IO_MC_SWEEPS):
        raise AssertionError("the resumed MC run differs")

    def dqmc(chains=F64_CHAINS, **kw):
        return mt.DQMC(headline_model(), beta=BETA, delta_tau=DTAU,
                       safe_mult=SAFE_MULT, n_chains=chains,
                       measure_rate=1, seed=6, device=DEVICE, **kw)

    read = zero_launches()
    full = dqmc()
    full.run(thermalization=1, sweeps=1, verbose=False)
    part = dqmc()
    part.run(thermalization=1, sweeps=0, verbose=False)
    fn = mt.save(str(tmp / "dqmc.mctorch"), part)
    ok, part2 = mt.resume(fn, device=DEVICE, thermalization=1, sweeps=1,
                          verbose=False)
    add(read())
    per_chain = (full.state["conf"] == part2.state["conf"]).flatten(
        1).all(1)
    occ = [np.asarray(s.observables()["occ"]["occ"].mean) for s in
           (full, part2)]
    grn = [np.asarray(s.observables()["greens"]["greens"].mean) for s in
           (full, part2)]
    log(f"[io] DQMC float64 8x8 {F64_CHAINS} chains, 1 + 1 sweeps against "
        f"1 saved + 1 resumed: conf bit-equal in {int(per_chain.sum())} of "
        f"{F64_CHAINS} chains, last_sweep {full.last_sweep} / "
        f"{part2.last_sweep}, occ means equal "
        f"{np.array_equal(*occ)}, greens means equal "
        f"{np.array_equal(*grn)}")
    if not (ok and bool(per_chain.all()) and part2.last_sweep ==
            full.last_sweep and np.array_equal(*occ)
            and np.array_equal(*grn)):
        raise AssertionError("the resumed float64 DQMC run differs")

    sim = dqmc(CHAINS, dtype=torch.float32,
               recorder=mt.ConfigRecorder(rate=1))
    sim.run(thermalization=X_THERM, sweeps=X_SWEEPS, verbose=False)
    read = zero_launches()
    sim.replay()
    launches = read()
    add(launches)
    n_rec, n_seg = len(sim.configs), sim.ctx.n_seg
    occ = float(sim.observables()["occ"]["occ"].mean.mean())
    log(f"[io] replay of {n_rec} recorded fields ({CHAINS} chains, "
        f"float32): udt_qr {launches['udt_qr']}, udt_qr_solve "
        f"{launches['udt_qr_solve']} (schedule {n_rec} x ({n_seg}, 1)); "
        f"occupation {occ:.5f}")
    if not (n_rec == X_SWEEPS and launches["udt_qr"] == n_rec * n_seg
            and launches["udt_qr_solve"] == n_rec
            and math.isfinite(occ) and abs(occ - 0.5) <= OCC_TOL):
        raise AssertionError("replay's launches or occupation are off")
    return totals


def phase_classical(mark):
    """Phase 7: the classical flavor and the checkpoints, each part ending
    with mark(tag); returns the kernels' launches of its runs, summed."""
    import tempfile
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, fn in (("ising", classical_ising),
                        ("wolff", classical_wolff), ("enum", classical_enum),
                        ("io", lambda: classical_io(Path(tmp)))):
            for k, v in fn().items():
                totals[k] = totals.get(k, 0) + v
            mark(tag)
    return totals


def alps_xml(lat):
    """A lattice as an ALPS GRAPH document (1-based ids, edges in bond
    order, vertex coordinates and bond vectors), as tests/test_alps.py
    writes one."""
    lines = [f'<GRAPH vertices="{lat.n_sites}" dimension="{lat.dim}">']
    for i, p in enumerate(lat.positions):
        lines.append(f'  <VERTEX id="{i + 1}"><COORDINATE>'
                     f'{" ".join(map(str, p))}</COORDINATE></VERTEX>')
    for b, (s, t, ty) in enumerate(lat.bonds):
        d = lat.positions[t] - lat.positions[s]
        lines.append(f'  <EDGE source="{s + 1}" target="{t + 1}" id="{b + 1}" '
                     f'type="{ty}" vector="{" ".join(map(str, d))}"/>')
    lines.append("</GRAPH>")
    return "\n".join(lines)


def item9_session(lattice=None, seed=8):
    """A headline session (float32, 256 chains) on ``lattice`` (default
    SquareLattice(L))."""
    import torch
    import montecarlo_tpu_torch as mt
    lattice = lattice if lattice is not None else mt.SquareLattice(L)
    model = mt.HubbardModelAttractive(l=lattice, U=U, mu=MU)
    return mt.DQMC(model, beta=BETA, delta_tau=DTAU, safe_mult=SAFE_MULT,
                   n_chains=CHAINS, measure_rate=1, seed=seed, device=DEVICE,
                   dtype=torch.float32), model


def item9_run(sim, read):
    """sim.run(ITEM9_THERM, ITEM9_SWEEPS): (read(), the launches since the
    counts were set to 0 before the session was built, and the run's wall
    seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(thermalization=ITEM9_THERM, sweeps=ITEM9_SWEEPS, verbose=False)
    torch.cuda.synchronize()
    return read(), time.perf_counter() - t0


def item9_alps(tmp, smi):
    """(8a) the headline on an ALPS file of the 8x8 and on SquareLattice(8)
    with one seed: conf and G bit-equal, the launches equal (K1, K2 and K3
    launched); the ALPS session saved and loaded on the card, conf
    bit-equal. Returns both runs' launches, summed."""
    import torch
    import montecarlo_tpu_torch as mt
    fn = tmp / "square8.xml"
    fn.write_text(alps_xml(mt.SquareLattice(L)))
    runs = {}
    for tag, lat in (("alps", mt.ALPSLattice(str(fn))),
                     ("native", mt.SquareLattice(L))):
        read = zero_launches()
        sim, _ = item9_session(lat)
        runs[tag] = (sim, *item9_run(sim, read))
    (sa, la, wa), (sn, ln, wn) = runs["alps"], runs["native"]
    same_conf = torch.equal(sa.state["conf"], sn.state["conf"])
    same_g = torch.equal(sa.state["G"], sn.state["G"])
    k123 = {k: la[k] for k in ("site_sweep", "udt_qr", "udt_qr_solve")}
    log(f"[item9] alps: 8x8 from {fn.name} ({len(sa.model.lattice)} sites, "
        f"{sa.model.lattice.n_bonds} bonds) against SquareLattice({L}), "
        f"seed 8, {ITEM9_THERM} + {ITEM9_SWEEPS} sweeps, {CHAINS} chains: "
        f"conf bit-equal {same_conf}, G bit-equal {same_g}; K1, K2, K3 "
        f"{k123} (native {[ln[k] for k in k123]}); wall {wa:.3f} s / "
        f"{wn:.3f} s ({smi})")
    if not (same_conf and same_g and la == ln and all(k123.values())):
        raise AssertionError("the ALPS headline differs from the native one")
    ck = mt.save(str(tmp / "alps.mctorch"), sa)
    back = mt.load(ck, device=DEVICE)
    ok = (isinstance(back.model.lattice, mt.ArbitraryLattice)
          and torch.equal(back.state["conf"], sa.state["conf"])
          and (back.model.lattice.bonds == sa.model.lattice.bonds).all())
    log(f"[item9] alps: saved and loaded: {back.model.lattice!r}, conf "
        f"bit-equal {ok}")
    if not ok:
        raise AssertionError("the loaded ALPS session differs")
    return {k: la[k] + ln[k] for k in la}


def _pc_kernel(S_np):
    """The shipped pairing correlation as a batch-first quad kernel."""
    import torch

    def kernel(G):
        Gu, Gd = G[:, 0], G[:, -1]
        S = torch.as_tensor(S_np).to(device=Gu.device, dtype=Gu.dtype)
        B = torch.einsum("kab,cbd->ckad", S, Gd)
        return Gu[:, None, None] * torch.einsum("ckad,qbd->ckqab", B, S)
    return kernel


def item9_custom(smi):
    """(8b) custom CDC, PC, CDS and GreensAt measurements beside the shipped
    ones on one headline session: float64 binner means within TOL_CUSTOM
    relative; K2/K3 per measurement pass against the schedule; wall and
    device ms of a measurement pass with and without the custom set.
    Returns (launches, CDC mean, PC mean, the lattice)."""
    import numpy as np
    import torch
    import montecarlo_tpu_torch as mt
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc import unequal_time as ut
    from montecarlo_tpu_torch.measurements import MeasurementRegistry
    from montecarlo_tpu_torch.measurements import dqmc_measurements as dm
    from montecarlo_tpu_torch.ops import KERNELS
    read = zero_launches()
    sim, model = item9_session(seed=9)
    lat = model.lattice
    shipped = {
        "CDC": (dm.charge_density_correlation(sim, model), "cdc"),
        "PC": (dm.pairing_correlation(sim, model, K=ITEM9_K), "pc"),
        "CDS": (dm.charge_density_susceptibility(sim, model), "cds"),
        "GAT": (dm.greens_measurement(sim, model,
                                      greens_at=ITEM9_GREENS_AT), "greens")}
    custom = {
        "CDC": mt.custom_measurement(
            sim, model, dm.cdc_matrix, name="cdc",
            lattice_iterator=mt.EachSitePairByDistance()),
        "PC": mt.custom_measurement(
            sim, model, _pc_kernel(mt.selection_matrices(lat, ITEM9_K)),
            name="pc", lattice_iterator=mt.EachLocalQuadByDistance(ITEM9_K)),
        "CDS": mt.custom_measurement(
            sim, model, dm.cdc4_matrix, name="cds",
            greens_iterator=mt.CombinedGreensIterator),
        "GAT": mt.custom_measurement(
            sim, model, lambda G: G[:, 0], name="greens",
            greens_iterator=mt.GreensAt(*ITEM9_GREENS_AT),
            lattice_iterator=mt.EachSitePair())}
    for k, (m, _) in shipped.items():
        sim[k] = m
        sim[f"{k}_custom"] = custom[k]
    names = ("udt_qr", "udt_qr_solve")
    passes, measure_all = [], sim._measure_all

    def counted(*args):
        before = [KERNELS[k].launches for k in names]
        measure_all(*args)
        passes.append([KERNELS[k].launches - b for k, b in zip(names, before)])

    sim._measure_all = counted
    launches, wall = item9_run(sim, read)
    sim._measure_all = measure_all
    ctx = sim.ctx
    n_udt, n_greens = ut.combined_udt_launches(ctx)
    schedule = [n_udt + ut.greens_kl_udts(ctx, *ITEM9_GREENS_AT), n_greens]
    log(f"[item9] custom: {CHAINS} chains, {ITEM9_THERM} + {ITEM9_SWEEPS} "
        f"sweeps in {wall:.3f} s; K2, K3 per measurement pass {passes}, "
        f"schedule {schedule} (one combined pass and one G{ITEM9_GREENS_AT} "
        f"serve the shipped and the custom measurements)")
    if not (len(passes) == ITEM9_SWEEPS
            and all(c == schedule for c in passes)):
        raise AssertionError("K2/K3 launches of the measurement pass differ "
                             "from the schedule's")
    obs = sim.observables()
    N = len(lat)
    errs = {}
    for k, (_, name) in shipped.items():
        ref = np.asarray(obs[k][name].mean)
        got = np.asarray(obs[f"{k}_custom"][name].mean)
        if k == "GAT":           # EachSitePair stores G_up / N
            ref, got = ref[0], got * N
        if not (np.isfinite(ref).all() and got.shape == ref.shape):
            raise AssertionError(f"{k}: shapes {got.shape}, {ref.shape} or "
                                 "non-finite values")
        errs[k] = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"[item9] custom against shipped, max|a - b| / max|b| of the "
        f"float64 binner means: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (limit {TOL_CUSTOM})")
    if not max(errs.values()) <= TOL_CUSTOM:
        raise AssertionError("a custom measurement differs from its shipped "
                             "counterpart")
    # one measurement pass with and without the custom set, wall and device
    shipped_only = MeasurementRegistry()
    for k, (m, _) in shipped.items():
        shipped_only.add(k, m, sim.n_chains, sim.device)
    conf = sim.state["conf"]
    G = core.greens_from_scratch(ctx, sim.consts, conf, 0)
    times = {}
    for tag, reg in (("shipped", shipped_only), ("with custom",
                                                 sim.measurements)):
        fn = lambda reg=reg: measure_all(reg, G, conf)
        times[tag] = (1e3 * timed(fn, 1), device_ms(fn, reps=1))
    log(f"[item9] measurement pass per measured sweep ({CHAINS} chains; "
        f"{smi}): "
        + "; ".join(f"{t}: wall {w:.1f} ms, device {ms_text(d)}"
                    for t, (w, d) in times.items()))
    return (launches, np.asarray(obs["CDC"]["cdc"].mean),
            np.asarray(obs["PC"]["pc"].mean), lat)


def item9_postproc(cdc, pc, lat):
    """(8c) S(q) of the CDC mean over the 8x8's reciprocal grid: 64 q
    points, S(q = 0) within TOL_SQ0 of uniform_fourier; the PC's s-wave
    apply_symmetry finite."""
    import numpy as np
    import montecarlo_tpu_torch as mt
    from montecarlo_tpu_torch.measurements.postprocessing import (
        reciprocal_discretization)
    qs = reciprocal_discretization(lat)
    S = mt.structure_factor(qs, lat.directions, cdc)
    q0 = int(np.argmin(np.linalg.norm(qs, axis=1)))
    uf = mt.uniform_fourier(cdc)
    swave = mt.apply_symmetry(pc, (1.0,))
    err = abs(S[q0] - uf)
    log(f"[item9] postproc: S(q) at {len(qs)} q points, S(0) "
        f"{S[q0].real:.9f}{S[q0].imag:+.1e}i, uniform_fourier {uf:.9f} "
        f"(|diff| {err:.2e}); S(pi, pi) "
        f"{S[int(np.argmin(np.linalg.norm(qs - np.pi, axis=1)))].real:.6f}; "
        f"PC s-wave {np.round(swave[:4].real, 6).tolist()}...")
    if not (len(qs) == L * L and S.shape == (L * L,) and err <= TOL_SQ0
            and np.isfinite(S).all() and np.isfinite(swave).all()):
        raise AssertionError("S(q) or the s-wave PC are off")


def item9_timers(smi):
    """(8d) the headline with the timers off and on, in turns (off, on, on,
    off): dqmc_block counted once per chunk in each timed run, its total in
    (0, the wall around run]; print_timer's lines. Returns the runs'
    launches, summed."""
    import io
    from montecarlo_tpu_torch.utils import timing
    totals, walls = {}, {"off": [], "on": []}
    chunks = 2                    # thermalization and measurement stages
    try:
        for mode in ("off", "on", "on", "off"):
            timing.reset_timer()
            (timing.enable_benchmarks if mode == "on"
             else timing.disable_benchmarks)()
            read = zero_launches()
            sim, _ = item9_session(seed=10)
            launches, wall = item9_run(sim, read)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            walls[mode].append(wall)
            data = timing.timer_data()
            if mode == "off":
                if data:
                    raise AssertionError(f"disabled timers recorded {data}")
                continue
            block = data["dqmc_block"]
            log(f"[item9] timers: dqmc_block x{block['count']}, "
                f"{1e3 * block['total_s']:.3f} ms of {1e3 * wall:.3f} ms "
                "around run")
            if not (block["count"] == chunks
                    and 0 < block["total_s"] <= wall):
                raise AssertionError("dqmc_block's count or total is off")
            buf = io.StringIO()
            timing.print_timer(buf)
            for line in buf.getvalue().splitlines():
                log(f"[item9] print_timer: {line}")
    finally:
        timing.disable_benchmarks()
        timing.reset_timer()
    log(f"[item9] timers: wall of {ITEM9_THERM} + {ITEM9_SWEEPS} sweeps, "
        f"timers off {', '.join(f'{w:.3f}' for w in walls['off'])} s, on "
        f"{', '.join(f'{w:.3f}' for w in walls['on'])} s (order off, on, "
        f"on, off; {smi})")
    return totals


def phase_item9(mark, smi):
    """Phase 8: ALPS lattices, custom measurements, post-processing and the
    timers at the headline, each part ending with mark(tag); returns the
    kernels' launches of its runs, summed."""
    import tempfile
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        add(item9_alps(Path(tmp), smi))
    mark("item9 alps")
    launches, cdc, pc, lat = item9_custom(smi)
    add(launches)
    mark("item9 custom")
    item9_postproc(cdc, pc, lat)
    mark("item9 postproc")
    add(item9_timers(smi))
    mark("item9 timers")
    return totals


def chains_sessions():
    """Phase 9's sessions: {tag: (a picklable factory of the session, the
    kernels its run must launch, chain-sweeps of its run)}."""
    import functools
    import torch
    import montecarlo_tpu_torch as mt
    dqmc = functools.partial(mt.DQMC, beta=BETA, delta_tau=DTAU,
                             measure_rate=1, seed=CH_SEED, device=DEVICE)
    return {
        "headline": (functools.partial(
            dqmc, headline_model(), safe_mult=SAFE_MULT, n_chains=CHAINS,
            dtype=torch.float32, thermalization=1, sweeps=2),
            ("site_sweep", "udt_qr", "udt_qr_solve"), CHAINS * 3),
        "flux10_c128": (functools.partial(
            dqmc, complex_model(L=CH_FLUX_L), safe_mult=CPLX_SM,
            n_chains=CH_FLUX_CHAINS, thermalization=1, sweeps=1),
            ("site_sweep_cx_c128",), CH_FLUX_CHAINS * 2),
        "ising": (functools.partial(
            mt.MC, mt.IsingModel(dims=2, L=L), beta=CH_ISING_BETA,
            n_chains=CH_ISING_CHAINS, seed=CH_SEED, global_moves=True,
            global_rate=2, thermalization=CH_ISING_THERM,
            sweeps=CH_ISING_SWEEPS, device=DEVICE),
            ("ising_sweep", "wolff_step"),
            CH_ISING_CHAINS * (CH_ISING_THERM + CH_ISING_SWEEPS)),
    }


def chains_check(tag, got, ref, kernels, launches, where):
    """Hold a sharded run's result to the one-process run's bit for bit and
    its launches to the session's kernels."""
    from montecarlo_tpu_torch.parallel.launch import differences
    diff = differences(got, ref)
    missing = [k for k in kernels if not launches.get(k)]
    log(f"[chains] {tag} {where}: "
        f"{'bit-identical to one process' if not diff else f'differs at {diff[:8]}'}"
        f"; launches {({k: launches.get(k, 0) for k in kernels})}")
    if diff:
        raise AssertionError(f"{tag} {where} differs from one process at "
                             f"{diff}")
    if missing:
        raise AssertionError(f"{tag} {where} launched no {missing}")


def phase_chains(smi):
    """Phase 9: chain sharding (montecarlo_tpu_torch.parallel). Each
    session once in this process (the reference, timed); (a) the headline
    on a one-rank NCCL mesh here, bit-identical, and cross_chain_mean of its
    occupation (an NCCL all-reduce) equal to the plain sum; (b) every
    session on CH_RANKS ranks of this card over gloo (parallel.launch.spawn:
    the kernels were built in phase 1, which every rank loads), each rank's
    result bit-identical, each session's kernels launched in each rank;
    (c) the wall seconds and chain-sweeps/s of one process and of the
    ranks (two processes sharing one card: not a scaling number). Any
    rank's exception or a mismatch fails the phase."""
    import torch
    import torch.distributed as dist
    from montecarlo_tpu_torch.parallel import chain_mesh, cross_chain_mean
    from montecarlo_tpu_torch.parallel import launch
    sessions = chains_sessions()
    ref, one_s = {}, {}
    for tag, (make, _, _) in sessions.items():
        sim = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(verbose=False)
        torch.cuda.synchronize()
        one_s[tag] = time.perf_counter() - t0
        ref[tag] = launch.session_result(sim)
        del sim
    make, kernels, _ = sessions["headline"]
    read = zero_launches()
    mesh = chain_mesh(device=DEVICE, backend="nccl")
    try:
        got = launch.run_sharded(mesh, make)
        launches = read()
        occ = 1.0 - torch.from_numpy(got["G"]).to(DEVICE).diagonal(
            dim1=-2, dim2=-1).reshape(CHAINS, -1).double()
        mean, plain = cross_chain_mean(occ, mesh), occ.sum(0) / CHAINS
        backend = dist.get_backend(mesh.get_group())
    finally:
        dist.destroy_process_group()
    chains_check("headline", got, ref["headline"], kernels, launches,
                 f"one-rank {backend} mesh")
    if not torch.equal(mean, plain):
        raise AssertionError("cross_chain_mean on one rank differs from the "
                             "plain mean")
    from montecarlo_tpu_torch.ops.site_sweep_cx import plan_layout
    lay = [plan_layout(CH_FLUX_L ** 2, 1, torch.complex128, c)
           for c in (CH_FLUX_CHAINS, CH_FLUX_CHAINS // CH_RANKS)]
    log(f"[chains] flux10_c128's K8-c128 layout: {lay[0].kind} (clusters "
        f"of {lay[0].cs}) at {CH_FLUX_CHAINS} chains in one process, "
        f"{lay[1].kind} (clusters of {lay[1].cs}) at a rank's "
        f"{CH_FLUX_CHAINS // CH_RANKS}")
    jobs = [(launch.run_sharded, (make,)) for make, _, _ in sessions.values()]
    t0 = time.perf_counter()
    ranks = launch.spawn(launch.run_jobs, CH_RANKS, jobs, device=DEVICE,
                         backend="gloo")
    spawn_s = time.perf_counter() - t0
    for i, (tag, (_, kernels, chain_sweeps)) in enumerate(sessions.items()):
        for r, res in enumerate(ranks):
            chains_check(tag, res[i], ref[tag], kernels, res[i]["launches"],
                         f"rank {r} of {CH_RANKS} (gloo, one card)")
        sh = max(res[i]["seconds"] for res in ranks)
        log(f"[chains] {tag}: one process {one_s[tag]:.3f} s = "
            f"{chain_sweeps / one_s[tag]:.1f} chain-sweeps/s; {CH_RANKS} "
            f"ranks on one card {sh:.3f} s = {chain_sweeps / sh:.1f} "
            f"chain-sweeps/s (slowest rank's run; two processes share the "
            f"card: not scaling) ({smi})")
    log(f"[chains] {CH_RANKS} ranks spawned, built, ran and joined in "
        f"{spawn_s:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import_port()
    t0 = time.perf_counter()
    mark = lambda tag: log(f"[time] {tag} done at "
                           f"{time.perf_counter() - t0:.1f} s")
    smi = phase_device()
    phase_build()
    mark("build")
    parity = phase_parity()
    mark("parity")
    sim, launches, _ = phase_slice()
    sim16, launches16, _ = phase_slice(L16, L16_CHAINS, L16_THERM,
                                       L16_SWEEPS, tag="l16")
    simcx, launchescx, _ = phase_slice(therm=CPLX_THERM, sweeps=CPLX_SWEEPS,
                                       tag="complex", complex_=True)
    # the f64 run takes DQMC's default dtype, float64
    sim64, launches64, _ = phase_slice(chains=F64_CHAINS, therm=X_THERM,
                                       sweeps=X_SWEEPS, tag="f64", session={})
    _, launchesmx, _ = phase_slice(
        chains=F64_CHAINS, therm=X_THERM, sweeps=X_SWEEPS, tag="mixed",
        session=dict(update_dtype=torch.float32))
    simcs, launchescs, _ = phase_slice(
        therm=X_THERM, sweeps=X_SWEEPS, tag="colscaled",
        session=dict(dtype=torch.float32, stab_method="qr_colscaled"))
    simrep, launchesrep, _ = phase_slice(therm=REP_THERM, sweeps=REP_SWEEPS,
                                         tag="repulsive", repulsive=True)
    simcx16, launchescx16, _ = phase_slice(
        L16, L16_CHAINS, CPLX_THERM, CPLX_SWEEPS, tag="complex16",
        complex_=True, phase_tol=PHASE_TOL_CX16)
    simch, launchesch, _ = phase_slice(
        CHAIN_L, CHAINS, CPLX_THERM, CPLX_SWEEPS, tag="chain128",
        complex_=True, dims=1)
    simfw, launchesfw, _ = phase_slice(
        therm=X_THERM, sweeps=X_SWEEPS, tag="fusewrap",
        session=dict(dtype=torch.float32, fuse_wrap=True))
    simwy, launcheswy, _ = phase_slice(
        therm=X_THERM, sweeps=X_SWEEPS, tag="colscaled_wy",
        session=dict(dtype=torch.float32, stab_method="qr_colscaled",
                     qr_wy=True))
    _, launches1, _ = phase_slice(chains=1, therm=1, sweeps=1, tag="single",
                                  hold_occ=False)
    mark("runs")
    # the default dtype's float64 and complex128 sessions (session {}):
    # K6-f64, K8-c128, K9-c128, each beside the library QR
    sim16f, launches16f, _ = phase_slice(
        L16, L16_CHAINS, FP64_THERM, FP64_SWEEPS, tag="l16_f64", session={},
        acc_range=F64_ACC_RANGE)
    simcx128, launchescx128, _ = phase_slice(
        therm=FP64_THERM, sweeps=FP64_SWEEPS, tag="complex_c128",
        complex_=True, session={}, no_imag=True)
    simcx16c, launchescx16c, _ = phase_slice(
        L16, L16_CHAINS, FP64_THERM, FP64_SWEEPS, tag="complex16_c128",
        complex_=True, session={}, no_imag=True)
    mark("fp64 runs")
    # item 4's sessions at the default dtype: K6-f64 and K9-c128 on padded
    # G, K8-c128 and K9-c128 at F = 2; each run's first slice visit against
    # the plain path right after it, and its state dropped (the card holds
    # every other run's until phase 5)
    item4 = dict(therm=FP64_THERM, sweeps=FP64_SWEEPS, session={}, smi=smi)
    cx4 = dict(item4, complex_=True, no_imag=True, phase_tol=PHASE_TOL_C128)
    item4_launches = []
    for seed, (L4, chains, tag, kw) in enumerate((
            (15, ITEM4_CHAINS, "l15_f64", item4),
            (14, ITEM4_CHAINS, "flux14_c128", cx4),
            (10, ITEM4_REP10_CHAINS, "rep_flux10_c128",
             dict(cx4, repulsive=True)),
            (L16, ITEM4_CHAINS, "rep_flux16_c128",
             dict(cx4, repulsive=True))), start=34):
        s4, l4, _ = phase_slice(L4, chains, tag=tag, **kw)
        phase_paths_fp64(((s4, seed),))
        item4_launches.append(l4)
        del s4
        torch.cuda.empty_cache()
    launches15, launchesf14, launchesr10, launchesr16 = item4_launches
    mark("item4 runs")
    simref, launchesref = phase_refresh(sim)
    mark("refresh")
    _, launchesrefcx, _ = phase_slice(
        therm=CPLX_THERM, sweeps=CPLX_SWEEPS, tag="refresh_complex",
        complex_=True, session=dict(dtype=torch.float32, g_refresh=True))
    mark("refresh_complex")
    launchescb = phase_checkerboard(sim)
    mark("checkerboard")
    libqr = phase_libqr()
    mark("libqr")
    runs = (launches, launches16, launchescx, launches64, launchesmx,
            launchescs, launchesrep, launchescx16, launchesch, launchesfw,
            launcheswy, launches1, launchesref, launchesrefcx, launchescb,
            launches16f, launchescx128, launchescx16c, launches15,
            launchesf14, launchesr10, launchesr16,
            *(lq for _, lq in libqr.values()))
    launches = {k: sum(r[k] for r in runs) for k in launches}
    # the item 4 runs' site sweeps: rows of their own
    for k, run, kernel in (
            ("site_sweep_delayed_f64_225", launches15,
             "site_sweep_delayed_f64"),
            ("site_sweep_delayed_cx_c128_196", launchesf14,
             "site_sweep_delayed_cx_c128"),
            ("site_sweep_cx_c128_f2_100", launchesr10, "site_sweep_cx_c128"),
            ("site_sweep_delayed_cx_c128_f2", launchesr16,
             "site_sweep_delayed_cx_c128")):
        launches[k] = run[kernel]
        launches[kernel] -= run[kernel]
    # qr_cx's and site_sweep_cx's launches by shape: the chain128 run's at
    # N = 128; the site sweeps' at N = 100: the libqr runs'
    for k in ("qr_cx", "site_sweep_cx"):
        launches[f"{k}_128"] = launchesch[k]
        launches[k] -= launchesch[k]
    for k in ("site_sweep", "site_sweep_f64", "site_sweep_cx"):
        launches[f"{k}_100"] = sum(lq[k] for _, lq in libqr.values())
        launches[k] -= launches[f"{k}_100"]
    phase_paths(sim, sim16, simcx, sim64, simcs, simrep, simcx16, simch,
                simfw, simwy)
    phase_paths_refresh(simref, sim64)
    phase_paths_libqr(libqr)
    phase_paths_fp64(((sim16f, 31), (simcx128, 32), (simcx16c, 33)))
    mark("paths")
    phase_witness(simcx, complex_model())
    mark("witness complex")
    phase_witness(simcx16, complex_model(L=L16), PHASE_TOL_CX16,
                  CX16_WITNESS_CHAINS, plain_c128=False)
    mark("witness complex16")
    phase_witness(libqr["libqr_c64"][0], complex_model(L=LIBQR_L),
                  PHASE_TOL_LIBQR)
    mark("witness libqr complex64")
    launchestd = phase_timedisp(sim)
    for k in launches:
        launches[k] += launchestd.get(k, 0)
    mark("timedisp")
    launchescl = phase_classical(mark)
    for k in launches:
        launches[k] += launchescl.get(k, 0)
    launches9 = phase_item9(mark, smi)
    for k in launches:
        launches[k] += launches9.get(k, 0)
    phase_chains(smi)
    mark("chains")
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], **parity[k])
               for k, (src, rep) in KERNEL_INFO.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
