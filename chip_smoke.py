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
              plan's ([layouts] lines)
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
              safe_mult=1
  5b. phase   a second witness for the phase statistics of the complex and
              the complex16 runs (complex16: its first 16 chains): one sweep
              pair from each run's final configuration with the same
              uniforms on the kernel path, the kernel path over complex128
              stacks, the plain path and the plain path in complex128, each
              with its imaginary-probability count, max |Im det|, drift and
              <s>

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
accumulated backward) over the FP32 (FP64 for the float64 kernels) rate
outside the tensor cores, the published peaks of one H100 SXM (NVIDIA's
data sheet: 3.35 TB/s, 67 TFLOP/s FP32, 34 TFLOP/s FP64).
"""

from __future__ import annotations

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
DEVICE = "cuda"
# published peaks of one H100 SXM (dense): HBM bytes/s, FP32 and FP64
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOP_PER_S, FP64_FLOP_PER_S = 3.35e12, 67e12, 34e12

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


def device_ms(fn, reps=20, tries=3):
    """Mean device time per call of fn() in ms: the device events of reps
    calls under torch.profiler, summed (no host time between launches);
    None where the profiler recorded no device event in tries attempts (it
    now and then returns an empty trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    return None


def ms_text(ms):
    """A time in ms for a log line, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    so its slab work is not counted). fp64: G and u in float64. wrap (K13):
    the two (N, N) wrap operands read once, and the wrap's two products,
    4 N^3 operations per flavor block."""
    el = 8 if complex_ or fp64 else 4
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
    """The A/B modes a session runs, each with a leading space: " fuse_wrap",
    " qr_wy", both or none."""
    return "".join(f" {m}" for m in ("fuse_wrap", "qr_wy") if getattr(ctx, m))


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

    parity_delayed(results)
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
    where = ssdcx.layout(ctx.N, ctx.F, kw["dk"])
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


def time_layouts(mod, G, sigma, u, kw):
    """Every layout of K6 or K9 (mod) that fits this shape, held against the
    layout cluster_plan picks (decisions identical, G within TOL_G of its
    largest entry) and timed; returns the largest max|dG|."""
    import torch
    C, F, N, _ = G.shape
    dk = kw["dk"]
    plan = mod.cluster_plan(N, F, dk)
    ref = mod.launch(G, sigma, u, plan, **kw)
    worst, times = 0.0, []
    for cs in (*mod.CLUSTER_SIZES, 1):
        if not mod.fits(N, F, dk, cs):
            continue
        out = mod.launch(G, sigma, u, cs, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out[1:], ref[1:])):
            raise AssertionError(f"{mod.__name__}: {cs} blocks per chain "
                                 f"decide otherwise than {plan}")
        worst = max(worst, (out[0] - ref[0]).abs().max().item())
        at_once = (f", {mod.max_clusters(F, N, dk, cs)} clusters at once"
                   if cs > 1 else "")
        ms = 1e3 * timed(lambda: mod.launch(G, sigma, u, cs, **kw), 20)
        times.append(f"CS={cs} {ms:.4f} ms{at_once}")
    name = mod.__name__.rsplit(".", 1)[-1]
    log(f"[layouts] {name} {tuple(G.shape)} dk={dk}, cluster_plan CS={plan}: "
        + "; ".join(times) + f"; max|dG| against the plan's {worst:.3e}")
    if worst > TOL_G * ref[0].abs().max().item():
        raise AssertionError(f"{name}: the layouts' G disagree")
    return worst


def sweep_kernel(ctx, chains):
    """The site-sweep kernel a session's main path launches (besides K13
    under fuse_wrap): K8 for complex G (K9 past N = 128), K6 past N = 128,
    K1 in float64 for float64 updates, K5 for float32 updates with F >= 2
    at even N, else K1 (K12 for one chain)."""
    import torch
    if ctx.is_complex:
        return "site_sweep_cx" if ctx.N <= 128 else "site_sweep_delayed_cx"
    if ctx.N > 128:
        return "site_sweep_delayed"
    if ctx.udtype == torch.float64:
        return "site_sweep_f64"
    if ctx.F >= 2 and ctx.N % 2 == 0:
        return "site_sweep_pair"
    return "site_sweep_single" if chains == 1 else "site_sweep"


def phase_slice(L=L, chains=CHAINS, therm=THERM, sweeps=SWEEPS, tag="slice",
                complex_=False, session=None, repulsive=False, dims=2,
                phase_tol=PHASE_TOL, hold_occ=True):
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
    held to its anchors (``repulsive_anchors``)."""
    import torch
    from montecarlo_tpu_torch import (DQMC, magnetization,
                                      spin_density_correlation)
    from montecarlo_tpu_torch.ops import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0
    session = dict(dtype=torch.float32) if session is None else session
    model = (complex_model(L=L, dims=dims) if complex_
             else headline_model(repulsive=repulsive, L=L))
    sim = DQMC(model, beta=BETA, delta_tau=DTAU,
               safe_mult=CPLX_SM if complex_ else SAFE_MULT, n_chains=chains,
               measure_rate=1, seed=0, device=DEVICE, **session)
    if repulsive:
        sim["sdc_z"] = spin_density_correlation(sim, model, "z")
        sim["m_z"] = magnetization(sim, model, "z")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(thermalization=therm, sweeps=sweeps, verbose=False)
    torch.cuda.synchronize()
    dur = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}

    ctx = sim.ctx
    n_pairs = therm + sweeps
    expected = dict.fromkeys(KERNELS, 0)
    # one site sweep per slice visit (under fuse_wrap K13 for every visit
    # but the measurement point's); every extend and Green's recomputation
    # runs one unfused QR (or, fused, one K2 per extend and one K3 per
    # recomputation)
    if ctx.fuse_wrap:
        expected["site_sweep_wrap"] = (2 * ctx.M - 1) * n_pairs
        expected[sweep_kernel(ctx, chains)] = n_pairs
    else:
        expected[sweep_kernel(ctx, chains)] = 2 * ctx.M * n_pairs
    n_qr = 4 * ctx.n_seg * n_pairs + ctx.n_seg + 1
    if ctx.is_complex:       # past N = 128 the library QR, as the JAX package
        expected.update(qr_cx=n_qr if ctx.N <= 128 else 0)
    elif ctx.dtype == torch.float64:
        expected.update(qr_f64=n_qr)
    elif ctx.stab_method == "qr_colscaled":
        expected["qr_vtau" if ctx.qr_wy else "qr_f32"] = n_qr
    elif ctx.N <= 128:
        expected.update(udt_qr=2 * ctx.n_seg * n_pairs + ctx.n_seg,
                        udt_qr_solve=2 * ctx.n_seg * n_pairs + 1)
    else:
        expected.update(qr_blocked=n_qr)
    log(f"[{tag}] launches {launches}, expected {expected}")
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
        f"chain-sweeps/s; acceptance {acc:.4f}; occ {occ:.5f}; "
        f"prop_err_max {sim.analysis.propagation_error.max:.3e}, mean "
        f"{sim.analysis.prop_err_mean:.3e}")
    drift = (sim.analysis.propagation_error.max, sim.analysis.prop_err_mean)
    if not all(map(math.isfinite, drift)):
        raise AssertionError(f"propagation drift max/mean {drift} not finite")
    if ctx.udtype == torch.float64 and not drift[0] < F64_DRIFT_MAX:
        raise AssertionError(f"float64 drift max {drift[0]} not below "
                             f"bench.py's {F64_DRIFT_MAX}")
    if not 0.05 < acc < 0.95:
        raise AssertionError(f"acceptance {acc} outside (0.05, 0.95)")
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
    return sim, launches, rate


def repulsive_anchors(sim, tag):
    """The repulsive run's physics at half filling: each flavor's
    occupation 0.5, the mean z magnetization 0 (spin symmetry), the local
    moment (the distance-0 bin of the z spin correlation, <(n_up -
    n_dn)^2>) above its U=0 value 0.5. The nearest-neighbor z correlation
    and the negative-detratio count are printed, not held: three sweeps
    need not show antiferromagnetic order, and at half filling the exact
    detratio is >= 0."""
    import numpy as np
    obs = sim.observables()
    occ_f = np.mean(obs["occ"]["occ"].mean, axis=-1)          # (F,)
    mz = float(np.mean(obs["m_z"]["m_z"].mean))
    sdc = obs["sdc_z"]["sdc_z"].mean                           # (n_dirs,)
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


def phase_witness(simcx, model, phase_tol=PHASE_TOL, chains=None):
    """One complex sweep pair at safe_mult=5 from a complex run's final
    configuration (its first chains, where given; the complex run: K8, K10;
    complex16: K9, the library QR), with the same uniforms, on the kernel
    path, the kernel path with complex128 stacks (the site sweep kernel and
    the wraps in complex64, the QR and the Green's recomputation in
    complex128), the plain path (use_kernels=False) and the plain path in
    complex128, each from its own fresh init_state. A pure gauge keeps
    every weight real, so in complex128 no proposal may count as an
    imaginary probability and the running phase must stay 1 to 1e-9: what
    the complex64 paths read there is float32 rounding, which the kernel
    and the plain path must read alike. The complex128 stacks tell the
    rounding of the stabilization (QR, recomputation) from that of the
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
    out = {}
    for name, session, use_kernels in (
            ("kernel complex64", dict(dtype=f32), True),
            ("kernel complex64 over complex128 stacks",
             dict(dtype=f64, update_dtype=f32), True),
            ("plain complex64", dict(dtype=f32), False),
            ("plain complex128", dict(dtype=f64), False)):
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
        out[name] = r
        torch.cuda.synchronize()
        log(f"[phase] N={N} {name} ({time.perf_counter() - t0:.1f} s): "
            f"imaginary probabilities {n_imag} of "
            f"{C * 2 * M * N} proposals ({r['share']:.4f}), max |Im det| "
            f"{r['imag_max']:.3e}; drift max/mean {r['drift_max']:.3e}/"
            f"{r['drift_mean']:.3e}; |<s> - 1| {r['s_dev']:.3e} over "
            f"{C} chains, |phase - 1| max {r['chain_dev']:.3e}, mean "
            f"{r['chain_mean']:.3e} over chains; acceptance {r['acc']:.4f}")
    k, x, p, d = (out[n] for n in (
        "kernel complex64", "kernel complex64 over complex128 stacks",
        "plain complex64", "plain complex128"))
    if not (d["share"] == 0 and d["s_dev"] < 1e-9 and d["chain_dev"] < 1e-9):
        raise AssertionError("complex128 plain path reads a non-real weight "
                             "for a pure gauge")
    if not all(r["s_dev"] < phase_tol for r in (k, x, p)):
        raise AssertionError(f"<s> off 1 by {k['s_dev']} (kernel), "
                             f"{x['s_dev']} (kernel over complex128 stacks), "
                             f"{p['s_dev']} (plain), bound {phase_tol}")
    if not k["share"] <= IMAG_SHARE_RATIO * p["share"]:
        raise AssertionError(f"kernel path's imaginary-probability share "
                             f"{k['share']} above {IMAG_SHARE_RATIO} times "
                             f"the plain path's {p['share']}")


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
    runs = (launches, launches16, launchescx, launches64, launchesmx,
            launchescs, launchesrep, launchescx16, launchesch, launchesfw,
            launcheswy, launches1)
    launches = {k: sum(r[k] for r in runs) for k in launches}
    # qr_cx's and site_sweep_cx's launches by shape: the chain128 run's at
    # N = 128
    for k in ("qr_cx", "site_sweep_cx"):
        launches[f"{k}_128"] = launchesch[k]
        launches[k] -= launchesch[k]
    phase_paths(sim, sim16, simcx, sim64, simcs, simrep, simcx16, simch,
                simfw, simwy)
    mark("paths")
    phase_witness(simcx, complex_model())
    mark("witness complex")
    phase_witness(simcx16, complex_model(L=L16), PHASE_TOL_CX16,
                  CX16_WITNESS_CHAINS)
    mark("witness complex16")
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
