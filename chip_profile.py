#!/usr/bin/env python3
"""Where the time of one DQMC sweep pair goes, on one NVIDIA GPU.

    python3 chip_profile.py [headline] [l16] [complex] [f64] [mixed]
                            [repulsive] [complex16] [chain128] [colscaled]
                            [fusewrap] [colscaled_wy] [single] [refresh]

Runs each named configuration of chip_smoke.py (default: headline):

  headline  8x8 attractive Hubbard, beta=10, M=100, safe_mult=10, 256
            chains, float32, rank-1 updates (kernels K1-K3)
  l16       16x16 (N=256), the same model and run settings, 64 chains,
            delayed updates in blocks of 32 (kernels K6 and K7)
  complex   the headline model with pure-gauge Peierls phases, safe_mult=5,
            256 chains, complex64 (kernels K8 and K10)
  f64       the headline model in strict float64 (DQMC's default dtype),
            128 chains (kernels K1 in float64 and K11)
  mixed     f64 with float32 updates over the float64 stacks (K1, K11)
  repulsive the repulsive model (F=2) at the headline's settings, 256
            chains, float32 (kernels K5, K2 and K3)
  complex16 the complex configuration at 16x16 (N=256), 64 chains, delay 32
            (kernel K9 and the library complex QR)
  chain128  a 128-site chain with pure-gauge Peierls phases, the complex
            settings, 256 chains (kernels K8 and K10 at N=128)
  colscaled the headline with stab_method="qr_colscaled" (kernels K1, K4)
  fusewrap  the headline with fuse_wrap=True (K13: every slice visit but
            the measurement point's in one launch with its wrap; K1, K2,
            K3)
  colscaled_wy  colscaled with qr_wy=True (K1; K14 with Q assembled
            outside in place of K4)
  single    the headline with one chain (K12, K2, K3)
  refresh   the headline model at safe_mult 5 with g_refresh=True (bench.py's
            refresh row: K1, K2, and K3 at every slice)

Compare a mode with its base configuration in one call (headline fusewrap,
colscaled colscaled_wy): two calls may land on two cards.

    python3 chip_profile.py stamps [K1] [K8] [K6] [K9] [K10] [K7] [K2] [K3]
                                   [K11] [K13] [K1-f64] [K5] [K4] [K14]

instead builds the kernels with -DMC_PHASE_STAMPS (csrc/phase_clock.cuh)
into a build directory of their own and prints where one launch of each
named kernel (default: all) spends its SM clock cycles at chip_smoke.py's
shapes: K1 at (256, 1, 64, 64) on the headline's inputs, K8 at (256, 1,
64, 64) on the complex configuration's and at (256, 1, 128, 128) on
chain128's, K6 and K9 (64 chains of 16x16 real and complex Green's
functions, dk = 32, in the layout cluster_plan picks), K10 at (256, 64,
64) and (256, 128, 128) complex64, K7 at (64, 256, 256) float32, K2
and K3 at (256, 64, 64) float32 (graded, prescaled, pivoted input; K3's
right-hand side random normal), K11 at (128, 64, 64) float64 on the same
kind of input and K13 at (256, 1, 64, 64) in each direction on the
headline's inputs with the session's wrap operands, K1 in float64 at
(128, 1, 64, 64) on the f64 configuration's inputs and K5 at (256, 2, 64,
64) on the repulsive configuration's (and K1 in float32 on the same
inputs beside it), K4 at (256, 64, 64) and (64, 128, 128) and K14 at
(256, 64, 64) and (256, 128, 128) on graded, prescaled, pivoted float32
matrices: the mean over
the launch's blocks of each phase that the kernel stamps, its share, and
its microseconds at the SM clock nvidia-smi reads after the launch, beside
the launch's mean synchronised time.

    python3 chip_profile.py timers [TRACE]

runs the headline through DQMC.run (1 + 2 sweeps) with the timers on
(montecarlo_tpu_torch.utils.timing) under torch.profiler, and prints each
timed section (dqmc_block: one per chunk of sweeps), as the profiler saw its
record_function range, with its wall and the device time of the device
events inside it, then print_timer's tree; the chrome trace, which shows
the sections over the kernels, goes to TRACE (default
chiprun_out/timers_trace.json.gz; gzipped when the name ends in .gz). Each
section is also an NVTX range.

    python3 chip_profile.py ptxas [SOURCE ...]

compiles the named csrc/ sources (default: site_sweep.cu and
site_sweep_cx.cu) as the build does, with -Xptxas -v, and prints what
ptxas reports for each kernel: registers, spill stores and loads, stack
frame and shared memory.

The configurations' runs print for each

  pair     ms per sweep pair and chain-sweeps/s, kernel path then plain path
           (use_kernels=False; not at 16x16 or on the chain, where the plain
           path's per-site launches take tens of seconds per sweep pair)
           then kernel path again, synchronised wall (two pairs each past
           N = 128, five below)
  layer    synchronised wall ms per call of sweep_slice, wrap_up, one
           slice visit as the sweep pair runs it (visit_slice: the sweep and
           wrap_up, or K13), extend_left and calculate_greens at the path's
           shapes
  device   torch.profiler over two kernel-path sweep pairs: device time per
           kernel name (device events only, so no time is counted twice),
           the device busy share of the profiled span, and the device time
           per sweep pair against the unprofiled wall time per sweep pair,
           and the shares of the device time of K1, K2, K3, K4, K6, K7,
           K8, K9, K10, K11, K13, K14, the GEMMs and the library complex QR
           (cuSOLVER's kernels)

with nvidia-smi's name, power limit, SM clock and power draw before and
after. Needs CUDA; builds the kernels like chip_smoke.py.
"""

from __future__ import annotations

import collections
import dataclasses
import subprocess
import sys

import chip_smoke as smoke
from chip_smoke import timed

PAIRS = 5
# the kernels that `stamps` times
STAMPED = ("K1", "K8", "K6", "K9", "K10", "K7", "K2", "K3", "K11", "K13",
           "K1-f64", "K5", "K4", "K14")
# device-time shares printed for every configuration: kernel name fragments
SHARES = {"K1": ("site_sweep_tiled_f32",),
          # K1-f64 and K5 under their former names too, for A/B runs
          # against older checkouts
          "K1-f64": ("site_sweep_tiled_f64", "site_sweep_kernel<double"),
          "K5": ("site_sweep_pair",),
          "K13": ("site_sweep_wrap_kernel",),
          "K2": ("udt_kernel<false",), "K3": ("udt_kernel<true",),
          # K4, K14 and K11 under their former names too (the shared-memory
          # qr_kernel<VTAU>, before it qr_kernel<T, VTAU>), for A/B runs
          # against older checkouts
          "K4": ("qr_f32_kernel<false", "qr_kernel<false>",
                 "qr_kernel<float, false>"),
          "K14": ("qr_f32_kernel<true", "qr_kernel<true>",
                  "qr_kernel<float, true>"),
          "K11": ("qr_f64_kernel", "qr_kernel<double"),
          "GEMMs": ("gemm",),
          "K6": ("site_sweep_delayed_cluster", "site_sweep_delayed_slab"),
          "K9": ("site_sweep_delayed_cx",), "K8": ("site_sweep_tiled_cx",),
          "K10": ("qr_cx_kernel",), "K7": ("qr_blocked_kernel",),
          "library complex QR": ("geqr", "orgqr", "ungqr", "larf",
                                 "cusolver")}
F32 = {"dtype": "float32"}
CS = {**F32, "stab_method": "qr_colscaled"}
# name: (model, safe_mult (None: the conservative mode's,
# validation.REFRESH_SM), chains, time the plain path, DQMC's keywords:
# dtypes by name ({} for the default, float64), the modes)
CONFIGS = {"headline": (smoke.headline_model, smoke.SAFE_MULT, smoke.CHAINS,
                        True, F32),
           "l16": (lambda: smoke.headline_model(L=smoke.L16), smoke.SAFE_MULT,
                   smoke.L16_CHAINS, False, F32),
           "complex": (smoke.complex_model, smoke.CPLX_SM, smoke.CHAINS, True,
                       F32),
           "f64": (smoke.headline_model, smoke.SAFE_MULT, smoke.F64_CHAINS,
                   True, {}),
           "mixed": (smoke.headline_model, smoke.SAFE_MULT, smoke.F64_CHAINS,
                     True, {"update_dtype": "float32"}),
           "repulsive": (lambda: smoke.headline_model(repulsive=True),
                         smoke.SAFE_MULT, smoke.CHAINS, True, F32),
           "complex16": (lambda: smoke.complex_model(L=smoke.L16),
                         smoke.CPLX_SM, smoke.L16_CHAINS, False, F32),
           "chain128": (lambda: smoke.complex_model(L=smoke.CHAIN_L, dims=1),
                        smoke.CPLX_SM, smoke.CHAINS, False, F32),
           "colscaled": (smoke.headline_model, smoke.SAFE_MULT, smoke.CHAINS,
                         True, CS),
           "fusewrap": (smoke.headline_model, smoke.SAFE_MULT, smoke.CHAINS,
                        True, {**F32, "fuse_wrap": True}),
           "colscaled_wy": (smoke.headline_model, smoke.SAFE_MULT,
                            smoke.CHAINS, True, {**CS, "qr_wy": True}),
           "single": (smoke.headline_model, smoke.SAFE_MULT, 1, True, F32),
           "refresh": (smoke.headline_model, None, smoke.CHAINS, True,
                       {**F32, "g_refresh": True})}


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def profile_config(name):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from montecarlo_tpu_torch import DQMC
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.ops.linalg import calculate_greens

    model, safe_mult, chains, plain, session = CONFIGS[name]
    if safe_mult is None:
        from montecarlo_tpu_torch.validation import REFRESH_SM as safe_mult
    session = {k: getattr(torch, v) if k.endswith("dtype") else v
               for k, v in session.items()}
    sim = DQMC(model(), beta=smoke.BETA, delta_tau=smoke.DTAU,
               safe_mult=safe_mult, n_chains=chains, seed=0,
               device=smoke.DEVICE, **session)
    print(f"== {name}: N={sim.ctx.N}, {chains} chains, safe_mult={safe_mult}, "
          f"{str(sim.ctx.dtype)[6:]}, stab {sim.ctx.stab_method}"
          f"{smoke.ab_modes(sim.ctx)}", flush=True)
    ctx, consts = sim.ctx, sim.consts
    holder = {"st": sim.state}

    def pair(c=ctx):
        holder["st"] = core.sweep_pair(c, consts, holder["st"],
                                       generator=sim.generator)[0]

    rate = lambda t: chains / t
    pairs = PAIRS if ctx.N <= 128 else 2
    t_k = timed(pair, pairs)                       # the SM clock ramps up here
    rows = [("kernel path", t_k)]
    if plain:
        rows.append(("plain path", timed(
            lambda: pair(dataclasses.replace(ctx, use_kernels=False)), 1)))
    t_k2 = timed(pair, pairs)
    rows.append(("kernel path again", t_k2))
    for label, t in rows:
        print(f"[pair] {label}: {t * 1e3:.2f} ms per sweep pair = "
              f"{rate(t):.1f} chain-sweeps/s", flush=True)

    st = holder["st"]
    conf = st["conf"]
    sig = conf[:, :, 5].contiguous()
    u = torch.rand(chains, ctx.N, device=smoke.DEVICE, dtype=ctx.urdtype)
    G = st["G"]
    S = [tuple(st[k][:, j] for k in ("S_U", "S_D", "S_T"))
         for j in (1, ctx.n_seg)]
    layer = {
        "sweep_slice": timed(lambda: core.sweep_slice(ctx, G, sig, u), 50),
        "wrap_up": timed(lambda: core.wrap_up(ctx, consts, sig, G), 50),
        "visit_slice": timed(lambda: core.visit_slice(ctx, consts, G, sig, u,
                                                      1), 50),
        "extend_left": timed(lambda: core.extend_left(ctx, consts, conf, 1,
                                                     *S[0]), 20),
        "calculate_greens": timed(lambda: calculate_greens(
            *S[0], *S[1], ctx.use_kernels, ctx.greens_udt_fn), 20),
    }
    print("[layer] wall ms per call: " + ", ".join(
        f"{k} {v * 1e3:.4f}" for k, v in layer.items()))
    slices = 2 * ctx.M * layer["visit_slice"]
    bounds = 2 * ctx.n_seg * (layer["extend_left"] + layer["calculate_greens"])
    print(f"[layer] per sweep pair: {2 * ctx.M} x visit_slice = "
          f"{slices * 1e3:.1f} ms; {2 * ctx.n_seg} x (extend + greens) = "
          f"{bounds * 1e3:.1f} ms", flush=True)

    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            pair()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit("chip_profile: the profiler recorded no device events")
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        per_name[e.name][0] += e.time_range.elapsed_us()
        per_name[e.name][1] += 1
    total_us = sum(v[0] for v in per_name.values())
    span_us = (max(e.time_range.end for e in dev)
               - min(e.time_range.start for e in dev))
    print(f"[device] {n_prof} sweep pairs: device time {total_us / 1e3:.2f} ms "
          f"in {len(dev)} device events over a span of {span_us / 1e3:.2f} ms "
          f"(busy share {total_us / span_us:.3f} under the profiler)")
    for kname, (us, n) in sorted(per_name.items(),
                                 key=lambda kv: -kv[1][0])[:20]:
        print(f"[device] {us / 1e3:9.3f} ms {n:6d}x  {kname[:90]}")
    shares = {label: sum(us for k, (us, _) in per_name.items()
                         if any(f in k.lower() for f in frags)) / total_us
              for label, frags in SHARES.items()}
    print("[device] shares of the device time: " + ", ".join(
        f"{k} {v:.3f}" for k, v in shares.items()))
    per_pair = total_us / 1e3 / n_prof
    print(f"[device] per sweep pair: device {per_pair:.2f} ms against "
          f"{t_k2 * 1e3:.2f} ms unprofiled wall: busy share "
          f"{per_pair / (t_k2 * 1e3):.3f}, idle share "
          f"{1 - per_pair / (t_k2 * 1e3):.3f}")
    print("smi", smi(), flush=True)


def _stamp_rows(readout, blocks):
    """The phase stamps of the last launch's first blocks blocks."""
    import numpy as np
    import torch
    from montecarlo_tpu_torch.ops import _build
    rows = np.zeros((blocks, 8), dtype=np.int64)
    code = getattr(_build.load(), readout + "_stamps")(
        rows.ctypes.data, blocks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(readout + "_stamps", code)
    return rows


def _print_stamps(head, label, rows, names, ms):
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True, check=True, timeout=60).stdout.split()[0])
    total = rows.sum(axis=1)
    print(f"== stamps {head}: {ms:.4f} ms per launch (stamped build), "
          f"SM clock {mhz:.0f} MHz; cycles per block mean {total.mean():.0f}, "
          f"max {total.max()} = {total.max() / mhz:.1f} us", flush=True)
    for p, name in enumerate(names):
        c = rows[:, p]
        print(f"[stamps] {label} phase {p} {name}: mean {c.mean():.0f} "
              f"cycles ({c.mean() / total.mean():.3f} of the block), "
              f"{c.mean() / mhz:.1f} us; min {c.min()}, max {c.max()}")


def qr_input(B, N, complex_):
    """chip_smoke.py's QR input: graded, prescaled, pivoted columns, and
    their power-of-two prescale mx (B,)."""
    import torch
    from montecarlo_tpu_torch.ops.linalg import _prescale_pivot
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(13)
    A = smoke.graded(gen, B, N, dtype=torch.complex64 if complex_ else None)
    Ap, mx, _ = _prescale_pivot(A)
    return Ap.contiguous(), mx.reshape(-1).contiguous()


def stamps(which):
    import torch
    from montecarlo_tpu_torch.ops import _build, qr
    from montecarlo_tpu_torch.ops import qr_blocked as qb
    from montecarlo_tpu_torch.ops import qr_cx as qcx
    from montecarlo_tpu_torch.ops import qr_householder as qh
    from montecarlo_tpu_torch.ops import site_sweep as ss
    from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
    _build.use_defines("-DMC_PHASE_STAMPS")
    # K1 on the headline's inputs, K8 on the complex configuration's and on
    # chain128's: one block per chain
    for label, mod, fn, readout, cx, where in (
            ("K1", ss, ss.site_sweep, "site_sweep_f32", False, {}),
            ("K8", sscx, sscx.site_sweep_cx, "site_sweep_cx_c64", True, {}),
            ("K8", sscx, sscx.site_sweep_cx, "site_sweep_cx_c64", True,
             dict(L=smoke.CHAIN_L, dims=1))):
        if label not in which:
            continue
        G, sigma, u, kw, _ = smoke.sweep_inputs(cx, **where)
        C, F, N, _ = G.shape
        call = lambda: fn(G, sigma, u, **kw)
        ms = 1e3 * timed(call, 20)
        n_acc = int(call()[2].sum())
        _print_stamps(f"{label} {tuple(G.shape)} {str(G.dtype)[6:]}, {n_acc} "
                      f"of {C * N} sites accepted, {C} blocks "
                      f"({mod.layout(N, F)})", label,
                      _stamp_rows(readout, C), mod.PHASES, ms)
    for label, mod, readout, cx in (
            ("K6", ssd, "site_sweep_delayed_f32", False),
            ("K9", ssdcx, "site_sweep_delayed_cx_c64", True)):
        if label not in which:
            continue
        G, sigma, u, kw, ctx, _ = smoke.delayed_inputs(complex_=cx)
        C, F, N, _ = G.shape
        dk = kw["dk"]
        cs = mod.cluster_plan(N, F, dk)
        call = lambda: mod.launch(G, sigma, u, cs, **kw)
        ms = 1e3 * timed(call, 20)
        n_acc = int(call()[2].sum())
        rows = _stamp_rows(readout, C * cs)
        _print_stamps(f"{label} {tuple(G.shape)} {str(G.dtype)[6:]} dk={dk}, "
                      f"{n_acc} of {C * N} sites accepted, {C * cs} blocks "
                      f"({mod.layout(N, F, dk, cs)})", label, rows,
                      mod.PHASES["slab" if cs == 1 else "cluster"], ms)
    for label, mod, fn, readout, shape, cx in (
            ("K10", qcx, qcx.qr_cx, "qr_cx_c64", (256, 64), True),
            ("K10", qcx, qcx.qr_cx, "qr_cx_c64", (256, 128), True),
            ("K7", qb, qb.qr_blocked, "qr_blocked_f32",
             (smoke.L16_CHAINS, smoke.L16 * smoke.L16), False)):
        if label not in which:
            continue
        B, N = shape
        A, _ = qr_input(B, N, cx)
        ms = 1e3 * timed(lambda: fn(A), 20)
        fn(A)
        # K10 runs one block per matrix, K7 a cluster of cluster_plan's
        blocks = B * (1 if cx else qb.cluster_plan(N, B))
        rows = _stamp_rows(readout, blocks)
        _print_stamps(f"{label} ({B}, {N}, {N}) {str(A.dtype)[6:]}, {blocks} "
                      f"blocks", label, rows, mod.PHASES, ms)
    # K2 and K3 at the headline's shape: one block per matrix
    B, N = smoke.CHAINS, smoke.L * smoke.L
    A, mx = qr_input(B, N, False)
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(14)
    Z = torch.randn(B, N, N, generator=gen, device=smoke.DEVICE)
    for label, fn, readout in (
            ("K2", lambda: qr.udt_qr(A, mx), "udt_qr_f32"),
            ("K3", lambda: qr.udt_qr_solve(A, Z, mx), "udt_qr_solve_f32")):
        if label not in which:
            continue
        ms = 1e3 * timed(fn, 20)
        fn()
        _print_stamps(f"{label} ({B}, {N}, {N}) float32, {B} blocks", label,
                      _stamp_rows(readout, B), qr.PHASES, ms)
    # K4 at the colscaled run's shape and at (64, 128, 128), K14 at the
    # colscaled_wy run's and at (256, 128, 128), on graded, prescaled,
    # pivoted float32 input: one block per matrix
    for label, fn, shapes in (("K4", qh.qr_f32, ((256, 64), (64, 128))),
                              ("K14", qh.qr_vtau, ((256, 64), (256, 128)))):
        if label not in which:
            continue
        for B, N in shapes:
            A, _ = qr_input(B, N, False)
            ms = 1e3 * timed(lambda: fn(A), 20)
            fn(A)
            _print_stamps(f"{label} ({B}, {N}, {N}) float32, {B} blocks",
                          label, _stamp_rows("qr_f32", B), qr.PHASES, ms)
    if "K11" in which:
        # the f64 run's shape and input: one block per matrix
        A64 = smoke.qr64_input(torch.Generator(device=smoke.DEVICE)
                               .manual_seed(13))
        B64 = A64.shape[0]
        ms = 1e3 * timed(lambda: qh.qr_f64(A64), 20)
        qh.qr_f64(A64)
        _print_stamps(f"K11 {tuple(A64.shape)} float64, {B64} blocks", "K11",
                      _stamp_rows("qr_f64", B64), qh.PHASES_F64, ms)
    # K1 in float64 at the f64 run's shape and inputs, K5 at the repulsive
    # run's (K1 in float32 beside it on the same inputs): one block per
    # chain; every kernel of csrc/site_sweep.cu stamps into the rows that
    # site_sweep_f32_stamps reads
    for label, head, fn, make in (
            ("K1-f64", "K1-f64", ss.site_sweep_f64, smoke.f64_sweep_inputs),
            ("K5", "K5", ss.site_sweep_pair, smoke.pair_sweep_inputs),
            ("K5", "K1 on K5's inputs", ss.site_sweep,
             smoke.pair_sweep_inputs)):
        if label not in which:
            continue
        G, sigma, u, kw, _ = make()
        C, N = G.shape[0], G.shape[-1]
        call = lambda: fn(G, sigma, u, **kw)
        ms = 1e3 * timed(call, 20)
        n_acc = int(call()[2].sum())
        _print_stamps(f"{head} {tuple(G.shape)} {str(G.dtype)[6:]}, {n_acc} "
                      f"of {C * N} sites accepted, {C} blocks", head,
                      _stamp_rows("site_sweep_f32", C), ss.PHASES, ms)
    if "K13" in which:
        # the fusewrap run's shape, each direction: one block per chain
        G, sigma, u, kw, ops, _, _ = smoke.wrap_inputs()
        C = G.shape[0]
        for d, (Ml, Mr) in ops.items():
            call = lambda: ss.site_sweep_wrap(G, sigma, u, Ml, Mr,
                                              wrap_dir=d, **kw)
            ms = 1e3 * timed(call, 20)
            n_acc = int(call()[2].sum())
            _print_stamps(f"K13 dir={d:+d} {tuple(G.shape)} float32, {n_acc} "
                          f"of {C * G.shape[-1]} sites accepted, {C} blocks",
                          f"K13 dir={d:+d}", _stamp_rows("site_sweep_wrap_f32",
                                                         C),
                          ss.WRAP_PHASES, ms)
    print("smi", smi(), flush=True)


def _demangle(name):
    """name demangled by c++filt where the machine has it."""
    import shutil
    if shutil.which("c++filt") is None:
        return name
    return subprocess.run(["c++filt", name], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def ptxas(names):
    """nvcc -Xptxas -v on csrc/ sources, as _build compiles them; prints the
    resource lines ptxas reports per kernel."""
    import tempfile
    from pathlib import Path
    from montecarlo_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or ("site_sweep.cu", "site_sweep_cx.cu"):
            cmd = _build.compile_command(nvcc, _build.CSRC_DIR / name,
                                         Path(tmp) / "k.o")
            out = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise SystemExit(f"chip_profile: nvcc failed on {name}")
            kernel = None
            for line in out.stderr.splitlines():
                if "Compiling entry function" in line:
                    kernel = _demangle(line.split("'")[1])
                elif kernel and ("registers" in line or "stack frame" in line
                                 or "spill" in line):
                    print(f"[ptxas] {name} {kernel}: "
                          f"{line.split('ptxas info    :')[-1].strip()}")


def timers(trace):
    """The headline through DQMC.run with the timers on, under the
    profiler: each timed section's wall and the device time inside it."""
    import io
    from pathlib import Path
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from montecarlo_tpu_torch.utils import timing
    warm, _ = smoke.item9_session(seed=10)        # builds, first launches
    warm.run(thermalization=1, sweeps=0, verbose=False)
    sim, _ = smoke.item9_session(seed=10)
    timing.reset_timer()
    timing.enable_benchmarks()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.run(thermalization=smoke.ITEM9_THERM,
                    sweeps=smoke.ITEM9_SWEEPS, verbose=False)
            torch.cuda.synchronize()
    finally:
        timing.disable_benchmarks()
    events = prof.events()
    # the profiler also draws each record_function range on the device's
    # timeline (a gpu_user_annotation under the section's name): not work
    names = set(timing.timer_data())
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in names]
    sections = [e for e in events if e.name == "dqmc_block"
                and e.device_type == DeviceType.CPU]
    if not dev or not sections:
        raise SystemExit("chip_profile: the profiler recorded no device "
                         "events or no timed section")
    for i, sec in enumerate(sections):
        r = sec.time_range
        inside = [e for e in dev if r.start <= e.time_range.start
                  and e.time_range.end <= r.end]
        us = sum(e.time_range.elapsed_us() for e in inside)
        print(f"[timers] {sec.name} #{i}: wall {r.elapsed_us() / 1e3:.3f} ms,"
              f" device {us / 1e3:.3f} ms in {len(inside)} device events "
              f"(busy share {us / r.elapsed_us():.3f})")
    buf = io.StringIO()
    timing.print_timer(buf)
    for line in buf.getvalue().splitlines():
        print(f"[timers] print_timer: {line}")
    timing.reset_timer()
    Path(trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f"[timers] chrome trace: {trace}", flush=True)


def main(argv):
    import torch
    if argv[:1] == ["timers"]:
        if not torch.cuda.is_available():
            print("chip_profile: needs one NVIDIA GPU", file=sys.stderr)
            return 1
        smoke.import_port()
        print("smi", smi(), flush=True)
        timers(argv[1] if len(argv) > 1
               else "chiprun_out/timers_trace.json.gz")
        return 0
    if argv[:1] == ["ptxas"]:
        smoke.import_port()
        ptxas(argv[1:])
        return 0
    if argv[:1] == ["stamps"]:
        which = argv[1:] or STAMPED
        unknown = [k for k in which if k not in STAMPED]
        if unknown:
            print(f"chip_profile: no stamps for {unknown}; choose from "
                  f"{STAMPED}", file=sys.stderr)
            return 2
        if not torch.cuda.is_available():
            print("chip_profile: needs one NVIDIA GPU", file=sys.stderr)
            return 1
        smoke.import_port()
        print("smi", smi(), flush=True)
        stamps(which)
        return 0
    names = argv or ["headline"]
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        print(f"chip_profile: unknown configuration {unknown}; choose from "
              f"{sorted(CONFIGS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_profile: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    smoke.import_port()
    print("smi", smi(), flush=True)
    for name in names:
        profile_config(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
