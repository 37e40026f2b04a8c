#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (montecarlo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (the script exits non-zero on the first
failure and prints no result line then):

  1. device   require CUDA; print nvidia-smi's name and power limit
  2. build    compile the CUDA kernels from csrc/ (nvcc, sm_90a)
  3. parity   each kernel against its plain PyTorch version on the card, at
              the shapes of the two simulations below, with both times
  4. slice    DQMC(...).run() through the public entry point at the headline
              configuration (8x8 attractive Hubbard, beta=10, 256 chains,
              float32), counting each kernel's launches during the run
  4b. l16     the same at 16x16 (N=256, 64 chains, delayed updates in
              blocks of 32: kernels K6 and K7)
  5. paths    one sweep_pair on the kernel path and on the plain path
              (use_kernels=False) from the same state and uniforms, at
              the slice's safe_mult=10 and at safe_mult=1; at 16x16 the
              first slice visit of each path

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is nvidia-smi's, and before that a {"kernels": [...]}
line with each kernel's launches, error and times.
"""

from __future__ import annotations

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
# the large-lattice configuration (bench.py's bench_dqmc(lattice_L=16,
# chains=64)): N=256, delay auto = 32
L16, L16_CHAINS, L16_F2_CHAINS, L16_THERM, L16_SWEEPS = 16, 64, 32, 1, 2
TOL_G, TOL_QR, TOL_D = 1e-5, 1e-5, 1e-5
OCC_TOL = 0.02           # |mean occupation - 0.5| at mu = 0
MIN_CONF_AGREE = 0.9
DEVICE = "cuda"

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


def real_state(model, chains, seed, use_kernels):
    """A float32 chain state of the headline configuration on the card."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=SAFE_MULT)
    ctx, consts = core.make_context(model, params, dtype=torch.float32,
                                    device=DEVICE, use_kernels=use_kernels)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    conf = model.rand_conf(gen, chains, params.slices, DEVICE)
    return ctx, consts, core.init_state(ctx, consts, conf), gen


def graded(gen, B, N, decades=16.0):
    """Columns scaled over 2*decades e-folds, as tests/test_pallas_qr.py::
    _graded scales them, of a well-conditioned core I + 0.3 randn / sqrt(N).
    A plain Gaussian core at N=64 has condition numbers up to ~1e4 over 256
    draws, which turns any float32 rounding-order difference into ~1e-3 in
    d (plain float32 against plain float64 on such input: 1.9e-3 on the CPU),
    so the bounds would measure the input instead of the kernel."""
    import torch
    core = (torch.eye(N, device=DEVICE) + 0.3 / math.sqrt(N) * torch.randn(
        B, N, N, generator=gen, device=DEVICE))
    grade = torch.exp((torch.rand(B, N, generator=gen, device=DEVICE) * 2 - 1)
                      * decades)
    return core * grade[:, None, :]


def check_sweep(name, out_k, out_p, shape, relative):
    """Decisions identical, G within TOL_G (times max|G| when relative);
    returns max|dG|."""
    import torch
    torch.cuda.synchronize()
    err = (out_k[0] - out_p[0]).abs().max().item()
    gmax = out_p[0].abs().max().item()
    same = [torch.equal(a.to(b.dtype), b) for a, b in
            zip(out_k[1:], out_p[1:])]
    acc = out_k[2].sum().item() / (shape[0] * shape[-1])
    log(f"[parity] {name} {shape}: sigma/acc/nneg equal {same}, max|dG| "
        f"{err:.3e} (max|G| {gmax:.3g}), acceptance {acc:.3f}")
    if not all(same) or not err <= TOL_G * (gmax if relative else 1.0):
        raise AssertionError(f"{name} kernel disagrees with plain at {shape}")
    return err


def phase_parity():
    """Each kernel against its plain version on the same card inputs."""
    import torch
    from montecarlo_tpu_torch.ops import qr, qr_blocked as qb
    from montecarlo_tpu_torch.ops import site_sweep as ss
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops.linalg import _prescale_pivot
    results = {}

    # ---- K1 at (256, 1, 64, 64) and (128, 2, 64, 64), on real Green's
    # functions (plain-path init_state) and the sweeps' uniform draws
    for repulsive, chains in ((False, CHAINS), (True, K1_F2_CHAINS)):
        model = headline_model(repulsive)
        ctx, _, state, gen = real_state(model, chains, 1, use_kernels=False)
        G = state["G"]
        sigma = state["conf"][:, :, ctx.M - 1].contiguous()
        u = torch.rand(chains, ctx.N, generator=gen, device=DEVICE)
        kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
                  use_boson=ctx.use_boson)
        err = check_sweep("site_sweep", ss.site_sweep(G, sigma, u, **kw),
                          ss.site_sweep_plain(G, sigma, u, **kw),
                          tuple(G.shape), relative=False)
        if not repulsive:
            results["site_sweep"] = dict(
                max_abs_err=err,
                ms=1e3 * timed(lambda: ss.site_sweep(G, sigma, u, **kw), 50),
                plain_ms=1e3 * timed(
                    lambda: ss.site_sweep_plain(G, sigma, u, **kw), 5))

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
        plain_ms=1e3 * timed(lambda: qr.udt_qr_plain(Ap, mx), 5))

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
    results["udt_qr_solve"] = dict(
        max_abs_err=max(eq, ex),
        ms=1e3 * timed(lambda: qr.udt_qr_solve(Ap, Z, mx), 50),
        plain_ms=1e3 * timed(lambda: qr.udt_qr_solve_plain(Ap, Z, mx), 5))

    # ---- K6 at (64, 1, 256, 256) and (32, 2, 256, 256) with dk = 32, and
    # at dk = 1, on real 16x16 Green's functions (plain-path init_state)
    errs = []
    for repulsive, chains in ((False, L16_CHAINS), (True, L16_F2_CHAINS)):
        model = headline_model(repulsive, L16)
        ctx, _, state, gen = real_state(model, chains, 5, use_kernels=False)
        G = state["G"]
        sigma = state["conf"][:, :, ctx.M - 1].contiguous()
        u = torch.rand(chains, ctx.N, generator=gen, device=DEVICE)
        kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
                  use_boson=ctx.use_boson)
        dks = (max(ctx.delay, 1), 1)[:1 if repulsive else 2]
        for dk in dks:
            errs.append(check_sweep(
                f"site_sweep_delayed dk={dk}",
                ssd.site_sweep_delayed(G, sigma, u, dk=dk, **kw),
                ssd.site_sweep_delayed_plain(G, sigma, u, dk=dk, **kw),
                tuple(G.shape), relative=True))
        if not repulsive:
            kw["dk"] = dks[0]
            results["site_sweep_delayed"] = dict(
                ms=1e3 * timed(lambda: ssd.site_sweep_delayed(
                    G, sigma, u, **kw), 20),
                plain_ms=1e3 * timed(lambda: ssd.site_sweep_delayed_plain(
                    G, sigma, u, **kw), 3))
    results["site_sweep_delayed"]["max_abs_err"] = max(errs)

    # ---- K7 at (64, 256, 256) on graded, prescaled, pivoted input
    B, N = L16_CHAINS, L16 * L16
    Ap, _, _ = _prescale_pivot(graded(gen, B, N))
    Ap = Ap.contiguous()
    Qk, Rk = qb.qr_blocked(Ap)
    Qp, Rp = qb.qr_blocked_plain(Ap)
    torch.cuda.synchronize()
    eq = (Qk - Qp).abs().max().item()
    er = (Rk - Rp).abs().max().item()
    rmax = Rp.abs().max().item()
    log(f"[parity] qr_blocked ({B}, {N}, {N}): max|dQ| {eq:.3e}, max|dR| "
        f"{er:.3e} (max|R| {rmax:.3g}), R lower zero "
        f"{bool((torch.tril(Rk, -1) == 0).all())}")
    if not (eq <= TOL_QR * Qp.abs().max().item() and er <= TOL_QR * rmax
            and bool((torch.tril(Rk, -1) == 0).all())):
        raise AssertionError("qr_blocked kernel disagrees with plain")
    results["qr_blocked"] = dict(
        max_abs_err=max(eq, er),
        ms=1e3 * timed(lambda: qb.qr_blocked(Ap), 20),
        plain_ms=1e3 * timed(lambda: qb.qr_blocked_plain(Ap), 3))
    for name, r in results.items():
        log(f"[parity] {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms per call")
    return results


def phase_slice(L=L, chains=CHAINS, therm=THERM, sweeps=SWEEPS, tag="slice"):
    """A simulation through DQMC(...).run(), with launch counts: the
    headline (8x8: K1-K3) or the 16x16 one (K6, K7)."""
    import torch
    from montecarlo_tpu_torch import DQMC
    from montecarlo_tpu_torch.ops import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0
    sim = DQMC(headline_model(L=L), beta=BETA, delta_tau=DTAU,
               safe_mult=SAFE_MULT, n_chains=chains, dtype=torch.float32,
               measure_rate=1, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(thermalization=therm, sweeps=sweeps, verbose=False)
    torch.cuda.synchronize()
    dur = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}

    ctx = sim.ctx
    n_pairs = therm + sweeps
    expected = dict.fromkeys(KERNELS, 0)
    if ctx.N <= 128:
        expected.update(site_sweep=2 * ctx.M * n_pairs,
                        udt_qr=2 * ctx.n_seg * n_pairs + ctx.n_seg,
                        udt_qr_solve=2 * ctx.n_seg * n_pairs + 1)
    else:   # every extend and every Green's recomputation runs one K7
        expected.update(site_sweep_delayed=2 * ctx.M * n_pairs,
                        qr_blocked=4 * ctx.n_seg * n_pairs + ctx.n_seg + 1)
    log(f"[{tag}] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("kernel launch counts differ from the path's")
    if not bool(torch.isfinite(sim.state["G"]).all()):
        raise AssertionError("G has non-finite entries")
    acc = sim.analysis.acc_rate
    occ = float(sim.observables()["occ"]["occ"].mean.mean())
    rate = chains * n_pairs / dur
    log(f"[{tag}] {L}x{L} beta={BETA} M={ctx.M} delay={ctx.delay} {chains} "
        f"chains f32: {n_pairs} sweeps in {dur:.3f} s = {rate:.1f} "
        f"chain-sweeps/s; acceptance {acc:.4f}; occ {occ:.5f}; "
        f"prop_err_max {sim.analysis.propagation_error.max:.3e}, mean "
        f"{sim.analysis.prop_err_mean:.3e}")
    drift = (sim.analysis.propagation_error.max, sim.analysis.prop_err_mean)
    if not all(map(math.isfinite, drift)):
        raise AssertionError(f"propagation drift max/mean {drift} not finite")
    if not 0.05 < acc < 0.95:
        raise AssertionError(f"acceptance {acc} outside (0.05, 0.95)")
    if not abs(occ - 0.5) <= OCC_TOL:
        raise AssertionError(f"occupation {occ} not within 0.5 +- {OCC_TOL}")
    return sim, launches, rate


def compare_paths(ctx_k, consts, state, seed, whole_pair=True):
    """The kernel path against the plain path (use_kernels=False: the plain
    site sweeps, torch.linalg.qr and solve_triangular) from the same state
    and the same uniforms: the decisions of the first slice visit (l = M-1,
    taken from the boundary's freshly recomputed G before any wrap has
    amplified the two paths' rounding differences) and, with whole_pair,
    those of one whole sweep pair."""
    import dataclasses
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.ops.linalg import calculate_greens
    ctx_p = dataclasses.replace(ctx_k, use_kernels=False)
    C, F, N, n = state["conf"].shape[0], ctx_k.F, ctx_k.N, ctx_k.n_seg
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = torch.rand(C, 2 * ctx_k.M, N, generator=gen, device=DEVICE)
    eye = torch.eye(N, device=DEVICE).expand(C, F, N, N)
    ones = torch.ones(C, F, N, device=DEVICE)
    sigma = state["conf"][:, :, -1]
    first, whole = [], []
    for ctx in (ctx_k, ctx_p):
        G = calculate_greens(state["S_U"][:, n], state["S_D"][:, n],
                             state["S_T"][:, n], eye, ones, eye,
                             ctx.use_kernels)
        G = core.wrap_down(ctx, consts, sigma, G)
        first.append(core.sweep_slice(ctx, G, sigma, u[:, 0])[1])
        if whole_pair:
            whole.append(core.sweep_pair(ctx, consts, state, u=u)[0])
    share_first = (first[0] == first[1]).all(1).float().mean().item()
    if not whole_pair:
        log(f"[paths] {int(math.sqrt(N))}x{int(math.sqrt(N))} "
            f"safe_mult={ctx_k.sm} delay={ctx_k.delay}: first slice visit "
            f"agrees in {share_first:.4f} of {C} chains")
        return share_first, None
    sk, sp = whole
    same = (sk["conf"] == sp["conf"]).flatten(1).all(1)
    dG = (sk["G"] - sp["G"]).abs().flatten(1).amax(1)
    drift = {name: (s["prop_err_max"].max().item(),
                    (s["prop_err_sum"].sum() / s["prop_err_n"].sum()).item())
             for name, s in (("kernel", sk), ("plain", sp))}
    log(f"[paths] safe_mult={ctx_k.sm}: first slice visit agrees in "
        f"{share_first:.4f} of {C} chains, the whole sweep pair in "
        f"{same.float().mean().item():.4f}; median max|dG| after it "
        f"{dG.median().item():.3e}; drift max/mean kernel "
        f"{drift['kernel'][0]:.3e}/{drift['kernel'][1]:.3e}, plain "
        f"{drift['plain'][0]:.3e}/{drift['plain'][1]:.3e}")
    return share_first, same.float().mean().item()


def phase_paths(sim, sim16):
    """The kernel path against the plain path.

    At the slice's safe_mult=10 in float32, each 10-slice window of wraps
    amplifies rounding differences to O(1): the drift monitor reads O(1) at
    window ends on both paths (as it did on the TPU for this mode), so two
    float32 paths whose QRs round differently part ways within the first
    window. There the decisions of the first slice visit are held to the
    bound; the whole sweep pair is held to it at safe_mult=1, where G is
    recomputed from the stack at every slice."""
    import torch
    from montecarlo_tpu_torch.dqmc import core
    from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
    first, _ = compare_paths(sim.ctx, sim.consts, sim.state, 3)
    if not first >= MIN_CONF_AGREE:
        raise AssertionError(f"kernel and plain paths agree on the first "
                             f"slice visit in only {first:.3f} of the chains")
    params = DQMCParameters(beta=BETA, delta_tau=DTAU, safe_mult=1)
    ctx1, consts1 = core.make_context(headline_model(), params,
                                      dtype=torch.float32, device=DEVICE)
    state1 = core.init_state(ctx1, consts1, sim.state["conf"])
    _, whole = compare_paths(ctx1, consts1, state1, 4)
    if not whole >= MIN_CONF_AGREE:
        raise AssertionError(f"kernel and plain paths agree in only "
                             f"{whole:.3f} of the chains at safe_mult=1")
    # 16x16: K7 Green's function + K6 against torch.linalg.qr +
    # sweep_slice_delayed
    first, _ = compare_paths(sim16.ctx, sim16.consts, sim16.state, 5,
                             whole_pair=False)
    if not first >= MIN_CONF_AGREE:
        raise AssertionError(f"kernel and plain paths agree on the first "
                             f"16x16 slice visit in only {first:.3f} of the "
                             "chains")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import_port()
    smi = phase_device()
    phase_build()
    parity = phase_parity()
    sim, launches, _ = phase_slice()
    sim16, launches16, _ = phase_slice(L16, L16_CHAINS, L16_THERM,
                                       L16_SWEEPS, tag="l16")
    launches = {k: launches[k] + launches16[k] for k in launches}
    phase_paths(sim, sim16)
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
