#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port in turns, on one NVIDIA GPU.

    python3 chip_ab.py PARENT CHANGE [CASE ...]

PARENT and CHANGE are directories that each hold a checkout of the repo (for
example the parent commit unpacked with ``git archive`` into a git-ignored
directory, and ``.``). For each in the order PARENT, CHANGE, CHANGE, PARENT,
a child process imports montecarlo_tpu_torch from that checkout (building
its kernels there) and prints the median synchronised time per call of
each case in CASES (or those whose names start with one of the CASE
arguments), and its device time per call under torch.profiler (the
kernels alone, where the host's launches are slower than the card); the
turns cancel a drift of the card's clock between the first run and the
last. Prints nvidia-smi's name and power limit, one
JSON line per run and a summary per case, with whether the change's
outputs are bit-equal to the parent's on the same inputs (and their
largest difference). Needs CUDA.

  qr_cx (256, 64, 64)    the complex QR K10 on 256 complex64 matrices,
  qr_cx (256, 128, 128)  random normal columns graded over 8 decades
  qr_blocked (64, 256, 256)  the blocked QR K7 on 64 float32 matrices of
                       the same kind
  site_sweep_delayed (64, 1, 256, 256)     K6 and K9 on chip_smoke.py's
  site_sweep_delayed_cx (64, 1, 256, 256)  inputs (the 16x16 and complex16
                       configurations' Green's functions, dk = 32), made by
                       this checkout's chip_smoke.py from each checkout's
                       port
  site_sweep_delayed_f64 (64, 1, 225, 225)      K6-f64 at dk = 1 and
  site_sweep_delayed_cx_c128 (64, 1, 196, 196)  K9-c128 at dk = 1 and at
  site_sweep_delayed_cx_c128 (64, 2, 256, 256)  F = 2, dk = 32 on the
                       l15_f64, flux14_c128 and rep_flux16_c128 runs'
                       inputs (chip_smoke.py's fp64_run_inputs), in the
                       layout each checkout's plan picks
  site_sweep_delayed_cx_c128 (64, 2, 196, 196)  K9-c128 at F = 2, dk = 1
                       (the repulsive 14x14 in a flux, rep_flux14_c128)
  site_sweep_delayed_f64 (64, 2, 144, 144)  K6-f64 at F = 2, dk = 1 (the
                       repulsive 12x12 in float64, the rank-1 layout in
                       clusters of 4)
  site_sweep_delayed_f64 (16, 1, 225, 225)      the same four shapes at
  site_sweep_delayed_cx_c128 (16, 1, 196, 196)  16 chains, DQMC's
  site_sweep_delayed_cx_c128 (16, 2, 256, 256)  default chain count
  site_sweep_delayed_cx_c128 (16, 2, 196, 196)
  site_sweep (256, 1, 64, 64)       K1 on the headline's inputs, K8 on the
  site_sweep_cx (256, 1, 64, 64)    complex configuration's and on
  site_sweep_cx (256, 1, 128, 128)  chain128's, made the same way
  site_sweep_cx_c128 (256, 2, 100, 100)  K8-c128 on chip_smoke.py's
  site_sweep_cx_c128 (64, 2, 128, 128)   k8_c128_inputs: rep_flux10_c128,
  site_sweep_cx_c128 (256, 1, 100, 100)  the repulsive 128-site ring, the
  site_sweep_cx_c128 (256, 1, 128, 128)  attractive 10x10 and chain128
  site_sweep_cx_c128 (256, 1, 64, 64)    in complex128, and the complex
  site_sweep_cx_c128 (256, 2, 64, 64)    row's 8x8 at F = 1 and 2, in the
                       layout each checkout's plan picks
  udt_qr (256, 64, 64)        the fused UDT K2 and K3 at the headline's
  udt_qr_solve (256, 64, 64)  shape and at the repulsive model's (B = 512:
  udt_qr (512, 64, 64)        two flavors), on chip_smoke.py's graded,
  udt_qr_solve (512, 64, 64)  prescaled, pivoted float32 matrices (K3's
                       right-hand side random normal)
  qr_f64 (128, 64, 64)  the float64 QR K11 at the f64 run's shape, on
                       chip_smoke.py's graded, prescaled, pivoted float64
                       matrices
  qr_f32 (256, 64, 64)     the float32 QR K4 at the colscaled run's shape
  qr_f32 (64, 128, 128)    and at N = 128, and K14 (V, tau and R) at the
  qr_vtau (256, 64, 64)    colscaled_wy run's shape and at N = 128, on
  qr_vtau (256, 128, 128)  chip_smoke.py's graded, prescaled, pivoted
                       float32 matrices
  site_sweep_wrap up (256, 1, 64, 64)    K13 in each direction on the
  site_sweep_wrap down (256, 1, 64, 64)  headline's inputs with the
                       session's wrap operands (chip_smoke.py's
                       wrap_inputs)
  site_sweep_f64 (128, 1, 64, 64)  K1 in float64 at the f64 run's shape
  site_sweep_f64 (64, 2, 64, 64)   and at F = 2 (chip_smoke.py's
                       f64_sweep_inputs)
  site_sweep_pair (256, 2, 64, 64)          K5 at the repulsive run's shape
  site_sweep_pair (256, 1, 64, 64)          and at F = 1, and K1 on the
  site_sweep on K5's inputs (256, 2, 64, 64)  same inputs (chip_smoke.py's
  site_sweep on K5's inputs (256, 1, 64, 64)  pair_sweep_inputs)

  ising_sweep (262144, 64)       K17 at bench.py's ising_flips shape (the
  ising_sweep (4096, 9)          8x8), at the 3x3 (four color classes), on
  ising_sweep (4096, 64) z=6     the cubic L = 4 and at the 32x32, on
  ising_sweep (4096, 1024)       uniforms and spins from a seeded generator
  wolff_move (4096, 64)          one Wolff move of chip_smoke.py's Wolff run
                       (4096 chains of the 8x8 at beta = 1/IsingTc, 20 sweeps
                       in), the same move at every call (the session's
                       generator reset first), through the checkout's own
                       MC session and move function: wall and device ms a
                       move, and the host synchronizations of one move
                       (torch's sync debug mode)

The prefix site_sweep selects every site-sweep case; site_sweep_f64,
site_sweep_pair and "site_sweep on" select those of K1-f64, K5 and K1
beside K5.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

BATCHES, CALLS = 7, 50


def _qr(B, N, complex_):
    def make():
        import torch
        from montecarlo_tpu_torch.ops import qr_blocked as qb
        from montecarlo_tpu_torch.ops import qr_cx as qcx
        gen = torch.Generator(device="cuda").manual_seed(0)
        A = torch.randn(B, N, N, generator=gen, device="cuda",
                        dtype=torch.complex64 if complex_ else torch.float32)
        A = A * torch.logspace(0, -8, N, device="cuda")[None, None, :]
        fn = qcx.qr_cx if complex_ else qb.qr_blocked
        return lambda: fn(A)
    return make


def _smoke():
    """chip_smoke.py of this checkout (the directory of this script), whose
    helpers drive whichever port was imported first."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", Path(__file__).resolve().parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(complex_, **where):
    def make():
        from montecarlo_tpu_torch.ops import site_sweep as ss
        from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
        G, sigma, u, kw, _ = _smoke().sweep_inputs(complex_, **where)
        fn = sscx.site_sweep_cx if complex_ else ss.site_sweep
        return lambda: fn(G, sigma, u, **kw)
    return make


def _k8_c128(case):
    def make():
        from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
        G, sigma, u, kw, _ = _smoke().k8_c128_inputs(case)
        return lambda: sscx.site_sweep_cx_c128(G, sigma, u, **kw)
    return make


def _f64_sweep(repulsive, chains):
    def make():
        from montecarlo_tpu_torch.ops import site_sweep as ss
        G, sigma, u, kw, _ = _smoke().f64_sweep_inputs(repulsive, chains)
        return lambda: ss.site_sweep_f64(G, sigma, u, **kw)
    return make


def _pair_sweep(repulsive, pair):
    """K5 (pair) or K1 on K5's inputs."""
    def make():
        from montecarlo_tpu_torch.ops import site_sweep as ss
        G, sigma, u, kw, _ = _smoke().pair_sweep_inputs(repulsive)
        fn = ss.site_sweep_pair if pair else ss.site_sweep
        return lambda: fn(G, sigma, u, **kw)
    return make


def _delayed(complex_):
    def make():
        from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
        from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
        G, sigma, u, kw, _, _ = _smoke().delayed_inputs(complex_=complex_)
        fn = (ssdcx.site_sweep_delayed_cx if complex_
              else ssd.site_sweep_delayed)
        return lambda: fn(G, sigma, u, **kw)
    return make


def _fp64_run(run, chains=64):
    """K6-f64 or K9-c128 on phase 3's inputs of an item 4 run
    (chip_smoke.py's fp64_run_inputs) at chains chains, through the
    wrapper: the layout the checkout's plan picks."""
    def make():
        import torch
        from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
        from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
        G, sigma, u, kw, _ = _smoke().fp64_run_inputs(run, chains)
        fn = (ssd.site_sweep_delayed_f64 if G.dtype == torch.float64
              else ssdcx.site_sweep_delayed_cx_c128)
        return lambda: fn(G, sigma, u, **kw)
    return make


def _f64_rep12():
    """K6-f64 at F = 2, dk = 1 on the repulsive 12x12's float64 inputs
    (chip_smoke.py's slice_inputs), through the wrapper."""
    def make():
        import torch
        from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
        smoke = _smoke()
        G, sigma, u, kw, _ = smoke.slice_inputs(
            smoke.headline_model(True, 12), 64, 44, dtype=torch.float64)
        return lambda: ssd.site_sweep_delayed_f64(G, sigma, u, dk=1, **kw)
    return make


def _udt(B, solve):
    def make():
        import torch
        from montecarlo_tpu_torch.ops import qr
        from montecarlo_tpu_torch.ops.linalg import _prescale_pivot
        smoke = _smoke()
        gen = torch.Generator(device="cuda").manual_seed(2)
        N = smoke.L * smoke.L
        Ap, mx, _ = _prescale_pivot(smoke.graded(gen, B, N))
        Ap, mx = Ap.contiguous(), mx.reshape(-1).contiguous()
        if not solve:
            return lambda: qr.udt_qr(Ap, mx)
        Z = torch.randn(B, N, N, generator=gen, device="cuda")
        return lambda: qr.udt_qr_solve(Ap, Z, mx)
    return make


def _qr64():
    def make():
        import torch
        from montecarlo_tpu_torch.ops import qr_householder as qh
        A = _smoke().qr64_input(torch.Generator(device="cuda").manual_seed(2))
        return lambda: qh.qr_f64(A)
    return make


def _qr32(B, N, vtau):
    """K4 (vtau: K14) on chip_smoke.py's graded, prescaled, pivoted float32
    matrices."""
    def make():
        import torch
        from montecarlo_tpu_torch.ops import qr_householder as qh
        from montecarlo_tpu_torch.ops.linalg import _prescale_pivot
        gen = torch.Generator(device="cuda").manual_seed(2)
        Ap, _, _ = _prescale_pivot(_smoke().graded(gen, B, N))
        Ap = Ap.contiguous()
        fn = qh.qr_vtau if vtau else qh.qr_f32
        return lambda: fn(Ap)
    return make


def _wrap(direction):
    def make():
        from montecarlo_tpu_torch.ops import site_sweep as ss
        G, sigma, u, kw, ops, _, _ = _smoke().wrap_inputs()
        Ml, Mr = ops[direction]
        return lambda: ss.site_sweep_wrap(G, sigma, u, Ml, Mr,
                                          wrap_dir=direction, **kw)
    return make


def _ising(C, dims, L):
    """K17 on uniforms and spins from a seeded generator."""
    def make():
        import torch
        import montecarlo_tpu_torch as mt
        from montecarlo_tpu_torch.ops import ising as kis
        model = mt.IsingModel(dims=dims, L=L)
        gen = torch.Generator(device="cuda").manual_seed(17)
        tabs = kis.make_tables(model.lattice, 0.44, "cuda")
        conf = model.rand_conf(gen, C, "cuda")
        u = torch.rand(C, tabs.N, generator=gen, device="cuda",
                       dtype=torch.float64)
        acc = torch.zeros(C, dtype=torch.int64, device="cuda")
        return lambda: kis.ising_sweep(conf, u, tabs, acc.zero_())
    return make


def _wolff_move():
    """One Wolff move of chip_smoke.py's Wolff run 20 sweeps in, the same
    move at every call, through the checkout's own MC session: its move
    function and level draws (one draw per level on the parent, a batch of
    levels handed back in part on a checkout with _level_uniforms)."""
    def make():
        import montecarlo_tpu_torch as mt
        sim = mt.MC(mt.IsingModel(dims=2, L=8), beta=1.0 / mt.IsingTc,
                    n_chains=4096, seed=1, global_moves=True, global_rate=2,
                    device="cuda")
        sim.run(thermalization=20, sweeps=0, verbose=False)
        _, move = sim._moves()
        C, N = sim.conf.shape
        z = sim.model.lattice.coordination
        if hasattr(sim, "_level_uniforms"):
            draw = lambda k: sim._level_uniforms((C, N, z), k)
        else:
            draw = lambda: sim._uniforms((C, N, z))
        state = sim.generator.get_state()

        def fn():
            sim.generator.set_state(state)
            flipped, size, _ = move(sim.conf, sim._seed_sites(N), draw)
            return flipped, size

        fn.count_syncs = True
        return fn
    return make


CASES = {"qr_cx (256, 64, 64)": _qr(256, 64, True),
         "qr_cx (256, 128, 128)": _qr(256, 128, True),
         "qr_blocked (64, 256, 256)": _qr(64, 256, False),
         "site_sweep_delayed (64, 1, 256, 256)": _delayed(False),
         "site_sweep_delayed_cx (64, 1, 256, 256)": _delayed(True),
         "site_sweep_delayed_f64 (64, 1, 225, 225)": _fp64_run("l15_f64"),
         "site_sweep_delayed_cx_c128 (64, 1, 196, 196)":
             _fp64_run("flux14_c128"),
         "site_sweep_delayed_cx_c128 (64, 2, 256, 256)":
             _fp64_run("rep_flux16_c128"),
         "site_sweep_delayed_cx_c128 (64, 2, 196, 196)":
             _fp64_run("rep_flux14_c128"),
         "site_sweep_delayed_f64 (64, 2, 144, 144)": _f64_rep12(),
         "site_sweep_delayed_f64 (16, 1, 225, 225)": _fp64_run("l15_f64", 16),
         "site_sweep_delayed_cx_c128 (16, 1, 196, 196)":
             _fp64_run("flux14_c128", 16),
         "site_sweep_delayed_cx_c128 (16, 2, 256, 256)":
             _fp64_run("rep_flux16_c128", 16),
         "site_sweep_delayed_cx_c128 (16, 2, 196, 196)":
             _fp64_run("rep_flux14_c128", 16),
         "site_sweep (256, 1, 64, 64)": _sweep(False),
         "site_sweep_cx (256, 1, 64, 64)": _sweep(True),
         "site_sweep_cx (256, 1, 128, 128)": _sweep(True, L=128, dims=1),
         "site_sweep_cx_c128 (256, 2, 100, 100)": _k8_c128("rep_flux10_c128"),
         "site_sweep_cx_c128 (64, 2, 128, 128)":
             _k8_c128("rep_chain128_c128"),
         "site_sweep_cx_c128 (256, 1, 100, 100)": _k8_c128("flux10_c128"),
         "site_sweep_cx_c128 (256, 1, 128, 128)": _k8_c128("chain128_c128"),
         "site_sweep_cx_c128 (256, 1, 64, 64)": _k8_c128("complex_c128"),
         "site_sweep_cx_c128 (256, 2, 64, 64)": _k8_c128("rep_complex_c128"),
         "udt_qr (256, 64, 64)": _udt(256, False),
         "udt_qr_solve (256, 64, 64)": _udt(256, True),
         "udt_qr (512, 64, 64)": _udt(512, False),
         "udt_qr_solve (512, 64, 64)": _udt(512, True),
         "qr_f64 (128, 64, 64)": _qr64(),
         "qr_f32 (256, 64, 64)": _qr32(256, 64, False),
         "qr_f32 (64, 128, 128)": _qr32(64, 128, False),
         "qr_vtau (256, 64, 64)": _qr32(256, 64, True),
         "qr_vtau (256, 128, 128)": _qr32(256, 128, True),
         "site_sweep_wrap up (256, 1, 64, 64)": _wrap(1),
         "site_sweep_wrap down (256, 1, 64, 64)": _wrap(-1),
         "site_sweep_f64 (128, 1, 64, 64)": _f64_sweep(False, 128),
         "site_sweep_f64 (64, 2, 64, 64)": _f64_sweep(True, 64),
         "site_sweep_pair (256, 2, 64, 64)": _pair_sweep(True, True),
         "site_sweep_pair (256, 1, 64, 64)": _pair_sweep(False, True),
         "site_sweep on K5's inputs (256, 2, 64, 64)": _pair_sweep(True,
                                                                   False),
         "site_sweep on K5's inputs (256, 1, 64, 64)": _pair_sweep(False,
                                                                   False),
         "ising_sweep (262144, 64)": _ising(262144, 2, 8),
         "ising_sweep (4096, 9)": _ising(4096, 2, 3),
         "ising_sweep (4096, 64) z=6": _ising(4096, 3, 4),
         "ising_sweep (4096, 1024)": _ising(4096, 2, 32),
         "wolff_move (4096, 64)": _wolff_move()}


def selected(prefixes):
    """The names of CASES that start with one of prefixes (all without)."""
    return [n for n in CASES
            if not prefixes or any(n.startswith(p) for p in prefixes)]


def compare_outputs(a, b):
    """(bit-equal, max|a - b| over the floating-point outputs) of two lists
    of output tensors of one case."""
    import torch
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    diff = max((float((x.double() - y.double()).abs().max())
                for x, y in zip(a, b)
                if x.is_floating_point() and x.shape == y.shape
                and x.numel()), default=0.0)
    return same, diff


def child(root, save, prefixes):
    """Import the port from root, time the selected cases there and save
    each case's outputs (a list of CPU tensors) to the file save."""
    import torch
    sys.path.insert(0, str(root))
    import montecarlo_tpu_torch
    where = Path(montecarlo_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise SystemExit(f"chip_ab: imported {where}, not from {root}")
    outputs = {}
    for name in selected(prefixes):
        make = CASES[name]
        fn = make()
        for _ in range(3):                  # build, load and warm up
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        # device time per call: the kernels' own time, without the host's
        # between launches (None where the profiler saw no device event)
        line = {"root": str(root), "case": name,
                "ms": statistics.median(times), "batches": times,
                "device_ms": _smoke().device_ms(fn, CALLS)}
        if getattr(fn, "count_syncs", False):
            line["host_syncs"] = _smoke().count_syncs(fn)[1]
        print(json.dumps(line), flush=True)
        outputs[name] = [t.cpu() for t in fn() if t is not None]
    torch.save(outputs, save)


def main(argv):
    if len(argv) >= 3 and argv[0] == "--child":
        child(Path(argv[1]), argv[2], argv[3:])
        return 0
    if len(argv) < 2 or not selected(argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    parent, change = (Path(a).resolve() for a in argv[:2])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    runs, saved = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, root) in enumerate((("parent", parent),
                                         ("change", change),
                                         ("change", change),
                                         ("parent", parent))):
            save = str(Path(tmp) / f"{i}.pt")
            saved.setdefault(tag, save)
            out = subprocess.run([sys.executable, __file__, "--child",
                                  str(root), save, *argv[2:]],
                                 capture_output=True, text=True, check=True,
                                 timeout=900, cwd=root)
            print(out.stdout, end="", flush=True)
            runs += [(tag, json.loads(line))
                     for line in out.stdout.splitlines()
                     if line.startswith("{")]    # not the log lines
        outs = {t: torch.load(f) for t, f in saved.items()}
    for name in selected(argv[2:]):
        for key, what in (("ms", "per call"),
                          ("device_ms", "device per call"),
                          ("host_syncs", "host synchronizations per call")):
            ms = {t: [r[key] for tt, r in runs
                      if tt == t and r["case"] == name and key in r]
                  for t in ("parent", "change")}
            if not ms["parent"]:
                continue
            print(f"[ab] {name}: parent {ms['parent']} ms, change "
                  f"{ms['change']} ms {what} (order parent, change, change, "
                  "parent)")
        same, diff = compare_outputs(outs["parent"][name],
                                     outs["change"][name])
        print(f"[ab] {name}: outputs bit-equal to the parent's {same}, "
              f"max|d| {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
