#!/usr/bin/env python3
"""Time every layout of K6-f64, K8-c128 or K9-c128 that takes a shape
against each other, in turns, at several chain counts, on one NVIDIA GPU.

    python3 chip_layouts.py CASE[:CHAINS[,CHAINS...]] [...]

CASE is an item 4 run of chip_smoke.py (``fp64_run_inputs``: l15_f64,
flux14_c128, rep_flux16_c128, rep_flux14_c128; its seed and delay), a
repulsive ring in a flux at delay 32 in complex128 (ring160_c128,
ring192_c128: the shapes where both the flavor layout and clusters of 4 in
two flavor stages fit) or one of K8-c128's cases (``K8_C128_CASES``:
rep_flux10_c128, rep_chain128_c128, flux10_c128, chain128_c128,
complex_c128, rep_complex_c128) or a ring of L sites in complex128 with
the complex row's phases for K8-c128 (k8_ringL attractive, F = 1;
k8_rep_ringL repulsive, F = 2; L <= 128). CHAINS defaults to 64; the
inputs are made once at the largest count and sliced. For each chain count it runs every layout of
``mod.layouts`` (the plan's first), checks that all give bit-equal outputs,
and prints one JSON line: the plan's layout, each layout's synchronised ms
per call (CUDA events over 20 calls, in the order plan, others, others
reversed, plan) and how many of its clusters the card runs at once. Prints
nvidia-smi's name and power limit first. Needs CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys

REPS = 20


def inputs(case, chains):
    """(G, sigma, u, keywords, module) of a case at chains chains."""
    import torch

    import chip_smoke as smoke
    from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
    from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
    from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
    if case in smoke.K8_C128_CASES:
        G, sigma, u, kw, _ = smoke.k8_c128_inputs(case, chains)
        return G, sigma, u, kw, sscx
    if case.startswith("k8_"):
        L = int(case.rsplit("ring", 1)[1])
        G, sigma, u, kw, _ = smoke.slice_inputs(
            smoke.complex_model(case.startswith("k8_rep"), L, 1), chains, L,
            safe_mult=smoke.CPLX_SM, dtype=torch.float64)
        return G, sigma, u, kw, sscx
    if case.startswith("ring"):
        L = int(case[4:].split("_")[0])
        G, sigma, u, kw, _ = smoke.slice_inputs(
            smoke.complex_model(True, L, 1), chains, L,
            safe_mult=smoke.CPLX_SM, dtype=torch.float64)
        kw = dict(kw, dk=32)
    else:
        G, sigma, u, kw, _ = smoke.fp64_run_inputs(case, chains)
    return G, sigma, u, kw, (ssd if G.dtype == torch.float64 else ssdcx)


def ms_per_call(call):
    import torch
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def at_once(mod, N, F, kw, lay, dtype):
    """How many clusters of lay the card runs at once (1: one block per
    chain)."""
    if "dk" not in kw:            # K8-c128: the one-block or rank-1 layout
        return mod.max_clusters(N, F, lay) if lay.kind == "rank1" else 1
    return mod.max_clusters(N, F, kw["dk"], lay, dtype)


def run(case, counts):
    import torch
    G0, s0, u0, kw, mod = inputs(case, max(counts))
    C0, F, N, _ = G0.shape
    for C in counts:
        G, sigma, u = (x[:C].contiguous() for x in (G0, s0, u0))
        lays = (mod.layouts(N, F, kw["dk"], G.dtype, C) if "dk" in kw
                else mod.layouts(N, F, G.dtype, C))
        calls = [lambda lay=lay: mod.launch(G, sigma, u, lay, **kw)
                 for lay in lays]
        outs = [call() for call in calls]
        same = all(torch.equal(a, b) for out in outs[1:]
                   for a, b in zip(outs[0], out) if a is not None)
        order = list(range(len(lays)))
        ms = {i: [] for i in order}
        for i in order + order[::-1]:
            ms[i].append(ms_per_call(calls[i]))
        print(json.dumps({
            "case": case, "shape": [C, F, N, N], "dk": kw.get("dk", 1),
            "plan": f"{lays[0].kind} CS={lays[0].cs}",
            "bit_equal": same,
            "layouts": [{"layout": f"{lay.kind} CS={lay.cs} "
                                   f"{list(lay.geometry)}",
                         "ms": ms[i],
                         "at_once": at_once(mod, N, F, kw, lay, G.dtype)}
                        for i, lay in enumerate(lays)]}), flush=True)
        if not same:
            raise SystemExit(f"chip_layouts: the layouts of {case} at {C} "
                             "chains disagree")


def main(argv):
    import torch
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_layouts: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    for arg in argv:
        case, _, counts = arg.partition(":")
        run(case, [int(c) for c in counts.split(",")] if counts else [64])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
