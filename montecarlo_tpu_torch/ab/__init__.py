"""The port's counterparts of the TPU A/B scripts of ``benchmarks/`` that
hold Pallas kernels of their own: ``q_backward_ab`` (kernel K15) and
``qr_step_shape_ab`` (kernel K16). Each runs its arms on the card at the
scripts' anchor shape, 256 matrices of 64 x 64 in float32, on the scripts'
graded input:

    python3 -m montecarlo_tpu_torch.ab.q_backward_ab
    python3 -m montecarlo_tpu_torch.ab.qr_step_shape_ab

Shared here: that input and the timing of the arms in turns with CUDA
events.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

B, N, CALLS = 256, 64, 200    # the scripts' anchor shape and calls an arm
TURNS = 2                     # rounds of the arms, forward then backward


def graded_input(B=B, N=N, device="cuda"):
    """The scripts' input (A, B x N x N float32): normal entries times
    2^linspace(18, -20, N) over the columns, like a prescaled product of
    propagators, from a generator seeded with 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    A = torch.randn(B, N, N, generator=gen, device=device)
    grade = torch.exp2(torch.linspace(18.0, -20.0, N, device=device))
    return (A * grade).contiguous()


def require_cuda(prog):
    """True where a CUDA card is present; else a message and False."""
    if torch.cuda.is_available():
        return True
    print(f"{prog}: torch.cuda.is_available() is False: the arms run on one "
          "NVIDIA GPU", file=sys.stderr)
    return False


def median_ms(fn, calls):
    """Median time of one call of fn() on the card, in ms, over calls calls
    each between two CUDA events. The calls are queued behind a sleeping
    kernel that lasts longer than the host takes to queue them, so that the
    events see the card's time and not the host's launches."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    fn()                                    # build, load and warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # sleep 2x the host's queueing time, counting 2 GHz (the H100's SM
    # clock tops out at 1.98 GHz, so the sleep is never shorter)
    torch.cuda._sleep(int(2 * host_s * 2e9))
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_in_turns(arms, calls=CALLS):
    """{name: [median ms per call, one per turn]} of each arm (name: a
    function of no arguments), the arms in TURNS turns: in order, then in
    reverse order, and so on, so that a drift of the card's clock falls on
    every arm alike."""
    names = list(arms)
    out = {n: [] for n in names}
    for t in range(TURNS):
        for n in names if t % 2 == 0 else reversed(names):
            out[n].append(median_ms(arms[n], calls))
    return out


def arm_lines(times, smi, calls):
    """One line an arm: its median ms per call in each turn, beside the
    card's name and power limit."""
    width = max(map(len, times))
    return [f"{n:{width}s}  " + ", ".join(f"{ms:.4f}" for ms in t)
            + f" ms per call (median of {calls} calls, {len(t)} turns); "
            f"{smi}" for n, t in times.items()]

