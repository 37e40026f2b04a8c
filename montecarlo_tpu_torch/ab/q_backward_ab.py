"""What share of the fused QR's time is forming Q, and what does forming Q
backward from the stored reflectors cost on the card? The port's
counterpart of ``benchmarks/q_backward_ab.py``:

    python3 -m montecarlo_tpu_torch.ab.q_backward_ab

Arms, at the script's anchor shape (256 matrices, N = 64, float32) on its
graded input (``montecarlo_tpu_torch.ab.graded_input``), timed in turns:
  K2        the fused UDT QR ``qr.udt_qr`` with the prescale mx = 1, as the
            script calls it (forward Q, floored and normalized R)
  K4        ``qr_householder.qr_f32``: Q accumulated forward, R
  K15 noq   ``qr_ab.qr_r``: K4's loop without Q, R alone (a lower bound of
            the loop's time without Q)
  K15 backward  ``qr_ab.qr_backward``: R storing the reflectors, then Q
            formed backward from them, with no block barrier
  library   ``torch.linalg.qr`` on the same input
and the script's correctness line for the backward arm: max|QR - A| /
max|A|, max|Q - Q_fwd| against K4's Q, and max|Q^T Q - I|. Refuses (exit
1) without a CUDA card.
"""

from __future__ import annotations

import sys

import torch

from montecarlo_tpu_torch import ab
from montecarlo_tpu_torch.ops import qr, qr_ab
from montecarlo_tpu_torch.ops import qr_householder as qh
from montecarlo_tpu_torch.utils import host

# max|QR - A| / max|A| and max|Q^T Q - I| of the backward arm: Householder
# QR is backward stable, so both stay near float32's rounding whatever the
# input's condition. max|Q - Q_fwd| depends on it (the graded input's
# condition numbers reach 1e4) and is printed, not held.
TOL_REC, TOL_ORTH = 1e-5, 1e-5


def arms(A):
    """The arms on A (B, N, N), each a function of no arguments."""
    mx = torch.ones(A.shape[0], device=A.device)
    return {"K2 udt_qr (forward Q, mx = 1)": lambda: qr.udt_qr(A, mx),
            "K4 qr_f32 (forward Q)": lambda: qh.qr_f32(A),
            "K15 qr_r (no Q)": lambda: qr_ab.qr_r(A),
            "K15 qr_backward (Q backward)": lambda: qr_ab.qr_backward(A),
            "library torch.linalg.qr": lambda: torch.linalg.qr(A)}


def check(A):
    """The backward arm's (Q, R) of A against A and against K4's Q: max|QR
    - A| / max|A|, max|Q - Q_fwd|, max|Q^T Q - I| (products in float64)."""
    Q, R = qr_ab.qr_backward(A)
    Q_fwd, _ = qh.qr_f32(A)
    Qd, Ad = Q.double(), A.double()
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    return dict(rec=((Qd @ R.double() - Ad).abs().max()
                     / Ad.abs().max()).item(),
                dq=(Q - Q_fwd).abs().max().item(),
                orth=(Qd.mT @ Qd - eye).abs().max().item())


def run(calls=ab.CALLS, smi=None, log=print):
    """The script on the card: the correctness line, then each arm's time
    (logged with the card's name and power limit) and the shares of Q.
    Returns {"check": check's dict, "times": {arm: [ms per turn]}}."""
    smi = smi or host.nvidia_smi()
    A = ab.graded_input()
    err = check(A)
    log(f"backward: |QR-A|/|A| {err['rec']:.2e}  |Q-Q_fwd| {err['dq']:.2e}"
        f"  |QtQ-I| {err['orth']:.2e}  ({tuple(A.shape)} float32)")
    if not (err["rec"] <= TOL_REC and err["orth"] <= TOL_ORTH):
        raise AssertionError("q_backward_ab: the backward arm's QR is wrong")
    times = ab.time_in_turns(arms(A), calls)
    for line in ab.arm_lines(times, smi, calls):
        log(line)
    k2, k4, noq, back, _ = (min(t) for t in times.values())
    log(f"Q's share of the time: K4 {(k4 - noq) / k4:.1%}, K2 "
        f"{(k2 - noq) / k2:.1%}; backward / forward (K15 backward / K4) "
        f"{back / k4:.3f} (each arm's faster turn)")
    return dict(check=err, times=times)


def main():
    prog = "q_backward_ab"
    if not ab.require_cuda(prog):
        return 1
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
