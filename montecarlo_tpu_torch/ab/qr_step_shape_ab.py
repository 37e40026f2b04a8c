"""Do several Householder columns per block barrier shorten the fused QR's
column loop on the card? The port's counterpart of
``benchmarks/qr_step_shape_ab.py``:

    python3 -m montecarlo_tpu_torch.ab.qr_step_shape_ab

Arms, at the script's anchor shape (256 matrices, N = 64, float32) on its
graded input (``montecarlo_tpu_torch.ab.graded_input``), timed in turns:
K16 (``qr_ab.qr_kcol``: K4's QR with forward Q) at KC = 1, 2 and 4
reflectors per block barrier, the TPU kernel's columns per grid step. R and
Q must be bit-equal to KC = 1's, which is K4's kernel, and to K4's
(``qr_householder.qr_f32``); the script holds R to 1e-3 max|R|. The
script's other lever, the lane-block width CB in {128, 256}, is a layout
width of the TPU's compiler (Mosaic) and has no counterpart here. Refuses
(exit 1) without a CUDA card.
"""

from __future__ import annotations

import sys

import torch

from montecarlo_tpu_torch import ab
from montecarlo_tpu_torch.ops import qr_ab
from montecarlo_tpu_torch.ops import qr_householder as qh
from montecarlo_tpu_torch.utils import host


def arms(A):
    """The arms on A (B, N, N), each a function of no arguments."""
    return {f"K16 qr_kcol KC={k}": (lambda k=k: qr_ab.qr_kcol(A, k))
            for k in qr_ab.COLS_PER_STEP}


def check(A):
    """Whether K16's (Q, R) of A at each KC is bit-equal to KC = 1's, and
    KC = 1's to K4's: {KC: bool}, with "K4" for the last."""
    ref = qr_ab.qr_kcol(A, 1)
    same = {k: all(map(torch.equal, qr_ab.qr_kcol(A, k), ref))
            for k in qr_ab.COLS_PER_STEP[1:]}
    same["K4"] = all(map(torch.equal, qh.qr_f32(A), ref))
    return same


def run(calls=ab.CALLS, smi=None, log=print):
    """The script on the card: the bit-equality of the arms, then each
    arm's time (logged with the card's name and power limit). Returns
    {"check": check's dict, "times": {arm: [ms per turn]}}."""
    smi = smi or host.nvidia_smi()
    A = ab.graded_input()
    same = check(A)
    log("K16 R and Q bit-equal to KC=1's: " + ", ".join(
        f"KC={k} {v}" for k, v in same.items() if k != "K4")
        + f"; KC=1 to K4's (qr_f32) {same['K4']}  ({tuple(A.shape)} "
        "float32; the TPU's lane-block width CB has no counterpart here)")
    if not all(same.values()):
        raise AssertionError("qr_step_shape_ab: K16 is not bit-equal "
                             "across KC and to K4")
    times = ab.time_in_turns(arms(A), calls)
    for line in ab.arm_lines(times, smi, calls):
        log(line)
    return dict(check=same, times=times)


def main():
    prog = "qr_step_shape_ab"
    if not ab.require_cuda(prog):
        return 1
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
