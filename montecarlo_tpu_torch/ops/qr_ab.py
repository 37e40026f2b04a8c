"""The A/B variants of the fused QR's column loop: kernel K15 (R without Q,
and Q formed backward from the stored reflectors) and K16 (several
Householder columns per block barrier), float32, 8 | N <= 64.

``qr_r`` (K15-noq), ``qr_backward`` (K15-backward) and ``qr_kcol`` (K16)
launch the CUDA kernels of ``csrc/qr_ab.cu`` on CUDA tensors and run
``householder_r_plain``, ``householder_qr_backward_plain`` and
``householder_qr_kcol_plain`` (plain PyTorch, the same algorithm and op
order) on CPU tensors. They replace the Pallas kernels of the TPU A/B
scripts ``benchmarks/q_backward_ab.py::_kernel_noq`` (reached through
``run_noq``), ``::_kernel_backward`` (through ``run_backward``) and
``benchmarks/qr_step_shape_ab.py::_kernel`` (through ``make_run``), which
ask how the fused QR K2 should shape its column loop: how much of its time
forming Q takes, and whether fewer grid steps shorten it. The port's
counterparts of the scripts are ``montecarlo_tpu_torch.ab``.

All three factor A (B, N, N) as given, with no prescale and no pivot, by
K4's column steps (``qr_householder.householder_qr_plain``): LAPACK signs,
R_jj = -sign(alpha)·||x||, exact zeros below the diagonal, and the reflector
H = I - tau v vᵀ with v = (alpha + s·||x||, x_tail), tau = 2 / v·v, and
tau = 0 where v·v is below finfo.tiny (the TPU scripts: where v·v is 0; the
TPU flushes subnormals to zero, CUDA and the CPU keep them).

  qr_r         R alone (K4's loop without Q); bit-equal to K4's R.
  qr_backward  (Q, R): R by K4's loop, storing the reflectors (V, tau),
               then Q = H_0···H_{N-1} formed backward, P <- H_j·P for
               j = N-1 … 0 from P = I; P changes only in its trailing
               (N-j, N-j) block at step j.
  qr_kcol      (Q, R) as K4, k ∈ {1, 2, 4} columns a step: the TPU kernel's
               columns per grid step, the CUDA kernel's reflectors per
               block barrier. Each column sees the same operations in the
               same order at every k, so Q and R are bit-equal to K4's.
"""

from __future__ import annotations

import torch

from . import _build
from . import qr_householder as qh

# K2's range, and the TPU scripts' N: one block of N / 8 warps per matrix
MAX_N = 64
COLS_PER_STEP = (1, 2, 4)


def householder_r_plain(A):
    """Plain PyTorch version of K15-noq: R of A (B, N, N) float32 by K4's
    column steps, without Q. Any N."""
    return qh.householder_qr_vtau_plain(A)[2]


def householder_qr_backward_plain(A):
    """Plain PyTorch version of K15-backward: (Q, R) of A (B, N, N)
    float32, R by K4's column steps storing the reflectors, then Q formed
    backward from them (P <- H_j P, j descending, on P's trailing block).
    Any N."""
    V, tau, R = qh.householder_qr_vtau_plain(A)
    B, N, _ = A.shape
    Q = torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()
    for j in range(N - 1, -1, -1):
        v = V[:, j:, j]
        w = torch.einsum("brc,br->bc", Q[:, j:, j:], v)
        Q[:, j:, j:] -= (tau[:, j, None] * w)[:, None, :] * v[:, :, None]
    return Q, R


def householder_qr_kcol_plain(A, k):
    """Plain PyTorch version of K16: (Q, R) of A (B, N, N) float32 by K4's
    column steps taken k columns a step. Grouping the columns changes no
    arithmetic (each column sees the same operations in the same order),
    so this is ``qr_householder.householder_qr_plain`` at every k. Any N."""
    _check_k(k)
    return qh.householder_qr_plain(A)


def _check_k(k):
    if k not in COLS_PER_STEP:
        raise ValueError(f"qr_kcol: k must be one of {COLS_PER_STEP}, "
                         f"got {k}")


def _check(name, A):
    """Shape and dtype of the kernels' domain on every device; on CUDA also
    contiguity. Returns (B, N, on_cuda)."""
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {A.device}")
    if A.dtype != torch.float32:
        raise ValueError(f"{name}: takes float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: A must be (B, N, N), got {tuple(A.shape)}")
    B, N, _ = A.shape
    if N % 8 or not 8 <= N <= MAX_N:
        raise ValueError(f"{name}: no kernel for N={N} (8 | N <= {MAX_N})")
    cuda = A.device.type == "cuda"
    if cuda and not A.is_contiguous():
        raise ValueError(f"{name}: A must be contiguous")
    return B, N, cuda


def _launch(name, *args):
    """Launch one of the kernels on the current stream of the first
    tensor's device (args: tensors, then ints)."""
    with torch.cuda.device(args[0].device):
        code = getattr(_build.load(), name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, code)


def qr_r(A):
    """R of A (B, N, N) float32, 8 | N <= 64 (kernel K15-noq): the CUDA
    kernel for a CUDA tensor (contiguous), ``householder_r_plain`` for a
    CPU tensor."""
    B, N, cuda = _check("qr_r", A)
    if not cuda:
        return householder_r_plain(A)
    R = torch.empty_like(A)
    _launch("qr_r_f32", A, R, B, N)
    qr_r.launches += 1
    return R


def qr_backward(A):
    """(Q, R) of A (B, N, N) float32, 8 | N <= 64, Q formed backward from
    the reflectors (kernel K15-backward): the CUDA kernel for a CUDA tensor
    (contiguous), ``householder_qr_backward_plain`` for a CPU tensor."""
    B, N, cuda = _check("qr_backward", A)
    if not cuda:
        return householder_qr_backward_plain(A)
    Q, R = torch.empty_like(A), torch.empty_like(A)
    _launch("qr_backward_f32", A, Q, R, B, N)
    qr_backward.launches += 1
    return Q, R


def qr_kcol(A, k):
    """(Q, R) of A (B, N, N) float32, 8 | N <= 64, at k ∈ {1, 2, 4}
    Householder columns per block barrier (kernel K16 at k = 2 and 4; k = 1
    is K4, ``qr_householder.qr_f32``): the CUDA kernel for a CUDA tensor (contiguous),
    ``householder_qr_kcol_plain`` for a CPU tensor."""
    _check_k(k)
    B, N, cuda = _check("qr_kcol", A)
    if not cuda:
        return householder_qr_kcol_plain(A, k)
    if k == 1:          # K4's kernel, counted as K4's launch
        return qh.qr_f32(A)
    Q, R = torch.empty_like(A), torch.empty_like(A)
    _launch("qr_kcol_f32", A, Q, R, B, N, k)
    qr_kcol.launches += 1
    return Q, R


qr_r.launches = 0
qr_backward.launches = 0
qr_kcol.launches = 0
