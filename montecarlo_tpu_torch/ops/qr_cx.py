"""Complex Householder QR (kernel K10), 8 | N <= 128.

``qr_cx`` launches the CUDA kernel ``csrc/qr_cx.cu`` on CUDA tensors and
runs its plain PyTorch version ``qr_cx_blocked_plain`` (the same algorithm
and blocking) on CPU tensors: a blocked compact-WY factorization in panels
of ``PANEL`` columns, the trailing columns updated once per panel,
A <- (I - V T V^H)^H A, and Q formed backward by panels after R,
Q[j0:, j0:] <- (I - V T V^H) Q[j0:, j0:] (the algorithm of
``ops/qr_blocked.py::blocked_householder``, which K7 runs in real
arithmetic). It replaces the Pallas kernel
``montecarlo_tpu/ops/pallas_qr.py::_qr_kernel_cx`` (reached through
``_qr_batched_cx`` / ``qr_lanes_cx`` / ``maybe_qr``), which accumulates Q
forward in the column steps; ``qr_cx_plain`` is that forward form and
``qr_cx_backward_plain`` the unblocked one with Q formed backward, which
the tests hold the blocked one against.

A = Q R of the prescaled, column-pivoted A (B, N, N), column by column with
the zgeqrf reflector up to the phase of the diagonal (``udt_dirty`` keeps
|R_jj| as D and the phase in its unit-magnitude Rs diagonal):
  alpha = x_j, phase = alpha/|alpha| (1 if alpha = 0),
  v = x on the tail, v_j = alpha + phase·||x||, tau = 2/(v^H v) (real),
  H = I - tau v v^H, R_jj = -phase·||x||, exact zeros below the diagonal.
A zero tail still reflects (v_j = 2 alpha), where LAPACK leaves the column
as it is; both factorizations are valid and differ by a unit phase per
column of Q and row of R.

A reflector whose v^H v is below the smallest normal number (finfo.tiny)
gets tau = 0, as a zero column does. The TPU kernel sets tau = 2/v^H v for
any v^H v > 0 and relies on the TPU flushing subnormals to zero; on CUDA and
the CPU 2/v^H v overflows to inf and fills the matrix with NaN (the trap of
K2, K3 and K7, ops/qr.py).
"""

from __future__ import annotations

import torch

from . import _build
from .qr_blocked import _reflect_panel, blocked_householder

MAX_N = 128
# the phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py)
PHASES = ("load", "panel column steps", "V, Gram and T", "trailing update",
          "store R", "form Q", "store Q")


# KB, the panel width of the kernel and of its plain version: wider panels
# gather more reflectors into the WY form of Q, which rounds more (see
# csrc/qr_cx.cu). The kernel is built for this width (kPanel) and refuses
# another.
PANEL = 8


def kernel_supports(N: int) -> bool:
    """Shapes the CUDA kernel takes: 8 | N <= 128 (A, then Q in its place,
    one panel's V, every panel's T and W of one complex64 matrix in shared
    memory)."""
    return N % 8 == 0 and 8 <= N <= MAX_N


def _reflectors(A):
    """Householder factorization of A (B, N, N) column by column: returns R
    and the reflectors [(v_j (B, N - j), tau_j (B,))], v_j over rows j.."""
    R = A.clone()
    V, tau = _reflect_panel(R, torch.finfo(A.real.dtype).tiny)
    return R, [(V[:, j:, j], tau[:, j]) for j in range(A.shape[-1])]


def _eye(A):
    B, N, _ = A.shape
    return torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()


def qr_cx_plain(A):
    """Plain PyTorch complex Householder QR of A (B, N, N), complex64 or
    complex128, with Q accumulated forward, Q <- Q·H_j, as the TPU kernel
    does: returns (Q, R). The reference the tests hold K10 and its plain
    version against, phase-normalized."""
    R, refl = _reflectors(A)
    Q = _eye(A)
    for j, (v, tau) in enumerate(refl):
        qw = torch.einsum("brk,bk->br", Q[:, :, j:], v)
        Q[:, :, j:] -= (tau[:, None] * qw)[:, :, None] * v.conj()[:, None, :]
    return Q, R


def qr_cx_backward_plain(A):
    """``qr_cx_plain`` with Q formed backward after the factorization,
    Q = H_0 (H_1 (... (H_{N-1} I))), step j changing only Q[j:, j:] (K10's
    algorithm): the same Q up to rounding. Returns (Q, R)."""
    R, refl = _reflectors(A)
    Q = _eye(A)
    for j in reversed(range(A.shape[-1])):
        v, tau = refl[j]
        w = torch.einsum("brc,br->bc", Q[:, j:, j:], v.conj())
        Q[:, j:, j:] -= (tau[:, None] * w)[:, None, :] * v[:, :, None]
    return Q, R


def qr_cx_blocked_plain(A):
    """K10's algorithm in plain PyTorch: the blocked compact-WY QR of A
    (B, N, N) in panels of ``PANEL`` columns, Q formed backward
    by panels. Returns (Q, R); the same factors as ``qr_cx_plain`` up to
    rounding."""
    Q, R, _ = blocked_householder(A, PANEL)
    return Q, R


def phase_normalized(Q, R):
    """(Q·S, S^H·R) with S = diag(R_jj / |R_jj|) (1 where R_jj = 0): the
    factors with a real non-negative diagonal, free of the phase choice.
    The phase of R_jj follows that of alpha, which rounding moves by about
    eps·||x||/|alpha| when |alpha| << ||x||, so two float32 factorizations
    agree in these factors, not always in their raw ones (plain complex64
    against complex128 on (32, 64, 64) graded input, on the CPU: Q to
    2.3e-5 raw and to 8.9e-7 phase-normalized)."""
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    mag = d.abs()
    ph = torch.where(mag > 0, d / torch.where(mag > 0, mag, 1.0), 1.0)
    return Q * ph[..., None, :], R * ph.conj()[..., :, None]


def qr_cx(A):
    """Complex Householder QR (kernel K10) of A (B, N, N): the CUDA kernel
    for a CUDA tensor (complex64, 8 | N <= 128, contiguous),
    ``qr_cx_blocked_plain`` for a CPU tensor. Returns (Q, R)."""
    if A.device.type == "cpu":
        return qr_cx_blocked_plain(A)
    B, N = _check(A)
    Q, R = torch.empty_like(A), torch.empty_like(A)
    with torch.cuda.device(A.device):
        code = _build.load().qr_cx_c64(
            A.data_ptr(), Q.data_ptr(), R.data_ptr(), B, N, PANEL,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("qr_cx", code)
    qr_cx.launches += 1
    return Q, R


qr_cx.launches = 0


def _check(A):
    if A.device.type != "cuda":
        raise ValueError(f"qr_cx: no kernel for device {A.device}")
    if A.dtype != torch.complex64:
        raise ValueError("qr_cx: the CUDA kernel takes complex64")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"qr_cx: A must be (B, N, N), got {tuple(A.shape)}")
    B, N, _ = A.shape
    if not kernel_supports(N):
        raise ValueError(f"qr_cx: no CUDA kernel for N={N} (8 | N <= "
                         f"{MAX_N})")
    if not A.is_contiguous():
        raise ValueError("qr_cx: A must be contiguous")
    return B, N
