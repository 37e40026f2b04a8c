"""Blocked compact-WY Householder QR for N > 128 (kernel K7).

``qr_blocked`` launches the CUDA kernel ``csrc/qr_blocked.cu`` on CUDA
tensors and runs ``qr_blocked_plain`` (plain PyTorch, the same algorithm and
blocking) on CPU tensors. It replaces the Pallas kernel
``montecarlo_tpu/ops/pallas_qr.py::_qr_mxu_kernel`` (reached through
``_qr_batched_mxu_chunk`` / ``qr_lanes_mxu``), and returns what that kernel
returns: (Q, R) of A (B, N, N), with the conventions of the fused kernels
(ops/qr.py): LAPACK signs (v_j = alpha + sign(alpha)·normx,
R_jj = -sign(alpha)·normx), tau = 0 when v·v is zero, exact zero fill below
the diagonal. No floor and no postscale: ops/linalg.py applies the udt_dirty
postscale to R.

A reflector whose v·v is below the smallest normal number (finfo.tiny) gets
tau = 0 as well. The TPU kernel computes tau = 2 / v·v for any v·v > 0 and
relies on the TPU flushing subnormals to zero; CUDA and the CPU keep them,
and 2 / v·v would overflow to inf (the trap ops/qr.py describes for K2/K3).

The columns are taken in panels of KB: each panel is factored column by
column, its reflectors are scaled to unit norm (v/‖v‖ with tau = 2: the raw
v's norms span the grading of the columns, and T built from them would span
its square and lose accuracy), its forward-LARFT T (KB x KB, upper
triangular) is built, so that H_1·…·H_KB = I - V·T·Vᵀ, and the trailing
columns are updated once per panel, A <- (I - V·T·Vᵀ)ᵀ·A. Q is then formed
backward by panels, last panel first, Q[j0:, j0:] <- (I - V·T·Vᵀ)·Q[j0:, j0:]
from the identity, which touches only the trailing block of Q (``qr_blocked_forward_plain``
accumulates Q forward over all of its rows, as the TPU kernel does; the
tests hold one against the other). The TPU kernel builds KB = 64 panels
from KB0 = 16 base panels by merging their T factors; that split only kept
its unrolled scalar recurrence small, and the port builds T at its panel
width directly.

On the card one thread-block cluster of CS blocks factors each matrix
(``cluster_plan``): every block factors the panel itself, and the blocks
share the trailing columns and Q's columns.
"""

from __future__ import annotations

import torch

from . import _build

# the JAX package's QR routing: N <= 128 takes the chain-on-lanes kernels
# (here K2/K3, ops/qr.py), N > 128 the blocked one
MIN_N = 129
# streaming multiprocessors of the H100 (SXM), which cluster_plan fills
SMS = 132
# the phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py)
PHASES = ("copy A and Q = I", "panel load", "panel column steps",
          "R out, V in place and out", "trailing update", "cluster barriers",
          "form Q", "Gram and T")


def panel_width(N: int) -> int:
    """KB: 32 where it divides N, else 16, else 8 (the last panel of the
    plain version may be narrower when 8 does not divide N either)."""
    return next((kb for kb in (32, 16) if N % kb == 0), 8)


def _smem_floats(N: int, kb: int, tc: int) -> int:
    # csrc/qr_blocked.cu::smem_floats: chunks of 8 or more columns in two
    # buffers of rows of tc + 4, of 4 columns in one unpadded buffer
    chunks = 2 * N * (tc + 4) if tc > 4 else N * tc
    return N * (kb + 1) + chunks + 2 * kb * tc + 2 * kb * kb + 2 * kb


def chunk_width(N: int) -> int:
    """TC, the columns of A or Q that the kernel stages per chunk: the
    widest of 32, 16 and 8 (at most KB) whose two chunk buffers fit one
    block's shared memory beside the panel, else 4 (one buffer, the next
    chunk staged after the current one: N past ~1000 at KB = 32, ~1400 at
    16, ~1750 at 8)."""
    kb = panel_width(N)
    return next((tc for tc in (32, 16, 8) if tc <= kb and
                 4 * _smem_floats(N, kb, tc) <= _build.SMEM_PER_BLOCK), 4)


def smem_bytes(N: int) -> int:
    """Shared memory of one block: the panel (its reflectors V in place),
    the staged chunks, W and Z, T and the Gram matrix VᵀV, v_j and tau."""
    return 4 * _smem_floats(N, panel_width(N), chunk_width(N))


def kernel_supports(N: int) -> bool:
    """Shapes the CUDA kernel takes: float32 with N > 128, 8 | N, and the
    block's buffers within one block's shared memory."""
    return (N >= MIN_N and N % 8 == 0
            and smem_bytes(N) <= _build.SMEM_PER_BLOCK)


def cluster_plan(N: int, B: int) -> int:
    """CS, the blocks per matrix: 2 where the 2·B blocks fit the card's
    SMs at once (l16's 64 matrices: 128 of 132), else 1. N takes no part:
    past N = 128 every block has at least two chunks of the first trailing
    update."""
    return 2 if 2 * B <= SMS else 1


def _reflect_panel(P, tiny):
    """Factor the panel P (B, m, kb) in place column by column: returns V
    (B, m, kb), zero above each pivot, and tau (B, kb). The reflector is
    zgeqrf's up to the phase of the diagonal; for real input the phase is
    LAPACK's sign (alpha = 0 takes +1)."""
    B, m, kb = P.shape
    V = torch.zeros_like(P)
    tau = torch.zeros(B, kb, dtype=P.real.dtype, device=P.device)
    for k in range(kb):
        alpha = P[:, k, k]
        tail = P[:, k + 1:, k]
        if P.is_complex():
            sigma = (tail.real * tail.real + tail.imag * tail.imag).sum(-1)
            amag2 = alpha.real * alpha.real + alpha.imag * alpha.imag
            amag = torch.sqrt(amag2)
            safe = amag > 0
            den = torch.where(safe, amag, 1.0)
            ph = torch.complex(torch.where(safe, alpha.real / den, 1.0),
                               torch.where(safe, alpha.imag / den, 0.0))
            normx = torch.sqrt(amag2 + sigma)
            vj = torch.complex(alpha.real + ph.real * normx,
                               alpha.imag + ph.imag * normx)
            vtv = sigma + vj.real * vj.real + vj.imag * vj.imag
        else:
            sigma = (tail * tail).sum(-1)
            normx = torch.sqrt(alpha * alpha + sigma)
            ph = torch.where(alpha >= 0, 1.0, -1.0).to(P.dtype)
            vj = alpha + ph * normx
            vtv = sigma + vj * vj
        tau[:, k] = torch.where(vtv >= tiny, 2.0 / vtv, 0.0)
        V[:, k, k] = vj
        V[:, k + 1:, k] = tail
        v = V[:, k:, k]
        # the panel's later columns: P[:, c] -= (tau·(v^H P[:, c]))·v
        w = torch.einsum("brc,br->bc", P[:, k:, k + 1:], v.conj())
        P[:, k:, k + 1:] -= ((tau[:, k, None] * w)[:, None, :]
                             * v[:, :, None])
        P[:, k, k] = -(ph * normx)
        P[:, k + 1:, k] = 0.0
    return V, tau


def _larft(V, tau):
    """Forward LARFT: T (B, kb, kb) upper triangular with H_1·…·H_kb =
    I - V·T·V^H, T[:k, k] = -tau_k·T[:k, :k]·(V[:, :k]^H·v_k)."""
    B, _, kb = V.shape
    g = V.mH @ V
    T = torch.zeros(B, kb, kb, dtype=V.dtype, device=V.device)
    for k in range(kb):
        T[:, k, k] = tau[:, k]
        T[:, :k, k] = -tau[:, k, None] * (T[:, :k, :k]
                                          @ g[:, :k, k, None])[..., 0]
    return T


def blocked_householder(A, KB):
    """Blocked compact-WY Householder QR of A (B, N, N), real or complex,
    in panels of KB columns (the last one narrower where KB does not divide
    N): the trailing columns updated once per panel, A <- (I - V T V^H)^H A,
    and Q formed backward by panels from the identity. Returns (Q, R, the
    panels' (j0, V, T)), R with exact zeros below the diagonal."""
    B, N, _ = A.shape
    tiny = torch.finfo(A.real.dtype).tiny
    R = A.clone()
    panels = []
    for j0 in range(0, N, KB):
        kb = min(KB, N - j0)
        P = R[:, j0:, j0:j0 + kb].clone()
        V, tau = _reflect_panel(P, tiny)
        R[:, j0:, j0:j0 + kb] = P
        # the compact-WY form of unit reflectors: v / ||v|| = v·sqrt(tau/2)
        # with tau = 2 (0 where tau = 0)
        V = V * torch.sqrt(tau / 2)[:, None, :].to(V.dtype)
        tau = torch.where(tau > 0, 2.0, 0.0).to(tau.dtype)
        T = _larft(V, tau)
        X = R[:, j0:, j0 + kb:]
        R[:, j0:, j0 + kb:] = X - V @ (T.mH @ (V.mH @ X))
        panels.append((j0, V, T))
    Q = torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()
    for j0, V, T in reversed(panels):
        X = Q[:, j0:, j0:]
        Q[:, j0:, j0:] = X - V @ (T @ (V.mH @ X))
    return Q, R, panels


def qr_blocked_plain(A):
    """Plain PyTorch blocked QR of A (B, N, N) in K7's panels, Q formed
    backward: returns (Q, R). Any N, float32 or float64."""
    Q, R, _ = blocked_householder(A, panel_width(A.shape[-1]))
    return Q, R


def qr_blocked_forward_plain(A):
    """``qr_blocked_plain`` with Q accumulated forward over all of its rows,
    Q <- Q·(I - V T Vᵀ) panel by panel, as the TPU kernel does: the same Q
    up to rounding. Returns (Q, R)."""
    B, N, _ = A.shape
    _, R, panels = blocked_householder(A, panel_width(N))
    Q = torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()
    for j0, V, T in panels:
        X = Q[:, :, j0:]
        Q[:, :, j0:] = X - ((X @ V) @ T) @ V.mT
    return Q, R


def qr_blocked(A):
    """Blocked QR (kernel K7) of A (B, N, N): the CUDA kernel for a CUDA
    tensor (float32, ``kernel_supports(N)``, contiguous), ``qr_blocked_plain``
    for a CPU tensor. Returns (Q, R)."""
    if A.device.type == "cpu":
        return qr_blocked_plain(A)
    B, N = _check(A)
    return launch(A, cluster_plan(N, B))


def launch(A, cs):
    """K7 on A (checked) in clusters of cs blocks per matrix (1 or 2):
    the layout ``cluster_plan`` picks, or the other one for A/B timing."""
    B, N = A.shape[0], A.shape[-1]
    Q, R = torch.empty_like(A), torch.empty_like(A)
    # each matrix's reflectors V (N x N) and T factors (N x KB)
    work = torch.empty(B, N * (N + panel_width(N)), dtype=A.dtype,
                       device=A.device)
    with torch.cuda.device(A.device):
        code = _build.load().qr_blocked_f32(
            A.data_ptr(), Q.data_ptr(), R.data_ptr(), work.data_ptr(), B, N,
            cs, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("qr_blocked", code)
    qr_blocked.launches += 1
    return Q, R


qr_blocked.launches = 0


def _check(A):
    if A.device.type != "cuda":
        raise ValueError(f"qr_blocked: no kernel for device {A.device}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"qr_blocked: A must be (B, N, N), got {tuple(A.shape)}")
    B, N, _ = A.shape
    if not kernel_supports(N):
        raise ValueError(f"qr_blocked: no CUDA kernel for N={N} (N >= "
                         f"{MIN_N}, 8 | N, {smem_bytes(N)} of "
                         f"{_build.SMEM_PER_BLOCK} bytes of shared memory)")
    if A.dtype != torch.float32:
        raise ValueError("qr_blocked: the CUDA kernel takes float32")
    if not A.is_contiguous():
        raise ValueError("qr_blocked: A must be contiguous")
    return B, N
