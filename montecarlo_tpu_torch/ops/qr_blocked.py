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
column, its forward-LARFT T (KB x KB, upper triangular) is built, so that
H_1·…·H_KB = I - V·T·Vᵀ, and the rest of A and the accumulated Q are
updated once per panel: A -= V·Tᵀ·(Vᵀ·A) on the trailing columns,
Q -= (Q·V)·T·Vᵀ. The TPU kernel builds KB = 64 panels from KB0 = 16 base
panels by merging their T factors; that split only kept its unrolled scalar
recurrence small, and the port builds T at its panel width directly.
"""

from __future__ import annotations

import torch

from . import _build

# the JAX package's QR routing: N <= 128 takes the chain-on-lanes kernels
# (here K2/K3, ops/qr.py), N > 128 the blocked one
MIN_N = 129


def panel_width(N: int) -> int:
    """KB: 32 where it divides N, else 16, else 8 (the last panel of the
    plain version may be narrower when 8 does not divide N either)."""
    return next((kb for kb in (32, 16) if N % kb == 0), 8)


def smem_bytes(N: int) -> int:
    """Shared memory of one block: the panel, its reflectors V, T and the
    Gram matrix VᵀV, and a 32x33 transpose tile."""
    kb = panel_width(N)
    return 4 * (2 * kb * N + 2 * kb * kb + kb + 1 + 32 * 33)


def kernel_supports(N: int) -> bool:
    """Shapes the CUDA kernel takes: float32 with N > 128, 8 | N, and the
    panel within one block's shared memory."""
    return (N >= MIN_N and N % 8 == 0
            and smem_bytes(N) <= _build.SMEM_PER_BLOCK)


def qr_blocked_plain(A):
    """Plain PyTorch blocked QR of A (B, N, N): returns (Q, R). Any N,
    float32 or float64."""
    B, N, _ = A.shape
    KB = panel_width(N)
    tiny = torch.finfo(A.dtype).tiny
    W = A.mT.clone()                       # W[:, c, :] = column c of A
    Q = torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()
    for j0 in range(0, N, KB):
        kb = min(KB, N - j0)
        P = W[:, j0:j0 + kb, :].clone()    # the panel's columns
        V = torch.zeros(B, kb, N, dtype=A.dtype, device=A.device)
        tau = torch.zeros(B, kb, dtype=A.dtype, device=A.device)
        for k in range(kb):
            j = j0 + k
            alpha = P[:, k, j]
            tail = P[:, k, j + 1:]
            sigma = (tail * tail).sum(-1)
            normx = torch.sqrt(alpha * alpha + sigma)
            s = torch.where(alpha >= 0, 1.0, -1.0).to(A.dtype)
            vj = alpha + s * normx
            vtv = sigma + vj * vj
            tau[:, k] = torch.where(vtv >= tiny, 2.0 / vtv, 0.0)
            V[:, k, j] = vj
            V[:, k, j + 1:] = tail
            # the panel's later columns: P[c] -= (tau·(P[c]·v))·v
            w = torch.einsum("bcr,br->bc", P[:, k + 1:, j:], V[:, k, j:])
            P[:, k + 1:, j:] -= ((tau[:, k, None] * w)[:, :, None]
                                 * V[:, None, k, j:])
            P[:, k, j] = -s * normx
            P[:, k, j + 1:] = 0.0
        W[:, j0:j0 + kb] = P
        # forward LARFT: T[:k, k] = -tau_k · T[:k, :k] · (V[:k]·v_k)
        g = V @ V.mT
        T = torch.zeros(B, kb, kb, dtype=A.dtype, device=A.device)
        for k in range(kb):
            T[:, k, k] = tau[:, k]
            T[:, :k, k] = -tau[:, k, None] * (T[:, :k, :k] @ g[:, :k, k, None])[..., 0]
        Vt = V[:, :, j0:]
        X = W[:, j0 + kb:, j0:]
        W[:, j0 + kb:, j0:] = X - ((X @ Vt.mT) @ T) @ Vt
        X = Q[:, :, j0:]
        Q[:, :, j0:] = X - ((X @ Vt.mT) @ T) @ Vt
    return Q, W.mT.contiguous()


def qr_blocked(A):
    """Blocked QR (kernel K7) of A (B, N, N): the CUDA kernel for a CUDA
    tensor (float32, ``kernel_supports(N)``, contiguous), ``qr_blocked_plain``
    for a CPU tensor. Returns (Q, R)."""
    if A.device.type == "cpu":
        return qr_blocked_plain(A)
    B, N = _check(A)
    Q, R = torch.empty_like(A), torch.empty_like(A)
    work = torch.empty_like(A)              # Aᵀ, factored in place
    with torch.cuda.device(A.device):
        code = _build.load().qr_blocked_f32(
            A.data_ptr(), Q.data_ptr(), R.data_ptr(), work.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
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
