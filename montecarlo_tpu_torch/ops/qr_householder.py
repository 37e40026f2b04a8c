"""Unfused Householder QR: kernel K4 in float32, kernel K11 in float64, and
K14, K4 emitting its reflectors (V, tau) in place of Q.

``qr_f32`` and ``qr_f64`` launch the CUDA kernels of ``csrc/udt_qr.cu``
(K4, K14: the column loop of K2 and K3) and ``csrc/qr_f64.cu`` (K11) on CUDA
tensors and run ``householder_qr_plain``
(plain PyTorch, the same algorithm and op order) on CPU tensors. They replace
the Pallas kernels ``montecarlo_tpu/ops/pallas_qr.py::_qr_kernel`` and its
KB=8 panel variant ``::_blocked_kernel`` (K4, reached through
``_qr_batched`` / ``qr_lanes`` / ``maybe_qr``), and ``::_qr_df_kernel``
(K11, reached through ``_qr_df_batched`` / ``qr_lanes_df`` / ``maybe_qr``
for float64). The panel variant computes the same function as the
per-column kernel and exists because the TPU's VMEM could not hold N = 128
otherwise; one kernel takes every N here.

A = Q R of the prescaled, column-pivoted A (B, N, N), column by column, with
LAPACK signs (R_jj = -sign(alpha)·||x||, exact) and exact zeros below the
diagonal. No floor and no postscale: ops/linalg.py applies them. The
reflector H = I - tau v vᵀ is the one of the TPU kernel of each dtype:
  float32 (K4):  v = (alpha + s·||x||, x_tail), tau = 2 / v·v, and tau = 0
                 when v·v is below finfo.tiny;
  float64 (K11): the LAPACK-normalized v = (1, x_tail / v_j) with
                 v_j = alpha + s·||x||, tau = v_j / (s·||x||), and H = I
                 where ||x||² is below finfo.tiny.
Both rules on small columns stand for the TPU's flush of subnormals to zero.

``qr_vtau`` (K14) runs K4's column steps without accumulating Q and returns
(V, tau, R), column j of V being v_j (zeros above row j, and all zeros
where tau_j = 0: v need not vanish below finfo.tiny, and the TPU's flushed v
does); ``qr_wy`` assembles Q = I - V T V^T from them outside the kernel
(``wy_assemble_q``). They replace ``pallas_qr.py::_qr_kernel_vtau`` and
``::_blocked_kernel_vtau`` (reached through ``_qr_batched_vtau`` /
``qr_lanes_wy`` / ``maybe_qr`` under MC_TPU_QR_WY=1) and ``_wy_assemble_q``.
In float32 the TPU kernel computes 2 / v·v for any v·v > 0; CUDA and the
CPU keep subnormals, and 2 / v·v would overflow to inf (the trap of K2, K3,
K7 and K10). In float64 the TPU kernel takes H = I where ||x||² = 0; a
subnormal ||x||² has lost its precision, and the reflector built from it is
not orthogonal (Q^T Q - I of 0.09 on a column scaled to ~1e-160), so H = I
below finfo.tiny as in float32. The TPU runs K11 in double-float arithmetic
(hi + lo float32 pairs) because it has no float64; here it runs in native
float64.
"""

from __future__ import annotations

import torch

from . import _build

# largest N of each kernel: the columns of A and Qᵀ of one matrix stay in
# the registers of one block of N / 8 warps (K4: up to 16 warps, K11: 8)
MAX_N = {torch.float32: 128, torch.float64: 64}
# K11's phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py;
# lane 0 of each block's last warp)
PHASES_F64 = ("load and first reflector", "update of A",
              "next reflector (owner warp)", "update of Q", "barrier", "store")


def kernel_supports(N: int, dtype=torch.float32) -> bool:
    """Shapes the CUDA kernels take: 8 | N <= 128 in float32 (K4), 8 | N <= 64
    in float64 (K11)."""
    return N % 8 == 0 and 8 <= N <= MAX_N.get(dtype, 0)


def _householder(A, with_q):
    """Column-by-column Householder QR of A (B, N, N), float32 (K4's
    reflector) or float64 (K11's). Returns (Q or None, R, V, tau): V holds
    the reflectors as columns (zero where tau = 0), tau (B, N)."""
    B, N, _ = A.shape
    normalized = A.dtype == torch.float64
    tiny = torch.finfo(A.dtype).tiny
    R = A.clone()
    V = torch.zeros_like(A)
    taus = []
    Q = (torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()
         if with_q else None)
    for j in range(N):
        alpha = R[:, j, j]
        tail = R[:, j + 1:, j]
        sigma = (tail * tail).sum(-1)
        n2 = alpha * alpha + sigma
        normx = torch.sqrt(n2)
        s = torch.where(alpha >= 0, 1.0, -1.0).to(A.dtype)
        vj = alpha + s * normx
        if normalized:
            live = n2 >= tiny
            iv = torch.where(live, 1.0 / torch.where(live, vj, 1.0), 0.0)
            v = torch.cat([live.to(A.dtype)[:, None], tail * iv[:, None]], 1)
            sn = torch.where(live, s * normx, 1.0)
            tau = torch.where(live, vj / sn, 0.0)
        else:
            v = torch.cat([vj[:, None], tail], dim=1)            # rows j..N-1
            vtv = sigma + vj * vj
            tau = torch.where(vtv >= tiny, 2.0 / vtv, 0.0)
        # trailing columns: A[:, c] -= (tau·(A[:, c]·v))·v for c > j
        w = torch.einsum("brc,br->bc", R[:, j:, j + 1:], v)
        R[:, j:, j + 1:] -= (tau[:, None] * w)[:, None, :] * v[:, :, None]
        R[:, j + 1:, j] = 0.0
        R[:, j, j] = -s * normx
        V[:, j:, j] = torch.where(tau[:, None] != 0, v, 0.0)
        taus.append(tau)
        if with_q:      # Q <- Q·H
            qw = torch.einsum("brk,bk->br", Q[:, :, j:], v)
            Q[:, :, j:] -= (tau[:, None] * qw)[:, :, None] * v[:, None, :]
    return Q, R, V, torch.stack(taus, dim=-1)


def householder_qr_plain(A):
    """Plain PyTorch Householder QR of A (B, N, N), float32 (K4's reflector)
    or float64 (K11's): returns (Q, R). Any N."""
    Q, R, _, _ = _householder(A, with_q=True)
    return Q, R


def householder_qr_vtau_plain(A):
    """Plain PyTorch version of K14: K4's column steps on A (B, N, N)
    float32 without Q; returns (V, tau, R). Any N."""
    _, R, V, tau = _householder(A, with_q=False)
    return V, tau, R


def wy_assemble_q(V, tau):
    """Q = H_0···H_{N-1} = I − V·T·Vᵀ from the reflectors V (..., N, N) and
    tau (..., N), with one batched triangular solve through the inverse-T
    identity T⁻¹ = striu(VᵀV) + diag(1/τ) (pallas_qr.py::_wy_assemble_q).
    Columns with τ = 0 have v = 0 and drop out exactly: their row of T⁻¹ is
    e_jᵀ. Two matmuls and the solve run in full float32 (make_context turns
    TF32 off)."""
    N = V.shape[-1]
    Vt = V.mT
    eye = torch.eye(N, dtype=V.dtype, device=V.device)
    tau_safe = torch.where(tau > 0, tau, 1.0)
    S = torch.triu(Vt @ V, 1) + (1.0 / tau_safe)[..., :, None] * eye
    X = torch.linalg.solve_triangular(S, Vt, upper=True)        # X = T·Vᵀ
    return eye - V @ X


def _launch(name, fn, A):
    """Allocate (Q, R) and launch one of the kernels on A's stream."""
    B, N = _check(name, A)
    Q, R = torch.empty_like(A), torch.empty_like(A)
    with torch.cuda.device(A.device):
        code = getattr(_build.load(), name)(
            A.data_ptr(), Q.data_ptr(), R.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, code)
    fn.launches += 1
    return Q, R


def qr_f32(A):
    """Householder QR (kernel K4) of A (B, N, N): the CUDA kernel for a CUDA
    tensor (float32, 8 | N <= 128, contiguous), ``householder_qr_plain`` for
    a CPU tensor. Returns (Q, R)."""
    if A.device.type == "cpu":
        return householder_qr_plain(A)
    return _launch("qr_f32", qr_f32, A)


def qr_f64(A):
    """Householder QR (kernel K11) of A (B, N, N): the CUDA kernel for a CUDA
    tensor (float64, 8 | N <= 64, contiguous), ``householder_qr_plain`` for a
    CPU tensor. Returns (Q, R)."""
    if A.device.type == "cpu":
        return householder_qr_plain(A)
    return _launch("qr_f64", qr_f64, A)


def qr_vtau(A):
    """Householder QR emitting the reflectors (kernel K14) of A (B, N, N):
    the CUDA kernel for a CUDA tensor (float32, 8 | N <= 128, contiguous),
    ``householder_qr_vtau_plain`` for a CPU tensor. Returns (V, tau, R)."""
    if A.device.type == "cpu":
        return householder_qr_vtau_plain(A)
    B, N = _check("qr_vtau", A)
    V, R = torch.empty_like(A), torch.empty_like(A)
    tau = torch.empty(B, N, dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        code = _build.load().qr_vtau_f32(
            A.data_ptr(), V.data_ptr(), tau.data_ptr(), R.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("qr_vtau", code)
    qr_vtau.launches += 1
    return V, tau, R


def qr_wy(A):
    """(Q, R) of A (B, N, N) float32 through K14 (``qr_vtau``) and the WY
    assembly of Q outside the kernel (``wy_assemble_q``): the JAX package's
    qr_lanes_wy."""
    V, tau, R = qr_vtau(A)
    return wy_assemble_q(V, tau), R


qr_f32.launches = 0
qr_f64.launches = 0
qr_vtau.launches = 0

_DTYPES = {"qr_f32": torch.float32, "qr_f64": torch.float64,
           "qr_vtau": torch.float32}


def _check(name, A):
    dtype = _DTYPES[name]
    if A.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {A.device}")
    if A.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {str(dtype)[6:]}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: A must be (B, N, N), got {tuple(A.shape)}")
    B, N, _ = A.shape
    if not kernel_supports(N, dtype):
        raise ValueError(f"{name}: no CUDA kernel for N={N} "
                         f"(8 | N <= {MAX_N[dtype]})")
    if not A.is_contiguous():
        raise ValueError(f"{name}: A must be contiguous")
    return B, N
