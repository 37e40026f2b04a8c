"""Fused Householder UDT kernels (K2: QR + udt_dirty postscale; K3: QR +
right-triangular solve).

``udt_qr`` and ``udt_qr_solve`` launch the CUDA kernels of
``csrc/udt_qr.cu`` on CUDA tensors and run ``udt_qr_plain`` /
``udt_qr_solve_plain`` (plain PyTorch, same algorithm and op order) on CPU
tensors. They replace the Pallas kernels
``montecarlo_tpu/ops/pallas_qr.py::_udt_kernel`` (via ``_udt_fused_batched``)
and ``::_udt_solve_kernel`` (via ``_udt_solve_batched``).

Both take the PRESCALED, column-PIVOTED matrix A (B, N, N) and its power-of-
two prescale mx (B,); pivoting and prescaling stay outside, in ops/linalg.py.
Column-by-column Householder QR with the LAPACK sign convention
(v_j = alpha + sign(alpha)·normx, R_jj = -sign(alpha)·normx), tau = 0 on a
zero tail (H = I), exact zero fill below the diagonal, and a floored
diagonal: d_j = max(|R_jj|, floor) and R_jj = +floor where |R_jj| < floor,
so flushed modes get an exact +1 on the normalized diagonal. floor = 2^-70
in float32 (the TPU kernels' value) and finfo.tiny in float64 (the JAX
package's cpu/gpu value).

A reflector whose v·v is below the smallest normal number (finfo.tiny) also
gets tau = 0. The TPU flushes such subnormal values to zero, so there this is
the zero-tail case; CUDA and the CPU keep subnormals, and 2 / v·v would
overflow to inf and fill the matrix with NaN. That happens on real float32
operands at beta = 10 (without this rule an 8x8 init_state turns NaN in
every chain); the modes involved lie some 35 decades below the largest,
where float32 holds no information about them anyway.

  udt_qr:       (Q, Rs = R / d, d·mx)          A·P = Q·diag(d·mx)·Rs
  udt_qr_solve: (Q, X = (Z/mx)·R⁻¹)            back-substitution pipelined
                                               into the column loop
"""

from __future__ import annotations

import torch

from . import _build

F32_FLOOR = 2.0 ** -70
# the phases that a build with -DMC_PHASE_STAMPS times (chip_profile.py)
# (lane 0 of each block's last warp, whose columns stay live longest) in
# the column loop of K2, K3, K4 and K14 (csrc/udt_qr.cu)
PHASES = ("load and first reflector", "update of A (K3: and the fold)",
          "next reflector (owner warp)", "update of Q (K14: none)", "barrier",
          "store")


def kernel_supports(N: int) -> bool:
    """Shapes the CUDA kernels take: float32 with 8 | N <= 64 (A, Q and X of
    one matrix stay in the registers of one block of 8 warps, N / 8 columns
    per warp; the TPU kernels' eligibility)."""
    return N % 8 == 0 and 8 <= N <= 64


def _floor(dtype):
    return F32_FLOOR if dtype == torch.float32 else torch.finfo(dtype).tiny


def _householder_qr(A, mx, Z=None):
    """Shared column loop of the plain versions. Returns (Q, R, d) with d the
    floored |R_jj| (prescaled domain), or (Q, X) when Z is given."""
    B, N, _ = A.shape
    floor = _floor(A.dtype)
    tiny = torch.finfo(A.dtype).tiny
    R = A.clone()
    Q = torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N).clone()
    d = torch.empty(B, N, dtype=A.dtype, device=A.device)
    if Z is not None:
        X = torch.zeros_like(A)
        invmx = 1.0 / mx
    for j in range(N):
        x = R[:, :, j]
        alpha = x[:, j]
        tail = x[:, j + 1:]
        sigma = (tail * tail).sum(-1)
        normx = torch.sqrt(alpha * alpha + sigma)
        s = torch.where(alpha >= 0, 1.0, -1.0).to(A.dtype)
        vj = alpha + s * normx
        v = torch.cat([vj[:, None], tail], dim=1)            # rows j..N-1
        vtv = sigma + vj * vj
        tau = torch.where(vtv >= tiny, 2.0 / vtv, 0.0)
        # trailing columns: A[:, c] -= (tau·(A[:, c]·v))·v for c > j
        w = torch.einsum("brc,br->bc", R[:, j:, j + 1:], v)
        R[:, j:, j + 1:] -= (tau[:, None] * w)[:, None, :] * v[:, :, None]
        # finalize column j: exact zero fill, floored diagonal
        rjj = -s * normx
        absr = rjj.abs()
        rjj_eff = torch.where(absr < floor, floor, rjj)
        R[:, j + 1:, j] = 0.0
        R[:, j, j] = rjj_eff
        d[:, j] = absr.clamp_min(floor)
        # Q <- Q·H
        qw = torch.einsum("brk,bk->br", Q[:, :, j:], v)
        Q[:, :, j:] -= (tau[:, None] * qw)[:, :, None] * v[:, None, :]
        if Z is not None:
            # X·R = Z/mx, column j: X[:, j] = (Z[:, j]/mx - ACC_j) / R_jj,
            # then fold X[:, j]·R[j, c] into the accumulators of columns c > j
            xcol = (Z[:, :, j] * invmx[:, None] - X[:, :, j]) / rjj_eff[:, None]
            X[:, :, j + 1:] += R[:, j, None, j + 1:] * xcol[:, :, None]
            X[:, :, j] = xcol
    if Z is not None:
        return Q, X
    return Q, R, d


def udt_qr_plain(A, mx):
    """Plain PyTorch fused UDT of a prescaled, pivoted A (B, N, N) with
    prescale mx (B,): returns (Q, Rs, d·mx). Any N, float32 or float64."""
    Q, R, d = _householder_qr(A, mx)
    return Q, R / d[:, :, None], d * mx[:, None]


def udt_qr_solve_plain(A, Z, mx):
    """Plain PyTorch fused UDT + solve: QR of the prescaled, pivoted A and
    X = (Z / mx)·R⁻¹ for the pivoted right-hand side Z (B, N, N). Returns
    (Q, X). Any N, float32 or float64."""
    return _householder_qr(A, mx, Z)


def udt_qr(A, mx):
    """Fused UDT (kernel K2) of A (B, N, N) with prescale mx (B,): the CUDA
    kernel for a CUDA tensor (float32, 8 | N <= 64, contiguous),
    ``udt_qr_plain`` for a CPU tensor."""
    if A.device.type == "cpu":
        return udt_qr_plain(A, mx)
    B, N = _check("udt_qr", A, mx)
    Q, Rs = torch.empty_like(A), torch.empty_like(A)
    d = torch.empty(B, N, dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        code = _build.load().udt_qr_f32(
            A.data_ptr(), mx.data_ptr(), Q.data_ptr(), Rs.data_ptr(),
            d.data_ptr(), B, N, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("udt_qr", code)
    udt_qr.launches += 1
    return Q, Rs, d


udt_qr.launches = 0


def udt_qr_solve(A, Z, mx):
    """Fused UDT + solve (kernel K3) of A, Z (B, N, N) with prescale mx (B,):
    the CUDA kernel for CUDA tensors (float32, 8 | N <= 64, contiguous),
    ``udt_qr_solve_plain`` for CPU tensors."""
    if A.device.type == "cpu":
        return udt_qr_solve_plain(A, Z, mx)
    _check("udt_qr_solve", A, mx, Z)
    B, N, _ = A.shape
    Q, X = torch.empty_like(A), torch.empty_like(A)
    with torch.cuda.device(A.device):
        code = _build.load().udt_qr_solve_f32(
            A.data_ptr(), Z.data_ptr(), mx.data_ptr(), Q.data_ptr(),
            X.data_ptr(), B, N, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("udt_qr_solve", code)
    udt_qr_solve.launches += 1
    return Q, X


udt_qr_solve.launches = 0


def _check(name, A, mx, Z=None):
    if A.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {A.device}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: A must be (B, N, N), got {tuple(A.shape)}")
    B, N, _ = A.shape
    if not kernel_supports(N):
        raise ValueError(f"{name}: no CUDA kernel for N={N} (8 | N <= 64)")
    ts = [A, mx] if Z is None else [A, mx, Z]
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{name}: the CUDA kernel takes float32")
    if tuple(mx.shape) != (B,) or (Z is not None and Z.shape != A.shape):
        raise ValueError(f"{name}: mx must be (B,) and Z like A")
    if any(t.device != A.device or not t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: tensors must be contiguous on one device")
    return B, N
