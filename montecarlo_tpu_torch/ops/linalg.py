"""Stabilized dense linear algebra for DQMC, over the trailing two axes of
batched tensors (counterpart of montecarlo_tpu/ops/linalg.py).

UDT decomposition A = U·diag(D)·T with U unitary and D positive, column
pivoting realized as a one-shot column-norm sort before an unpivoted QR, in
the "dirty T" form: ``udt_dirty`` returns the triangular factor R and the
pivot so that triangular solves stay cheap. ``udt_dirty_colscaled`` is the
per-column-scaled variant of stab_method="qr_colscaled".

Two paths, chosen by ``use_kernels``:
  * kernel path (True), routed by dtype and N as the JAX package routes it:
    - float32, N <= 64: the fused kernels of ops/qr.py — K2 inside
      ``udt_dirty``, K3 (QR + triangular solve) inside ``calculate_greens``
      — whose flushed-mode rule is R_jj = +floor;
    - float32 at 64 < N <= 128, and float32 inside ``udt_dirty_colscaled``:
      the unfused QR K4 (ops/qr_householder.py), or with ``qr_wy`` K14
      (the reflectors V and tau) and Q assembled outside in WY form, the
      JAX package's MC_TPU_QR_WY route;
    - float64 at N <= 128: the float64 QR K11 (ops/qr_householder.py);
    - N > 128: the blocked QR K7 (ops/qr_blocked.py);
    - complex (Peierls sessions): the complex QR K10 (ops/qr_cx.py) for
      complex64 at N <= 128 and, as in the JAX package
      (pallas_qr.maybe_qr), the library QR beyond and for complex128;
    every unfused QR is followed by the unfused udt_dirty postscale, and
    ``calculate_greens`` by ``rdiv_dirty`` (the JAX package has no fused
    solve for them). The CUDA kernels take 8 | N (K11: N <= 64); on the CPU
    each route runs its kernel's plain version at any N;
  * library path (False): ``torch.linalg.qr`` + the udt_dirty postscale and
    ``torch.linalg.solve_triangular``.
The unfused postscale's flushed-mode rule is |diag| < 0.5 → 1; both rules
give flushed modes a unit diagonal. For complex A, D = |R_jj| and the phase
of R_jj stays in Rs's unit-magnitude diagonal.
"""

from __future__ import annotations

import torch

from .qr import F32_FLOOR, udt_qr, udt_qr_solve
from .qr_blocked import MIN_N as BLOCKED_MIN_N
from .qr_blocked import qr_blocked
from .qr_cx import qr_cx
from .qr_householder import qr_f32, qr_f64, qr_wy as _qr_wy

# the fused K2/K3 take float32 up to this N
FUSED_MAX_N = 64
# K10 takes complex up to this N; the JAX package runs XLA's QR beyond
CX_QR_MAX_N = 128


def argsort_desc(v):
    """Permutation sorting v descending along the last axis, ties to the
    lower index first (a stable sort of -v)."""
    return torch.sort(-v, dim=-1, stable=True).indices


def invert_permutation(piv):
    """ipiv[..., piv[..., j]] = j."""
    idx = torch.arange(piv.shape[-1], device=piv.device).expand_as(piv)
    return torch.empty_like(piv).scatter_(-1, piv, idx)


def permute_rows(T, piv):
    """T[..., piv, :]. scatter_columns(R, piv) @ T == R @ permute_rows(T, piv)
    lets the UDT T-factor update skip the inverse permutation."""
    return torch.take_along_dim(T, piv[..., :, None], dim=-2)


def scatter_columns(R, piv):
    """Given M and piv with A[..., :, piv] = M, return A."""
    return torch.take_along_dim(R, invert_permutation(piv)[..., None, :], dim=-1)


def _gather_columns(A, piv):
    return torch.take_along_dim(A, piv[..., None, :], dim=-1)


def _column_norms(A):
    sq = (A.real * A.real + A.imag * A.imag) if A.is_complex() else A * A
    return sq.sum(-2).sqrt()


def _prescale_pivot(A):
    """(Ap, mx, piv): A scaled by the power of two mx that brings its largest
    entry to ~2^50, with columns sorted by descending norm. Power-of-two
    scaling is exact, so the graded column structure is untouched; the
    headroom keeps squared norms from overflowing and small columns from
    flushing (DQMC products span tens of decades)."""
    mx = A.abs().amax(dim=(-2, -1), keepdim=True)
    mx = mx.clamp_min(torch.finfo(mx.dtype).tiny)
    mx = torch.exp2(torch.ceil(torch.log2(mx)) - 50.0)
    As = A / mx
    piv = argsort_desc(_column_norms(As))
    return _gather_columns(As, piv), mx, piv


def _fused(A, use_kernels):
    """True where the fused kernels K2/K3 take A: real float32, N <= 64."""
    return (use_kernels and A.dtype == torch.float32
            and A.shape[-1] <= FUSED_MAX_N)


def udt_dirty(A, use_kernels=True, qr_wy=False):
    """A = U · diag(D) · T with T = R[:, inv_piv] (T·P = R upper triangular).

    Returns (U, D, R, piv): U (..., n, n) unitary, D (..., n) positive,
    R (..., n, n) upper triangular with unit-magnitude diagonal, piv (..., n)
    with A[..., :, piv] = U D R. qr_wy takes K14 + the WY assembly in K4's
    place (``_qr``); the fused K2 keeps float32 N <= 64, as in the JAX
    package."""
    Ap, mx, piv = _prescale_pivot(A)
    shape, n = A.shape, A.shape[-1]
    if _fused(A, use_kernels):
        Q, Rs, d = udt_qr(Ap.reshape(-1, n, n), mx.reshape(-1))
        return Q.reshape(shape), d.reshape(shape[:-1]), Rs.reshape(shape), piv
    Q, R = _qr(Ap, use_kernels, qr_wy)
    d, Rs = _postscale(R)
    return Q, d * mx[..., 0], Rs, piv


def udt_dirty_colscaled(A, use_kernels=True, qr_wy=False):
    """Per-column-scaled udt_dirty (stab_method="qr_colscaled"): every column
    is normalized before the QR, so no column can overflow or flush to zero
    whatever beta. The scales s fold into D (d = |R_jj|·s_j) and into T
    (ratios s_j / s_i on the upper triangle, bounded by the descending
    pivot order). Same results as ``udt_dirty``; the QR goes through
    ``_qr`` (K4 in float32 on the kernel path, K14 with qr_wy)."""
    tiny = torch.finfo(A.real.dtype).tiny
    m = A.abs().amax(dim=-2).clamp_min(tiny)
    s = (m * _column_norms(A / m[..., None, :])).clamp_min(tiny)
    piv = argsort_desc(s)
    sp = torch.take_along_dim(s, piv, dim=-1)
    Q, R = _qr(_gather_columns(A, piv) / sp[..., None, :], use_kernels,
               qr_wy)
    dhat = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    dhat = dhat.clamp_min(torch.finfo(dhat.dtype).eps ** 2)
    n = R.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=A.device).triu()
    ratio = torch.where(upper, sp[..., None, :], 0.0) / sp[..., :, None]
    return Q, dhat * sp, (R / dhat[..., :, None]) * ratio, piv


def _qr(A, use_kernels, qr_wy=False):
    """(Q, R) of A (..., n, n) without floor or postscale: on the kernel path
    K10 (complex64, n <= 128), K7 (n > 128), K11 (float64) or K4 (float32;
    with qr_wy K14 and the WY assembly of Q), else the library QR (and for
    complex64 past n = 128 and complex128, as the JAX package)."""
    shape, n = A.shape, A.shape[-1]
    if not use_kernels or (A.is_complex() and (
            n > CX_QR_MAX_N or A.dtype != torch.complex64)):
        return _library_qr(A)
    if A.is_complex():
        qr = qr_cx
    elif n >= BLOCKED_MIN_N:
        qr = qr_blocked
    elif A.dtype == torch.float64:
        qr = qr_f64
    else:
        qr = _qr_wy if qr_wy else qr_f32
    Q, R = qr(A.reshape(-1, n, n))
    return Q.reshape(shape), R.reshape(shape)


def _library_qr(A):
    """torch.linalg.qr(A). Complex columns are first scaled to a largest
    entry of ~1 by exact powers of two, folded back into R's columns:
    Householder QR is equivariant under such scalings (each reflector comes
    from its own column, each update acts on one column), so the factors are
    those of A. cuSOLVER's complex64 QR returns non-finite factors on a CUDA
    device when some columns lie ~30 decades below the largest (measured on
    an H100; its float32 QR and LAPACK's do not), which the graded DQMC
    products reach at beta = 10."""
    if not A.is_complex():
        return torch.linalg.qr(A)
    top = A.abs().amax(dim=-2, keepdim=True)
    top = top.clamp_min(torch.finfo(top.dtype).tiny)
    s = torch.exp2(torch.ceil(torch.log2(top)))
    Q, R = torch.linalg.qr(A / s)
    return Q, R * s


def _postscale(R):
    """(d, Rs): d = |R_jj| floored (2^-70 in float32 and complex64,
    finfo.tiny in float64 and complex128), Rs = R / d with the unit diagonal
    forced on flushed modes."""
    d = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    floor = F32_FLOOR if d.dtype == torch.float32 else torch.finfo(d.dtype).tiny
    d = d.clamp_min(floor)
    Rs = R / d[..., :, None]
    # flushed modes have an all-zero R row: force the unit diagonal so the
    # triangular solves stay finite
    diag = torch.diagonal(Rs, dim1=-2, dim2=-1)
    fixed = torch.where(diag.abs() < 0.5, torch.ones_like(diag), diag)
    return d, Rs + torch.diag_embed(fixed - diag)


def rdiv_dirty(A, R, piv):
    """A · T^{-1} where T = scatter_columns(R, piv): A[..., :, piv] @ R^{-1}."""
    return torch.linalg.solve_triangular(R, _gather_columns(A, piv),
                                         upper=True, left=False)


def calculate_greens(Ul, Dl, Tl, Ur, Dr, Tr, use_kernels=True,
                     udt_fn=None):
    """G = [I + Ul·diag(Dl)·Tl · Tr^H·diag(Dr)·Ur^H]^{-1}, range-safe.

    With Dlp = max(Dl, 1), Dlm = min(Dl, 1) (likewise Dr):
      G = Ur·Drp^{-1}·M^{-1}·Dlp^{-1}·Ul^H,
      M = Dlp^{-1}·(Ul^H Ur)·Drp^{-1} + Dlm·(Tl Tr^H)·Drm,
    where every factor of M is bounded by ~1, so all intermediates stay
    within ~e^{beta·W}. One interior UDT of M by udt_fn (``udt_dirty`` when
    None; ``udt_dirty_colscaled`` for stab_method="qr_colscaled"): for
    ``udt_dirty`` in float32 at N <= 64 on the kernel path its QR and the
    triangular solve run fused in kernel K3, otherwise udt_fn is followed by
    ``rdiv_dirty``."""
    Dlp, Dlm = Dl.clamp_min(1.0), Dl.clamp_max(1.0)
    Drp, Drm = Dr.clamp_min(1.0), Dr.clamp_max(1.0)
    X = Tl @ Tr.mH
    M = (Ul.mH @ Ur) / Dlp[..., :, None] / Drp[..., None, :]
    M = M + (Dlm[..., :, None] * X) * Drm[..., None, :]
    Zpre = Ur / Drp[..., None, :]
    if udt_fn in (None, udt_dirty) and _fused(M, use_kernels):
        u, Z = _fused_greens_solve(M, Zpre)
    else:
        u, d, r, piv = (udt_fn or udt_dirty)(M, use_kernels)
        Z = rdiv_dirty(Zpre, r, piv) / d[..., None, :]
    W = u.mH / Dlp[..., None, :]
    return Z @ (W @ Ul.mH)


def _fused_greens_solve(M, Zpre):
    """(u, Z) with M·P = u·diag(d)·Rs and Z = (Zpre·P)·Rs^{-1}/d, through
    kernel K3 — udt_dirty(M) followed by rdiv_dirty(Zpre, Rs, piv)/d."""
    Mp, mx, piv = _prescale_pivot(M)
    Zp = _gather_columns(Zpre, piv)
    shape, n = M.shape, M.shape[-1]
    Q, X = udt_qr_solve(Mp.reshape(-1, n, n), Zp.reshape(-1, n, n),
                        mx.reshape(-1))
    return Q.reshape(shape), X.reshape(shape)
