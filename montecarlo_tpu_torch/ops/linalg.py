"""Stabilized dense linear algebra for DQMC, over the trailing two axes of
batched tensors (counterpart of montecarlo_tpu/ops/linalg.py).

UDT decomposition A = U·diag(D)·T with U unitary and D positive, column
pivoting realized as a one-shot column-norm sort before an unpivoted QR, in
the "dirty T" form: ``udt_dirty`` returns the triangular factor R and the
pivot so that triangular solves stay cheap. ``udt_dirty_colscaled`` is the
per-column-scaled variant of stab_method="qr_colscaled".

Two paths, chosen by ``use_kernels``:
  * kernel path (True), routed by ``qr_route(N, dtype)`` as the JAX
    package routes it (pallas_qr.qr_supported / maybe_qr / df_qr_ok):
    - "K2/K3", float32 at 8 | N <= 64: the fused kernels of ops/qr.py —
      K2 inside ``udt_dirty``, K3 (QR + triangular solve) inside
      ``calculate_greens`` and ``calculate_greens_inv`` — whose flushed-mode
      rule is R_jj = +floor; the unfused QR of ``udt_dirty_colscaled`` is
      K4 there;
    - "K4", float32 at 8 | N <= 128 past 64: the unfused QR K4
      (ops/qr_householder.py), or with ``qr_wy`` K14 (the reflectors V and
      tau) and Q assembled outside in WY form, the JAX package's
      MC_TPU_QR_WY route;
    - "K7", float32 at 8 | N > 128: the blocked QR K7 (ops/qr_blocked.py);
    - "K11", float64 at 8 | N <= 64: the float64 QR K11;
    - "K10", complex64 at 8 | N <= 128: the complex QR K10 (ops/qr_cx.py);
    - "library" for every other shape (8 ∤ N, float64 past N = 64,
      complex64 past N = 128, complex128): ``torch.linalg.qr``, where the
      JAX package runs XLA's QR;
    every unfused QR is followed by the unfused udt_dirty postscale, and
    the Green's functions by ``rdiv_dirty`` (the JAX package has no fused
    solve for them). The route is the same on every device: on the CPU a
    kernel's route runs its plain version;
  * library path (False): ``torch.linalg.qr`` + the udt_dirty postscale and
    ``torch.linalg.solve_triangular``.
The unfused postscale's flushed-mode rule is |diag| < 0.5 → 1; both rules
give flushed modes a unit diagonal. For complex A, D = |R_jj| and the phase
of R_jj stays in Rs's unit-magnitude diagonal.
"""

from __future__ import annotations

import torch

from . import qr as _qr_fused
from . import qr_blocked as _qr_blocked
from . import qr_cx as _qr_cx
from . import qr_householder as _qrh
from .qr import F32_FLOOR, udt_qr, udt_qr_solve
from .qr_blocked import qr_blocked
from .qr_cx import qr_cx
from .qr_householder import qr_f32, qr_f64, qr_wy as _qr_wy


def qr_route(N: int, dtype) -> str:
    """The kernel path's QR of an (N, N) matrix of dtype, chosen by shape:
    "K2/K3" (float32, 8 | N <= 64: the fused UDT and UDT + solve of
    ``udt_dirty`` and the Green's functions), "K4" (float32, 8 | N <= 128),
    "K7" (float32, 8 | N > 128 within one block's shared memory), "K11"
    (float64, 8 | N <= 64), "K10" (complex64, 8 | N <= 128) or "library"
    (``torch.linalg.qr``; every other shape, as the JAX package runs XLA's
    QR where no Pallas kernel takes it: pallas_qr.py:1222 qr_supported,
    :1247 maybe_qr, :1540 df_qr_ok)."""
    if dtype == torch.float32:
        if _qr_fused.kernel_supports(N):
            return "K2/K3"
        if _qrh.kernel_supports(N, torch.float32):
            return "K4"
        if _qr_blocked.kernel_supports(N):
            return "K7"
    elif dtype == torch.float64:
        if _qrh.kernel_supports(N, torch.float64):
            return "K11"
    elif dtype == torch.complex64:
        if _qr_cx.kernel_supports(N):
            return "K10"
    return "library"


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
    """True where the fused kernels K2/K3 take A: the kernel path at
    ``qr_route`` "K2/K3" (float32, 8 | N <= 64)."""
    return use_kernels and qr_route(A.shape[-1], A.dtype) == "K2/K3"


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
    the unfused QR of ``qr_route``: K4 on the "K2/K3" and "K4" routes (with
    qr_wy K14 and the WY assembly of Q), K7, K11, K10, or the library QR;
    the library QR off the kernel path."""
    shape, n = A.shape, A.shape[-1]
    route = qr_route(n, A.dtype) if use_kernels else "library"
    if route == "library":
        return _library_qr(A)
    qr = {"K7": qr_blocked, "K11": qr_f64, "K10": qr_cx}.get(
        route, _qr_wy if qr_wy else qr_f32)
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
    products reach at beta = 10. ``_library_qr.launches`` counts the calls
    on a CUDA tensor, as the kernel wrappers count their launches."""
    if A.device.type == "cuda":
        _library_qr.launches += 1
    if not A.is_complex():
        return torch.linalg.qr(A)
    top = A.abs().amax(dim=-2, keepdim=True)
    top = top.clamp_min(torch.finfo(top.dtype).tiny)
    s = torch.exp2(torch.ceil(torch.log2(top)))
    Q, R = torch.linalg.qr(A / s)
    return Q, R * s


_library_qr.launches = 0


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
    ``udt_dirty`` on the "K2/K3" route its QR and the triangular solve run
    fused in kernel K3, otherwise udt_fn is followed by ``rdiv_dirty``.
    For unitary Ul, Ur this is ``calculate_greens_inv`` of Ul^H, Ur^H, the
    same operations on the same values."""
    return calculate_greens_inv(Ul.mH, Dl, Tl, Ur.mH, Dr, Tr, use_kernels,
                                udt_fn)


def calculate_greens_inv(Ulinv, Dl, Tl, Urinv, Dr, Tr, use_kernels=True,
                         udt_fn=None):
    """``calculate_greens`` through the explicit inverses Ulinv = Ul^{-1},
    Urinv = Ur^{-1} of possibly non-unitary factors (the JAX package's
    calculate_greens_inv, ops/linalg.py:358):

      G = Ur^{-H}·Drp^{-1}·M^{-1}·Dlp^{-1}·Ul^{-1},
      M = Dlp^{-1}·(Ul^{-1}·Ur^{-H})·Drp^{-1} + Dlm·(Tl Tr^H)·Drm.

    The g_refresh mode's carries accumulate raw B multiplications between
    stack boundaries and their inverses beside them, so Ulinv and Urinv are
    not unitary there. K3 takes Ur^{-H} / Drp as its right-hand side."""
    Dlp, Dlm = Dl.clamp_min(1.0), Dl.clamp_max(1.0)
    Drp, Drm = Dr.clamp_min(1.0), Dr.clamp_max(1.0)
    Urdaginv = Urinv.mH
    X = Tl @ Tr.mH
    M = (Ulinv @ Urdaginv) / Dlp[..., :, None] / Drp[..., None, :]
    M = M + (Dlm[..., :, None] * X) * Drm[..., None, :]
    Zpre = Urdaginv / Drp[..., None, :]
    if udt_fn in (None, udt_dirty) and _fused(M, use_kernels):
        u, Z = _fused_greens_solve(M, Zpre)
    else:
        u, d, r, piv = (udt_fn or udt_dirty)(M, use_kernels)
        Z = rdiv_dirty(Zpre, r, piv) / d[..., None, :]
    W = u.mH / Dlp[..., None, :]
    return Z @ (W @ Ulinv)


def _fused_greens_solve(M, Zpre):
    """(u, Z) with M·P = u·diag(d)·Rs and Z = (Zpre·P)·Rs^{-1}/d, through
    kernel K3 — udt_dirty(M) followed by rdiv_dirty(Zpre, Rs, piv)/d."""
    Mp, mx, piv = _prescale_pivot(M)
    Zp = _gather_columns(Zpre, piv)
    shape, n = M.shape, M.shape[-1]
    Q, X = udt_qr_solve(Mp.reshape(-1, n, n), Zp.reshape(-1, n, n),
                        mx.reshape(-1))
    return Q.reshape(shape), X.reshape(shape)
