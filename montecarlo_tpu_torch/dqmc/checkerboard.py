"""Checkerboard slice matrices (counterpart of montecarlo_tpu/dqmc/
checkerboard.py).

Each hopping group g (vertex-disjoint bonds, ``Lattice.checkerboard_groups``)
exponentiates exactly as independent 2×2 bond rotations: for a bond
amplitude w = T[s, t] (T[t, s] = conj(w)),

    exp(-dtau·[[0, w], [conj(w), 0]]) = [[cosh|a|, -sinh|a|·p],
                                         [-sinh|a|·conj(p), cosh|a|]],
    a = dtau·w, p = a / |a|,

applied as row (left) or column (right) gather-mix-scatter updates of
(C, F, N, N) tensors; the chemical potential's diagonal is a scaling. The
slice matrix is the symmetric splitting

    B_cb = [prod_{g>=2} e^{-dtau/2 T_g}] e^{-dtau T_1}
           [prod_{g>=2, reversed} e^{-dtau/2 T_g}] · e^{-dtau mu} · e^{-dtau V(l)},

within O(dtau^2) of the dense e^{-dtau T} e^{-dtau V}, with an exact
inverse. ``make_context(checkerboard=True)`` applies it as one dense matrix
(``assemble_dense_operator``) in place of exp(-dtau T): the hot path and its
kernels are unchanged. The sparse appliers serve the tests and very large
lattices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class CheckerboardData:
    """Per-group bond indices and rotation coefficients, as tensors on one
    device: srcs, trgs (n_b,) int64; cosh_* real, sinh_* (the upper
    off-diagonal, -sinh|a|·p) real or complex; mu_diag (N,) e^{-dtau
    diag(T)} and its inverse."""

    srcs: Tuple
    trgs: Tuple
    cosh_full: Tuple       # e^{-dtau T_g}
    sinh_full: Tuple
    cosh_half: Tuple       # e^{-dtau/2 T_g}
    sinh_half: Tuple
    mu_diag: torch.Tensor
    mu_diag_inv: torch.Tensor


def build_checkerboard(lattice, hopping: np.ndarray, dtau: float,
                       device="cpu") -> CheckerboardData:
    """The groups' coefficients from the (Hermitian) hopping matrix, in
    float64 (sinh in complex128 for complex hopping), on device."""
    hopping = np.asarray(hopping)
    if np.iscomplexobj(hopping) and not np.allclose(hopping,
                                                    hopping.conj().T):
        raise ValueError("checkerboard needs a Hermitian hopping matrix")
    mk = lambda a: torch.as_tensor(a, device=device)

    def coeffs(a):
        mag = np.abs(a)
        safe = np.where(mag > 0, mag, 1.0)
        p = np.where(mag > 0, a / safe, np.ones_like(a))
        return mk(np.cosh(mag)), mk(-np.sinh(mag) * p)

    out = {k: [] for k in ("srcs", "trgs", "cosh_full", "sinh_full",
                           "cosh_half", "sinh_half")}
    for g in lattice.checkerboard_groups:
        s, t = g[:, 0].astype(np.int64), g[:, 1].astype(np.int64)
        a = dtau * hopping[s, t]
        out["srcs"].append(mk(s))
        out["trgs"].append(mk(t))
        for name, x in (("full", a), ("half", 0.5 * a)):
            c, sh = coeffs(x)
            out["cosh_" + name].append(c)
            out["sinh_" + name].append(sh)
    mu = np.diag(hopping).real
    return CheckerboardData(**{k: tuple(v) for k, v in out.items()},
                            mu_diag=mk(np.exp(-dtau * mu)),
                            mu_diag_inv=mk(np.exp(dtau * mu)))


def _mix_rows(M, src, trg, c, s):
    """M ← e^{-dtau T_g} M: mix the row pairs (src, trg) over the leading
    axes; s is the upper off-diagonal coefficient, conj(s) the lower."""
    A, B = M[..., src, :], M[..., trg, :]
    M = M.clone()
    M[..., src, :] = c[:, None] * A + s[:, None] * B
    M[..., trg, :] = s.conj()[:, None] * A + c[:, None] * B
    return M


def _mix_cols(M, src, trg, c, s):
    """M ← M e^{-dtau T_g}: mix the column pairs (T_g Hermitian: the src
    column takes conj(s), the trg column s)."""
    A, B = M[..., :, src], M[..., :, trg]
    M = M.clone()
    M[..., :, src] = c[None, :] * A + s.conj()[None, :] * B
    M[..., :, trg] = s[None, :] * A + c[None, :] * B
    return M


def _hop(cb: CheckerboardData, M, inv: bool, mix):
    """The symmetric group product applied by mix (rows: from the left,
    columns: from the right); inv flips the sign of every sinh, which
    inverts each rotation exactly."""
    n = len(cb.srcs)
    sgn = -1.0 if inv else 1.0
    for g in reversed(range(1, n)):
        M = mix(M, cb.srcs[g], cb.trgs[g], cb.cosh_half[g],
                sgn * cb.sinh_half[g])
    M = mix(M, cb.srcs[0], cb.trgs[0], cb.cosh_full[0], sgn * cb.sinh_full[0])
    for g in range(1, n):
        M = mix(M, cb.srcs[g], cb.trgs[g], cb.cosh_half[g],
                sgn * cb.sinh_half[g])
    return M


def _hop_left(cb, M, inv: bool):
    return _hop(cb, M, inv, _mix_rows)


def _hop_right(cb, M, inv: bool):
    return _hop(cb, M, inv, _mix_cols)


def mult_B_left_cb(ctx, consts, cb: CheckerboardData, sigma_l, M):
    """M ← B_cb(l) M (M: (C, F, N, N), sigma_l (C, N)): eV, mu, then the
    hopping groups."""
    from . import core
    M = core.eV_diag(ctx, sigma_l)[..., :, None] * M
    return _hop_left(cb, cb.mu_diag[:, None] * M, inv=False)


def mult_B_inv_left_cb(ctx, consts, cb: CheckerboardData, sigma_l, M):
    """M ← B_cb(l)^{-1} M."""
    from . import core
    M = cb.mu_diag_inv[:, None] * _hop_left(cb, M, inv=True)
    return core.eV_diag(ctx, sigma_l, -1.0)[..., :, None] * M


def mult_B_right_cb(ctx, consts, cb: CheckerboardData, sigma_l, M):
    """M ← M B_cb(l)."""
    from . import core
    M = _hop_right(cb, M, inv=False) * cb.mu_diag[None, :]
    return M * core.eV_diag(ctx, sigma_l)[..., None, :]


def mult_B_inv_right_cb(ctx, consts, cb: CheckerboardData, sigma_l, M):
    """M ← M B_cb(l)^{-1}."""
    from . import core
    M = M * core.eV_diag(ctx, sigma_l, -1.0)[..., None, :]
    return _hop_right(cb, M * cb.mu_diag_inv[None, :], inv=True)


def slice_matrix_cb(ctx, consts, cb: CheckerboardData, sigma_l):
    """B_cb(l) (C, F, N, N), assembled densely from the identity."""
    I = torch.eye(ctx.N, dtype=ctx.dtype, device=sigma_l.device).expand(
        sigma_l.shape[0], ctx.F, ctx.N, ctx.N)
    return mult_B_left_cb(ctx, consts, cb, sigma_l, I)


def assemble_dense_operator(lattice, hopping: np.ndarray, dtau: float):
    """The checkerboard hopping operator op = [prod_{g>=2} e^{-dtau/2 T_g}]
    e^{-dtau T_1} [prod_{g>=2, reversed} e^{-dtau/2 T_g}] · diag(e^{-dtau
    mu}) and its exact inverse (each rotation inverted, not the matrix), as
    dense (N, N) CPU tensors in float64, complex128 for complex hopping (as
    the JAX package assembles them, dqmc/checkerboard.py:189)."""
    hopping = np.asarray(hopping)
    cb = build_checkerboard(lattice, hopping, dtau)
    dtype = torch.complex128 if np.iscomplexobj(hopping) else torch.float64
    I = torch.eye(hopping.shape[0], dtype=dtype)
    op = _hop_left(cb, I, inv=False) * cb.mu_diag.to(dtype)[None, :]
    op_inv = cb.mu_diag_inv.to(dtype)[:, None] * _hop_left(cb, I, inv=True)
    return op, op_inv
