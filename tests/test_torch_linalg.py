"""Stabilized linear algebra of the PyTorch/CUDA port (montecarlo_tpu_torch.
ops.linalg) against montecarlo_tpu.ops.linalg, on the same numpy inputs.

Permutation helpers must agree exactly. The float64 decompositions agree to
1e-10 relative: both are Householder QR (the JAX side and the port's library
path through LAPACK, the port's kernel path through the fused kernels' plain
column loop), so they differ only by rounding -- and, on the kernel path, by
the sign of the last column of U and the last row of R (_sign_normalized).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import linalg as jl
from montecarlo_tpu_torch.ops import linalg as tl

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _graded(seed, shape, decades=12.0):
    rng = np.random.default_rng(seed)
    N = shape[-1]
    return rng.normal(size=shape) * np.exp(
        rng.uniform(-decades, decades, size=shape[:-2] + (1, N)))


def _rand_udt(rng, B, N, decades):
    """Factors like a DQMC stack entry: orthogonal U, graded D, unit upper T."""
    U, _ = np.linalg.qr(rng.normal(size=(B, N, N)))
    D = np.sort(np.exp(rng.uniform(-decades, decades, size=(B, N))))[:, ::-1]
    T = np.triu(0.3 * rng.normal(size=(B, N, N)), 1) + np.eye(N)
    return U, D.copy(), T


@pytest.mark.parametrize("seed", [0, 1])
def test_argsort_desc_matches_with_ties(seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, size=(5, 12)).astype(np.float64)   # many ties
    pj, _ = jl.argsort_desc(jnp.asarray(v))
    pt = tl.argsort_desc(torch.from_numpy(v))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_permutation_helpers_match():
    rng = np.random.default_rng(2)
    piv = np.stack([rng.permutation(9) for _ in range(4)])
    A = rng.normal(size=(4, 9, 9))
    tp, ta = torch.from_numpy(piv), torch.from_numpy(A)
    jp, ja = jnp.asarray(piv), jnp.asarray(A)
    np.testing.assert_array_equal(tl.invert_permutation(tp).numpy(),
                                  np.asarray(jl.invert_permutation(jp)))
    np.testing.assert_array_equal(tl.permute_rows(ta, tp).numpy(),
                                  np.asarray(jl.permute_rows(ja, jp)))
    np.testing.assert_array_equal(tl.scatter_columns(ta, tp).numpy(),
                                  np.asarray(jl.scatter_columns(ja, jp)))
    # the identity the T-factor update relies on
    R = tl.scatter_columns(ta, tp) @ ta
    np.testing.assert_allclose(R.numpy(), (ta @ tl.permute_rows(ta, tp)).numpy(),
                               rtol=1e-12, atol=1e-12)


def _sign_normalized(U, R):
    """(U S, S R) with S = diag(sign R_jj): free of the QR's sign choice.
    LAPACK leaves a zero tail unreflected (the last column keeps alpha's
    sign); the fused kernels reflect it as the TPU kernel does, which flips
    the last column of U and the last row of R."""
    U, R = np.asarray(U), np.asarray(R)
    s = np.sign(np.diagonal(R, axis1=-2, axis2=-1))
    return U * s[..., None, :], R * s[..., :, None]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 2, 24, 24), (2, 136, 136)])
def test_udt_dirty_matches_jax_f64(use_kernels, shape):
    """N = 136 > 128 takes the blocked QR (K7) on the kernel path."""
    A = _graded(sum(shape), shape)
    Uj, Dj, Rj, pj = jl.udt_dirty(jnp.asarray(A))
    Ut, Dt, Rt, pt = tl.udt_dirty(torch.from_numpy(A), use_kernels)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=TOL)
    for a, b in zip(_sign_normalized(Ut, Rt), _sign_normalized(Uj, Rj)):
        assert _rel(a, b) <= TOL
    if not use_kernels:   # LAPACK on both sides: the same signs
        assert _rel(Ut.numpy(), Uj) <= TOL
        assert _rel(Rt.numpy(), Rj) <= TOL
    # the decomposition: A[..., :, piv] = U diag(D) R
    Ap = np.take_along_axis(A, pt.numpy()[..., None, :], axis=-1)
    rec = (Ut * Dt[..., None, :]) @ Rt
    assert _rel(rec.numpy(), Ap) <= TOL


def test_udt_dirty_library_path_fixes_flushed_modes():
    """The library path's rule for flushed modes: |diag| < 0.5 -> 1."""
    A = _graded(3, (2, 16, 16), decades=2.0)
    A[:, :, -4:] = 0.0
    Uj, Dj, Rj, pj = jl.udt_dirty(jnp.asarray(A))
    Ut, Dt, Rt, pt = tl.udt_dirty(torch.from_numpy(A), use_kernels=False)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    diag = torch.diagonal(Rt, dim1=-2, dim2=-1)
    assert torch.equal(diag.abs(), torch.ones_like(diag))
    np.testing.assert_array_equal(diag.numpy(),
                                  np.diagonal(np.asarray(Rj), axis1=-2, axis2=-1))


def test_prescale_is_an_exact_power_of_two():
    A = torch.from_numpy(_graded(4, (3, 8, 8), decades=30.0))
    _, mx, _ = tl._prescale_pivot(A)
    m, e = torch.frexp(mx)
    assert torch.equal(m, torch.full_like(m, 0.5))
    top = (A.abs().amax(dim=(-2, -1)) / mx[:, 0, 0])
    assert bool(((top > 2.0 ** 49) & (top <= 2.0 ** 50)).all())


def test_rdiv_dirty_matches_jax():
    rng = np.random.default_rng(5)
    A = _graded(5, (3, 12, 12))
    _, _, R, piv = jl.udt_dirty(jnp.asarray(A))
    Z = rng.normal(size=(3, 12, 12))
    ref = jl.rdiv_dirty(jnp.asarray(Z), R, piv)
    out = tl.rdiv_dirty(torch.from_numpy(Z), torch.tensor(np.asarray(R)),
                        torch.tensor(np.asarray(piv)).long())
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("decades", [4.0, 20.0])
def test_calculate_greens_matches_jax_f64(use_kernels, decades):
    rng = np.random.default_rng(int(decades))
    B, N = 3, 16
    l, r = _rand_udt(rng, B, N, decades), _rand_udt(rng, B, N, decades)
    Gj = jl.calculate_greens(*map(jnp.asarray, l + r))
    Gt = tl.calculate_greens(*map(torch.from_numpy, l + r),
                             use_kernels=use_kernels)
    assert _rel(Gt.numpy(), Gj) <= TOL
    # against the direct inverse at a grading where that is still accurate
    if decades == 4.0:
        (Ul, Dl, Tl), (Ur, Dr, Tr) = l, r
        P = (Ul * Dl[:, None, :]) @ Tl @ np.swapaxes(
            (Ur * Dr[:, None, :]) @ Tr, -1, -2)
        Gd = np.linalg.inv(np.eye(N) + P)
        assert _rel(Gt.numpy(), Gd) <= 1e-8


@pytest.mark.parametrize("use_kernels", [True, False])
def test_calculate_greens_large_n_matches_jax_f64(use_kernels):
    """N = 136: udt_dirty through K7 (kernel path) or LAPACK, then the
    triangular solve, against the JAX package."""
    rng = np.random.default_rng(11)
    l, r = _rand_udt(rng, 2, 136, 10.0), _rand_udt(rng, 2, 136, 10.0)
    Gj = jl.calculate_greens(*map(jnp.asarray, l + r))
    Gt = tl.calculate_greens(*map(torch.from_numpy, l + r),
                             use_kernels=use_kernels)
    assert _rel(Gt.numpy(), Gj) <= TOL


@pytest.mark.parametrize("use_kernels", [True, False])
def test_calculate_greens_float32_near_float64(use_kernels):
    """Both float32 paths stay within 1e-4 of the float64 result at DQMC-like
    grading (over five draws of these factors the kernel path's error was
    1.5e-6 to 2.3e-5, the library path's 1.4e-6 to 6.4e-5: conditioning of
    the random T sets it)."""
    rng = np.random.default_rng(9)
    l, r = _rand_udt(rng, 4, 16, 20.0), _rand_udt(rng, 4, 16, 20.0)
    G64 = jl.calculate_greens(*map(jnp.asarray, l + r))
    G32 = tl.calculate_greens(*[torch.from_numpy(x).float() for x in l + r],
                              use_kernels=use_kernels)
    assert G32.dtype == torch.float32
    assert _rel(G32.numpy(), G64) <= 1e-4
