"""Measurement post-processing (counterpart of
montecarlo_tpu/measurements/postprocessing.py).

Host-side numpy transforms of distance-binned results: the
reciprocal-lattice discretization, Fourier transforms and structure
factors, symmetry-weighted sums and the superfluid density from the
current-current susceptibility. Inputs may be tensors (on any device) or
arrays, such as ``observables()[key][name].mean``; the arithmetic runs in
numpy float64, or complex128 for complex data.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    """x as a float64 (complex128 if complex) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64,
                    copy=False)


def reciprocal_discretization(lattice, L: int = None):
    """The L × L q points of the reciprocal parallelogram, each folded to
    its least norm (2-D lattices with a unit cell; L defaults to the
    lattice's first extent)."""
    B = lattice.reciprocal_vectors()
    if lattice.dim != 2:
        raise NotImplementedError("reciprocal discretization is 2D only")
    v1, v2 = B[0], B[1]
    L = L or lattice.shape[0]
    qs = []
    for i in range(L):
        for j in range(L):
            best, bestn = None, np.inf
            for n in (-1, 0, 1):
                for m in (-1, 0, 1):
                    q = v1 * (n + i / L) + v2 * (m + j / L)
                    if np.linalg.norm(q) < bestn:
                        bestn = np.linalg.norm(q)
                        best = q
            qs.append(best)
    return np.array(qs)


def fourier_transform(qs, dirs, values):
    """F(q) = Σ_dir exp(i q·dir) · value[dir], (n_q, ...) complex128."""
    qs, dirs, values = _host(qs), _host(dirs), _host(values)
    phases = np.exp(1j * qs @ dirs.T)  # (nq, ndirs)
    return phases @ values


def structure_factor(qs, dirs, values):
    """S(q) of distance-binned correlations: ``fourier_transform``."""
    return fourier_transform(qs, dirs, values)


def uniform_fourier(values):
    """The q = 0 component: the sum over the direction axis."""
    return np.sum(_host(values), axis=0)


def apply_symmetry(data, weights=(1.0,)):
    """Contract the trailing direction axes of a (dirs[, K[, K]]) binned
    result with symmetry weights (e.g. the s-wave or extended-s-wave form
    factors)."""
    data = _host(data)
    w = np.asarray(weights)
    if data.ndim == 1:
        return np.sum(w * data[: len(w)])
    if data.ndim == 2:
        return data[:, : len(w)] @ w
    if data.ndim == 3:
        return np.einsum("ijk,j,k->i", data[:, : len(w), : len(w)], w, w)
    raise ValueError(f"unsupported data rank {data.ndim}")


def superfluid_density(data, lattice, dirs=None):
    """Superfluid density from the (n_dirs, K) current-current
    susceptibility: ρ_s ∝ Λ_T − Λ_L, the difference of its transverse and
    longitudinal q → 0 limits (2-D lattices with a unit cell)."""
    data = _host(data)
    B = lattice.reciprocal_vectors()
    qx = B[0] / lattice.shape[0]
    qy = B[1] / lattice.shape[1]
    if dirs is None:
        dirs = lattice.directions
    out = 0.0 + 0.0j
    K = data.shape[1]
    for i in range(data.shape[0]):
        for j in range(K):
            d = dirs[j]
            out += (np.exp(1j * qy @ d) - np.exp(1j * qx @ d)) * data[i, j]
    return out
