"""Standard equal-time DQMC observables via Wick's theorem (counterpart of
montecarlo_tpu/measurements/dqmc_measurements.py): the Green's function,
occupation, sign, HS-field energy, and the charge, spin and pairing
correlations binned by distance. The time-displaced measurements
(susceptibilities, ``greens_at``) are ROADMAP Queue 1 item 1 and raise.

Green's functions carry a chain and a flavor-block axis: (C, F, N, N).
G[:, up] = G[:, 0], G[:, down] = G[:, F-1]: the attractive model (F = 1)
reads the same block for both spins, which gives its collapsed kernels;
the repulsive model (F = 2) has no cross-spin entries. Every kernel matrix
is formed for all chains at once with elementwise and outer-product algebra
and reduced over direction bins with one product by a one-hot matrix;
distance-binned outputs are divided by N.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .core import Measurement


class Greens:
    """Marker: the measurement needs the equal-time Green's function."""


class GreensAt:
    """Marker factory: the measurement needs G(k, l) (time-displaced, not
    ported: ROADMAP Queue 1 item 1)."""

    def __init__(self, k, l):
        self.kl = (int(k), int(l))


class CombinedGreensIterator:
    """Marker: the measurement integrates over (G(0,l), G(l,0), G(l,l))
    (susceptibilities, not ported: ROADMAP Queue 1 item 1)."""


def _time_displaced(what):
    return NotImplementedError(
        f"{what} (time-displaced) is not ported to montecarlo_tpu_torch yet "
        "(ROADMAP Queue 1 item 1)")


def _session_eltype(mc):
    """Binner dtype of a G-derived observable: complex128 for a complex
    (Peierls) session, whose imaginary parts are data, float64 otherwise."""
    ctx = getattr(mc, "ctx", None)
    return torch.complex128 if ctx is not None and ctx.is_complex else torch.float64


def _blocks(G):
    """(G_up, G_dn), each (C, N, N), of a (C, F, N, N) Green's function."""
    return G[:, 0], G[:, -1]


def _updn(G):
    Gu, Gd = _blocks(G)
    I = torch.eye(Gu.shape[-1], dtype=Gu.dtype, device=Gu.device)
    return Gu, Gd, I


def _diag(X):
    return torch.diagonal(X, dim1=-2, dim2=-1)


# ---------------------------------------------------------------- kernel mats
def cdc_matrix(G):
    """Charge density correlation kernel matrices K[c, i, j], (C, N, N)."""
    Gu, Gd, I = _updn(G)
    du = 1.0 - _diag(Gu)
    dd = 1.0 - _diag(Gd)
    nn = (du[:, :, None] * du[:, None, :] + du[:, :, None] * dd[:, None, :] +
          dd[:, :, None] * du[:, None, :] + dd[:, :, None] * dd[:, None, :])
    return nn + (I - Gu.mT) * Gu + (I - Gd.mT) * Gd


def sdc_x_matrix(G):
    """Spin density correlation kernel, x (and y: the same for a
    block-diagonal G, whose cross-spin entries vanish), (C, N, N)."""
    Gu, Gd, I = _updn(G)
    return (I - Gu.mT) * Gd + (I - Gd.mT) * Gu


sdc_y_matrix = sdc_x_matrix


def sdc_z_matrix(G):
    """Spin density correlation kernel, z, (C, N, N)."""
    Gu, Gd, I = _updn(G)
    du = 1.0 - _diag(Gu)
    dd = 1.0 - _diag(Gd)
    nn = (du[:, :, None] * du[:, None, :] - du[:, :, None] * dd[:, None, :] -
          dd[:, :, None] * du[:, None, :] + dd[:, :, None] * dd[:, None, :])
    return nn + (I - Gu.mT) * Gu + (I - Gd.mT) * Gd


def mz_vector(G):
    """m_z(i) = G_dn[i, i] - G_up[i, i], (C, N)."""
    Gu, Gd = _blocks(G)
    return _diag(Gd) - _diag(Gu)


# ------------------------------------------------------------- reductions
def _dir_onehot(lat):
    """One-hot direction-binning matrix P (N², n_dirs), numpy:
    P[i·N + j, d] = 1 iff pair_dir(i, j) == d."""
    N = len(lat)
    P = np.zeros((N * N, lat.n_dirs), np.float32)
    P[np.arange(N * N), lat.pair_dir.reshape(-1)] = 1.0
    return P


def _bin_by_dir(K, P, N):
    """Reduce (..., N, N) kernel matrices over direction bins: (..., n_dirs).
    P: the one-hot matrix as a tensor of K's dtype on K's device."""
    return K.reshape(K.shape[:-2] + (N * N,)) @ P / N


def _selection_matrices(lat, K):
    """One-hot target-selection matrices S (K, N, N), numpy:
    S[k, s, trg(s, k)] = 1 where the k-th direction target of s exists, the
    row zero where it does not (the validity mask). The quad gather
    G[trg(s1, k1), trg(s2, k2)] is (S_{k1} G S_{k2}ᵀ)[s1, s2]."""
    N = len(lat)
    trg, mask = lat.target_by_direction(K)
    S = np.zeros((K, N, N), np.float32)
    kk, ss = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    S[kk, ss, np.where(mask, trg, 0).T] = mask.T
    return S


class _OnDevice:
    """A host numpy constant, uploaded once per (device, dtype) it is asked
    for (the measurements run on the session's device, in G's dtype)."""

    def __init__(self, array):
        self.array = array
        self.cache = {}

    def like(self, X):
        key = (X.device, X.dtype)
        if key not in self.cache:
            self.cache[key] = torch.as_tensor(self.array).to(
                device=X.device, dtype=X.dtype)
        return self.cache[key]


# ----------------------------------------------------------- measurements
def greens_measurement(mc, model, greens_at=None, **kwargs) -> Measurement:
    """Full equal-time Green's function, shape (F, N, N) per chain."""
    if greens_at is not None:
        raise _time_displaced("greens_at")
    F, N = model.nflavors, len(model.lattice)

    def measure(greens, **_):
        return {"greens": greens}

    return Measurement("greens", {"greens": (F, N, N)}, measure,
                       dtype=_session_eltype(mc))


def occupation(mc, model, **kwargs) -> Measurement:
    """n(i) = 1 - Re G[i, i] per flavor, shape (F, N) per chain (the
    diagonal of a Hermitian model's G is real up to rounding)."""
    F, N = model.nflavors, len(model.lattice)

    def measure(greens, **_):
        return {"occ": 1.0 - torch.diagonal(greens, dim1=-2, dim2=-1).real}

    return Measurement("occupation", {"occ": (F, N)}, measure)


def sign_measurement(mc, model, **kwargs) -> Measurement:
    """Average sign / phase ⟨s⟩ of the configuration weight, per chain.

    Complex sessions accept with the real part of the weight; the phase they
    discard is tracked per chain (``core._track_detratio_batch``) and taken
    at the measurement point. ⟨s⟩ near 1 certifies the run free of the phase
    problem; |⟨s⟩| << 1 means the Re-projected estimators are biased (phase
    reweighting is not implemented, as in the JAX package). Real sessions
    measure the constant 1."""
    eltype = _session_eltype(mc)

    def measure(phase=None, greens=None, **_):
        if phase is None:
            return {"sign": torch.ones(greens.shape[0], dtype=eltype,
                                       device=greens.device)}
        return {"sign": phase}

    return Measurement("sign", {"sign": ()}, measure, dtype=eltype)


def boson_energy_measurement(mc, model, **kwargs) -> Measurement:
    """HS-field energy per chain (``model.energy_boson``)."""
    dtau = mc.parameters.delta_tau

    def measure(conf, **_):
        return {"E_boson": model.energy_boson(conf, dtau)}

    return Measurement("boson_energy", {"E_boson": ()}, measure)


def _by_distance_measurement(mc, model, name,
                             matrix_fn: Callable) -> Measurement:
    lat = model.lattice
    N = len(lat)
    P = _OnDevice(_dir_onehot(lat))

    def measure(greens, **_):
        K = matrix_fn(greens)
        return {name: _bin_by_dir(K, P.like(K), N)}

    return Measurement(name, {name: (lat.n_dirs,)}, measure,
                       dtype=_session_eltype(mc))


def charge_density_correlation(mc, model, **kwargs) -> Measurement:
    """⟨n_i n_j⟩ binned by distance, (n_dirs,) per chain."""
    return _by_distance_measurement(mc, model, "cdc", cdc_matrix)


def spin_density_correlation(mc, model, dir: str, **kwargs) -> Measurement:
    """⟨S^a_i S^a_j⟩, a = x/y/z, binned by distance, (n_dirs,) per chain."""
    fn = {"x": sdc_x_matrix, "y": sdc_y_matrix, "z": sdc_z_matrix}[dir]
    return _by_distance_measurement(mc, model, f"sdc_{dir}", fn)


def magnetization(mc, model, dir: str, **kwargs) -> Measurement:
    """m_a(i) per site, (N,) per chain; x and y vanish identically for a
    block-diagonal G (no spin-flip terms)."""
    N = len(model.lattice)

    def measure(greens, **_):
        if dir in ("x", "y"):
            m = greens.new_zeros(greens.shape[:1] + (N,))
        else:
            m = mz_vector(greens)
        return {f"m_{dir}": m}

    return Measurement(f"magnetization_{dir}", {f"m_{dir}": (N,)}, measure,
                       dtype=_session_eltype(mc))


def pairing_correlation(mc, model, K: int = None, **kwargs) -> Measurement:
    """s/extended-s-wave pairing correlation, (n_dirs, K, K) per chain:
    P[dir12, k1, k2] = 1/N Σ_{(s1,s2)∈dir12} G_up[s1,s2]·G_dn[t1,t2],
    t_i = the site at direction k_i from s_i (missing targets masked by
    the zero rows of the selection matrices)."""
    lat = model.lattice
    N = len(lat)
    if K is None:
        K = 1 + lat.coordination
    S = _OnDevice(_selection_matrices(lat, K))
    P = _OnDevice(_dir_onehot(lat))

    def measure(greens, **_):
        Gu, Gd = _blocks(greens)
        Sk = S.like(Gu)
        # Gd[t1(s1,k1), t2(s2,k2)] = (S_{k1} Gd S_{k2}ᵀ)[s1, s2]
        B = torch.einsum("kab,cbd->ckad", Sk, Gd)
        Cq = torch.einsum("ckad,qbd->ckqab", B, Sk)
        binned = _bin_by_dir(Gu[:, None, None] * Cq, P.like(Gu), N)
        return {"pc": torch.movedim(binned, -1, 1)}     # (C, n_dirs, K, K)

    return Measurement("pairing_correlation", {"pc": (lat.n_dirs, K, K)},
                       measure, dtype=_session_eltype(mc))


def charge_density(mc, model, greens_iterator=Greens, **kwargs):
    """Charge density correlation for the equal-time Green's function; the
    susceptibility (any other iterator) raises."""
    if greens_iterator is Greens:
        return charge_density_correlation(mc, model, **kwargs)
    raise _time_displaced("charge_density_susceptibility")


def spin_density(mc, model, dir, greens_iterator=Greens, **kwargs):
    """Spin density correlation for the equal-time Green's function; the
    susceptibility (any other iterator) raises."""
    if greens_iterator is Greens:
        return spin_density_correlation(mc, model, dir, **kwargs)
    raise _time_displaced("spin_density_susceptibility")


def pairing(mc, model, greens_iterator=Greens, **kwargs):
    """Pairing correlation for the equal-time Green's function; the
    susceptibility (any other iterator) raises."""
    if greens_iterator is Greens:
        return pairing_correlation(mc, model, **kwargs)
    raise _time_displaced("pairing_susceptibility")
