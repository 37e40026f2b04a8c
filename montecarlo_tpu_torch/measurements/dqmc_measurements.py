"""Standard DQMC observables via Wick's theorem (counterpart of
montecarlo_tpu/measurements/dqmc_measurements.py): the Green's function
(equal-time, or time-displaced with ``greens_at``), occupation, sign,
HS-field energy, the charge, spin and pairing correlations binned by
distance, and the τ-integrated charge, spin, pairing and current-current
susceptibilities (kind "combined": step functions of the combined
iterator, ``dqmc/unequal_time.py``).

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
    """Marker factory: the measurement needs G(k, l). Use
    greens_measurement(mc, model, greens_at=(k, l))."""

    def __init__(self, k, l):
        self.kl = (int(k), int(l))


class CombinedGreensIterator:
    """Marker: the measurement integrates over (G(0,l), G(l,0), G(l,l))
    (the susceptibilities, Measurement.kind "combined")."""


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


# ------------------------------------------------- time-displaced kernel mats
def cdc4_matrix(G00, G0l, Gl0, Gll):
    """Charge density susceptibility step kernel, (C, N, N)."""
    Gu0, Gd0 = _blocks(G00)
    GuL, GdL = _blocks(Gll)
    du, dd = 1.0 - _diag(GuL), 1.0 - _diag(GdL)
    eu, ed = 1.0 - _diag(Gu0), 1.0 - _diag(Gd0)
    nn = (du + dd)[:, :, None] * (eu + ed)[:, None, :]
    G0lu, G0ld = _blocks(G0l)
    Gl0u, Gl0d = _blocks(Gl0)
    return nn - G0lu.mT * Gl0u - G0ld.mT * Gl0d


def sdc_x4_matrix(G00, G0l, Gl0, Gll):
    """Spin density susceptibility step kernel, x (and y: the same for a
    block-diagonal G), (C, N, N)."""
    G0lu, G0ld = _blocks(G0l)
    Gl0u, Gl0d = _blocks(Gl0)
    return -(G0lu.mT * Gl0d + G0ld.mT * Gl0u)


sdc_y4_matrix = sdc_x4_matrix


def sdc_z4_matrix(G00, G0l, Gl0, Gll):
    """Spin density susceptibility step kernel, z, (C, N, N)."""
    GuL, GdL = _blocks(Gll)
    Gu0, Gd0 = _blocks(G00)
    du, dd = 1.0 - _diag(GuL), 1.0 - _diag(GdL)
    eu, ed = 1.0 - _diag(Gu0), 1.0 - _diag(Gd0)
    nn = (du - dd)[:, :, None] * (eu - ed)[:, None, :]
    G0lu, G0ld = _blocks(G0l)
    Gl0u, Gl0d = _blocks(Gl0)
    return nn - G0lu.mT * Gl0u - G0ld.mT * Gl0d


# ----------------------------------------------------------- measurements
def greens_measurement(mc, model, greens_at=None, **kwargs) -> Measurement:
    """Full equal-time Green's function, shape (F, N, N) per chain; with
    ``greens_at=(k, l)`` the time-displaced G(k·dtau ← l·dtau)."""
    F, N = model.nflavors, len(model.lattice)
    eltype = _session_eltype(mc)
    if greens_at is None:
        def measure(greens, **_):
            return {"greens": greens}

        return Measurement("greens", {"greens": (F, N, N)}, measure,
                           dtype=eltype)

    def measure_at(utg, **_):
        return {"greens": utg}

    return Measurement(f"greens_at_{greens_at}", {"greens": (F, N, N)},
                       measure_at, kind="greens_at", dtype=eltype,
                       greens_at=(int(greens_at[0]), int(greens_at[1])))


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


def charge_density_susceptibility(mc, model, **kwargs) -> Measurement:
    """τ-integrated ⟨n_i(τ) n_j(0)⟩ binned by distance, (n_dirs,) per
    chain."""
    return _by_distance_susceptibility(mc, model, "cds", cdc4_matrix)


def spin_density_susceptibility(mc, model, dir: str, **kwargs) -> Measurement:
    """τ-integrated ⟨S^a_i(τ) S^a_j(0)⟩, a = x/y/z, binned by distance,
    (n_dirs,) per chain."""
    fn = {"x": sdc_x4_matrix, "y": sdc_y4_matrix, "z": sdc_z4_matrix}[dir]
    return _by_distance_susceptibility(mc, model, f"sds_{dir}", fn)


def _by_distance_susceptibility(mc, model, name, matrix4_fn) -> Measurement:
    lat = model.lattice
    N = len(lat)
    P = _OnDevice(_dir_onehot(lat))

    def step(G00, G0l, Gl0, Gll, **_):
        return {name: matrix4_fn(G00, G0l, Gl0, Gll)}

    def finish(acc):
        return {name: _bin_by_dir(acc[name], P.like(acc[name]), N)}

    return Measurement(name, {name: (lat.n_dirs,)}, step, kind="combined",
                       dtype=_session_eltype(mc),
                       combined_acc_shapes={name: (N, N)},
                       combined_finish_fn=finish)


def pairing_susceptibility(mc, model, K: int = None, **kwargs) -> Measurement:
    """τ-integrated pairing susceptibility, (n_dirs, K, K) per chain: the
    step kernel Gl0_up[s1, s2]·Gl0_dn[t1, t2], t_i the site at direction k_i
    from s_i."""
    lat = model.lattice
    N = len(lat)
    if K is None:
        K = 1 + lat.coordination
    S = _OnDevice(_selection_matrices(lat, K))
    P = _OnDevice(_dir_onehot(lat))

    def step(G00, G0l, Gl0, Gll, **_):
        Gl0u, Gl0d = _blocks(Gl0)
        Sk = S.like(Gl0u)
        # Gl0d[t1(s1,k1), t2(s2,k2)] = (S_{k1} Gl0d S_{k2}ᵀ)[s1, s2]
        B = torch.einsum("kab,cbd->ckad", Sk, Gl0d)
        Cq = torch.einsum("ckad,qbd->ckqab", B, Sk)
        return {"ps": Gl0u[:, None, None] * Cq}          # (C, K, K, N, N)

    def finish(acc):
        binned = _bin_by_dir(acc["ps"], P.like(acc["ps"]), N)
        return {"ps": torch.movedim(binned, -1, 1)}       # (C, n_dirs, K, K)

    return Measurement("pairing_susceptibility", {"ps": (lat.n_dirs, K, K)},
                       step, kind="combined", dtype=_session_eltype(mc),
                       combined_acc_shapes={"ps": (K, K, N, N)},
                       combined_finish_fn=finish)


def current_current_susceptibility(mc, model, K: int = None,
                                   **kwargs) -> Measurement:
    """τ-integrated current-current correlation, (n_dirs, K) per chain,
    binned by (dir12, dir) with synced bond directions.

    With t_i the site at direction k from s_i and the bond current
    j_b(s) = T[s,t]·G_b[t,s] - T[t,s]·G_b[s,t], the step kernel is
      Σ_{b1,b2} j_{b1,l}(s1)·j_{b2,0}(s2)
      + Σ_b [ T[t1,s1]T[t2,s2]·(-G0l_b[s2,t1])·Gl0_b[s1,t2]
            - T[s1,t1]T[t2,s2]·(-G0l_b[s2,s1])·Gl0_b[t1,t2]
            - T[t1,s1]T[s2,t2]·(-G0l_b[t2,t1])·Gl0_b[s1,s2]
            + T[s1,t1]T[s2,t2]·(-G0l_b[t2,s1])·Gl0_b[t1,s2] ]
    with every gather a product by the one-hot selection matrices S_k."""
    lat = model.lattice
    N = len(lat)
    if K is None:
        K = 1 + lat.coordination
    S = _OnDevice(_selection_matrices(lat, K))
    P = _OnDevice(_dir_onehot(lat))
    trg, mask = lat.target_by_direction(K)
    trg = np.where(mask, trg, 0)
    T_host = np.asarray(model.hopping_matrix())
    # per direction k the hopping along and against the bond, (K, N)
    T_st = _OnDevice(np.stack([T_host[np.arange(N), trg[:, k]]
                               for k in range(K)], 0))      # T[s, t(s,k)]
    T_ts = _OnDevice(np.stack([T_host[trg[:, k], np.arange(N)]
                               for k in range(K)], 0))      # T[t(s,k), s]

    def _dedup(G):
        """(distinct flavor blocks, multiplicity): F = 1 has G_up ≡ G_dn."""
        if G.shape[1] == 1:
            return [G[:, 0]], 2.0
        return [G[:, 0], G[:, -1]], 1.0

    def step(G00, G0l, Gl0, Gll, **_):
        Sk, tst, tts = S.like(Gl0), T_st.like(Gl0), T_ts.like(Gl0)

        def j_density(G):
            bs, mult = _dedup(G)
            total = 0.0
            for Gb in bs:
                d1 = torch.einsum("ksa,cas->cks", Sk, Gb)   # Gb[t(s,k), s]
                d2 = torch.einsum("csa,ksa->cks", Gb, Sk)   # Gb[s, t(s,k)]
                total = total + (tst * d1 - tts * d2)
            return mult * total                              # (C, K, N)

        jl, j0 = j_density(Gll), j_density(G00)
        Kmat = jl[..., :, None] * j0[..., None, :]           # (C, K, N, N)
        b0l, mult = _dedup(G0l)
        bl0, _ = _dedup(Gl0)
        for G0b, Gl0b in zip(b0l, bl0):
            G0T = G0b.mT
            A1 = torch.einsum("kab,cbd->ckad", Sk, G0T)      # G0l[s2, t1]
            A3 = torch.einsum("ckab,kdb->ckad", A1, Sk)      # G0l[t2, t1]
            B1 = torch.einsum("cab,kdb->ckad", G0T, Sk)      # G0l[t2, s1]
            A4 = torch.einsum("kab,cbd->ckad", Sk, Gl0b)     # Gl0[t1, s2]
            A5 = torch.einsum("ckab,kdb->ckad", A4, Sk)      # Gl0[t1, t2]
            B2 = torch.einsum("cab,kdb->ckad", Gl0b, Sk)     # Gl0[s1, t2]
            Kmat = Kmat + mult * (
                (tts[:, :, None] * tts[:, None, :]) * (-A1) * B2
                - (tst[:, :, None] * tts[:, None, :]) * (-G0T)[:, None] * A5
                - (tts[:, :, None] * tst[:, None, :]) * (-A3) * Gl0b[:, None]
                + (tst[:, :, None] * tst[:, None, :]) * (-B1) * A4)
        return {"ccs": Kmat}

    def finish(acc):
        return {"ccs": _bin_by_dir(acc["ccs"], P.like(acc["ccs"]), N).mT}

    return Measurement("current_current_susceptibility",
                       {"ccs": (lat.n_dirs, K)}, step, kind="combined",
                       dtype=_session_eltype(mc),
                       combined_acc_shapes={"ccs": (K, N, N)},
                       combined_finish_fn=finish)


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
    """Charge density correlation for the equal-time Green's function, the
    susceptibility for any other iterator."""
    if greens_iterator is Greens:
        return charge_density_correlation(mc, model, **kwargs)
    return charge_density_susceptibility(mc, model, **kwargs)


def spin_density(mc, model, dir, greens_iterator=Greens, **kwargs):
    """Spin density correlation for the equal-time Green's function, the
    susceptibility for any other iterator."""
    if greens_iterator is Greens:
        return spin_density_correlation(mc, model, dir, **kwargs)
    return spin_density_susceptibility(mc, model, dir, **kwargs)


def pairing(mc, model, greens_iterator=Greens, **kwargs):
    """Pairing correlation for the equal-time Green's function, the
    susceptibility for any other iterator."""
    if greens_iterator is Greens:
        return pairing_correlation(mc, model, **kwargs)
    return pairing_susceptibility(mc, model, **kwargs)
