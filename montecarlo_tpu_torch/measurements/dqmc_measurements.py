"""Standard equal-time DQMC observables (counterpart of
montecarlo_tpu/measurements/dqmc_measurements.py; only ``greens``,
``occupation`` and ``sign`` are ported so far, the rest is ROADMAP Queue 1
item 6).

Green's functions carry a flavor-block axis: (C, F, N, N).
"""

from __future__ import annotations

import torch

from .core import Measurement


def _session_eltype(mc):
    """Binner dtype of a G-derived observable: complex128 for a complex
    (Peierls) session, whose imaginary parts are data, float64 otherwise."""
    ctx = getattr(mc, "ctx", None)
    return torch.complex128 if ctx is not None and ctx.is_complex else torch.float64


def greens_measurement(mc, model, greens_at=None, **kwargs) -> Measurement:
    """Full equal-time Green's function, shape (F, N, N) per chain."""
    if greens_at is not None:
        raise NotImplementedError(
            "greens_at (time-displaced G) is not ported to montecarlo_tpu_torch "
            "yet (ROADMAP Queue 1 item 7)")
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
