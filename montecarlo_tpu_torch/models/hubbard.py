"""Hubbard models for DQMC (counterpart of montecarlo_tpu/models/hubbard.py).

Discrete Hirsch Hubbard-Stratonovich field sigma(i, l) = ±1, stored as an
int8 tensor of shape (chains, N, slices). The flavor-block axis F is the
leading matrix axis: F=1 attractive (spin-symmetric), F=2 repulsive (up/down
blocks with opposite HS coupling).

Local update data (used by ops/site_sweep.py):
  lambda       = acosh(exp(U*dtau/2))   Hirsch coupling
  flavor_signs = (+1,) attractive; (+1, -1) repulsive
  delta_f      = exp(sign_f * dE_boson) - 1 with dE_boson = -2*lambda*sigma
  r_f          = 1 + delta_f*(1 - G_f[i,i])
  detratio     = prod_f r_f ** (2/F)
  Metropolis weight = exp(-dE_boson * use_boson_weight) * detratio
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .base import Model
from ..lattices.lattice import Lattice
from ..lattices.library import choose_lattice


class _HubbardBase(Model):
    nflavors: int = 1
    flavor_signs = (1.0,)
    use_boson_weight: bool = True

    def __init__(self, dims: int = 2, L: int = None, l: Lattice = None,
                 t: float = 1.0, U: float = 1.0, mu: float = 0.0,
                 peierls=None):
        """peierls: optional (N, N) real antisymmetric phase matrix; the
        hopping then becomes complex, and make_context promotes the session
        to complex64 or complex128."""
        if l is None:
            if L is None:
                raise ValueError("need l=lattice or L (+dims)")
            l = choose_lattice(dims, L)
        self.lattice = l
        self.l = l
        self.t = float(t)
        self.U = float(U)
        if self.U < 0.0:
            raise ValueError("U is the absolute interaction strength")
        self.mu = float(mu)
        if peierls is not None:
            peierls = np.asarray(peierls, np.float64)
            if peierls.shape != (len(l), len(l)):
                raise ValueError("peierls must be (N, N)")
            if not np.allclose(peierls, -peierls.T):
                raise ValueError("peierls phases must be antisymmetric")
        self.peierls = peierls

    def parameters(self) -> Dict:
        p = {"t": self.t, "U": self.U, "mu": self.mu}
        if self.peierls is not None:
            p["peierls"] = np.asarray(self.peierls)
        p.update(dims=self.lattice.dim, L=self.lattice.shape[0])
        return p

    def rand_conf(self, generator: torch.Generator, n_chains: int,
                  n_slices: int, device=None) -> torch.Tensor:
        """Random ±1 HS field, (C, N, M) int8, drawn from ``generator``
        (which must live on ``device``; default: the generator's device)."""
        N = len(self.lattice)
        device = generator.device if device is None else device
        bits = torch.randint(0, 2, (n_chains, N, n_slices), generator=generator,
                             device=device, dtype=torch.int8)
        return 2 * bits - 1

    def hopping_matrix(self) -> np.ndarray:
        """(N, N) hopping matrix incl. chemical potential: -t on nearest-
        neighbor bonds, -mu on the diagonal (complex with Peierls phases)."""
        N = len(self.lattice)
        cplx = self.peierls is not None
        T = np.zeros((N, N), np.complex128 if cplx else np.float64)
        np.fill_diagonal(T, -self.mu)
        for (src, trg) in self.lattice.neighbors(directed=True):
            amp = -self.t
            if cplx:
                amp = amp * np.exp(1j * self.peierls[trg, src])
            T[trg, src] += amp
        return T

    def lamb(self, delta_tau: float) -> float:
        """Hirsch lambda = acosh(exp(U*dtau/2))."""
        return math.acosh(math.exp(0.5 * self.U * float(delta_tau)))

    def energy_boson(self, conf, delta_tau: float) -> torch.Tensor:
        """Bosonic (HS-field) energy per chain, (C,) float64, of a field
        conf (C, N, M): lambda * sum(sigma) with the bosonic weight, zero
        without it (repulsive)."""
        if not self.use_boson_weight:
            return torch.zeros(conf.shape[0], dtype=torch.float64,
                               device=conf.device)
        return self.lamb(delta_tau) * conf.sum(dim=(1, 2)).to(torch.float64)

    def __repr__(self):
        return (f"{type(self).__name__}({len(self.lattice)} sites, t={self.t}, "
                f"U={self.U}, mu={self.mu})")


class HubbardModelAttractive(_HubbardBase):
    """Attractive (-|U|) Hubbard model: one flavor block, detratio = r^2."""

    nflavors = 1
    flavor_signs = (1.0,)
    use_boson_weight = True


class HubbardModelRepulsive(_HubbardBase):
    """Repulsive (+|U|) Hubbard model: two flavor blocks with opposite HS
    coupling, no bosonic weight, defined at half filling."""

    nflavors = 2
    flavor_signs = (1.0, -1.0)
    use_boson_weight = False

    def __init__(self, dims: int = 2, L: int = None, l: Lattice = None,
                 t: float = 1.0, U: float = 1.0, mu: float = 0.0,
                 peierls=None):
        if mu != 0.0:
            raise ValueError("the repulsive model is defined at half filling (mu=0)")
        super().__init__(dims=dims, L=L, l=l, t=t, U=U, mu=0.0,
                         peierls=peierls)

    def parameters(self) -> Dict:
        p = super().parameters()
        p.pop("mu", None)
        return p


def HubbardModel(*args, U: float = 1.0, **kwargs):
    """Dispatch on the sign of U: U > 0 → repulsive, U ≤ 0 → attractive
    with |U|."""
    if U > 0:
        return HubbardModelRepulsive(*args, U=U, **kwargs)
    return HubbardModelAttractive(*args, U=-U, **kwargs)
