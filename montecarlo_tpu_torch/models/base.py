"""Model abstraction (counterpart of montecarlo_tpu/models/base.py).

A DQMC model provides what the engine reads directly: ``lattice``,
``nflavors``, ``flavor_signs``, ``use_boson_weight``, ``hopping_matrix()``,
``lamb(delta_tau)`` and ``rand_conf(...)``. There are no interaction or
local-update hooks: the engine owns the Hirsch algebra (``dqmc.core.eV_diag``
and the site-sweep kernel take the model's scalars).
"""

from __future__ import annotations

from typing import Dict

from ..lattices.lattice import Lattice


class Model:
    """Base class for Hamiltonians."""

    lattice: Lattice

    def parameters(self) -> Dict:
        raise NotImplementedError

    def __len__(self):
        return len(self.lattice)
