"""Concrete lattices (counterpart of montecarlo_tpu/lattices/library.py).
Only the square lattice is ported so far; the others are ROADMAP Queue 1
item 18."""

from __future__ import annotations

import numpy as np

from .lattice import Lattice, UnitCell


def SquareLattice(L: int) -> Lattice:
    """2D periodic square lattice, bonds = right and up neighbor per site."""
    uc = UnitCell(
        name="square",
        primitive_vectors=np.eye(2),
        basis=np.zeros((1, 2)),
        bonds=((0, 0, (1, 0), 0), (0, 0, (0, 1), 0)),
    )
    return Lattice(uc, (L, L))


def choose_lattice(dims: int, L: int) -> Lattice:
    """The default lattice for a dimensionality (the JAX package's rule:
    1 → chain, 2 → square, 3 → cubic)."""
    if dims == 2:
        return SquareLattice(L)
    if dims in (1, 3):
        raise NotImplementedError(
            f"dims={dims}: only the square lattice is ported "
            "(ROADMAP Queue 1 item 18)")
    raise ValueError(f"No default lattice for dims={dims}")
