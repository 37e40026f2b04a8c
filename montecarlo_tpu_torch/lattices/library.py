"""Concrete lattices (counterpart of montecarlo_tpu/lattices/library.py).
The chain and the square lattice are ported; the others are ROADMAP Queue 1
item 9."""

from __future__ import annotations

import numpy as np

from .lattice import Lattice, UnitCell


def Chain(L: int) -> Lattice:
    """1D periodic chain, bond = right neighbor per site."""
    uc = UnitCell(
        name="chain",
        primitive_vectors=np.eye(1),
        basis=np.zeros((1, 1)),
        bonds=((0, 0, (1,), 0),),
    )
    return Lattice(uc, (L,))


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
    if dims == 1:
        return Chain(L)
    if dims == 2:
        return SquareLattice(L)
    if dims == 3:
        raise NotImplementedError(
            "dims=3: the cubic lattice is not ported yet "
            "(ROADMAP Queue 1 item 9)")
    raise ValueError(f"No default lattice for dims={dims}")
