"""Concrete lattices (counterpart of montecarlo_tpu/lattices/library.py):
every lattice of the JAX package's library, made by the Bravais-with-basis
constructor with the same unit cells, so site numbering, bonds and colorings
agree with the JAX package's."""

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


def CubicLattice(L: int) -> Lattice:
    """3D periodic cubic lattice, bonds = the +x, +y and +z neighbor per
    site."""
    uc = UnitCell(
        name="cubic",
        primitive_vectors=np.eye(3),
        basis=np.zeros((1, 3)),
        bonds=((0, 0, (1, 0, 0), 0), (0, 0, (0, 1, 0), 0),
               (0, 0, (0, 0, 1), 0)),
    )
    return Lattice(uc, (L, L, L))


def TriangularLattice(L: int, Lx: int = None, Ly: int = None) -> Lattice:
    """2D periodic triangular lattice with 60-degree primitive vectors, 6
    nearest neighbors per site."""
    Lx = Lx or L
    Ly = Ly or L
    a1 = np.array([1.0, 0.0])
    a2 = np.array([0.5, np.sqrt(3) / 2])
    uc = UnitCell(
        name="triangular",
        primitive_vectors=np.stack([a1, a2]),
        basis=np.zeros((1, 2)),
        bonds=((0, 0, (1, 0), 0), (0, 0, (0, 1), 0), (0, 0, (1, -1), 0)),
    )
    return Lattice(uc, (Lx, Ly))


def Honeycomb(L: int) -> Lattice:
    """2D periodic honeycomb lattice: a 2-site basis, 3 neighbors per site."""
    a1 = np.array([np.sqrt(3), 0.0])
    a2 = np.array([np.sqrt(3) / 2, 1.5])
    basis = np.array([[0.0, 0.0], [np.sqrt(3) / 2, 0.5]])
    uc = UnitCell(
        name="honeycomb",
        primitive_vectors=np.stack([a1, a2]),
        basis=basis,
        bonds=((0, 1, (0, 0), 0), (0, 1, (-1, 0), 0), (0, 1, (0, -1), 0)),
    )
    return Lattice(uc, (L, L))


def GenericLattice(primitive_vectors, basis, bonds, shape,
                   name="generic") -> Lattice:
    """A lattice of any unit cell: bonds as (basis_from, basis_to,
    cell_offset, bond_type). Uneven coordination pads the neighbor table
    with -1."""
    uc = UnitCell(
        name=name,
        primitive_vectors=np.asarray(primitive_vectors, dtype=float),
        basis=np.asarray(basis, dtype=float),
        bonds=tuple((int(a), int(b), tuple(int(o) for o in off), int(t))
                    for (a, b, off, t) in bonds),
    )
    return Lattice(uc, shape)


def choose_lattice(dims: int, L: int) -> Lattice:
    """The default lattice for a dimensionality (the JAX package's rule:
    1 → chain, 2 → square, 3 → cubic)."""
    if dims == 1:
        return Chain(L)
    if dims == 2:
        return SquareLattice(L)
    if dims == 3:
        return CubicLattice(L)
    raise ValueError(f"No default lattice for dims={dims}")
