from .lattice import Lattice, UnitCell
from .library import (Chain, CubicLattice, GenericLattice, Honeycomb,
                      SquareLattice, TriangularLattice, choose_lattice)

__all__ = ["Chain", "CubicLattice", "GenericLattice", "Honeycomb", "Lattice",
           "SquareLattice", "TriangularLattice", "UnitCell", "choose_lattice"]
