from .lattice import Lattice, UnitCell
from .library import Chain, SquareLattice, choose_lattice

__all__ = ["Chain", "Lattice", "UnitCell", "SquareLattice", "choose_lattice"]
