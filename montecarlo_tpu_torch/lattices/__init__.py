from .lattice import Lattice, UnitCell
from .library import SquareLattice, choose_lattice

__all__ = ["Lattice", "UnitCell", "SquareLattice", "choose_lattice"]
