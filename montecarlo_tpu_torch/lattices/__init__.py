from .alps import ALPSLattice, ArbitraryLattice
from .iterators import (EachLocalQuadByDistance,
                        EachLocalQuadBySyncedDistance, EachSite,
                        EachSiteAndFlavor, EachSitePair,
                        EachSitePairByDistance, OnSite)
from .lattice import Lattice, UnitCell
from .library import (Chain, CubicLattice, GenericLattice, Honeycomb,
                      SquareLattice, TriangularLattice, choose_lattice)

__all__ = ["ALPSLattice", "ArbitraryLattice", "Chain",
           "CubicLattice", "EachLocalQuadByDistance",
           "EachLocalQuadBySyncedDistance", "EachSite", "EachSiteAndFlavor",
           "EachSitePair", "EachSitePairByDistance", "GenericLattice",
           "Honeycomb", "Lattice", "OnSite", "SquareLattice",
           "TriangularLattice", "UnitCell", "choose_lattice"]
