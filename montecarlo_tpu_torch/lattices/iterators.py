"""Lattice iterators as whole index maps (counterpart of
montecarlo_tpu/lattices/iterators.py).

Each iterator names a set of site tuples and the shape of what a
measurement over it stores; ``measurements/custom.py`` turns a kernel over
an iterator into one gather or one product by a one-hot binning matrix,
built once on the host. Plain frozen dataclasses, copied from the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .lattice import BondLattice


@dataclass(frozen=True)
class EachSiteAndFlavor:
    """Every (site, flavor) index 0 .. N·flavors − 1."""
    lattice: BondLattice
    flavors: int = 1

    @property
    def indices(self):
        return np.arange(len(self.lattice) * self.flavors)

    def output_size(self, lattice):
        return (len(lattice) * self.flavors,)


@dataclass(frozen=True)
class EachSite:
    """Every site."""
    @property
    def indices(self):
        return None

    def output_size(self, lattice):
        return (len(lattice),)


@dataclass(frozen=True)
class OnSite:
    """(site, site) pairs."""
    def output_size(self, lattice):
        return (len(lattice),)


@dataclass(frozen=True)
class EachSitePair:
    """All (src, trg) pairs."""
    def output_size(self, lattice):
        return (len(lattice), len(lattice))


@dataclass(frozen=True)
class EachSitePairByDistance:
    """All (src, trg) pairs binned by their minimal periodic displacement,
    the output indexed by direction (``lattice.pair_dir``,
    ``lattice.n_dirs``)."""
    def output_size(self, lattice):
        return (lattice.n_dirs,)


@dataclass(frozen=True)
class EachLocalQuadByDistance:
    """(src1, trg1, src2, trg2) quads with trg_i among the K nearest
    directions from src_i, binned by (dir12, dir1, dir2)."""
    K: int

    def output_size(self, lattice):
        return (lattice.n_dirs, self.K, self.K)


@dataclass(frozen=True)
class EachLocalQuadBySyncedDistance:
    """EachLocalQuadByDistance with dir1 == dir2, binned by (dir12, dir)."""
    K: int

    def output_size(self, lattice):
        return (lattice.n_dirs, self.K)
