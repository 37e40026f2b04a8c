"""Bravais lattices with a basis (numpy only).

Counterpart of montecarlo_tpu/lattices/lattice.py, restricted to what the
DQMC engine reads: site count, bonds and the neighbor table. Site numbering
and bond order are the JAX package's, so hopping matrices agree bit for bit.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class UnitCell:
    """A Bravais lattice with a basis.

    primitive_vectors: (dim, dim) rows are the primitive lattice vectors a_i.
    basis: (n_basis, dim) cartesian positions inside the cell.
    bonds: sequence of (basis_from, basis_to, cell_offset, bond_type) where
        cell_offset is a dim-tuple of unit-cell displacements.
    """

    name: str
    primitive_vectors: np.ndarray
    basis: np.ndarray
    bonds: Tuple[Tuple[int, int, Tuple[int, ...], int], ...]


class Lattice:
    """A finite periodic lattice with static index tables.

    Attributes (all host numpy):
      n_sites         total number of sites N
      positions       (N, dim) cartesian positions
      neighbor_table  (N, z_max) int32 directed neighbors, -1 padded
      bonds           (n_bonds, 3) int32 (src, trg, type), each undirected
                      bond once
    """

    def __init__(self, unitcell: UnitCell, shape: Sequence[int]):
        uc = unitcell
        self.unitcell = uc
        self.shape = tuple(int(s) for s in shape)
        dim = uc.primitive_vectors.shape[0]
        if len(self.shape) != dim:
            raise ValueError("shape must have one extent per dimension")
        self.dim = dim
        nb = uc.basis.shape[0]
        self.n_basis = nb

        # site index = basis + nb * (c_0 + L_0 * (c_1 + L_1 * (...)))
        cells = itertools.product(*[range(L) for L in reversed(self.shape)])
        cells = [tuple(reversed(c)) for c in cells]
        self._cells = np.array(sorted(cells, key=self._cell_rank), dtype=np.int64)
        self.n_cells = len(self._cells)
        self.n_sites = self.n_cells * nb

        A = uc.primitive_vectors
        self.positions = np.zeros((self.n_sites, dim))
        for ci, c in enumerate(self._cells):
            for b in range(nb):
                self.positions[nb * ci + b] = c @ A + uc.basis[b]

        self._build_bonds()
        self._build_neighbor_table()

    def _cell_rank(self, c) -> int:
        rank = 0
        for L, x in zip(reversed(self.shape), reversed(c)):
            rank = rank * L + x
        return rank

    def site_index(self, cell, basis: int = 0) -> int:
        c = tuple(int(x) % L for x, L in zip(cell, self.shape))
        return self.n_basis * self._cell_rank(c) + basis

    def _build_bonds(self):
        bonds = []
        for ci, c in enumerate(self._cells):
            for (b_from, b_to, off, btype) in self.unitcell.bonds:
                src = self.n_basis * ci + b_from
                trg = self.site_index(np.array(c) + np.array(off), b_to)
                bonds.append((src, trg, btype))
        self.bonds = np.array(bonds, dtype=np.int32).reshape(-1, 3)
        self.n_bonds = len(self.bonds)

    def _build_neighbor_table(self):
        nbrs: List[List[int]] = [[] for _ in range(self.n_sites)]
        for (src, trg, _t) in self.bonds:
            nbrs[src].append(int(trg))
            if trg != src:
                nbrs[trg].append(int(src))
        z = max((len(x) for x in nbrs), default=0)
        table = -np.ones((self.n_sites, z), dtype=np.int32)
        for i, x in enumerate(nbrs):
            table[i, : len(x)] = x
        self.neighbor_table = table
        self.coordination = z

    def __len__(self):
        return self.n_sites

    def neighbors(self, directed: bool = True) -> np.ndarray:
        """(n, 2) array of (src, trg) pairs; directed=True lists both
        orientations of every bond."""
        und = self.bonds[:, :2]
        if not directed:
            return und
        return np.concatenate([und, und[:, ::-1]], axis=0)
