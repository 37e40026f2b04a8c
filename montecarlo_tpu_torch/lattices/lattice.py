"""Bravais lattices with a basis (numpy only).

Counterpart of montecarlo_tpu/lattices/lattice.py, restricted to what the
engines, their measurements and checkpoints read: site count, bonds, the
neighbor table, the binning of site pairs by their minimal periodic
displacement, the greedy colorings of bonds (checkerboard groups) and
sites, ``reciprocal_vectors`` and ``state_dict``. Site numbering, bond
order and direction bins are the JAX package's, so hopping matrices and
binned observables agree bit for bit.

Everything derived from the bond list lives in ``BondLattice``, which both
the Bravais ``Lattice`` and the bond-list ``alps.ArbitraryLattice`` extend
(the JAX package lends ``Lattice``'s methods to its ``ArbitraryLattice``
one by one instead).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property
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


class BondLattice:
    """What a lattice derives from its bond list and site positions.

    A subclass sets n_sites, bonds ((n_bonds, 3) int32 (src, trg, type),
    each undirected bond once), dim, shape, positions ((N, dim) or None)
    and cell_vectors ((dim, dim) periodicity vectors or None), then calls
    ``_build_neighbor_table``."""

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

    @property
    def size(self):
        return self.shape

    def neighbors(self, directed: bool = True) -> np.ndarray:
        """(n, 2) array of (src, trg) pairs; directed=True lists both
        orientations of every bond."""
        und = self.bonds[:, :2]
        if not directed:
            return und
        return np.concatenate([und, und[:, ::-1]], axis=0)

    def lattice_vectors(self) -> np.ndarray:
        return self.cell_vectors

    # --------------------------------------------------------- checkerboard
    @cached_property
    def checkerboard_groups(self) -> List[np.ndarray]:
        """Greedy edge coloring of the bond list into groups of
        vertex-disjoint bonds, in bond order: a list of (n_g, 2) int32
        arrays of (src, trg)."""
        bonds = [(int(s), int(t)) for (s, t, _ty) in self.bonds]
        used = np.zeros(len(bonds), dtype=bool)
        groups = []
        while not used.all():
            sites_used = np.zeros(self.n_sites, dtype=bool)
            group = []
            for bid, (src, trg) in enumerate(bonds):
                if used[bid] or sites_used[src] or sites_used[trg]:
                    continue
                used[bid] = sites_used[src] = sites_used[trg] = True
                group.append((src, trg))
            groups.append(np.array(group, dtype=np.int32))
        return groups

    @cached_property
    def site_colors(self) -> List[np.ndarray]:
        """Greedy coloring of the sites in index order (no two neighbors
        share a color; a square lattice of even L gets two): a list of
        int32 site arrays, one per color."""
        color = -np.ones(self.n_sites, dtype=np.int64)
        for i in range(self.n_sites):
            used = {color[j] for j in self.neighbor_table[i]
                    if j >= 0 and color[j] >= 0}
            c = 0
            while c in used:
                c += 1
            color[i] = c
        return [np.where(color == c)[0].astype(np.int32)
                for c in range(color.max() + 1)]

    # ------------------------------------------------------ direction binning
    @cached_property
    def _pair_binning(self):
        return _bin_pairs_by_distance(self.positions, self.cell_vectors)

    @property
    def pair_dir(self) -> np.ndarray:
        """(N, N) int32: pair_dir[src, trg] = direction-bin index of the
        minimal periodic displacement pos[src] - pos[trg], bins sorted by
        directed norm, bin 0 = onsite."""
        return self._pair_binning[0]

    @property
    def directions(self) -> np.ndarray:
        """(n_dirs, dim) displacement vector of each direction bin."""
        return self._pair_binning[1]

    @property
    def n_dirs(self) -> int:
        return self._pair_binning[1].shape[0]

    def target_by_direction(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """(N, K) int32 table trg[src, k] = the site at direction k from src,
        and its (N, K) validity mask (a direction with no target from src is
        masked; a periodic Bravais lattice with a basis has at most one)."""
        pd = self.pair_dir
        N = self.n_sites
        trg = -np.ones((N, K), dtype=np.int32)
        for src in range(N):
            for t in range(N):
                d = pd[src, t]
                if d < K:
                    trg[src, d] = t
        return trg, trg >= 0


class Lattice(BondLattice):
    """A finite periodic lattice with static index tables.

    Attributes (all host numpy):
      n_sites         total number of sites N
      positions       (N, dim) cartesian positions
      cell_vectors    (dim, dim) periodicity vectors L_i * a_i
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
        self.cell_vectors = (np.array(self.shape)[:, None] * A).astype(float)

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

    def reciprocal_vectors(self) -> np.ndarray:
        """Reciprocal primitive vectors 2π (A⁻¹)ᵀ, one per row."""
        return 2 * np.pi * np.linalg.inv(self.unitcell.primitive_vectors).T

    def state_dict(self):
        """What rebuilds the lattice: the unit cell and the shape
        (``Lattice(UnitCell(...), shape)``), the JAX package's layout."""
        uc = self.unitcell
        return {
            "name": uc.name,
            "primitive_vectors": np.asarray(uc.primitive_vectors),
            "basis": np.asarray(uc.basis),
            "bonds": [[a, b, list(off), t] for (a, b, off, t) in uc.bonds],
            "shape": list(self.shape),
        }

    @classmethod
    def from_state(cls, state):
        """The lattice of a ``state_dict``."""
        uc = UnitCell(
            name=state["name"],
            primitive_vectors=np.asarray(state["primitive_vectors"]),
            basis=np.asarray(state["basis"]),
            bonds=tuple((int(a), int(b), tuple(int(o) for o in off), int(t))
                        for (a, b, off, t) in state["bonds"]))
        return cls(uc, tuple(state["shape"]))


def _directed_norm(v: np.ndarray, eps: float = 1e-6) -> float:
    """norm + eps * polar angle: a unique sort key for 2D directions."""
    l = np.linalg.norm(v)
    if v.shape[0] == 2 and l > eps:
        ang = np.arccos(np.clip(v[0] / l, -1.0, 1.0))
        if v[1] < 0:
            ang = 2 * np.pi - ang
        return l + eps * ang
    return l


def _bin_pairs_by_distance(positions: np.ndarray, cell_vectors: np.ndarray,
                           eps: float = 1e-6):
    """(pair_dir, directions): every (src, trg) pair binned by its minimal
    periodic displacement pos[src] - pos[trg] (the wrap of least directed
    norm), the bins sorted by directed norm."""
    N, dim = positions.shape
    shifts = _generate_combinations(cell_vectors)
    disp = positions[:, None, :] - positions[None, :, :]            # (N,N,dim)
    cand = disp[:, :, None, :] + shifts[None, None, :, :]          # (N,N,S,dim)
    norms = np.linalg.norm(cand, axis=-1)
    if dim == 2:
        l = norms
        with np.errstate(invalid="ignore", divide="ignore"):
            ang = np.arccos(np.clip(
                cand[..., 0] / np.where(l > eps, l, 1.0), -1, 1))
        ang = np.where(cand[..., 1] < 0, 2 * np.pi - ang, ang)
        key = np.where(l > eps, l + eps * ang, l)
    else:
        key = norms
    best = np.argmin(key + 1e-12 * np.arange(len(shifts)), axis=-1)
    md = np.take_along_axis(cand, best[:, :, None, None], axis=2)[:, :, 0, :]
    # unique directions within eps, quantized
    q = np.round(md / eps).astype(np.int64)
    uniq, inv = np.unique(q.reshape(-1, dim), axis=0, return_inverse=True)
    uniq_vecs = uniq * eps
    keys = np.array([_directed_norm(v, eps) for v in uniq_vecs])
    order = np.argsort(keys, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    pair_dir = rank[inv].reshape(N, N).astype(np.int32)
    dirs = uniq_vecs[order]
    dirs[np.abs(dirs) < eps / 2] = 0.0          # snap near-zero to zero
    return pair_dir, dirs


def _generate_combinations(vs: np.ndarray) -> np.ndarray:
    """All {-1, 0, +1} integer combinations of the periodicity vectors."""
    out = [np.zeros(vs.shape[1])]
    for v in vs:
        out = [e - v for e in out] + out + [e + v for e in out]
    return np.stack(out, axis=0)
