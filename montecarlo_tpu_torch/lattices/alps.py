"""ALPS XML lattice import (counterpart of montecarlo_tpu/lattices/alps.py).

Parses an ALPS "lattice graph" XML file — a <GRAPH vertices=".."
dimension=".."> element with <VERTEX> children (optionally carrying
<COORDINATE> positions) and <EDGE source=".." target=".." type=".."
id=".." vector=".."/> children — into an :class:`ArbitraryLattice`, which
offers what models and flavors read of a lattice (n_sites, bonds, the
neighbor table, checkerboard groups, site colors) from ``BondLattice``, so
every model and flavor runs on it unchanged.

Uses the standard library's xml.etree parser. ALPS files index sites from
1; everything here is 0-based.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from functools import cached_property
from typing import List, Optional

import numpy as np

from .lattice import BondLattice, _bin_pairs_by_distance


class ArbitraryLattice(BondLattice):
    """A finite lattice given by an explicit site and bond list (no unit
    cell).

    Models only need ``len(l)``, ``l.neighbors()`` and the checkerboard and
    site colorings, all of which derive from the bond list.
    Distance-binned lattice iterators (pair_dir, directions) also need
    positions and periodicity vectors, and raise ValueError when those were
    not given. Its shape is (n_sites,)."""

    def __init__(self, n_sites: int, bonds: np.ndarray,
                 positions: Optional[np.ndarray] = None,
                 cell_vectors: Optional[np.ndarray] = None,
                 dim: int = None, name: str = "arbitrary"):
        self.name = name
        self.n_sites = int(n_sites)
        self.bonds = np.asarray(bonds, dtype=np.int32).reshape(-1, 3)
        self.n_bonds = len(self.bonds)
        self.positions = (None if positions is None
                          else np.asarray(positions, float))
        self.cell_vectors = (None if cell_vectors is None
                             else np.asarray(cell_vectors, float))
        self.dim = int(dim) if dim is not None else (
            self.positions.shape[1] if self.positions is not None else 1)
        self.shape = (self.n_sites,)
        self._build_neighbor_table()

    def lattice_vectors(self):
        if self.cell_vectors is None:
            raise ValueError(f"{self.name}: no periodicity vectors available")
        return self.cell_vectors

    @cached_property
    def _pair_binning(self):
        if self.positions is None or self.cell_vectors is None:
            raise ValueError(
                f"{self.name}: distance-binned lattice iterators need site "
                "positions and periodicity vectors; this lattice was built "
                "from a bond list only. Pass positions=/cell_vectors= or use "
                "a Bravais-basis Lattice.")
        return _bin_pairs_by_distance(self.positions, self.cell_vectors)

    def state_dict(self):
        """What rebuilds the lattice (``from_state``); ``bond_vecs``, which
        ``ALPSLattice`` sets, is not part of it, as in the JAX package."""
        return {
            "kind": "arbitrary",
            "name": self.name,
            "n_sites": self.n_sites,
            "bonds": np.asarray(self.bonds),
            "positions": (None if self.positions is None
                          else np.asarray(self.positions)),
            "cell_vectors": (None if self.cell_vectors is None
                             else np.asarray(self.cell_vectors)),
            "dim": self.dim,
        }

    @staticmethod
    def from_state(state):
        """The lattice of a ``state_dict``."""
        return ArbitraryLattice(
            n_sites=state["n_sites"], bonds=state["bonds"],
            positions=state.get("positions"),
            cell_vectors=state.get("cell_vectors"),
            dim=state.get("dim"), name=state.get("name", "arbitrary"))

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, {self.n_sites} sites, "
                f"{self.n_bonds} bonds)")


def ALPSLattice(xmlfile: str) -> ArbitraryLattice:
    """Parse an ALPS lattice-graph XML file.

    Expects the <GRAPH> element (or a document whose root contains one) with
    ``vertices`` and ``dimension`` attributes and 1-based <EDGE source
    target type id vector> children sorted by id. Vertex <COORDINATE> text,
    when every vertex has it, becomes the site positions; the edges'
    vectors become ``bond_vecs`` (n_bonds, dim). The file gives no
    periodicity vectors, so distance-binned measurements raise on it.
    """
    root = ET.parse(xmlfile).getroot()
    graph = root if root.tag.upper() == "GRAPH" else root.find(".//GRAPH")
    if graph is None:
        raise ValueError(f"{xmlfile}: no <GRAPH> element found")
    n_sites = int(graph.attrib["vertices"])
    dim = int(graph.attrib["dimension"])

    edges = graph.findall("EDGE")
    bonds = np.zeros((len(edges), 3), dtype=np.int32)
    bond_vecs = np.zeros((len(edges), dim))
    for i, edge in enumerate(edges):
        eid = int(edge.attrib.get("id", i + 1))
        if eid != i + 1:
            raise ValueError(
                f"{xmlfile}: edges must be sorted by id 1..N (got id={eid} "
                f"at position {i + 1})")
        bonds[i, 0] = int(edge.attrib["source"]) - 1
        bonds[i, 1] = int(edge.attrib["target"]) - 1
        bonds[i, 2] = int(edge.attrib.get("type", 0))
        if "vector" in edge.attrib:
            bond_vecs[i] = [float(x) for x in edge.attrib["vector"].split()]

    coords: List[np.ndarray] = []
    for v in graph.findall("VERTEX"):
        c = v.find("COORDINATE")
        if c is not None and c.text:
            coords.append(np.array([float(x) for x in c.text.split()]))
    positions = np.stack(coords, axis=0) if len(coords) == n_sites else None

    lat = ArbitraryLattice(n_sites=n_sites, bonds=bonds, positions=positions,
                           dim=dim, name=f"ALPS({xmlfile})")
    lat.bond_vecs = bond_vecs
    return lat
