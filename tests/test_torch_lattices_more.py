"""The lattices of montecarlo_tpu_torch/lattices/library.py beyond the chain
and the square (cubic, triangular, honeycomb, generic) and Lattice.
state_dict, against montecarlo_tpu, on the CPU.

Everything is integer or copied data, so every comparison is exact: bonds,
neighbor tables, site colorings, positions and the state_dict.
"""

import numpy as np
import pytest

import montecarlo_tpu as jmc
from montecarlo_tpu.lattices import library as jlib

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.lattices import Lattice
from montecarlo_tpu_torch.lattices import library as tlib

# (constructor, argument, sites, bonds, coordination): tests/test_lattices.py
CASES = {
    "chain4": ("Chain", 4, 4, 4, 2),
    "square4": ("SquareLattice", 4, 16, 32, 4),
    "cubic3": ("CubicLattice", 3, 27, 81, 6),
    "triangular4": ("TriangularLattice", 4, 16, 48, 6),
    "honeycomb3": ("Honeycomb", 3, 18, 27, 3),
}

# a 2-site basis with one extra bond on site 0: coordinations 3 and 2, so
# the neighbor table is padded with -1
GENERIC = dict(primitive_vectors=np.eye(2), basis=[[0.0, 0.0], [0.5, 0.0]],
               bonds=[(0, 1, (0, 0), 0), (1, 0, (1, 0), 0),
                      (0, 0, (0, 1), 1)],
               shape=(3, 3), name="ladder")


def _pair(name):
    ctor, arg = CASES[name][:2]
    return getattr(jlib, ctor)(arg), getattr(tlib, ctor)(arg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_counts_and_mirrors(name):
    """Sites, bonds and coordination as tests/test_lattices.py counts them;
    every directed bond has its mirror; undirected bonds unique."""
    _, _, nsites, nbonds, coord = CASES[name]
    _, lat = _pair(name)
    assert len(lat) == nsites
    assert lat.n_bonds == nbonds
    assert lat.coordination == coord
    dirbonds = {(int(s), int(t)) for s, t in lat.neighbors(directed=True)}
    assert all((t, s) in dirbonds for s, t in dirbonds)
    und = lat.neighbors(directed=False)
    assert len({tuple(sorted(b)) for b in map(tuple, und)}) == len(und)
    table = lat.neighbor_table
    assert table.shape == (nsites, coord) and (table >= 0).all()
    assert all(len(set(row)) == coord for row in table)


@pytest.mark.parametrize("name", sorted(CASES) + ["generic"])
def test_tables_and_colors_match_jax(name):
    """Bonds, neighbor table, positions and the greedy site coloring equal
    the JAX package's; no two neighbors share a color."""
    if name == "generic":
        jl, tl = jlib.GenericLattice(**GENERIC), tlib.GenericLattice(**GENERIC)
    else:
        jl, tl = _pair(name)
    np.testing.assert_array_equal(tl.bonds, jl.bonds)
    np.testing.assert_array_equal(tl.neighbor_table, jl.neighbor_table)
    np.testing.assert_array_equal(tl.positions, jl.positions)
    assert len(tl.site_colors) == len(jl.site_colors)
    for a, b in zip(tl.site_colors, jl.site_colors):
        np.testing.assert_array_equal(a, b)
    color = np.empty(len(tl), int)
    for c, sites in enumerate(tl.site_colors):
        color[sites] = c
    for i, row in enumerate(tl.neighbor_table):
        nb = row[(row >= 0) & (row != i)]
        assert (color[nb] != color[i]).all()


@pytest.mark.parametrize("name", sorted(CASES) + ["generic"])
def test_state_dict_matches_jax_and_rebuilds(name):
    """state_dict holds what the JAX package's holds, and from_state
    rebuilds an equal lattice."""
    if name == "generic":
        jl, tl = jlib.GenericLattice(**GENERIC), tlib.GenericLattice(**GENERIC)
    else:
        jl, tl = _pair(name)
    st, jst = tl.state_dict(), jl.state_dict()
    assert st.keys() == jst.keys()
    for k in st:
        if isinstance(st[k], np.ndarray):
            np.testing.assert_array_equal(st[k], jst[k])
        else:
            assert st[k] == jst[k]
    back = Lattice.from_state(st)
    assert back.unitcell.name == tl.unitcell.name and back.shape == tl.shape
    np.testing.assert_array_equal(back.bonds, tl.bonds)
    np.testing.assert_array_equal(back.neighbor_table, tl.neighbor_table)


def test_generic_lattice_pads_uneven_coordination():
    """The generic ladder's table is padded with -1 exactly where the JAX
    package pads it."""
    tl = tlib.GenericLattice(**GENERIC)
    assert tl.coordination == 4 and (tl.neighbor_table < 0).any()
    np.testing.assert_array_equal(
        tl.neighbor_table < 0,
        jlib.GenericLattice(**GENERIC).neighbor_table < 0)


@pytest.mark.parametrize("dims,L,ctor", [(1, 5, "Chain"),
                                         (2, 3, "SquareLattice"),
                                         (3, 3, "CubicLattice")])
def test_choose_lattice(dims, L, ctor):
    """choose_lattice picks the chain, the square and the cubic lattice as
    the JAX package's does (dims=3 no longer raises)."""
    lat = tlib.choose_lattice(dims, L)
    np.testing.assert_array_equal(
        lat.neighbor_table, getattr(jlib, ctor)(L).neighbor_table)
    with pytest.raises(ValueError, match="dims=4"):
        tlib.choose_lattice(4, L)


def test_exports():
    """The lattice constructors are exported at the package root, as the
    JAX package's are."""
    for name in ("Chain", "SquareLattice", "CubicLattice",
                 "TriangularLattice", "Honeycomb", "GenericLattice"):
        assert callable(getattr(tmc, name)) and hasattr(jmc, name)
