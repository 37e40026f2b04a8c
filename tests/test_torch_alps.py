"""ALPS lattice files, ArbitraryLattice and Lattice.reciprocal_vectors of
montecarlo_tpu_torch against montecarlo_tpu, on the CPU (the port of
tests/test_alps.py, and parity checks).

Parsed tables are integer or copied data, so those comparisons are exact;
reciprocal vectors agree within 1e-14; a float64 DQMC run on an ALPS file
of the square lattice is bit-equal to the run on SquareLattice (the same
bonds in the same order give the same hopping matrix).
"""

import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.lattices import library as jlib

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.lattices import library as tlib


def _write_xml(path, lat, coordinates=True):
    """A lattice as an ALPS GRAPH file (1-based ids), edges in bond order."""
    lines = [f'<GRAPH vertices="{lat.n_sites}" dimension="{lat.dim}">']
    for i, p in enumerate(lat.positions):
        coord = (f"<COORDINATE>{' '.join(map(str, p))}</COORDINATE>"
                 if coordinates else "")
        lines.append(f'  <VERTEX id="{i + 1}">{coord}</VERTEX>')
    for b, (s, t, ty) in enumerate(lat.bonds):
        d = lat.positions[t] - lat.positions[s]
        lines.append(f'  <EDGE source="{s + 1}" target="{t + 1}" id="{b + 1}" '
                     f'type="{ty}" vector="{" ".join(map(str, d))}"/>')
    lines.append("</GRAPH>")
    path.write_text("\n".join(lines))
    return lat


def _write_square_xml(path, L=2):
    """A periodic L x L square lattice as an ALPS GRAPH file."""
    return _write_xml(path, tmc.SquareLattice(L))


# a 2-site basis with an extra bond on site 0: coordinations 3 and 2, a
# neighbor table padded with -1 (tests/test_torch_lattices_more.py)
LADDER = dict(primitive_vectors=np.eye(2), basis=[[0.0, 0.0], [0.5, 0.0]],
              bonds=[(0, 1, (0, 0), 0), (1, 0, (1, 0), 0),
                     (0, 0, (0, 1), 1)],
              shape=(3, 3), name="ladder")

FILES = {
    "square4": lambda: tlib.SquareLattice(4),
    "triangular3": lambda: tlib.TriangularLattice(3),
    "ladder_no_coordinates": lambda: tlib.GenericLattice(**LADDER),
}


def _dqmc(model, **kw):
    args = dict(beta=1.0, n_chains=4, seed=1, sweeps=10, thermalization=0,
                print_rate=10 ** 9, device="cpu")
    args.update(kw)
    return tmc.DQMC(model, **args)


# ---------------------------------------------------------------------------
# tests/test_alps.py
# ---------------------------------------------------------------------------

def test_alps_parse_matches_native(tmp_path):
    fn = tmp_path / "square.xml"
    native = _write_square_xml(fn, L=2)
    lat = tmc.ALPSLattice(str(fn))
    assert len(lat) == native.n_sites
    assert lat.n_bonds == native.n_bonds
    assert np.array_equal(lat.bonds, native.bonds)
    assert np.allclose(lat.positions, native.positions)
    for i in range(len(lat)):
        assert sorted(lat.neighbor_table[i]) == sorted(native.neighbor_table[i])
    assert len(lat.checkerboard_groups) >= 2
    assert sum(len(g) for g in lat.checkerboard_groups) == lat.n_bonds


def test_alps_dqmc_end_to_end(tmp_path):
    """DQMC on an imported ALPS lattice reproduces half filling at mu=0."""
    fn = tmp_path / "square.xml"
    _write_square_xml(fn, L=2)
    model = tmc.HubbardModelAttractive(l=tmc.ALPSLattice(str(fn)), U=4.0,
                                       mu=0.0)
    mc = _dqmc(model, n_chains=16, seed=3, sweeps=80, thermalization=40,
               measure_rate=2)
    assert mc.run(verbose=False)
    occ = mc.observables()["occ"]["occ"].mean
    assert np.max(np.abs(occ - 0.5)) < 0.05


def test_alps_checkpoint_roundtrip(tmp_path):
    """save / load of an ALPS session: load rebuilds an ArbitraryLattice with
    the same bonds, the same conf, and a run resumed from it repeats the
    uninterrupted one."""
    fn = tmp_path / "square.xml"
    _write_square_xml(fn, L=2)
    lat = tmc.ALPSLattice(str(fn))
    model = tmc.HubbardModelAttractive(l=lat, U=2.0, mu=0.0)
    mc = _dqmc(model)
    mc.run(verbose=False)
    ck = tmc.save(str(tmp_path / "alps.mctorch"), mc)
    mc2 = tmc.load(ck, device="cpu")
    assert isinstance(mc2.model.lattice, tmc.ArbitraryLattice)
    np.testing.assert_array_equal(mc2.model.lattice.bonds, lat.bonds)
    np.testing.assert_array_equal(mc2.model.lattice.positions, lat.positions)
    assert torch.equal(mc2.state["conf"], mc.state["conf"])
    np.testing.assert_array_equal(mc2.model.hopping_matrix(),
                                  model.hopping_matrix())
    mc.run(sweeps=14, verbose=False)
    mc2.run(sweeps=14, verbose=False)
    assert torch.equal(mc2.state["conf"], mc.state["conf"])


def test_arbitrary_lattice_no_positions_errors():
    lat = tmc.ArbitraryLattice(n_sites=4, bonds=[[0, 1, 0], [1, 2, 0],
                                                 [2, 3, 0], [3, 0, 0]])
    with pytest.raises(ValueError, match="positions"):
        _ = lat.pair_dir


def test_alps_rejects_unsorted_edges(tmp_path):
    fn = tmp_path / "bad.xml"
    fn.write_text('<GRAPH vertices="2" dimension="1">'
                  '<EDGE source="1" target="2" id="7"/></GRAPH>')
    with pytest.raises(ValueError, match="sorted"):
        tmc.ALPSLattice(str(fn))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FILES))
def test_alps_parse_matches_jax(tmp_path, name):
    """The same file through both parsers: equal bonds, positions, bond
    vectors, neighbor-table multisets, checkerboard groups, site colors and
    state_dict (the same keys: bond_vecs is not in it)."""
    fn = tmp_path / f"{name}.xml"
    _write_xml(fn, FILES[name](), coordinates=name != "ladder_no_coordinates")
    jl, tl = jmc.ALPSLattice(str(fn)), tmc.ALPSLattice(str(fn))
    assert (len(tl), tl.n_bonds, tl.dim, tl.shape) == \
        (len(jl), jl.n_bonds, jl.dim, jl.shape)
    np.testing.assert_array_equal(tl.bonds, jl.bonds)
    np.testing.assert_array_equal(tl.bond_vecs, jl.bond_vecs)
    if jl.positions is None:
        assert tl.positions is None
    else:
        np.testing.assert_array_equal(tl.positions, jl.positions)
    np.testing.assert_array_equal(tl.neighbor_table, jl.neighbor_table)
    assert [sorted(r) for r in tl.neighbor_table] == \
        [sorted(r) for r in jl.neighbor_table]
    for got, want in ((tl.checkerboard_groups, jl.checkerboard_groups),
                      (tl.site_colors, jl.site_colors)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    ts, js = tl.state_dict(), jl.state_dict()
    assert ts.keys() == js.keys() and "bond_vecs" not in ts
    for k in ts:
        if isinstance(js[k], np.ndarray):
            np.testing.assert_array_equal(ts[k], js[k])
        else:
            assert ts[k] == js[k]


@pytest.mark.parametrize("ctor,arg", [
    ("Chain", 5), ("SquareLattice", 4), ("TriangularLattice", 3),
    ("Honeycomb", 3), ("CubicLattice", 3)])
def test_reciprocal_vectors_match_jax(ctor, arg):
    """2π (A⁻¹)ᵀ, and B Aᵀ = 2π I."""
    jl, tl = getattr(jlib, ctor)(arg), getattr(tlib, ctor)(arg)
    B = tl.reciprocal_vectors()
    np.testing.assert_allclose(B, jl.reciprocal_vectors(), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(B @ tl.unitcell.primitive_vectors.T,
                               2 * np.pi * np.eye(tl.dim), atol=1e-12)


@pytest.mark.parametrize("name", ["square4", "triangular3"])
def test_arbitrary_lattice_derives_what_lattice_does(name):
    """An ArbitraryLattice given a Lattice's bonds, positions and
    periodicity vectors derives the same tables through BondLattice: the
    colorings, the direction binning and the direction targets, equal to
    the native lattice's and to the JAX package's ArbitraryLattice's."""
    native = FILES[name]()
    kw = dict(n_sites=native.n_sites, bonds=native.bonds,
              positions=native.positions, cell_vectors=native.cell_vectors)
    tl, jl = tmc.ArbitraryLattice(**kw), jmc.ArbitraryLattice(**kw)
    assert tl.n_dirs == native.n_dirs == jl.n_dirs
    for ref in (native, jl):
        np.testing.assert_array_equal(tl.pair_dir, ref.pair_dir)
        np.testing.assert_array_equal(tl.directions, ref.directions)
        for a, b in zip(tl.target_by_direction(5),
                        ref.target_by_direction(5)):
            np.testing.assert_array_equal(a, b)
        for got, want in ((tl.checkerboard_groups, ref.checkerboard_groups),
                          (tl.site_colors, ref.site_colors)):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tl.lattice_vectors(), native.cell_vectors)
    assert not isinstance(tl, tmc.Lattice)


def test_alps_distance_binning_raises_with_advice(tmp_path):
    """An ALPS file carries no periodicity vectors: a distance-binned
    measurement on it raises the JAX package's ValueError, advice included,
    and a site-resolved one works."""
    fn = tmp_path / "square.xml"
    _write_square_xml(fn, L=2)
    model = tmc.HubbardModelAttractive(l=tmc.ALPSLattice(str(fn)), U=2.0)
    sim = _dqmc(model)
    advice = ("distance-binned lattice iterators need site positions and "
              "periodicity vectors.*Pass positions=/cell_vectors= or use a "
              "Bravais-basis Lattice")
    for make in (lambda: tmc.charge_density_correlation(sim, model),
                 lambda: tmc.pairing_correlation(sim, model, K=2),
                 lambda: tmc.custom_measurement(
                     sim, model, lambda G: G[:, 0], name="g")):
        with pytest.raises(ValueError, match=advice):
            make()
    with pytest.raises(ValueError, match="no periodicity vectors"):
        model.lattice.lattice_vectors()
    sim["n"] = tmc.custom_measurement(
        sim, model, lambda G: 1.0 - torch.diagonal(G[:, 0], dim1=-2,
                                                    dim2=-1),
        name="n", lattice_iterator=tmc.EachSite())
    sim.run(sweeps=2, verbose=False)
    assert sim["n"]["n"].mean.shape == (4,)


def test_model_parameters_on_arbitrary_lattice(tmp_path):
    """HubbardModel.parameters() carries dims and L only for a lattice with
    a unit cell, as the JAX package's (on an ArbitraryLattice shape[0] is
    n_sites, no extent); the checkpoint rebuilds the lattice from its
    state."""
    fn = tmp_path / "tri.xml"
    _write_xml(fn, tlib.TriangularLattice(3))
    tm = tmc.HubbardModelAttractive(l=tmc.ALPSLattice(str(fn)), U=2.0)
    jm = jmc.HubbardModelAttractive(l=jmc.ALPSLattice(str(fn)), U=2.0)
    assert tm.parameters() == jm.parameters()
    assert "L" not in tm.parameters() and "dims" not in tm.parameters()
    sq = tmc.HubbardModelAttractive(dims=2, L=3, U=2.0).parameters()
    assert (sq["dims"], sq["L"]) == (2, 3)
    np.testing.assert_array_equal(tm.hopping_matrix(), jm.hopping_matrix())
    sim = _dqmc(tm, sweeps=1)
    sim2 = tmc.load(tmc.save(str(tmp_path / "tri.mctorch"), sim),
                    device="cpu")
    np.testing.assert_array_equal(sim2.model.lattice.bonds, tm.lattice.bonds)
    np.testing.assert_array_equal(sim2.model.hopping_matrix(),
                                  tm.hopping_matrix())


def test_ising_refuses_padded_alps_lattice(tmp_path):
    """An ALPS lattice of uneven coordination has a -1-padded neighbor
    table, which the Ising moves refuse (ROADMAP Queue 3); one of even
    coordination runs."""
    fn = tmp_path / "ladder.xml"
    _write_xml(fn, tlib.GenericLattice(**LADDER), coordinates=False)
    lat = tmc.ALPSLattice(str(fn))
    assert (lat.neighbor_table < 0).any()
    with pytest.raises(ValueError, match="padded with -1"):
        tmc.IsingModel(l=lat)
    fn = tmp_path / "square.xml"
    _write_square_xml(fn, L=4)
    sim = tmc.MC(tmc.IsingModel(l=tmc.ALPSLattice(str(fn))), beta=0.3,
                 n_chains=4, seed=2, device="cpu")
    sim.run(sweeps=4, thermalization=0, verbose=False)
    assert sim.conf.shape == (4, 16)


def test_alps_dqmc_bit_equal_to_square(tmp_path):
    """A float64 DQMC run on the ALPS file of the 4x4 square lattice and on
    SquareLattice(4) with the same seed: conf, G and every binner mean
    equal, bit for bit."""
    fn = tmp_path / "square4.xml"
    _write_square_xml(fn, L=4)
    runs = []
    for lat in (tmc.ALPSLattice(str(fn)), tmc.SquareLattice(4)):
        sim = _dqmc(tmc.HubbardModelAttractive(l=lat, U=4.0), seed=7,
                    sweeps=3, thermalization=1, measure_rate=1)
        sim.run(verbose=False)
        runs.append(sim)
    a, b = runs
    assert torch.equal(a.state["conf"], b.state["conf"])
    assert torch.equal(a.state["G"], b.state["G"])
    for key, name in (("occ", "occ"), ("greens", "greens")):
        np.testing.assert_array_equal(a[key][name].mean, b[key][name].mean)
