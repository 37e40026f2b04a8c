"""The equal-time measurements of the PyTorch/CUDA port (montecarlo_tpu_torch)
and the lattice's direction binning they read, against montecarlo_tpu on the
CPU: the same float64 Green's functions, made with numpy from a seed, go
through each JAX kernel function and factory (vmapped over chains) and
through the port's batched counterpart. Both sides compute the same
elementwise products and the same one-hot contractions in float64, so they
agree to rounding: within 1e-12 of the largest entry.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.lattices.library import choose_lattice as j_lattice
from montecarlo_tpu.measurements import dqmc_measurements as jdm

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.lattices.library import choose_lattice as t_lattice
from montecarlo_tpu_torch.measurements import dqmc_measurements as tdm

TOL = 1e-12


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.max(np.abs(out - ref)) <= TOL * max(1.0, np.max(np.abs(ref)))


def _models(L, repulsive):
    if repulsive:
        return (jmc.HubbardModelRepulsive(dims=2, L=L, U=4.0),
                tmc.HubbardModelRepulsive(dims=2, L=L, U=4.0))
    return (jmc.HubbardModelAttractive(dims=2, L=L, U=4.0),
            tmc.HubbardModelAttractive(dims=2, L=L, U=4.0))


def _greens(L, F, seed, C=3, complex_=False):
    """(C, F, N, N) float64 (complex128) G near 0.5 I, and a (C, N, 10) int8
    field."""
    rng = np.random.default_rng(seed)
    N = L * L
    G = 0.5 * np.eye(N) + 0.3 * rng.normal(size=(C, F, N, N))
    if complex_:
        G = G + 0.3j * rng.normal(size=G.shape)
    conf = rng.choice(np.array([-1, 1], np.int8), size=(C, N, 10))
    return G, conf


# ---------------------------------------------------------------------------
# lattice: direction binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [2, 3, 4, 6, 8])
def test_direction_binning_identical(L):
    lj, lt = j_lattice(2, L), t_lattice(2, L)
    np.testing.assert_array_equal(lt.cell_vectors, lj.cell_vectors)
    np.testing.assert_array_equal(lt.lattice_vectors(), lj.lattice_vectors())
    np.testing.assert_array_equal(lt.pair_dir, lj.pair_dir)
    np.testing.assert_array_equal(lt.directions, lj.directions)
    assert lt.n_dirs == lj.n_dirs
    assert lt.pair_dir.dtype == np.int32 and np.all(np.diag(lt.pair_dir) == 0)
    for K in (1, 4, 5, L * L):
        for a, b in zip(lt.target_by_direction(K), lj.target_by_direction(K)):
            np.testing.assert_array_equal(a, b)


def test_binning_helpers_identical():
    from montecarlo_tpu.lattices import lattice as jl
    from montecarlo_tpu_torch.lattices import lattice as tl
    v = np.array([[3.0, 0.0], [0.0, 5.0]])
    np.testing.assert_array_equal(tl._generate_combinations(v),
                                  jl._generate_combinations(v))
    for w in ([1.0, 0.0], [-1.0, 1.0], [0.0, -2.0], [0.0, 0.0]):
        w = np.asarray(w)
        assert tl._directed_norm(w) == jl._directed_norm(w)
    lat = t_lattice(2, 4)
    for a, b in zip(tl._bin_pairs_by_distance(lat.positions, lat.cell_vectors),
                    jl._bin_pairs_by_distance(lat.positions, lat.cell_vectors)):
        np.testing.assert_array_equal(a, b)
    K = 5
    np.testing.assert_array_equal(tdm._selection_matrices(lat, K),
                                  jdm._selection_matrices(j_lattice(2, 4), K))
    np.testing.assert_array_equal(tdm._dir_onehot(lat),
                                  jdm._dir_onehot(j_lattice(2, 4)))


# ---------------------------------------------------------------------------
# kernel matrices and factories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,F", [(4, 1), (4, 2), (6, 2)])
def test_kernel_matrices_match_jax(L, F):
    G, _ = _greens(L, F, 10 * L + F)
    Gj, Gt = jnp.asarray(G), torch.from_numpy(G)
    for name in ("cdc_matrix", "sdc_x_matrix", "sdc_y_matrix",
                 "sdc_z_matrix", "mz_vector"):
        ref = jax.vmap(getattr(jdm, name))(Gj)
        _close(getattr(tdm, name)(Gt).numpy(), ref)
    lat = t_lattice(2, L)
    K = jax.vmap(jdm.cdc_matrix)(Gj)
    ref = jdm._bin_by_dir(K, jdm._dir_onehot(j_lattice(2, L)), L * L)
    P = torch.from_numpy(tdm._dir_onehot(lat)).double()
    _close(tdm._bin_by_dir(tdm.cdc_matrix(Gt), P, L * L).numpy(), ref)


def _factories(mod):
    """(label, factory(mc, model)) of every ported equal-time factory."""
    out = [("occupation", mod.occupation),
           ("greens", mod.greens_measurement),
           ("sign", mod.sign_measurement),
           ("boson_energy", mod.boson_energy_measurement),
           ("cdc", mod.charge_density_correlation),
           ("charge_density", mod.charge_density),
           ("pc", mod.pairing_correlation),
           ("pc K=4", lambda mc, m: mod.pairing_correlation(mc, m, K=4)),
           ("pairing K=4", lambda mc, m: mod.pairing(mc, m, K=4))]
    for d in ("x", "y", "z"):
        out += [(f"sdc_{d}", lambda mc, m, d=d:
                 mod.spin_density_correlation(mc, m, d)),
                (f"spin_density {d}", lambda mc, m, d=d:
                 mod.spin_density(mc, m, d)),
                (f"m_{d}", lambda mc, m, d=d: mod.magnetization(mc, m, d))]
    return out


@pytest.mark.parametrize("L,repulsive", [(4, False), (4, True), (6, True)])
def test_factories_match_jax(L, repulsive):
    """Every ported factory: the same observables and per-chain shapes, and
    the same values on the same G and field within 1e-12."""
    jm, tm = _models(L, repulsive)
    G, conf = _greens(L, tm.nflavors, 20 * L + repulsive)
    mc = SimpleNamespace(parameters=SimpleNamespace(delta_tau=0.1))
    for (label, jf), (_, tf) in zip(_factories(jdm), _factories(tdm)):
        mj, mt = jf(mc, jm), tf(mc, tm)
        assert mt.obs_shapes == mj.obs_shapes, label
        assert mt.name == mj.name, label
        ref = mj.measure_fn(greens=jnp.asarray(G), conf=jnp.asarray(conf))
        out = mt.measure_fn(greens=torch.from_numpy(G),
                            conf=torch.from_numpy(conf), phase=None)
        assert set(out) == set(ref), label
        for k in ref:
            assert out[k].dtype in (torch.float64, torch.int64), (label, k)
            _close(out[k].numpy(), ref[k])
            assert out[k].shape[1:] == mt.obs_shapes[k], (label, k)


def test_factories_complex_session_match_jax():
    """A complex (Peierls) session's G: complex kernel values and complex128
    binners on both sides."""
    jm, tm = _models(4, True)
    G, conf = _greens(4, 2, 31, complex_=True)
    mcj = SimpleNamespace(ctx=SimpleNamespace(is_complex=True,
                                              dtype=jnp.complex128))
    mct = SimpleNamespace(ctx=SimpleNamespace(is_complex=True))
    for (label, jf), (_, tf) in zip(_factories(jdm), _factories(tdm)):
        if label in ("boson_energy", "sign", "occupation"):
            continue
        mj, mt = jf(mcj, jm), tf(mct, tm)
        assert mt.dtype == torch.complex128, label
        ref = mj.measure_fn(greens=jnp.asarray(G), conf=jnp.asarray(conf))
        out = mt.measure_fn(greens=torch.from_numpy(G), conf=None)
        for k in ref:
            _close(out[k].numpy(), ref[k])


def test_pairing_masks_missing_targets():
    """On a lattice where some direction targets are missing from a site
    (K beyond the bins of one site), the selection matrices' zero rows give
    the reference's mask: the JAX and port values agree, and a K past the
    number of bins leaves those entries exactly zero."""
    jm, tm = _models(2, True)
    G, conf = _greens(2, 2, 41)
    n_dirs = tm.lattice.n_dirs
    K = n_dirs + 2
    mj = jdm.pairing_correlation(None, jm, K=K)
    mt = tdm.pairing_correlation(None, tm, K=K)
    ref = mj.measure_fn(greens=jnp.asarray(G))["pc"]
    out = mt.measure_fn(greens=torch.from_numpy(G))["pc"].numpy()
    _close(out, ref)
    assert np.all(out[:, :, n_dirs:, :] == 0) and np.all(out[..., n_dirs:] == 0)


def test_time_displaced_dispatch_raises():
    tm = _models(2, True)[1]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1"):
        tdm.charge_density(None, tm, greens_iterator=tdm.CombinedGreensIterator)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1"):
        tdm.spin_density(None, tm, "z",
                         greens_iterator=tdm.CombinedGreensIterator)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1"):
        tdm.pairing(None, tm, greens_iterator=tdm.GreensAt(1, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1"):
        tdm.greens_measurement(None, tm, greens_at=(1, 0))
    assert tdm.GreensAt(2, 1).kl == (2, 1)


def test_energy_boson_matches_jax():
    rng = np.random.default_rng(5)
    conf = rng.choice(np.array([-1, 1], np.int8), size=(4, 16, 10))
    for repulsive in (False, True):
        jm, tm = _models(4, repulsive)
        out = tm.energy_boson(torch.from_numpy(conf), 0.1)
        assert out.dtype == torch.float64
        _close(out.numpy(), jm.energy_boson(jnp.asarray(conf), 0.1))


def test_root_exports_the_factories():
    for name in ("charge_density_correlation", "spin_density_correlation",
                 "magnetization", "pairing_correlation",
                 "boson_energy_measurement", "charge_density",
                 "spin_density", "pairing", "Greens", "GreensAt",
                 "CombinedGreensIterator", "occupation",
                 "greens_measurement"):
        assert getattr(tmc, name) is getattr(tdm, name), name
        assert hasattr(jmc, name), name
