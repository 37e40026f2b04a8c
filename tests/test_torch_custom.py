"""custom_measurement and selection_matrices of montecarlo_tpu_torch, on the
CPU: the port of tests/test_custom_measurement.py (user kernels against the
shipped observables, a loop oracle and the classical Binder cumulant), and
parity with the JAX package's custom_measurement.

The port's kernels are batch-first ((C, F, N, N) in, (C, *raw) out); the
JAX package's are per chain and vmapped. The parity cases feed the same
numpy-seeded Green's functions to both measure functions (for the combined
iterator, to both step functions over a few slices, then both finish
functions), for every (greens iterator, lattice iterator) pair, on the 4x4
square and the 3x3 triangular lattice at F = 1 and 2, and require
agreement within 1e-12 relative in float64 (the binning sums in another
order). Shipped and custom observables of one run agree within 1e-12.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.measurements import Measurement
from montecarlo_tpu_torch.measurements import dqmc_measurements as dm

RTOL = 1e-12


def _sim(lattice=None, **kw):
    model = tmc.HubbardModelAttractive(l=lattice or tmc.SquareLattice(4),
                                       U=4.0)
    args = dict(beta=1.0, delta_tau=0.1, n_chains=4, seed=11, sweeps=10,
                thermalization=5, measure_rate=2, device="cpu")
    args.update(kw)
    return tmc.DQMC(model, **args), model


def _mean(obs, key, name):
    return np.asarray(obs[key][name].mean)


def _pc_kernel(S_np):
    """The shipped pairing correlation as a batch-first quad kernel."""
    def kernel(G):
        Gu, Gd = G[:, 0], G[:, -1]
        S = torch.as_tensor(S_np, dtype=Gu.dtype)
        B = torch.einsum("kab,cbd->ckad", S, Gd)
        C = torch.einsum("ckad,qbd->ckqab", B, S)
        return Gu[:, None, None] * C
    return kernel


@pytest.fixture(scope="module")
def square_run():
    """One 4x4 run with every custom measurement of the square-lattice
    tests beside its shipped counterpart."""
    sim, model = _sim()
    K = 3
    sim["pc_ref"] = dm.pairing_correlation(sim, model, K=K)
    sim["pc_custom"] = tmc.custom_measurement(
        sim, model, _pc_kernel(tmc.selection_matrices(model.lattice, K)),
        name="pc", lattice_iterator=tmc.EachLocalQuadByDistance(K))
    sim["cds_ref"] = dm.charge_density_susceptibility(sim, model)
    sim["cds_custom"] = tmc.custom_measurement(
        sim, model, dm.cdc4_matrix, name="cds",
        greens_iterator=tmc.CombinedGreensIterator,
        lattice_iterator=tmc.EachSitePairByDistance())
    sim["occ_ref"] = dm.occupation(sim, model)
    sim["occ_custom"] = tmc.custom_measurement(
        sim, model, lambda G: 1.0 - torch.diagonal(G[:, 0], dim1=-2,
                                                   dim2=-1),
        name="n", lattice_iterator=tmc.EachSite())
    sim["gp"] = tmc.custom_measurement(sim, model, lambda G: G[:, 0],
                                       name="gp",
                                       lattice_iterator=tmc.EachSitePair())
    sim["gat_ref"] = dm.greens_measurement(sim, model, greens_at=(3, 1))
    sim["gat_custom"] = tmc.custom_measurement(
        sim, model, lambda G: G[:, 0], name="gat",
        greens_iterator=tmc.GreensAt(3, 1),
        lattice_iterator=tmc.EachSitePair())
    assert sim.run(verbose=False)
    return sim, model, sim.observables()


def test_custom_by_distance_matches_shipped_cdc_triangular():
    sim, model = _sim(tmc.TriangularLattice(3))
    sim["cdc_ref"] = dm.charge_density_correlation(sim, model)
    sim["cdc_custom"] = tmc.custom_measurement(
        sim, model, dm.cdc_matrix, name="cdc",
        lattice_iterator=tmc.EachSitePairByDistance())
    sim.run(verbose=False)
    obs = sim.observables()
    np.testing.assert_allclose(_mean(obs, "cdc_custom", "cdc"),
                               _mean(obs, "cdc_ref", "cdc"), rtol=0,
                               atol=1e-12)


def test_custom_by_distance_vs_loop_oracle():
    """A hand-written kernel through custom_measurement equals an explicit
    loop over all (src, trg) pairs binned by direction, applied to the same
    measured G (one measurement, so the binner mean is the sample)."""
    def kernel(G):
        Gu = G[:, 0]
        return Gu * Gu.mT + 0.5 * Gu

    sim, model = _sim(tmc.TriangularLattice(3), sweeps=2, thermalization=5,
                      measure_rate=2)
    sim["k"] = tmc.custom_measurement(sim, model, kernel, name="k")
    sim["greens"] = dm.greens_measurement(sim, model)
    sim.run(verbose=False)
    obs = sim.observables()
    G = np.asarray(obs["greens"]["greens"].per_chain_mean)  # (C, F, N, N)
    got = np.asarray(obs["k"]["k"].per_chain_mean)         # (C, n_dirs)
    lat = model.lattice
    N, pd = len(lat), np.asarray(lat.pair_dir)
    assert got.shape == (G.shape[0], lat.n_dirs)
    for c in range(G.shape[0]):
        Gu = G[c, 0]
        Kmat = Gu * Gu.T + 0.5 * Gu
        oracle = np.zeros(lat.n_dirs)
        for s in range(N):
            for t in range(N):
                oracle[pd[s, t]] += Kmat[s, t]
        np.testing.assert_allclose(got[c], oracle / N, rtol=0, atol=1e-9)


def test_custom_quad_matches_shipped_pc(square_run):
    _, _, obs = square_run
    np.testing.assert_allclose(_mean(obs, "pc_custom", "pc"),
                               _mean(obs, "pc_ref", "pc"), rtol=0,
                               atol=1e-12)


def test_custom_combined_matches_shipped_cds(square_run):
    _, _, obs = square_run
    np.testing.assert_allclose(_mean(obs, "cds_custom", "cds"),
                               _mean(obs, "cds_ref", "cds"), rtol=0,
                               atol=1e-10)


def test_custom_each_site(square_run):
    _, _, obs = square_run
    np.testing.assert_allclose(_mean(obs, "occ_custom", "n"),
                               _mean(obs, "occ_ref", "occ")[0], rtol=0,
                               atol=1e-12)


def test_custom_each_site_pair_normalization(square_run):
    _, model, obs = square_run
    N = len(model.lattice)
    v = _mean(obs, "gp", "gp")
    assert v.shape == (N, N)
    np.testing.assert_allclose(v * N, _mean(obs, "greens", "greens")[0],
                               rtol=0, atol=1e-12)


def test_custom_greens_at_matches_shipped(square_run):
    """GreensAt(k, l) through custom_measurement reads the same G(k, l) as
    greens_measurement(greens_at=(k, l)) (EachSitePair divides by N)."""
    _, model, obs = square_run
    N = len(model.lattice)
    np.testing.assert_allclose(_mean(obs, "gat_custom", "gat") * N,
                               _mean(obs, "gat_ref", "greens")[0], rtol=0,
                               atol=1e-12)


def test_custom_kernel_must_be_batch_first(square_run):
    """A per-chain kernel (the JAX package's contract) raises, naming the
    batch-first contract."""
    sim, model, _ = square_run
    m = tmc.custom_measurement(sim, model, lambda G: G[0, 0], name="bad")
    G = torch.zeros(2, 1, 16, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="batch-first"):
        m.measure_fn(greens=G)


def test_custom_classical_mc_measurement_binder():
    """A user-defined classical measurement (the Binder cumulant) through
    the generic Measurement: measure_fn sees the batched configuration,
    finish_fn derives U4 from the binned moments; deep in the ordered phase
    U4 -> 2/3."""
    model = tmc.IsingModel(dims=2, L=8)
    sim = tmc.MC(model, beta=1.0, n_chains=32, seed=4, sweeps=120,
                 thermalization=60, device="cpu")

    def measure(conf, **_):
        m = conf.reshape(conf.shape[0], -1).to(torch.float64).mean(1).abs()
        return {"m2": m ** 2, "m4": m ** 4}

    def finish(stats, _context):
        m2 = np.mean(stats["m2"].per_chain_mean)
        m4 = np.mean(stats["m4"].per_chain_mean)
        return {"U4": float(1.0 - m4 / (3.0 * m2 ** 2))}

    sim["binder"] = Measurement(name="binder",
                                obs_shapes={"m2": (), "m4": ()},
                                measure_fn=measure, finish_fn=finish)
    sim.run(verbose=False)
    u4 = sim.observables()["binder"]["U4"]
    assert abs(u4 - 2.0 / 3.0) < 0.015, u4


# ---------------------------------------------------------------------------
# parity with the JAX package's custom_measurement
# ---------------------------------------------------------------------------

ITERATORS = ["EachSite", "OnSite", "EachSiteAndFlavor", "EachSitePair",
             "EachSitePairByDistance", "EachLocalQuadByDistance",
             "EachLocalQuadBySyncedDistance"]
GREENS = ["Greens", "GreensAt", "Combined"]
LATTICES = {"square4": ("SquareLattice", 4, 3),
            "triangular3": ("TriangularLattice", 3, 4)}
C, M = 2, 3          # chains; slices summed by the combined step


def _raw(kind, A, B, S, np_):
    """A kernel of the raw shape of ``kind`` from two (.., N, N) blocks: per
    chain for the JAX package (np_ = jnp), batch-first for the port (np_ =
    torch); the same arithmetic."""
    batched = np_ is torch
    mT = (lambda X: X.mT) if batched else (lambda X: X.T)
    diag = ((lambda X: torch.diagonal(X, dim1=-2, dim2=-1)) if batched
            else jnp.diagonal)
    if kind == "site":
        return 1.0 - diag(A) * diag(B)
    if kind == "pair":
        return A * mT(B) + 0.5 * A
    S = (torch.as_tensor(S, dtype=A.dtype) if batched
         else jnp.asarray(S, A.dtype))
    if kind == "quad":
        if batched:
            X = torch.einsum("kab,cbd->ckad", S, B)
            return A[:, None, None] * torch.einsum("ckad,qbd->ckqab", X, S)
        X = jnp.einsum("kab,bc->kac", S, B)
        return A[None, None] * jnp.einsum("kac,qbc->kqab", X, S)
    if batched:                                            # synced
        return torch.einsum("kab,cbe,kde->ckad", S, B, S) * A[:, None]
    return jnp.einsum("kab,bc,kdc->kad", S, B, S) * A[None]


def _kind(iterator):
    return {"EachSite": "site", "OnSite": "site", "EachSitePair": "pair",
            "EachSitePairByDistance": "pair",
            "EachLocalQuadByDistance": "quad",
            "EachLocalQuadBySyncedDistance": "synced"}.get(iterator)


def _kernels(iterator, S):
    """(equal-time kernel, combined kernel), each as (JAX, port)."""
    kind = _kind(iterator)
    if kind is None:                                      # EachSiteAndFlavor
        def flav(np_, G, H=None):
            if np_ is torch:
                d = lambda X: torch.diagonal(X, dim1=-2, dim2=-1)
                v = 1.0 - d(G) if H is None else d(G) * d(H) + d(H)
                return v.reshape(v.shape[0], -1)
            d = lambda X: jnp.diagonal(X, axis1=-2, axis2=-1)
            v = 1.0 - d(G) if H is None else d(G) * d(H) + d(H)
            return v.reshape(-1)

        eq = [lambda G, np_=np_: flav(np_, G) for np_ in (jnp, torch)]
        comb = [lambda G00, G0l, Gl0, Gll, np_=np_: flav(np_, Gl0, G0l)
                for np_ in (jnp, torch)]
        return eq, comb

    def block(np_, X, f):
        return X[:, f] if np_ is torch else X[f]

    eq = [lambda G, np_=np_: _raw(kind, block(np_, G, 0), block(np_, G, -1),
                                  S, np_) for np_ in (jnp, torch)]
    comb = [lambda G00, G0l, Gl0, Gll, np_=np_:
            _raw(kind, block(np_, Gl0, 0), block(np_, G0l, -1), S, np_)
            + _raw(kind, block(np_, Gll, 0), block(np_, G00, -1), S, np_)
            for np_ in (jnp, torch)]
    return eq, comb


def _iterator(pkg, name, lattice, K, F):
    cls = getattr(pkg, name)
    if name == "EachSiteAndFlavor":
        return cls(lattice, flavors=F)
    if name.startswith("EachLocalQuad"):
        return cls(K)
    return cls()


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("lattice", sorted(LATTICES))
@pytest.mark.parametrize("iterator", ITERATORS)
@pytest.mark.parametrize("greens", GREENS)
def test_custom_matches_jax(greens, iterator, lattice, F):
    ctor, L, K = LATTICES[lattice]
    jl, tl = getattr(jmc, ctor)(L), getattr(tmc, ctor)(L)
    N = len(tl)
    S = tmc.selection_matrices(tl, K)
    np.testing.assert_array_equal(S, jmc.selection_matrices(jl, K))
    (jeq, teq), (jcomb, tcomb) = _kernels(iterator, S)
    rng = np.random.default_rng(
        [GREENS.index(greens), ITERATORS.index(iterator), L, F])
    Gs = rng.normal(size=(4 * M, C, F, N, N))

    def build(pkg, lat, kernel, comb, dtype):
        gi = {"Greens": pkg.Greens, "GreensAt": pkg.GreensAt(2, 1),
              "Combined": pkg.CombinedGreensIterator}[greens]
        return pkg.custom_measurement(
            None, types.SimpleNamespace(lattice=lat),
            comb if greens == "Combined" else kernel, name="x",
            lattice_iterator=_iterator(pkg, iterator, lat, K, F),
            greens_iterator=gi, dtype=dtype)

    mj = build(jmc, jl, jeq, jcomb, jnp.float64)
    mt = build(tmc, tl, teq, tcomb, torch.float64)
    assert mt.obs_shapes == mj.obs_shapes and mt.kind == mj.kind
    if greens == "Combined":
        assert mt.combined_acc_shapes == mj.combined_acc_shapes
        G00 = Gs[0]
        steps = [Gs[1 + 3 * s: 4 + 3 * s] for s in range(M)]
        want = []
        for c in range(C):               # the JAX step and finish per chain
            acc = sum(np.asarray(mj.measure_fn(
                G00=jnp.asarray(G00[c]), G0l=jnp.asarray(a[c]),
                Gl0=jnp.asarray(b[c]), Gll=jnp.asarray(d[c]))["x"])
                for a, b, d in steps)
            want.append(np.asarray(mj.combined_finish_fn(
                {"x": jnp.asarray(acc)})["x"]))
        want = np.stack(want)
        T = lambda X: torch.as_tensor(X)
        acc = sum(mt.measure_fn(G00=T(G00), G0l=T(a), Gl0=T(b),
                                Gll=T(d))["x"] for a, b, d in steps)
        got = mt.combined_finish_fn({"x": acc})["x"].numpy()
    else:
        arg = "greens" if greens == "Greens" else "utg"
        want = np.asarray(mj.measure_fn(**{arg: jnp.asarray(Gs[0])})["x"])
        got = mt.measure_fn(**{arg: torch.as_tensor(Gs[0])})["x"].numpy()
    assert got.shape == want.shape == (C,) + mj.obs_shapes["x"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
