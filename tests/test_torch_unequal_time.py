"""The time-displaced path of the PyTorch/CUDA port (montecarlo_tpu_torch)
against montecarlo_tpu on the CPU, in float64: the slice multiplies, the
forward / backward / inverse UDT blocks, G(k, l), the UDT stacks, the
combined iterator (every G(0,l), G(l,0), G(l,l)), the range iterator, the
accuracy self-checks, the susceptibilities and greens_at measured through
the drivers' measurement passes, and DQMC.greens.

The same HS field, made with numpy from a seed, goes to both sides (the JAX
functions per chain, vmapped where they scan; the port's batched over
chains). The JAX side runs its plain route (use_pallas=False), as its own
tests do on the CPU. Both compute the same float64 operations in the same
order up to the QR (LAPACK's on the JAX side, K11's plain version on the
port's), so G agrees to float64 rounding: TOL_G absolute on entries of
O(1), and the susceptibilities TOL_SUSC relative to their largest entry.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc import unequal_time as jut
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.measurements import dqmc_measurements as jdm
from montecarlo_tpu.measurements.core import ObservableResult as JResult

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc import unequal_time as tut
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.measurements import dqmc_measurements as tdm

# float64 rounding of G through ~M/sm UDTs and the full1/full2 algebra
# stays near 1e-14 at beta = 1; 1e-10 leaves four decades
TOL_G = 1e-10
TOL_SUSC = 1e-12
C, L, BETA, DTAU, SM = 2, 2, 1.0, 0.1, 5
# the (k, l) pairs of tests/test_unequal_time.py::test_greens_kl_vs_naive
KL_PAIRS = [(0, 0), (3, 0), (7, 2), (10, 10), (5, 5), (0, 4), (2, 9), (0, 10)]


def _gauge(N, seed=0):
    phi = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, N)
    return phi[:, None] - phi[None, :]


def _setup(repulsive=False, peierls=False, seed=3):
    """((jctx, jconsts), (tctx, tconsts), conf (C, N, M) int8 numpy, the two
    models): float64 sessions (complex128 with pure-gauge Peierls phases)
    at L = 2, beta = 1, dtau = 0.1, safe_mult = 5."""
    kw = dict(dims=2, L=L, U=4.0)
    if peierls:
        kw["peierls"] = _gauge(L * L)
    if repulsive:
        jm, tm = jmc.HubbardModelRepulsive(**kw), tmc.HubbardModelRepulsive(**kw)
    else:
        jm = jmc.HubbardModelAttractive(mu=0.5, **kw)
        tm = tmc.HubbardModelAttractive(mu=0.5, **kw)
    pj = dict(beta=BETA, delta_tau=DTAU, safe_mult=SM)
    jctx, jconsts = jcore.make_context(jm, JParams(**pj))
    tctx, tconsts = tcore.make_context(tm, TParams(**pj), dtype=torch.float64,
                                       device="cpu")
    conf = np.random.default_rng(seed).choice(
        np.array([-1, 1], np.int8), size=(C, len(tm.lattice), tctx.M))
    return (jctx, jconsts), (tctx, tconsts), conf, (jm, tm)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(out, ref, tol=TOL_G):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.max(np.abs(out - ref))
    assert err <= tol, err


def _per_chain(fn, conf):
    """A JAX per-chain function over the chains of conf, stacked."""
    return np.stack([np.asarray(fn(jnp.asarray(c))) for c in conf])


def _product(F):
    U, D, T = (np.asarray(x) for x in F)
    return (U * D[..., None, :]) @ T


def test_slice_multiplies_match_jax():
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup()
    rng = np.random.default_rng(1)
    M = rng.normal(size=(C, 1, 4, 4))
    for name in ("mult_B_left", "mult_B_right", "mult_B_inv_left",
                 "mult_B_inv_right", "mult_B_dagger_left",
                 "mult_B_dagger_right", "mult_B_invdag_right"):
        ref = np.stack([np.asarray(getattr(jcore, name)(
            jctx, jconsts, jnp.asarray(conf[c, :, 3]), jnp.asarray(M[c])))
            for c in range(C)])
        out = getattr(tcore, name)(tctx, tconsts, _t(conf[:, :, 3]), _t(M))
        _close(out.numpy(), ref, 1e-13)


@pytest.mark.parametrize("block,args", [
    ("forward_block", (7,)), ("backward_block", (3,)),
    ("inverse_block", (2, 9))])
def test_blocks_match_jax(block, args):
    """Each block's product U·diag(D)·T (the factors themselves depend on
    the QR's sign choices) against the JAX package's."""
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup()
    ref = np.stack([_product(getattr(jut, block)(jctx, jconsts,
                                                 jnp.asarray(c), *args))
                    for c in conf])
    out = _product(getattr(tut, block)(tctx, tconsts, _t(conf), *args))
    _close(out, ref, TOL_G * np.max(np.abs(ref)))


@pytest.mark.parametrize("k,l", KL_PAIRS)
def test_greens_kl_matches_jax(k, l):
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup()
    ref = _per_chain(lambda c: jut.greens_kl(jctx, jconsts, c, k, l), conf)
    out = tut.greens_kl(tctx, tconsts, _t(conf), k, l)
    _close(out.numpy(), ref)


def test_build_ut_stacks_match_jax():
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup()
    ref = jax.vmap(lambda c: jut.build_ut_stacks(jctx, jconsts, c))(
        jnp.asarray(conf))
    out = tut.build_ut_stacks(tctx, tconsts, _t(conf))
    for name in ("fwd", "bwd", "inv"):
        assert len(out[name]) == tctx.n_el
        for j, F in enumerate(out[name]):
            r = _product(tuple(np.asarray(x)[:, j] for x in ref[name]))
            _close(_product(F), r, TOL_G * np.max(np.abs(r)))


def _jax_history(jctx, jconsts, conf, G00, recalculate):
    """Every (G0l, Gl0, Gll) of the JAX combined iterator: (C, M, 3, F, N,
    N)."""
    M, F, N = jctx.M, jctx.F, jctx.N

    def step(acc, G0l, Gl0, Gll):
        hist, i = acc
        return hist.at[i].set(jnp.stack([G0l, Gl0, Gll])), i + 1

    def one(c, g):
        acc0 = (jnp.zeros((M, 3, F, N, N), jnp.result_type(g)), 0)
        return jut.combined_greens_apply(jctx, jconsts, c, g, acc0, step,
                                         recalculate=recalculate)[0]

    return np.asarray(jax.vmap(one)(jnp.asarray(conf), jnp.asarray(G00)))


def _torch_history(tctx, tconsts, conf, G00, recalculate):
    hist = tut.combined_greens_apply(
        tctx, tconsts, _t(conf), _t(G00), [],
        lambda acc, *G: acc + [torch.stack(G, 1)], recalculate=recalculate)
    assert len(hist) == tctx.M
    return torch.stack(hist, 1).numpy()


@pytest.mark.parametrize("recalculate,peierls", [
    (None, False), (2 * SM, False), (None, True)])
def test_combined_greens_apply_matches_jax(recalculate, peierls):
    """Every (G0l, Gl0, Gll), l = 1..M, on the default schedule (every
    boundary a recalculation) and at recalculate = 2·safe_mult (the first
    boundary a stabilization); with pure-gauge Peierls phases in
    complex128."""
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup(peierls=peierls)
    G00 = _per_chain(lambda c: jcore.greens_from_scratch(jctx, jconsts, c, 0),
                     conf)
    _close(tcore.greens_from_scratch(tctx, tconsts, _t(conf), 0).numpy(), G00)
    ref = _jax_history(jctx, jconsts, conf, G00, recalculate)
    out = _torch_history(tctx, tconsts, conf, G00, recalculate)
    assert out.dtype == (np.complex128 if peierls else np.float64)
    _close(out, ref)


@pytest.mark.parametrize("l", [3])
def test_greens_range_apply_matches_jax(l):
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup()
    M, F, N = jctx.M, jctx.F, jctx.N

    def step(hist, k, G):
        return hist.at[k].set(G)

    ref = np.asarray(jax.vmap(lambda c: jut.greens_range_apply(
        jctx, jconsts, c, l, jnp.zeros((M + 1, F, N, N)), step))(
            jnp.asarray(conf)))
    seen = {}

    def tstep(acc, k, G):
        seen[k] = G
        return acc + 1

    n = tut.greens_range_apply(tctx, tconsts, _t(conf), l, 0, tstep)
    assert n == M + 1 - l and sorted(seen) == list(range(l, M + 1))
    _close(torch.stack([seen[k] for k in range(l, M + 1)], 1).numpy(),
           ref[:, l:])


def test_accuracy_self_checks_match_jax():
    """combined_accuracy per chain on both schedules, at float64 rounding
    as the JAX package's (its first chain at recalculate = 2·safe_mult),
    and the verify and range-accuracy forms."""
    (jctx, jconsts), (tctx, tconsts), conf, _ = _setup()
    G00 = _per_chain(lambda c: jcore.greens_from_scratch(jctx, jconsts, c, 0),
                     conf)
    ref = float(jut.combined_accuracy(jctx, jconsts, jnp.asarray(conf[0]),
                                      jnp.asarray(G00[0]),
                                      recalculate=2 * SM))
    assert ref < TOL_G
    for rec in (SM, 2 * SM):
        out = tut.combined_accuracy(tctx, tconsts, _t(conf), _t(G00),
                                    recalculate=rec).numpy()
        assert out.shape == (C,) and np.all(out < TOL_G), out
    assert tut.verify_combined(tctx, tconsts, _t(conf), _t(G00),
                               maxerror=TOL_G)
    assert tut.verify_range(tctx, tconsts, _t(conf), 3, maxerror=TOL_G)
    with pytest.raises(ValueError, match="multiple of safe_mult"):
        tut.combined_accuracy(tctx, tconsts, _t(conf), _t(G00), recalculate=3)


def _susceptibilities(mod, mc, model):
    out = {"CDS": mod.charge_density_susceptibility(mc, model),
           "PS": mod.pairing_susceptibility(mc, model, K=4),
           "CCS": mod.current_current_susceptibility(mc, model, K=4),
           "UTG": mod.greens_measurement(mc, model, greens_at=(2, 7)),
           "occ": mod.occupation(mc, model)}
    for d in ("x", "y", "z"):
        out[f"SDS{d}"] = mod.spin_density_susceptibility(mc, model, d)
    return out


@pytest.mark.parametrize("repulsive", [False, True])
def test_measure_all_matches_jax(repulsive):
    """CDS, SDS x/y/z, PS, CCS, a greens_at and an equal-time
    measurement pushed through each driver's measurement pass from the same
    G and field: per-chain values within TOL_SUSC of the largest (TOL_G on
    G(k, l))."""
    (jctx, jconsts), (tctx, tconsts), conf, (jm, tm) = _setup(repulsive)
    G00 = _per_chain(lambda c: jcore.greens_from_scratch(jctx, jconsts, c, 0),
                     conf)
    jfake = SimpleNamespace(ctx=jctx, consts=jconsts,
                            parameters=JParams(beta=BETA, delta_tau=DTAU,
                                               safe_mult=SM))
    jmeas = _susceptibilities(jdm, jfake, jm)
    bstates = {k: m.bind(C) for k, m in jmeas.items()}
    new = jmc.DQMC._measure_all(jfake, list(jmeas.items()), bstates,
                                jnp.asarray(G00), jnp.asarray(conf))

    sim = tmc.DQMC(tm, n_chains=C, beta=BETA, delta_tau=DTAU, safe_mult=SM,
                   device="cpu", measurements={})
    sim.state = interop.state_from_numpy(
        {**interop.state_to_numpy(sim.state), "conf": conf})
    for k, m in _susceptibilities(tdm, sim, tm).items():
        sim[k] = m
    sim._measure_all(sim.measurements, _t(G00), _t(conf))
    for k, m in jmeas.items():
        tmeas = sim.measurements.measurements[k]
        assert (tmeas.name, tmeas.kind, tmeas.obs_shapes) == (
            m.name, m.kind, m.obs_shapes), k
        for name in m.obs_shapes:
            ref = np.asarray(JResult(new[k][name]).per_chain_mean)
            out = sim[k][name].per_chain_mean
            assert out.shape == (C,) + m.obs_shapes[name]
            tol = TOL_G if k.startswith("UTG") else TOL_SUSC * np.max(
                np.abs(ref))
            _close(out, ref, tol)
            if k in ("CDS", "PS", "CCS") or k.startswith("SDS"):
                assert np.max(np.abs(ref)) > 1e-3, (k, "vanishes")


def test_dqmc_greens_matches_jax():
    """DQMC.greens(slice) and DQMC.greens(k, l) from the same field: the
    physical G; G(l, l) equals the equal-time G(l), and G(k, 0) = -G(k, M)
    (anti-periodicity)."""
    _, _, conf, (jm, tm) = _setup(seed=8)
    kw = dict(n_chains=C, beta=BETA, delta_tau=DTAU, safe_mult=SM)
    jsim = jmc.DQMC(jm, measurements={}, **kw)
    jsim.state = {**jsim.state, "conf": jnp.asarray(conf)}
    sim = tmc.DQMC(tm, device="cpu", measurements={}, **kw)
    sim.state["conf"] = _t(conf)
    M = sim.ctx.M
    for args in ((3,), (7, 2)):
        _close(sim.greens(*args).numpy(), np.asarray(jsim.greens(*args)))
    _close(sim.greens(7, 7).numpy(), sim.greens(7).numpy())
    _close(sim.greens(3, 0).numpy(), -sim.greens(3, M).numpy())
    assert tmc.greens(sim, 2, 7).shape == (C, 1, 4, 4)


@pytest.mark.parametrize("recalculate", [None, 2 * SM])
def test_udt_schedule_counts(monkeypatch, recalculate):
    """combined_udt_launches and greens_kl_udts count the udt_dirty and
    calculate_greens calls that the iterator and greens_kl make: on the
    card in float32 at 8 | N <= 64, K2's and K3's launches."""
    _, (tctx, tconsts), conf, _ = _setup()
    calls = {"udt": 0, "greens": 0}
    udt, greens = tcore.udt, tut.calculate_greens

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tcore, "udt", count("udt", udt))
    monkeypatch.setattr(tut, "calculate_greens", count("greens", greens))
    G00 = tcore.greens_from_scratch(tctx, tconsts, _t(conf), 0)
    calls.update(udt=0, greens=0)
    tut.combined_greens_apply(tctx, tconsts, _t(conf), G00, 0,
                              lambda acc, *G: acc, recalculate=recalculate)
    assert (calls["udt"], calls["greens"]) == tut.combined_udt_launches(
        tctx, recalculate)
    for k, l in KL_PAIRS:
        calls.update(udt=0)
        tut.greens_kl(tctx, tconsts, _t(conf), k, l)
        assert calls["udt"] == tut.greens_kl_udts(tctx, k, l), (k, l)


def test_factories_of_the_time_displaced_path():
    """Names, kinds, shapes and accumulator shapes of every time-displaced
    factory, and the dispatchers, as the JAX package's."""
    _, _, _, (jm, tm) = _setup(repulsive=True)
    mc = SimpleNamespace(parameters=SimpleNamespace(delta_tau=DTAU))
    for k, m in _susceptibilities(jdm, mc, jm).items():
        t = _susceptibilities(tdm, mc, tm)[k]
        assert (t.name, t.kind, t.obs_shapes, t.combined_acc_shapes,
                t.greens_at) == (m.name, m.kind, m.obs_shapes,
                                 m.combined_acc_shapes, m.greens_at), k
    it = tdm.CombinedGreensIterator
    assert tdm.charge_density(mc, tm, greens_iterator=it).name == "cds"
    assert tdm.spin_density(mc, tm, "y", greens_iterator=it).name == "sds_y"
    assert tdm.pairing(mc, tm, greens_iterator=it, K=4).obs_shapes == (
        jdm.pairing(mc, jm, greens_iterator=jdm.CombinedGreensIterator,
                    K=4).obs_shapes)
    with pytest.raises(ValueError, match="unknown measurement kind"):
        tdm.Measurement("x", {"x": ()}, lambda **_: {}, kind="later")
