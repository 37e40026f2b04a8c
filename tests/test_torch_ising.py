"""The classical flavor of the PyTorch/CUDA port (montecarlo_tpu_torch:
models/ising.py, ops/ising.py's plain versions of K17 and K18,
measurements/ising.py, mc/mc.py) against montecarlo_tpu, on the CPU.

The port's moves take their random numbers as arguments, so every parity
test replays the JAX package's key order with jax.random and hands the same
numbers to both sides: a sweep splits the key once per color class and
draws (C, n_c) float64 uniforms per class (the port takes them concatenated
in class order); a Wolff move splits once for the seeds (randint) and once
per BFS level for (C, N, z) float64 uniforms (the port draws a batch of
levels and hands back those the search did not use: JaxStream.levels
rewinds the key to the one after the last level used).

Tolerances: spins, accepted counts, clusters and cluster sizes are integers
and must be equal; energies and magnetizations exact; binner means of a
multi-sweep run within 1e-12 (float64 sums of the same integers, in another
order). The statistical tests are tests/test_ising_mc.py's, with its
tolerances.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.lattices import library as jlib

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.lattices import library as tlib
from montecarlo_tpu_torch.ops import ising as kis
from torch_port_inputs import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")

# every lattice of the classical path, one of each coloring: Chain(5) has
# three color classes, Square(3) four, Square(2) lists each neighbor twice
LATTICES = [("Chain", 5), ("SquareLattice", 2), ("SquareLattice", 3),
            ("SquareLattice", 4), ("CubicLattice", 3),
            ("TriangularLattice", 4), ("Honeycomb", 3)]
IDS = [f"{c}{L}" for c, L in LATTICES]


def _models(ctor, L):
    return (jmc.IsingModel(l=getattr(jlib, ctor)(L)),
            tmc.IsingModel(l=getattr(tlib, ctor)(L)))


def _conf(C, N, seed):
    rng = np.random.default_rng(seed)
    return (2 * rng.integers(0, 2, (C, N)) - 1).astype(np.int8)


class JaxStream:
    """The JAX package's random stream for the classical moves, as numpy:
    per sweep one split per color class, per Wolff move one split for the
    seeds and one per BFS level."""

    def __init__(self, key, colors, C):
        self.key, self.colors, self.C = key, colors, C

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def uniforms(self, shape):
        if len(shape) == 2:        # a sweep: the classes' draws, in order
            return torch.from_numpy(np.concatenate(
                [np.asarray(jax.random.uniform(
                    self._split(), (self.C, len(idx)), jnp.float64))
                 for idx in self.colors], axis=1))
        return torch.from_numpy(np.asarray(jax.random.uniform(
            self._split(), shape, jnp.float64)))

    def levels(self, shape, k):
        """k BFS levels' uniforms stacked (k, *shape), and rewind(used),
        which sets the key to the one after the used-th level's split."""
        keys, draws = [self.key], []
        for _ in range(k):
            draws.append(self.uniforms(shape))
            keys.append(self.key)

        def rewind(used):
            self.key = keys[used]

        return torch.stack(draws), rewind

    def seeds(self, N):
        return torch.from_numpy(np.array(jax.random.randint(
            self._split(), (self.C,), 0, N))).long()


@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_sweep_plain_matches_jax(ctor, L):
    """K17's plain version against make_sweep_fn over three sweeps at two
    temperatures: conf and the accepted count bit-equal."""
    jm, tm = _models(ctor, L)
    C, N = 16, len(tm.lattice)
    for beta in (0.2, 0.6):
        jsweep = jax.jit(jm.make_sweep_fn(beta))
        tsweep = tm.make_sweep_fn(beta, CPU)
        key = jax.random.PRNGKey(L + int(10 * beta))
        conf = _conf(C, N, L)
        jconf, tconf = jnp.asarray(conf), torch.from_numpy(conf)
        for _ in range(3):
            stream = JaxStream(key, tm.lattice.site_colors, C)
            u = stream.uniforms((C, N))
            jconf, key, n_acc = jsweep(jconf, key)
            acc = torch.zeros(C, dtype=torch.int64)
            tconf, acc = tsweep(tconf, u, acc)
            np.testing.assert_array_equal(tconf.numpy(), np.asarray(jconf))
            assert int(acc.sum()) == int(n_acc)
            assert np.array_equal(np.asarray(stream.key), np.asarray(key))


def test_sweep_accumulates_counts_in_place():
    """acc collects each chain's accepted sites across sweeps, in place."""
    tm = tmc.IsingModel(dims=2, L=4)
    tabs = kis.make_tables(tm.lattice, 0.3, CPU)
    conf = torch.from_numpy(_conf(4, 16, 0))
    acc = torch.zeros(4, dtype=torch.int64)
    gen = torch.Generator().manual_seed(1)
    total = torch.zeros(4, dtype=torch.int64)
    for _ in range(3):
        fresh = torch.zeros(4, dtype=torch.int64)
        u = torch.rand(4, 16, generator=gen, dtype=torch.float64)
        conf_a, acc2 = kis.ising_sweep_plain(conf, u, tabs, acc)
        conf_b, fresh = kis.ising_sweep(conf, u, tabs, fresh)
        assert acc2 is acc and torch.equal(conf_a, conf_b)
        total += fresh
        conf = conf_a
    assert torch.equal(acc, total)


@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_global_move_matches_jax(ctor, L):
    """The Wolff move (K18's plain version in batches of levels) against
    make_global_move_fn on the same seeds and per-level uniforms: clusters,
    flipped conf and cluster sizes equal, and the same number of levels
    drawn."""
    jm, tm = _models(ctor, L)
    C, N = 16, len(tm.lattice)
    beta = 1.0 / jmc.IsingTc
    jmove = jax.jit(jm.make_global_move_fn(beta))
    tmove = tm.make_global_move_fn(beta, CPU)
    key = jax.random.PRNGKey(100 + L)
    conf = _conf(C, N, 7 + L)
    for _ in range(3):
        stream = JaxStream(key, tm.lattice.site_colors, C)
        flipped, key, size = jmove(jnp.asarray(conf), key)
        tflipped, tsize, levels = tmove(
            torch.from_numpy(conf), stream.seeds(N),
            lambda k: stream.levels((C, N, tm.lattice.coordination), k))
        np.testing.assert_array_equal(tflipped.numpy(), np.asarray(flipped))
        np.testing.assert_array_equal(tsize.numpy(), np.asarray(size))
        assert np.array_equal(np.asarray(stream.key), np.asarray(key))
        assert levels >= 1
        conf = np.asarray(flipped)


def _wolff_gather(conf, inc, front, spin, u, tabs):
    """K18's gather formulation in numpy: site t joins when it is not in
    the cluster, has the seed's spin, and some bond (i, k) onto it
    (tabs.rev) has i on the frontier and u[c, i, k] < p_add."""
    C, N = conf.shape
    z = tabs.z
    rev = tabs.rev.numpy()
    add = np.zeros((C, N), bool)
    for c in range(C):
        for t in range(N):
            if inc[c, t] or conf[c, t] != spin[c, 0]:
                continue
            for e in rev[t]:
                if e >= 0 and front[c, e // z] and u[c, e // z, e % z] < tabs.p_add:
                    add[c, t] = True
    return inc | add, add


@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_wolff_step_reverse_table(ctor, L):
    """The reverse table K18 gathers through gives the plain version's
    scatter result, level after level (batches of one level), from random
    seeds."""
    _, tm = _models(ctor, L)
    C, N, z = 8, len(tm.lattice), tm.lattice.coordination
    tabs = kis.make_tables(tm.lattice, 0.5, CPU)
    rng = np.random.default_rng(L)
    conf = torch.from_numpy(_conf(C, N, L))
    seeds = torch.from_numpy(rng.integers(0, N, C))
    inc = torch.zeros(C, N, dtype=torch.bool)
    inc[torch.arange(C), seeds] = True
    spin = conf.gather(1, seeds[:, None])
    front = inc
    for _ in range(4):
        u = torch.from_numpy(rng.random((C, N, z)))
        new_inc, new_front, flag = kis.wolff_step(conf, inc, front, spin,
                                                  u[None], tabs)
        g_inc, g_front = _wolff_gather(conf.numpy(), inc.numpy(),
                                       front.numpy(), spin.numpy(),
                                       u.numpy(), tabs)
        np.testing.assert_array_equal(new_inc.numpy(), g_inc)
        np.testing.assert_array_equal(new_front.numpy(), g_front)
        assert flag.tolist() == [int(front.any()), int(g_front.any())]
        inc, front = new_inc, new_front


@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_energy_magnetization_exact(ctor, L):
    """make_energy_fn and make_magnetization_fn equal the JAX package's
    exactly."""
    jm, tm = _models(ctor, L)
    conf = _conf(32, len(tm.lattice), 3)
    for jfn, tfn in ((jm.make_energy_fn(), tm.make_energy_fn()),
                     (jm.make_magnetization_fn(),
                      tm.make_magnetization_fn())):
        out = tfn(torch.from_numpy(conf))
        assert out.dtype == torch.float64
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(jfn(jnp.asarray(conf))))


@pytest.mark.parametrize("global_moves", [False, True])
def test_mc_run_matches_jax(global_moves):
    """Several MC sweeps (thermalization, then measurement with the default
    measurements; Wolff moves every 2 sweeps) on the JAX package's stream:
    conf and counters equal, binner means within 1e-12, the derived C and
    chi within 1e-12."""
    kw = dict(beta=0.44, n_chains=8, seed=3, global_moves=global_moves,
              global_rate=2)
    jm = jmc.MC(jmc.IsingModel(dims=2, L=4), **kw)
    tm = tmc.MC(tmc.IsingModel(dims=2, L=4), device="cpu", **kw)
    tm.conf = torch.from_numpy(np.asarray(jm.conf))
    stream = JaxStream(jm.key, tm.model.lattice.site_colors, 8)
    tm._uniforms, tm._seed_sites = stream.uniforms, stream.seeds
    tm._level_uniforms = stream.levels
    run = dict(thermalization=4, sweeps=8, verbose=False, chunk=4)
    assert jm.run(**run) and tm.run(**run)
    np.testing.assert_array_equal(tm.conf.numpy(), np.asarray(jm.conf))
    for f in ("prop_local", "acc_local", "prop_global", "acc_global",
              "acc_rate", "acc_rate_global"):
        assert getattr(tm.analysis, f) == getattr(jm.analysis, f), f
    assert (tm.analysis.levels_global > 0) == global_moves
    jobs, tobs = jm.observables(), tm.observables()
    for group, names in (("Energy", ("E", "E2", "e", "C")),
                         ("Magn", ("M", "M2", "m", "chi"))):
        for n in names:
            a, b = tobs[group][n], jobs[group][n]
            if n in ("C", "chi"):
                assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
                continue
            assert a.count == b.count == 8
            np.testing.assert_allclose(a.per_chain_mean, b.per_chain_mean,
                                       rtol=1e-12, atol=1e-12)


def test_mc_stream_independent_of_chunk():
    """The uniforms are drawn per sweep: chunk sizes 1, 7 and 256 give the
    same chains and counters."""
    out = []
    for chunk in (1, 7, 256):
        sim = tmc.MC(tmc.IsingModel(dims=2, L=4), beta=0.5, n_chains=4,
                     seed=9, global_moves=True, global_rate=3, device="cpu")
        sim.run(sweeps=15, verbose=False, chunk=chunk)
        out.append((sim.conf.clone(), sim.analysis.acc_local,
                    sim.analysis.acc_global, sim.analysis.levels_global))
    for o in out[1:]:
        assert torch.equal(o[0], out[0][0]) and o[1:] == out[0][1:]


def test_schedules_and_counters():
    """Global moves on sweeps divisible by global_rate (counted from
    last_sweep + 1), measurements on those divisible by measure_rate;
    prop_global counts chains per move."""
    sim = tmc.MC(tmc.IsingModel(dims=2, L=3), beta=0.4, n_chains=5, seed=1,
                 global_moves=True, global_rate=4, measure_rate=3,
                 device="cpu")
    sim.run(thermalization=2, sweeps=10, verbose=False, chunk=5)
    assert sim.analysis.prop_global == (12 // 4) * 5
    assert sim.analysis.prop_local == 12 * 5 * 9
    # measured sweeps 3, 6, 9, 12 (sweep 3 onwards is the measurement stage)
    assert sim["Energy"]["E"].count == 4
    sim.run(thermalization=2, sweeps=14, verbose=False)
    assert sim.last_sweep == 16
    assert sim.analysis.prop_global == (16 // 4) * 5
    assert sim["Energy"]["E"].count == 5


# ---------------------------------------------------------------------------
# tests/test_ising_mc.py's statistical tests, on the port
# ---------------------------------------------------------------------------

def exact_ising_3x3(beta):
    """Exact thermal averages on the periodic 3x3 by enumeration."""
    bonds = tlib.SquareLattice(3).bonds[:, :2]
    s = np.array(list(itertools.product([-1, 1], repeat=9)))
    Es = -np.sum(s[:, bonds[:, 0]] * s[:, bonds[:, 1]], axis=1)
    Ms = np.abs(s.sum(axis=1))
    w = np.exp(-beta * (Es - Es.min()))
    return (Es * w).sum() / w.sum(), (Ms * w).sum() / w.sum()


@pytest.mark.parametrize("beta", [0.3, 0.5])
def test_ising_vs_exact_enumeration(beta):
    mc = tmc.MC(tmc.IsingModel(dims=2, L=3), beta=beta, n_chains=64, seed=42,
                sweeps=800, thermalization=200, device="cpu")
    assert mc.run(verbose=False)
    E_exact, M_exact = exact_ising_3x3(beta)
    obs = mc.observables()
    E, M = obs["Energy"]["E"], obs["Magn"]["M"]
    assert abs(E.mean - E_exact) < max(4 * E.std_error, 0.05)
    assert abs(M.mean - M_exact) < max(4 * M.std_error, 0.05)


def test_ising_8x8_near_reference_golden():
    """8x8 at beta=0.35: the reference's golden means <m>=0.398,
    <e>=-0.924."""
    mc = tmc.MC(tmc.IsingModel(dims=2, L=8), beta=0.35, n_chains=64, seed=7,
                sweeps=700, thermalization=300, device="cpu")
    assert mc.run(verbose=False)
    obs = mc.observables()
    assert abs(obs["Energy"]["e"].mean - (-0.924)) < 0.025
    assert abs(obs["Magn"]["m"].mean - 0.398) < 0.06


def test_wolff_accelerates_near_tc():
    mc = tmc.MC(tmc.IsingModel(dims=2, L=8), beta=1.0 / tmc.IsingTc,
                n_chains=32, seed=3, sweeps=250, thermalization=100,
                global_moves=True, global_rate=2, device="cpu")
    assert mc.run(verbose=False)
    assert mc.analysis.acc_global > 0
    assert 0.3 < mc.observables()["Magn"]["m"].mean < 0.8


def test_energy_magnetization_consistency():
    model = tmc.IsingModel(dims=2, L=4)
    mc = tmc.MC(model, beta=0.4, n_chains=8, seed=1, sweeps=100,
                thermalization=0, device="cpu")
    assert mc.run(verbose=False)
    E = model.make_energy_fn()(mc.conf).numpy()
    bonds = model.lattice.bonds[:, :2]
    conf = mc.conf.numpy()
    np.testing.assert_array_equal(
        E, -np.sum(conf[:, bonds[:, 0]] * conf[:, bonds[:, 1]], axis=1))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_padded_table_refused():
    """A lattice of uneven coordination (neighbor table padded with -1):
    the JAX package's gathers read -1 as the last site; the port refuses."""
    lat = tlib.GenericLattice(np.eye(2), [[0.0, 0.0], [0.5, 0.0]],
                              [(0, 1, (0, 0), 0), (1, 0, (1, 0), 0),
                               (0, 0, (0, 1), 1)], (3, 3))
    assert (lat.neighbor_table < 0).any()
    with pytest.raises(ValueError, match="padded with -1"):
        tmc.IsingModel(l=lat)
    with pytest.raises(ValueError, match="padded with -1"):
        kis.make_tables(lat, 0.4, CPU)


def test_ising_model_needs_a_lattice():
    with pytest.raises(ValueError, match="dims and L"):
        tmc.IsingModel()
    assert len(tmc.IsingModel(dims=3, L=3).lattice) == 27


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tmc.MC(tmc.IsingModel(dims=2, L=4), beta=0.4, n_chains=2)
