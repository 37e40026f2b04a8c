"""The Wolff move in batches of BFS levels and the register layouts of K17
and K18 (montecarlo_tpu_torch: models/ising.py's make_global_move_fn and
batch_levels, ops/ising.py's wolff_step_plain and neighbor_masks, mc/mc.py's
_level_uniforms), on the CPU.

The batched move is held against the JAX package's make_global_move_fn on
its own stream (tests/test_torch_ising.py's JaxStream, whose levels()
rewinds the key) at one, two and N + 1 levels a batch. The kernels' layouts
cannot run here, so their arithmetic is written out in numpy (spins,
clusters and frontiers as bit masks, as in csrc/ising.cu) and held against
the plain versions. Everything compared is an integer: equal, no tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.models import ising as tising
from montecarlo_tpu_torch.ops import ising as kis
from test_torch_ising import CPU, IDS, LATTICES, JaxStream, _conf, _models
from torch_port_inputs import one_torch_thread  # noqa: F401

BATCHES = {"1": lambda N: 1, "2": lambda N: 2, "N+1": lambda N: N + 1}
RULE = tising.batch_levels


def _fix_batch(monkeypatch, lb):
    """Fix the Wolff move's batches to lb levels (None: batch_levels' rule):
    the move reads models.ising.batch_levels at each batch."""
    monkeypatch.setattr(tising, "batch_levels",
                        RULE if lb is None else lambda *a: lb)


@functools.cache
def _jax_move(ctor, L):
    jm, _ = _models(ctor, L)
    return jax.jit(jm.make_global_move_fn(1.0 / jmc.IsingTc))


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_batched_move_matches_jax(ctor, L, batch, monkeypatch):
    """make_global_move_fn at a fixed batch size, and level by level (one
    level a batch), against the JAX package's move on its stream, three
    moves: flipped conf and cluster sizes equal, the key equal after each
    move (exactly ``levels`` level draws consumed), and the same level
    count at both batch sizes."""
    _, tm = _models(ctor, L)
    C, N, z = 16, len(tm.lattice), tm.lattice.coordination
    colors = tm.lattice.site_colors
    moves = [(tm.make_global_move_fn(1.0 / jmc.IsingTc, CPU), lb)
             for lb in (BATCHES[batch](N), 1)]
    jmove = _jax_move(ctor, L)
    key = jax.random.PRNGKey(200 + L)
    conf = _conf(C, N, 9 + L)
    for _ in range(3):
        start = key
        flipped, key, size = jmove(jnp.asarray(conf), key)
        levels = []
        for move, lb in moves:
            _fix_batch(monkeypatch, lb)
            stream = JaxStream(start, colors, C)
            tflipped, tsize, n = move(torch.from_numpy(conf), stream.seeds(N),
                                      lambda k: stream.levels((C, N, z), k))
            np.testing.assert_array_equal(tflipped.numpy(),
                                          np.asarray(flipped))
            np.testing.assert_array_equal(tsize.numpy(), np.asarray(size))
            assert np.array_equal(np.asarray(stream.key), np.asarray(key))
            levels.append(n)
        assert levels[0] == levels[1] >= 1
        conf = np.asarray(flipped)


def test_mc_wolff_run_independent_of_batch(monkeypatch):
    """MC.run with Wolff moves gives the same conf and counters at every
    batch size (the model's choice, 1, 2 and N + 1 levels), as
    test_mc_stream_independent_of_chunk does for the chunk size; the
    generator ends in the same state."""
    out = []
    for lb in (None, 1, 2, 17):
        _fix_batch(monkeypatch, lb)
        sim = tmc.MC(tmc.IsingModel(dims=2, L=4), beta=1.0 / tmc.IsingTc,
                     n_chains=6, seed=11, global_moves=True, global_rate=2,
                     device="cpu")
        sim.run(thermalization=4, sweeps=12, verbose=False, chunk=5)
        a = sim.analysis
        out.append((sim.conf.clone(), sim.generator.get_state(), a.acc_local,
                    a.acc_global, a.prop_global, a.levels_global))
    assert out[0][-1] > 0
    for o in out[1:]:
        assert torch.equal(o[0], out[0][0]) and torch.equal(o[1], out[0][1])
        assert o[2:] == out[0][2:]


def test_level_uniforms_rewind():
    """MC._level_uniforms draws torch.rand's numbers level by level and
    rewind(used) leaves the generator where used single draws would."""
    sim = tmc.MC(tmc.IsingModel(dims=2, L=3), beta=0.4, n_chains=3, seed=5,
                 device="cpu")
    shape = (3, 9, 4)
    start = sim.generator.get_state()
    ref = [torch.rand(shape, generator=sim.generator, dtype=torch.float64)
           for _ in range(4)]
    for used in (0, 2, 4):
        sim.generator.set_state(start)
        u, rewind = sim._level_uniforms(shape, 4)
        assert u.shape == (4, *shape) and torch.equal(u, torch.stack(ref))
        rewind(used)
        gen = torch.Generator().set_state(start)
        for _ in range(used):
            torch.rand(shape, generator=gen, dtype=torch.float64)
        assert torch.equal(sim.generator.get_state(), gen.get_state())


def test_batch_levels_rule():
    """batch_levels: the cap is N + 1 and the BATCH_BYTES budget (at least
    one level); the first batch of a move the previous move's levels plus
    an eighth plus 2 (the cap on the first move), later batches a quarter
    of that, at least 2."""
    B = tising.batch_levels
    level = 8 * 4096 * 64 * 4                   # 8.4 MB: 4096 chains, 8x8
    assert tising.BATCH_BYTES // level == 64
    assert B(None, 0, 4096, 64, 4) == 64        # the budget below N + 1
    assert B(None, 0, 16, 64, 4) == 65          # N + 1
    assert B(28, 0, 4096, 64, 4) == 33
    assert B(28, 33, 4096, 64, 4) == 8
    assert B(3, 5, 4096, 64, 4) == 2
    assert B(60, 0, 4096, 64, 4) == 64
    assert B(None, 0, 262144, 64, 4) == 1       # 537 MB a level
    assert B(28, 0, 262144, 64, 4) == 1


def _bits(rows):
    """(C, N) bool -> (C,) Python int bit masks, bit t for column t."""
    return [sum(1 << t for t in np.flatnonzero(r)) for r in rows]


def _unbits(masks, N):
    return np.array([[(m >> t) & 1 for t in range(N)] for m in masks], bool)


def _sweep_registers(conf, u, tabs):
    """K17's tile layout in numpy: the spins of a chain as a bit mask up
    over class positions (bit r: the spin of site order[r]); the neighbor
    sum of position p 2 popc(up & masks[p]) - z; a class's accepted flips
    one mask, applied after the class."""
    masks = tabs.masks.numpy().view(np.uint64)
    order, thr, z, b = tabs.order.numpy(), tabs.thr.numpy(), tabs.z, tabs.bounds
    C, N = conf.shape
    up = np.array(_bits(conf[:, order] > 0), np.uint64)
    count = np.zeros(C, np.int64)
    for k in range(len(b) - 1):
        flip = np.zeros(C, np.uint64)
        for p in range(b[k], b[k + 1]):
            nn = 2 * np.bitwise_count(up & masks[p]).astype(np.int64) - z
            h = np.where((up >> np.uint64(p)) & np.uint64(1), nn, -nn)
            acc = (h <= 0) | (u[:, p] < thr[np.clip(h, 0, None)])
            flip |= np.where(acc, np.uint64(1) << np.uint64(p), np.uint64(0))
            count += acc
        up ^= flip
    out = np.empty((C, N), np.int8)
    out[:, order] = np.where(_unbits(up.tolist(), N), 1, -1)
    return out, count


@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_sweep_register_layout(ctor, L):
    """K17's tile layout arithmetic (every lattice here has N <= 64)
    against ising_sweep_plain, three sweeps at two temperatures: conf and
    counts equal; each mask holds exactly the neighbors the table lists.
    The 2x2 lists each neighbor twice: no masks (the shared-memory
    layout)."""
    _, tm = _models(ctor, L)
    C, N = 12, len(tm.lattice)
    rng = np.random.default_rng(L)
    for beta in (0.3, 0.9):
        tabs = kis.make_tables(tm.lattice, beta, CPU)
        table, order = tabs.table.numpy(), tabs.order.numpy()
        listed = np.stack([np.bincount(table[i], minlength=N)[order]
                           for i in order])
        if listed.max() > 1:
            assert tabs.masks is None
            return
        held = _unbits(tabs.masks.numpy().view(np.uint64).tolist(), N)
        np.testing.assert_array_equal(held, listed == 1)
        conf = torch.from_numpy(_conf(C, N, L + int(10 * beta)))
        for _ in range(3):
            u = torch.from_numpy(rng.random((C, N)))
            acc = torch.zeros(C, dtype=torch.int64)
            ref, acc = kis.ising_sweep_plain(conf, u, tabs, acc)
            got, count = _sweep_registers(conf.numpy(), u.numpy(), tabs)
            np.testing.assert_array_equal(got, ref.numpy())
            np.testing.assert_array_equal(count, acc.numpy())
            conf = ref


def test_masks_only_up_to_64_sites():
    """The tile layout's masks exist for N <= 64 without a neighbor listed
    twice (K17 sweeps the rest in shared memory)."""
    masks = lambda dims, L: kis.make_tables(
        tmc.IsingModel(dims=dims, L=L).lattice, 0.4, CPU).masks
    assert masks(2, 8).shape == (64,) and masks(3, 4).shape == (64,)
    assert masks(2, 9) is None
    assert masks(2, 2) is None           # each neighbor listed twice


def _wolff_registers(conf, inc, front, spin, u, tabs):
    """K18's register layout in numpy: per chain, cluster, frontier and
    same-spin sites as bit masks; a level's new frontier the targets t
    (same spin, not in the cluster) with a bond e of rev[t] from a frontier
    site whose uniform u[level, c].flat[e] is below p_add; a chain runs
    levels while its frontier holds a site. Returns (cluster, frontier,
    [most levels run, frontier left])."""
    C, N = conf.shape
    z, rev = tabs.z, tabs.rev.numpy()
    same = _bits(conf == spin)
    incs, frs, ran_all = _bits(inc), _bits(front), []
    for c in range(C):
        ran = 0
        for level in range(u.shape[0]):
            if not frs[c]:
                break
            ran = level + 1
            cand = same[c] & ~incs[c]
            flat = u[level, c].reshape(-1)
            new = 0
            for t in range(N):
                if (cand >> t) & 1 and any(
                        e >= 0 and (frs[c] >> (e // z)) & 1
                        and flat[e] < tabs.p_add for e in rev[t]):
                    new |= 1 << t
            frs[c] = new
            incs[c] |= new
        ran_all.append(ran)
    return (_unbits(incs, N), _unbits(frs, N),
            [max(ran_all), int(any(frs))])


@pytest.mark.parametrize("ctor,L", LATTICES, ids=IDS)
def test_wolff_register_layout(ctor, L):
    """K18's layout (each chain its own levels, bit masks) against
    wolff_step_plain over batches of 1, 3 and N + 1 levels from random
    seeds: cluster, frontier and status equal."""
    _, tm = _models(ctor, L)
    C, N, z = 8, len(tm.lattice), tm.lattice.coordination
    tabs = kis.make_tables(tm.lattice, 0.5, CPU)
    rng = np.random.default_rng(30 + L)
    conf = torch.from_numpy(_conf(C, N, L))
    seeds = torch.from_numpy(rng.integers(0, N, C))
    inc0 = torch.zeros(C, N, dtype=torch.bool)
    inc0[torch.arange(C), seeds] = True
    spin = conf.gather(1, seeds[:, None])
    for Lb in (1, 3, N + 1):
        inc, front, left = inc0, inc0, 1
        while left:
            u = torch.from_numpy(rng.random((Lb, C, N, z)))
            got = _wolff_registers(conf.numpy(), inc.numpy(), front.numpy(),
                                   spin.numpy(), u.numpy(), tabs)
            inc, front, status = kis.wolff_step(conf, inc, front, spin, u,
                                                tabs)
            np.testing.assert_array_equal(got[0], inc.numpy())
            np.testing.assert_array_equal(got[1], front.numpy())
            assert got[2] == status.tolist() and status[0] >= 1
            left = status.tolist()[1]
            assert left == int(bool(front.any()))


def test_wolff_scratch_rule():
    """K18 keeps a chain's state in device memory only in the block layout
    past a block's shared memory (4N bytes)."""
    assert not kis.wolff_scratch(64, 4)          # registers
    assert not kis.wolff_scratch(1024, 4)        # the block layout on chip
    assert not kis.wolff_scratch(64, 9)
    assert kis.wolff_scratch(58113, 4)           # 232,452 bytes
    assert not kis.wolff_scratch(58112, 4)
