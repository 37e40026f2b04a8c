"""Chain sharding of the PyTorch/CUDA port (montecarlo_tpu_torch.parallel)
on the CPU: two ranks, each its own process, over a gloo group.

One module-scoped world of 2 ranks runs every sharded scenario once
(``parallel.launch.run_jobs``; the ranks' functions live in the port, since
a spawned process imports the module of its target and this one imports
JAX); the tests hold what the ranks returned against the same sessions run
in this process: bit for bit, as tests/test_parallel.py holds the JAX
package's sharded runs. cross_chain_mean and pmean_tree are held against
the JAX package's on conftest's 8-device CPU mesh.
"""

import functools
import pickle
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu.parallel as jpar
import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import parallel as tpar
from montecarlo_tpu_torch.entry import dryrun_multichip, entry
from montecarlo_tpu_torch.parallel import launch
from torch_port_inputs import one_torch_thread  # noqa: F401

RANKS = 2
MEANS_INPUT = np.random.default_rng(7).normal(size=(16, 3))


def dqmc(seed=3, **kw):
    """tests/test_parallel.py's sharded DQMC session (2x2, U = 2, beta = 1,
    16 chains a seed, 10 sweeps, measure_rate 2), as a picklable factory."""
    return functools.partial(
        tmc.DQMC, tmc.HubbardModelAttractive(dims=2, L=2, U=2.0), beta=1.0,
        n_chains=16, seed=seed, sweeps=10, thermalization=0, measure_rate=2,
        print_rate=10 ** 9, device="cpu", **kw)


def ising():
    """Ising 4x4 at beta 0.4, 16 chains, 10 + 50 sweeps, a Wolff move every
    2 sweeps."""
    return functools.partial(
        tmc.MC, tmc.IsingModel(dims=2, L=4), beta=0.4, n_chains=16, seed=1,
        sweeps=50, thermalization=10, global_moves=True, global_rate=2,
        device="cpu")


# name: (factory, sweep counts to stop at, run keywords); "_ck" scenarios
# save a checkpoint at the first stop and resume sharded from it; "_every"
# ones save after every chunk (run's safe_every = 0) to <name>.mctorch
SCENARIOS = {"dqmc": (dqmc(), (None,), dict(chunk=5)),
             "dqmc_two_seeds": (dqmc((3, 4)), (None,), dict(chunk=5)),
             "mc": (ising(), (None,), {}),
             "dqmc_ck": (dqmc(), (5, 10), dict(chunk=5)),
             "mc_ck": (ising(), (20, 50), dict(chunk=16)),
             "mc_every": (ising(), (None,), dict(chunk=16, safe_every=0.0))}


def saved_to(name, directory):
    """The run keywords of a scenario, an "_every" one's file in
    directory."""
    kw = dict(SCENARIOS[name][2])
    if name.endswith("_every"):
        kw["filename"] = str(directory / f"{name}.mctorch")
    return kw


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario, sharded over 2 gloo ranks in one spawned world:
    {name: what rank 0 and rank 1 returned}, and the checkpoints' dir."""
    tmp = tmp_path_factory.mktemp("parallel")
    jobs = [(functools.partial(launch.run_sharded, **saved_to(name, tmp)),
             (make, stops, str(tmp / f"{name}.mctorch")
              if name.endswith("_ck") else None))
            for name, (make, stops, _) in SCENARIOS.items()]
    jobs.append((launch.chain_means, (MEANS_INPUT,)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")      # one torch thread a rank
        ranks = launch.spawn(launch.run_jobs, RANKS, jobs, device="cpu",
                             backend="gloo")
    names = list(SCENARIOS) + ["means"]
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}, tmp


def one_process(name):
    """A scenario's session run in this process."""
    make, stops, kw = SCENARIOS[name]
    sim = make()
    sim.run(sweeps=stops[-1], verbose=False, **kw)
    return sim


def assert_identical(a, b):
    """a and b equal leaf by leaf (``launch.differences``: arrays bit for
    bit, NaN where NaN, numbers exactly; timings skipped)."""
    assert launch.differences(a, b) == []


def assert_rank_results(ranks, sim):
    """Every rank's run_sharded result equals sim's session_result."""
    one = launch.session_result(sim)
    for got in ranks:
        got = dict(got)
        assert got.pop("seconds") > 0
        assert not any(got.pop("launches").values())   # plain CPU paths
        assert_identical(got, one)


def test_cross_chain_mean_matches_jax(world):
    """cross_chain_mean and pmean_tree over 2 ranks (8 chains each) against
    the JAX package's on the 8-device mesh, within 1e-12 in float64."""
    results, _ = world
    mesh = jpar.chain_mesh(8)
    x = jnp.asarray(MEANS_INPUT)
    ref = np.asarray(jpar.cross_chain_mean(x, mesh))
    tree = jpar.pmean_tree({"x": x, "y": [2 * x]}, mesh)
    for mean, got in results["means"]:
        assert mean.dtype == np.float64
        np.testing.assert_allclose(mean, ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["x"], np.asarray(tree["x"]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got["y"][0], np.asarray(tree["y"][0]),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["dqmc", "dqmc_two_seeds"])
def test_sharded_dqmc_bit_identical(world, name):
    """A 2-rank DQMC session (one seed; two seeds, 32 chains) equals the
    session run in one process: conf and G of every chain, the analysis
    (acc_rate and every counter), every observable's mean and std error."""
    results, _ = world
    sim = one_process(name)
    assert_rank_results(results[name], sim)
    assert 0.0 < sim.analysis.acc_rate < 1.0


def test_sharded_mc_bit_identical(world):
    """A 2-rank Ising session with Wolff moves equals the one-process run
    (conf, counters, BFS levels, observables), and 0 < m < 1 as
    tests/test_parallel.py asks of the JAX package's."""
    results, _ = world
    sim = one_process("mc")
    assert_rank_results(results["mc"], sim)
    assert sim.analysis.levels_global > 0 and sim.analysis.acc_global > 0
    m = results["mc"][0]["observables"]["Magn"]["m"][0]
    assert 0.0 < m < 1.0


@pytest.mark.parametrize("name", ["dqmc_ck", "mc_ck"])
def test_sharded_checkpoint(world, tmp_path, name):
    """A sharded session's checkpoint (rank 0's file, saved at the first
    stop) equals the one-process checkpoint at the same sweep array for
    array, and the session resumed from it and sharded again ends where
    the one-process session resumed from its checkpoint ends (a resume
    rebuilds G from the configuration, so both differ from an
    uninterrupted run in G's rounding)."""
    results, ck_dir = world
    make, stops, kw = SCENARIOS[name]
    sim = make()
    sim.run(sweeps=stops[0], verbose=False, **kw)
    ours = tmc.save(str(tmp_path / "one.mctorch"), sim)
    with open(ours, "rb") as f:
        one = pickle.load(f)
    with open(ck_dir / f"{name}.mctorch", "rb") as f:
        sharded = pickle.load(f)
    assert sharded["state"]["last_sweep"] == sim.last_sweep > 0
    assert_identical(sharded, one)
    resumed = tmc.load(ours, device="cpu")
    resumed.run(sweeps=stops[-1], verbose=False, **kw)
    assert_rank_results(results[name], resumed)


def test_sharded_run_saves_on_rank0_decision(world, tmp_path):
    """A sharded run with safe_every = 0 saves after every chunk on rank
    0's decision (each rank's clock would decide otherwise): its last file
    equals the one-process run's, and every rank ends as one process."""
    results, ck_dir = world
    make, _, _ = SCENARIOS["mc_every"]
    sim = make()
    sim.run(verbose=False, **saved_to("mc_every", tmp_path))
    files = []
    for d in (ck_dir, tmp_path):
        with open(d / "mc_every.mctorch", "rb") as f:
            files.append(pickle.load(f))
    assert files[0]["state"]["last_sweep"] == sim.last_sweep == 60
    assert_identical(*files)
    assert_rank_results(results["mc_every"], sim)


def test_shard_simulation_checks():
    """shard_simulation raises ValueError where the mesh size does not
    divide n_chains, and on a session sharded already."""
    class TwoRanks:                 # a mesh as shard_simulation reads it
        def size(self):
            return 2

    for make in (dqmc(), ising()):
        with pytest.raises(ValueError, match="divisible"):
            tpar.shard_simulation(make(n_chains=15), TwoRanks())


def test_unsharded_session_holds_one_process_sharding():
    """An unsharded session holds ChainSharding(): one rank with every
    chain, whose block is all of a tensor and whose collectives return
    their input, so sessions run one path sharded or not."""
    for sim in (dqmc()(), ising()()):
        sh = sim.shard
        assert sh.mesh is None and (sh.size, sh.rank) == (1, 0)
        assert sh.block(16) == slice(0, 16)
        t = sim.conf
        assert sh.take(t).data_ptr() == t.data_ptr()
        assert torch.equal(sh.take(t), t) and sh.gather([t])[0] is t
        assert sh.all_max(t) is t and sh.all_sum(t) is t
        assert sh.decide([1, "x"]) == [1, "x"]
        assert launch.differences(launch.session_result(sim),
                                  launch.session_result(sim)) == []


def test_rank_exception_fails_spawn(monkeypatch):
    """A rank that raises (here: 15 chains over 2 ranks) fails the whole
    spawn with its error; nothing is caught and carried on."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="must be divisible"):
        launch.spawn(launch.run_sharded, RANKS,
                     functools.partial(dqmc(), n_chains=15),
                     device="cpu", backend="gloo")


def test_chain_mesh_nccl_with_more_ranks_than_gpus_raises(monkeypatch):
    """NCCL with more ranks than visible GPUs (one more than this machine
    has, as torchrun's variables or spawn's count) raises ValueError naming
    gloo, before any process group exists; so do NCCL on the CPU and an
    unknown backend."""
    ranks = torch.cuda.device_count() + 1
    monkeypatch.setenv("WORLD_SIZE", str(ranks))
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="gloo"):
        tpar.chain_mesh(backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        launch.spawn(launch.run_jobs, ranks, [], backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        tpar.chain_mesh(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        launch.spawn(launch.run_jobs, 2, [], device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unsupported"):
        tpar.chain_mesh(device="cpu", backend="mpi")
    assert not torch.distributed.is_initialized()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("init", ["process", "environment"])
def test_one_rank_mesh_in_process(monkeypatch, init):
    """chain_mesh in a process without a group makes a world of one rank
    (gloo on the CPU), or the world torchrun's variables describe (here a
    world of one on localhost): the mesh is 1-D over CHAIN_AXIS, its
    sharding the whole chain axis, and a session sharded over it runs as
    unsharded, bit for bit, its checkpoint state included."""
    if init == "environment":
        for k, v in dict(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost",
                         MASTER_PORT=str(free_port())).items():
            monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="world has 1"):
        tpar.chain_mesh(2, device="cpu")
    mesh = tpar.chain_mesh(1, device="cpu")
    try:
        assert mesh.mesh_dim_names == (tpar.CHAIN_AXIS,)
        sh = tpar.chain_sharding(mesh)
        assert (sh.size, sh.rank, sh.block(16)) == (1, 0, slice(0, 16))
        assert sh.device == torch.device("cpu")
        sharded = tpar.shard_simulation(dqmc()(), mesh)
        with pytest.raises(ValueError, match="sharded already"):
            tpar.shard_simulation(sharded, mesh)
        sharded.run(verbose=False, chunk=5)
        plain = one_process("dqmc")
        assert_identical(launch.session_result(sharded),
                         launch.session_result(plain))
        assert_identical(sharded.state_dict(), plain.state_dict())
    finally:
        torch.distributed.destroy_process_group()


def test_entry_and_dryrun_multichip(capsys):
    """entry(device="cpu") gives a sweep pair of the 4-chain 2x2 session
    and its arguments; dryrun_multichip(2, device="cpu") runs 2 ranks and
    prints the JAX package's line with a mean occupation in (0, 1)."""
    fn, (state, u) = entry(device="cpu")
    out = fn(state, u)
    assert out["conf"].shape == state["conf"].shape == (4, 4, 10)
    assert u.shape == (4, 20, 4)
    assert torch.isfinite(out["G"]).all()
    assert (out["conf"] != state["conf"]).any()
    dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): OK — sweep+measure step "
                           "executed, psum-reduced occupation mean = ")
    assert 0.0 < float(line.rsplit("= ", 1)[1]) < 1.0
