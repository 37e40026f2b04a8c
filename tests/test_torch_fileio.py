"""Checkpoint, resume, recording and replay of the PyTorch/CUDA port
(montecarlo_tpu_torch/io, MC and DQMC state_dict / load_state / replay)
against montecarlo_tpu's contract (tests/test_fileio.py,
tests/test_dqmc_fileio.py), on the CPU.

Resumed runs must be bit-identical to uninterrupted ones: the configuration
and the generators' states are saved, and every derived DQMC quantity is
rebuilt from the field (core.init_state), with the same operations the
uninterrupted run applies. Tolerances: configurations, generator states,
counters and binner means equal; a rebuilt G within 1e-10 of the saved
session's (as the JAX test); replay's observables against the JAX
package's replay of the same fields within 1e-10 (float64 Green's
functions from scratch, summed in another order).
"""

import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.io import checkpoint


def _mc(**kw):
    args = dict(beta=0.4, n_chains=4, seed=5, device="cpu")
    args.update(kw)
    return tmc.MC(tmc.IsingModel(dims=2, L=4), **args)


def _dqmc(model=None, **kw):
    model = model or tmc.HubbardModelAttractive(dims=2, L=2, U=2.0, mu=0.5)
    args = dict(beta=1.0, n_chains=4, seed=17, sweeps=40, thermalization=0,
                measure_rate=2, print_rate=10 ** 9, device="cpu")
    args.update(kw)
    return tmc.DQMC(model, **args)


def _state(fn):
    with open(fn, "rb") as f:
        return pickle.load(f)["state"]


# ---------------------------------------------------------------------------
# MC (tests/test_fileio.py)
# ---------------------------------------------------------------------------

def test_mc_save_load_roundtrip(tmp_path):
    mc = _mc(beta=0.5, seed=11, sweeps=50, thermalization=10)
    assert mc.run(verbose=False)
    fn = tmc.save(str(tmp_path / "mc.mctorch"), mc)
    mc2 = tmc.load(fn, device="cpu")
    assert torch.equal(mc.conf, mc2.conf)
    assert torch.equal(mc.generator.get_state(), mc2.generator.get_state())
    assert mc2.last_sweep == mc.last_sweep == 60
    assert mc2.parameters == mc.parameters and mc2.parameters.beta == 0.5
    assert mc2.analysis == mc.analysis
    for k, n in (("Energy", "E"), ("Magn", "m")):
        np.testing.assert_array_equal(mc2[k][n].mean, mc[k][n].mean)
        assert mc2[k][n].count == mc[k][n].count == 50


@pytest.mark.parametrize("global_moves", [False, True])
def test_mc_resume_matches_uninterrupted(tmp_path, global_moves):
    """A run interrupted at sweep 30, saved and resumed to 60 equals the
    uninterrupted run: conf, generator, counters and binner means."""
    kw = dict(global_moves=global_moves, global_rate=3, sweeps=60)
    full = _mc(**kw)
    assert full.run(verbose=False, chunk=30)
    part = _mc(**kw)
    part.run(sweeps=30, verbose=False, chunk=30)
    fn = tmc.save(str(tmp_path / "part.mctorch"), part)
    ok, part2 = tmc.resume(fn, device="cpu", sweeps=60, verbose=False,
                           chunk=30)
    assert ok and part2.last_sweep == 60
    assert torch.equal(full.conf, part2.conf)
    assert torch.equal(full.generator.get_state(),
                       part2.generator.get_state())
    assert full.analysis == part2.analysis
    np.testing.assert_array_equal(full["Energy"]["E"].mean,
                                  part2["Energy"]["E"].mean)


def test_mc_safe_before_saves_and_resumes(tmp_path):
    """A deadline already passed: run saves after its first chunk and
    returns False; resuming from the file finishes the run as the
    uninterrupted one."""
    fn = str(tmp_path / "deadline.mctorch")
    part = _mc(sweeps=40)
    assert part.run(verbose=False, chunk=10, safe_before=0.0,
                    filename=fn) is False
    assert part.last_sweep == 10 and os.path.exists(fn)
    ok, part2 = tmc.resume(fn, device="cpu", verbose=False, chunk=10)
    full = _mc(sweeps=40)
    full.run(verbose=False, chunk=10)
    assert ok and torch.equal(full.conf, part2.conf)


def test_dqmc_safe_every_saves_each_chunk(tmp_path):
    """safe_every=0: a checkpoint after every chunk, overwritten in place;
    the last one holds the finished run."""
    fn = str(tmp_path / "every.mctorch")
    mc = _dqmc(sweeps=6)
    assert mc.run(verbose=False, chunk=3, safe_every=0.0, filename=fn)
    mc2 = tmc.load(fn, device="cpu")
    assert mc2.last_sweep == 6
    assert torch.equal(mc.state["conf"], mc2.state["conf"])


def test_mc_replay():
    mc = _mc(beta=0.5, seed=2, sweeps=40,
             recorder=tmc.ConfigRecorder(rate=2))
    assert mc.run(verbose=False)
    assert len(mc.configs) == 20
    c = mc.configs[0]
    assert c.shape == (4, 16) and set(np.unique(c)) <= {-1, 1}
    energy = mc.model.make_energy_fn()
    expect = np.mean([energy(torch.from_numpy(c)).numpy()
                      for c in mc.configs], axis=0)
    assert mc.replay()
    E = mc.observables()["Energy"]["E"]
    assert E.count == 20
    np.testing.assert_allclose(E.per_chain_mean, expect, rtol=1e-12)
    assert mc.configs[-1].tolist() == mc.conf.tolist()


def test_save_rename_and_overwrite(tmp_path):
    mc = _mc(beta=0.3, n_chains=2, sweeps=5)
    mc.run(verbose=False)
    fn = str(tmp_path / "x.mctorch")
    f1 = tmc.save(fn, mc)
    f2 = tmc.save(fn, mc)
    assert f1 == fn and f2 != f1 and "x_1" in f2
    with pytest.raises(FileExistsError):
        tmc.save(fn, mc, rename=False)
    mc.run(sweeps=8, verbose=False)
    f3 = tmc.save(fn, mc, overwrite=True)
    assert f3 == fn and not os.path.exists(fn + ".backup")
    assert tmc.load(fn, device="cpu").last_sweep == 8


def test_overwrite_restores_backup_on_failure(tmp_path, monkeypatch):
    """A failed overwrite puts the old file back."""
    mc = _mc(n_chains=2, sweeps=3)
    mc.run(verbose=False)
    fn = tmc.save(str(tmp_path / "y.mctorch"), mc)
    before = open(fn, "rb").read()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.pickle, "dump", boom)
    with pytest.raises(OSError, match="disk full"):
        tmc.save(fn, mc, overwrite=True)
    assert open(fn, "rb").read() == before
    assert not os.path.exists(fn + ".backup")


# ---------------------------------------------------------------------------
# DQMC (tests/test_dqmc_fileio.py)
# ---------------------------------------------------------------------------

def test_dqmc_save_load_roundtrip(tmp_path):
    mc = _dqmc()
    assert mc.run(verbose=False, chunk=10)
    fn = tmc.save(str(tmp_path / "dqmc.mctorch"), mc)
    mc2 = tmc.load(fn, device="cpu")
    assert torch.equal(mc.state["conf"], mc2.state["conf"])
    assert mc2.last_sweep == mc.last_sweep
    assert mc2.parameters.beta == 1.0 and mc2.parameters.slices == 10
    np.testing.assert_array_equal(mc.observables()["occ"]["occ"].mean,
                                  mc2.observables()["occ"]["occ"].mean)
    assert mc2.analysis == mc.analysis
    # the rebuilt stack is consistent: Green's functions from scratch agree
    np.testing.assert_allclose(mc.greens().numpy(), mc2.greens().numpy(),
                               atol=1e-10)


SESSIONS = {
    "f64": {},
    "f32_colscaled": dict(dtype=torch.float32, stab_method="qr_colscaled"),
    "refresh": dict(g_refresh=True),
    "checkerboard": dict(checkerboard=True),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_dqmc_resume_matches_uninterrupted(tmp_path, name):
    """Saved at sweep 10 and resumed to 20: conf, G and the generator
    bit-equal to the uninterrupted run (float64, float32 with the
    column-scaled UDT, the conservative mode, the checkerboard operator)."""
    kw = dict(sweeps=20, **SESSIONS[name])
    full = _dqmc(**kw)
    assert full.run(verbose=False, chunk=5)
    part = _dqmc(**kw)
    part.run(sweeps=10, verbose=False, chunk=5)
    fn = tmc.save(str(tmp_path / f"{name}.mctorch"), part)
    ok, part2 = tmc.resume(fn, device="cpu", verbose=False, chunk=5)
    assert ok and part2.last_sweep == 20
    assert part2.ctx.dtype == full.ctx.dtype
    assert torch.equal(full.state["conf"], part2.state["conf"])
    assert torch.equal(full.state["G"], part2.state["G"])
    assert torch.equal(full.generator.get_state(),
                       part2.generator.get_state())
    np.testing.assert_array_equal(full.observables()["occ"]["occ"].mean,
                                  part2.observables()["occ"]["occ"].mean)


def test_dqmc_resume_with_sequence_seeds(tmp_path):
    """A session of two seeds saves both generators and resumes as the
    uninterrupted run."""
    full = _dqmc(seed=(3, 4), n_chains=2, sweeps=6)
    full.run(verbose=False, chunk=3)
    part = _dqmc(seed=(3, 4), n_chains=2, sweeps=6)
    part.run(sweeps=3, verbose=False, chunk=3)
    fn = tmc.save(str(tmp_path / "seeds.mctorch"), part)
    ok, part2 = tmc.resume(fn, device="cpu", verbose=False, chunk=3)
    assert len(part2.generators) == 2 and part2.n_chains == 4
    assert torch.equal(full.state["conf"], part2.state["conf"])


# every switch of the port's numerics, each away from its default
NUMERICS = {
    "dtype_f32": dict(dtype=torch.float32),
    "update_dtype": dict(update_dtype=torch.float32),
    "stab_method": dict(stab_method="qr_colscaled"),
    "use_kernels": dict(use_kernels=False),
    "delay": dict(delay=4),
    "checkerboard": dict(checkerboard=True),
    "g_refresh": dict(g_refresh=True),
    "fuse_wrap": dict(dtype=torch.float32, fuse_wrap=True),
    "qr_wy": dict(dtype=torch.float32, stab_method="qr_colscaled",
                  qr_wy=True),
}


@pytest.mark.parametrize("name", sorted(NUMERICS))
def test_dqmc_numerics_roundtrip(tmp_path, name):
    """Each switch of the session's numerics survives save and load (at
    4x4: 8 | N, so qr_wy has K4's route)."""
    model = tmc.HubbardModelAttractive(dims=2, L=4, U=2.0)
    mc = _dqmc(model, n_chains=2, **NUMERICS[name])
    mc.run(sweeps=1, verbose=False)
    fn = tmc.save(str(tmp_path / f"{name}.mctorch"), mc)
    mc2 = tmc.load(fn, device="cpu")
    for f in ("dtype", "update_dtype", "stab_method", "use_kernels", "delay",
              "checkerboard", "g_refresh", "fuse_wrap", "qr_wy"):
        assert getattr(mc2.ctx, f) == getattr(mc.ctx, f), f
    assert mc2.state["G"].dtype == mc.state["G"].dtype
    assert torch.equal(mc.state["conf"], mc2.state["conf"])


def test_dqmc_replay_matches_jax():
    """The port's replay and the JAX package's replay of the same recorded
    fields: the same count, occupation and Green's means within 1e-10."""
    mc = _dqmc(recorder=tmc.ConfigRecorder(rate=5))
    assert mc.run(verbose=False, chunk=10)
    assert len(mc.configs) == 8
    assert mc.replay()
    occ = mc.observables()["occ"]["occ"]
    assert occ.count == 8
    assert np.all(np.abs(occ.mean - 0.6) < 0.3)
    jm = jmc.DQMC(jmc.HubbardModelAttractive(dims=2, L=2, U=2.0, mu=0.5),
                  beta=1.0, n_chains=4, seed=17, sweeps=40, measure_rate=2,
                  print_rate=10 ** 9)
    assert jm.replay(configurations=list(mc.configs))
    jobs, tobs = jm.observables(), mc.observables()
    for k in ("occ", "greens"):
        np.testing.assert_allclose(tobs[k][k].per_chain_mean,
                                   jobs[k][k].per_chain_mean, atol=1e-10)
        assert tobs[k][k].count == jobs[k][k].count == 8


def test_dqmc_replay_complex_matches_jax():
    """A complex (Peierls) session's replay carries each field's weight
    phase: the sign observable and the occupation against the JAX
    package's."""
    rng = np.random.default_rng(2)
    a = rng.uniform(-0.5, 0.5, (4, 4))
    theta = a - a.T
    kw = dict(dims=2, L=2, U=2.0, mu=0.3, peierls=theta)
    mc = _dqmc(tmc.HubbardModelAttractive(**kw), sweeps=6,
               recorder=tmc.ConfigRecorder(rate=2))
    mc.run(verbose=False)
    mc.replay()
    jm = jmc.DQMC(jmc.HubbardModelAttractive(**kw), beta=1.0, n_chains=4,
                  seed=17, measure_rate=2, print_rate=10 ** 9)
    jm.replay(configurations=list(mc.configs))
    for k in ("occ", "sign"):
        np.testing.assert_allclose(mc.observables()[k][k].per_chain_mean,
                                   jm.observables()[k][k].per_chain_mean,
                                   atol=1e-10)


def test_dqmc_checkpoint_restores_th_states_and_analysis(tmp_path):
    from montecarlo_tpu_torch.measurements import dqmc_measurements as dm
    model = tmc.HubbardModelAttractive(dims=2, L=2, U=2.0, mu=0.5)

    def build():
        mc = _dqmc(model, seed=5, sweeps=10, thermalization=10)
        mc.thermalization_measurements.add(
            "occ_th", dm.occupation(mc, model), mc.n_chains, mc.device)
        return mc

    mc = build()
    assert mc.run(verbose=False, chunk=5)
    th_before = mc.observables("TH")["occ_th"]["occ"]
    assert th_before.count > 0
    fn = tmc.save(str(tmp_path / "th.mctorch"), mc)
    mc2 = build()
    mc2.load_state(_state(fn))
    th_after = mc2.observables("TH")["occ_th"]["occ"]
    assert th_after.count == th_before.count
    np.testing.assert_array_equal(th_after.mean, th_before.mean)
    assert mc2.analysis == mc.analysis
    assert mc2.analysis.prop_local == mc.analysis.prop_local > 0


@pytest.mark.parametrize("flavor", ["MC", "DQMC"])
def test_orphan_measurement_state_warns(tmp_path, flavor):
    mc = _mc(sweeps=4) if flavor == "MC" else _dqmc(sweeps=4)
    mc.run(verbose=False)
    fn = tmc.save(str(tmp_path / "orphan.mctorch"), mc)
    mc2 = _mc() if flavor == "MC" else _dqmc()
    key = "Magn" if flavor == "MC" else "greens"
    del mc2[key]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        mc2.load_state(_state(fn))
    assert any(key in str(r.message) for r in rec)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", ["MC", "DQMC"])
def test_generator_device_mismatch_refused(tmp_path, flavor):
    """A checkpoint whose generators drew on CUDA does not load on the CPU
    (a crafted payload): the run is never silently reseeded."""
    mc = _mc(sweeps=2) if flavor == "MC" else _dqmc(sweeps=2)
    mc.run(verbose=False)
    fn = tmc.save(str(tmp_path / "dev.mctorch"), mc)
    with open(fn, "rb") as f:
        payload = pickle.load(f)
    for saved in payload["state"]["rng"]:
        assert saved["device"] == "cpu" and saved["state"].dtype == np.uint8
        saved["device"] = "cuda"
    with open(fn, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="draw on 'cuda'"):
        tmc.load(fn, device="cpu")


def test_alps_lattice_checkpoint_names_item_9():
    info = {"type": "IsingModel", "parameters": {"dims": 2, "L": 3},
            "lattice": {"kind": "arbitrary"}}
    with pytest.raises(NotImplementedError, match="item 9"):
        checkpoint._reconstruct_model(info)


def test_foreign_file_refused(tmp_path):
    fn = str(tmp_path / "other.pkl")
    with open(fn, "wb") as f:
        pickle.dump({"VERSION": 1, "type": "MC", "state": {}}, f)
    with pytest.raises(ValueError, match="not a version-1"):
        tmc.load(fn, device="cpu")
