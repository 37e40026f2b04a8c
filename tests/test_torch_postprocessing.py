"""Post-processing, compare helpers, timers and the root export map of
montecarlo_tpu_torch, on the CPU: the port of tests/test_postprocessing.py
and parity with the JAX package.

The post-processing and compare functions are numpy on both sides and must
agree within 1e-12 on the same arrays, and the port's must give the same
results on tensors. Every name of montecarlo_tpu's export map and each of
its module-level functions must resolve in the port, whose import loads no
JAX module.
"""

import ast
import importlib
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.measurements import postprocessing as jpp

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.measurements import postprocessing as tpp
from montecarlo_tpu_torch.utils import timing

# the modules (each package's utils exports the function compare)
jcmp = importlib.import_module("montecarlo_tpu.utils.compare")
tcmp = importlib.import_module("montecarlo_tpu_torch.utils.compare")
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=TOL * max(1.0, np.abs(b).max()))


@pytest.fixture
def timers():
    """Timers reset and enabled for one test, disabled and reset after."""
    tmc.reset_timer()
    tmc.enable_benchmarks()
    yield
    tmc.disable_benchmarks()
    tmc.reset_timer()


# ---------------------------------------------------------------------------
# tests/test_postprocessing.py
# ---------------------------------------------------------------------------

def test_reciprocal_discretization():
    lat = tmc.SquareLattice(4)
    qs = tpp.reciprocal_discretization(lat)
    assert qs.shape == (16, 2)
    assert np.any(np.all(np.abs(qs) < 1e-12, axis=1))
    assert np.max(np.linalg.norm(qs, axis=1)) <= np.pi * np.sqrt(2) + 1e-9


def test_fourier_transform_constant():
    lat = tmc.SquareLattice(4)
    qs = tpp.reciprocal_discretization(lat)
    vals = np.ones(lat.n_dirs)
    F = tmc.fourier_transform(qs, lat.directions, vals)
    q0 = np.where(np.all(np.abs(qs) < 1e-12, axis=1))[0][0]
    assert abs(F[q0] - lat.n_dirs) < 1e-9
    assert np.allclose(tmc.structure_factor(qs, lat.directions, vals), F)


def test_uniform_fourier_and_symmetry():
    data = np.arange(12.0).reshape(4, 3)
    assert tmc.uniform_fourier(data[:, 0]) == np.sum(data[:, 0])
    assert np.allclose(tmc.apply_symmetry(data, (1.0,)), data[:, 0])
    cube = np.arange(8.0).reshape(2, 2, 2)
    s = tmc.apply_symmetry(cube, (1.0, 0.5))
    assert np.allclose(s, np.einsum("ijk,j,k->i", cube, [1, 0.5], [1, 0.5]))
    with pytest.raises(ValueError, match="rank"):
        tmc.apply_symmetry(np.zeros((2, 2, 2, 2)))


def test_superfluid_density_runs():
    lat = tmc.SquareLattice(4)
    data = np.random.default_rng(0).normal(size=(lat.n_dirs, 5))
    rho = tmc.superfluid_density(data, lat)
    assert np.isfinite(rho.real) and np.isfinite(rho.imag)


def test_timer_registry(timers):
    with tmc.timer("outer"):
        with tmc.timer("inner"):
            pass
    data = timing.timer_data()
    assert "outer" in data and "inner" in data["outer"]["children"]
    assert data["outer"]["count"] == 1
    tmc.disable_benchmarks()
    with tmc.timer("outer"):
        pass
    assert timing.timer_data()["outer"]["count"] == 1   # no-op when disabled
    buf = io.StringIO()
    tmc.print_timer(buf)
    assert "outer" in buf.getvalue() and "x1" in buf.getvalue()


def test_compare_helpers():
    assert tmc.absdiff([1.0, 2.0], [1.0, 2.5]) == 0.5
    assert tmc.reldiff([1.0], [1.0]) == 0.0
    assert tmc.effreldiff([1.0, 1e-20], [1.0, 2e-20]) == 0.0
    assert tmc.compare([1.0], [1.0 + 1e-8])
    assert not tmc.compare([1.0], [1.1])


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctor,L", [("SquareLattice", 4), ("SquareLattice", 5),
                                    ("TriangularLattice", 3),
                                    ("Honeycomb", 3)])
def test_postprocessing_matches_jax(ctor, L):
    """The same arrays through both packages' post-processing, and the
    port's on tensors: equal within 1e-12."""
    jl, tl = getattr(jmc, ctor)(L), getattr(tmc, ctor)(L)
    rng = np.random.default_rng(L)
    qs = tpp.reciprocal_discretization(tl)
    _close(qs, jpp.reciprocal_discretization(jl))
    _close(tpp.reciprocal_discretization(tl, L=3),
           jpp.reciprocal_discretization(jl, L=3))
    dirs, nd = tl.directions, tl.n_dirs
    for values in (rng.normal(size=nd), rng.normal(size=(nd, 3)),
                   rng.normal(size=nd) + 1j * rng.normal(size=nd)):
        want = jpp.fourier_transform(qs, dirs, values)
        _close(tpp.fourier_transform(qs, dirs, values), want)
        _close(tpp.structure_factor(torch.as_tensor(qs),
                                    torch.as_tensor(dirs),
                                    torch.as_tensor(values)), want)
        _close(tpp.uniform_fourier(torch.as_tensor(values)),
               jpp.uniform_fourier(values))
    for shape, w in (((nd,), (1.0, 0.5, -0.25)), ((nd, 4), (1.0, 0.25)),
                     ((nd, 4, 4), (1.0, -0.5, 0.5))):
        data = rng.normal(size=shape)
        want = jpp.apply_symmetry(data, w)
        _close(tpp.apply_symmetry(data, w), want)
        _close(tpp.apply_symmetry(torch.as_tensor(data), w), want)
    ccs = rng.normal(size=(nd, 5))
    _close(tpp.superfluid_density(ccs, tl),
           jpp.superfluid_density(ccs, jl))
    _close(tpp.superfluid_density(torch.as_tensor(ccs), tl),
           jpp.superfluid_density(ccs, jl))


def test_postprocessing_structure_factor_of_a_run():
    """S(q) of a port run's CDC mean over the 4x4's reciprocal grid: 16 q
    points, S(q = 0) = uniform_fourier, as the JAX package computes it from
    the same mean; the PC's s-wave apply_symmetry finite."""
    model = tmc.HubbardModelAttractive(dims=2, L=4, U=4.0)
    sim = tmc.DQMC(model, beta=1.0, n_chains=4, seed=3, sweeps=2,
                   thermalization=1, measure_rate=1, device="cpu")
    sim["cdc"] = tmc.charge_density_correlation(sim, model)
    sim["pc"] = tmc.pairing_correlation(sim, model, K=3)
    sim.run(verbose=False)
    obs = sim.observables()
    cdc = obs["cdc"]["cdc"].mean
    lat = model.lattice
    qs = tpp.reciprocal_discretization(lat)
    S = tmc.structure_factor(qs, lat.directions, cdc)
    q0 = int(np.argmin(np.linalg.norm(qs, axis=1)))
    assert S.shape == (16,)
    assert abs(S[q0] - tmc.uniform_fourier(cdc)) < 1e-10
    _close(S, jpp.structure_factor(qs, jmc.SquareLattice(4).directions,
                                   np.asarray(cdc)))
    assert np.isfinite(tmc.apply_symmetry(obs["pc"]["pc"].mean)).all()


def test_compare_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 7))
    y = x + rng.normal(size=x.shape) * np.logspace(-16, -2, 42).reshape(6, 7)
    y[0, 0] = x[0, 0] = 0.0
    for fn in ("absdiff", "reldiff", "effreldiff"):
        want = getattr(jcmp, fn)(x, y)
        assert getattr(tcmp, fn)(x, y) == want
        assert getattr(tcmp, fn)(torch.as_tensor(x), torch.as_tensor(y)) == want
    for kw in ({}, dict(atol=1e-9), dict(rtol=1e-3), dict(rtol=1e-1)):
        assert tcmp.compare(x, y, **kw) == jcmp.compare(x, y, **kw)
        assert tcmp.compare(torch.as_tensor(x), torch.as_tensor(y), **kw) \
            == jcmp.compare(x, y, **kw)


# ---------------------------------------------------------------------------
# timers in the drivers
# ---------------------------------------------------------------------------

def test_dqmc_and_mc_blocks_are_timed(timers):
    """DQMC.run times each chunk as dqmc_block and MC.run as mc_block: one
    count per chunk, totals within the run's wall."""
    import time
    sim = tmc.DQMC(tmc.HubbardModelAttractive(dims=2, L=2, U=2.0),
                   beta=1.0, n_chains=2, seed=1, device="cpu")
    t0 = time.perf_counter()
    sim.run(thermalization=1, sweeps=5, verbose=False, chunk=2)
    wall = time.perf_counter() - t0
    mc = tmc.MC(tmc.IsingModel(dims=2, L=4), beta=0.3, n_chains=2, seed=1,
                device="cpu")
    mc.run(thermalization=3, sweeps=4, verbose=False, chunk=3)
    data = timing.timer_data()
    assert data["dqmc_block"]["count"] == 4          # 1 | 2, 2, 1
    assert 0 < data["dqmc_block"]["total_s"] <= wall
    assert data["mc_block"]["count"] == 3            # 3 | 3, 1
    buf = io.StringIO()
    tmc.print_timer(buf)
    assert "dqmc_block" in buf.getvalue() and "mc_block" in buf.getvalue()


def test_disabled_timers_record_nothing():
    tmc.reset_timer()
    assert not timing.benchmarks_enabled()
    sim = tmc.DQMC(tmc.HubbardModelAttractive(dims=2, L=2, U=2.0),
                   beta=1.0, n_chains=2, seed=1, device="cpu")
    sim.run(thermalization=0, sweeps=1, verbose=False)
    assert timing.timer_data() == {}


def test_timer_outside_cuda_does_not_touch_the_card(timers, monkeypatch):
    """A section on the CPU, or with no device in a process that never
    initialized CUDA, neither synchronizes nor opens an NVTX range."""
    def refuse(*_):
        raise AssertionError("CUDA called")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    with tmc.timer("cpu", "cpu"):
        pass
    with tmc.timer("default"):
        pass
    assert timing.timer_data()["cpu"]["count"] == 1


# ---------------------------------------------------------------------------
# the root export map
# ---------------------------------------------------------------------------

def _jax_module_functions():
    """Names of the functions defined at the top of montecarlo_tpu's
    __init__.py (read from its source: importing a submodule rebinds
    montecarlo_tpu.measurements to the subpackage)."""
    tree = ast.parse((ROOT / "montecarlo_tpu" / "__init__.py").read_text())
    return sorted(n.name for n in tree.body
                  if isinstance(n, ast.FunctionDef)
                  and not n.name.startswith("_"))


def test_export_map_matches_jax():
    fns = _jax_module_functions()
    assert set(fns) >= {"run", "replay", "greens", "reset", "measurements",
                        "observables", "lattice", "model", "parameters"}
    missing = [k for k in list(jmc._EXPORTS) + fns if not hasattr(tmc, k)]
    assert not missing, missing
    for k in jmc._EXPORTS:
        assert k in tmc.__all__
    for k in fns:
        assert callable(getattr(tmc, k)) and k in tmc.__all__
    assert callable(tmc.measurements)


def test_module_level_functions():
    model = tmc.HubbardModelAttractive(dims=2, L=2, U=2.0)
    sim = tmc.DQMC(model, beta=1.0, n_chains=2, seed=1, device="cpu",
                   recorder=tmc.ConfigRecorder(rate=1))
    assert tmc.run(sim, thermalization=0, sweeps=2, verbose=False)
    assert tmc.lattice(sim) is model.lattice is tmc.lattice(model)
    assert tmc.model(sim) is model
    assert tmc.measurements(sim) is sim.measurements
    assert tmc.measurements(sim, "TH") is sim.thermalization_measurements
    assert set(tmc.observables(sim)) == {"occ", "greens"}
    p = tmc.parameters(sim)
    assert p["beta"] == 1.0 and p["U"] == 2.0 and p["L"] == 2
    assert tmc.greens(sim).shape == (2, 1, 4, 4)
    assert tmc.replay(sim)
    assert sim["occ"]["occ"].count == 2
    tmc.reset(sim)
    assert sim["occ"]["occ"].count == 0 and sim.last_sweep == 0


def test_import_loads_no_jax():
    """A fresh interpreter importing the port (and every name of the export
    map) loads no jax, jaxlib or montecarlo_tpu module."""
    code = ("import sys, montecarlo_tpu_torch as m; [getattr(m, k) for k in "
            "m.__all__]; print(sorted({n.split('.')[0] for n in sys.modules"
            " if n.split('.')[0] in ('jax', 'jaxlib', 'montecarlo_tpu')}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.strip()
    assert out == "[]"
