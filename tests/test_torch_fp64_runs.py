"""Small DQMC.run sessions of the PyTorch/CUDA port (montecarlo_tpu_torch)
at the settings of its float64 and complex128 site-sweep routes (kernels
K6-f64 and K8-c128, through their plain versions on the CPU) against the
JAX package's XLA path, from the same state and the same uniforms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from test_torch_complex import _models as _cx_models
from test_torch_complex import _rel as _rel_cx
from test_torch_dqmc import (_assert_stacks_close, _contexts, _jax_init,
                             _jax_uniforms, _np, _rel)
from torch_port_inputs import flux_theta, one_torch_thread  # noqa: F401

F64, C128 = torch.float64, torch.complex128
# the port's float64 and complex128 paths take every operation of the XLA
# loops in the same order up to the site sweeps' delta (exp(x) - 1 against
# expm1) and the library's QR, so G and the stacks agree to float64
# rounding grown over a few slices
TOL_RUN = 1e-10


def _run_against_jax(jctx, jconsts, sim, C, seed, pairs=2):
    """pairs sweep pairs of the JAX package's XLA path from _jax_init's
    state, and sim.run (1 thermalization + pairs - 1 measured sweeps) from
    the same state with the same uniforms (sim._uniforms replaced by the
    JAX chains' draws, pair by pair). Returns (sim, the final JAX state as
    numpy arrays)."""
    _, s0 = _jax_init(jctx, jconsts, C, seed)
    pair = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)
    s, us = s0, []
    for _ in range(pairs):
        us.append(torch.from_numpy(_jax_uniforms(s["key"], 2 * jctx.M,
                                                 jctx.N, jnp.float64)))
        s = pair(s)[0]
    draws = iter(us)
    sim.state = interop.state_from_numpy(_np(s0))
    sim._uniforms = lambda: next(draws)
    sim.run(thermalization=1, sweeps=pairs - 1, verbose=False)
    return sim, _np(s)


def test_dqmc_run_f64_n144_delay24_matches_jax():
    """DQMC(12x12, delay=24) in the default float64 on the CPU (K6-f64's
    route: its plain version, and the library QR as at float64 past
    N = 64) through DQMC.run against two XLA sweep pairs of the JAX
    package from the same state and uniforms: every decision and count
    identical, G and the stacks within TOL_RUN, no negative weight."""
    (jctx, jconsts), (tctx, _) = _contexts(0.5, 5, "f64", L=12, delay=24)
    assert tctx.N == 144 and tctx.delay == 24 and tctx.use_kernels
    model = tmc.HubbardModelAttractive(dims=2, L=12, U=4.0, mu=0.0)
    sim = tmc.DQMC(model, beta=0.5, safe_mult=5, n_chains=2, delay=24,
                   device="cpu", measure_rate=1)
    assert sim.ctx.dtype == sim.ctx.udtype == F64
    sim, sj = _run_against_jax(jctx, jconsts, sim, 2, 31)
    st = interop.state_to_numpy(sim.state)
    np.testing.assert_array_equal(st["conf"], sj["conf"])
    assert sim.analysis.acc_local == int(sj["acc"].sum()) > 0
    assert sim.analysis.prop_local == int(sj["prop"].sum())
    assert sim.analysis.negative_probability.count == int(
        sj["neg_prob"].sum())
    assert _rel(st["G"], sj["G"]) <= TOL_RUN
    _assert_stacks_close(st, sj, TOL_RUN)
    assert sim.analysis.propagation_error.max < 1e-9


@pytest.mark.parametrize("repulsive", [False, True])
def test_dqmc_run_complex128_n16_matches_jax(repulsive):
    """DQMC(4x4 with flux) in the default float64, i.e. complex128 (K8-c128's
    route at F = 1 and F = 2: its plain version), through DQMC.run against
    two XLA sweep pairs of the JAX package from the same state and
    uniforms: every decision and the imaginary-weight count identical, G
    and the running phase within TOL_RUN."""
    theta = flux_theta(16)
    jm, tm = _cx_models(theta, repulsive=repulsive)
    jctx, jconsts = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                       dtype=jnp.float64)
    sim = tmc.DQMC(tm, beta=1.0, safe_mult=5, n_chains=3, device="cpu",
                   measure_rate=1)
    assert sim.ctx.dtype == sim.ctx.udtype == C128 and sim.ctx.use_kernels
    assert sim.ctx.F == (2 if repulsive else 1)
    sim, sj = _run_against_jax(jctx, jconsts, sim, 3, 44)
    st = interop.state_to_numpy(sim.state)
    np.testing.assert_array_equal(st["conf"], sj["conf"])
    assert sim.analysis.acc_local == int(sj["acc"].sum()) > 0
    assert sim.analysis.imaginary_probability.count == int(
        sj["ls_imag_count"].sum())
    assert _rel_cx(st["G"], sj["G"]) <= TOL_RUN
    assert np.max(np.abs(st["ls_phase"] - sj["ls_phase"])) <= TOL_RUN
