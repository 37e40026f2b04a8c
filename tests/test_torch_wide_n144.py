"""The complex128 sweep pair of the PyTorch/CUDA port (montecarlo_tpu_torch)
at N = 144 against the JAX package's XLA path: the whole complex N > 128
route (K9 through its plain version in blocks of 16, the library QR) and
the plain path. Its own file, so that a test worker takes it beside
tests/test_torch_wide.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.dqmc import core as jcore

from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from test_torch_dqmc import _jax_init, _jax_uniforms, _np
from test_torch_wide import _contexts, _rel
from torch_port_inputs import flux_theta, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_pair_cx_n144():
    """One complex128 sweep pair of the JAX package's XLA path at 12x12
    (N = 144) on a flux pattern, beta = 1, safe_mult = 5 (two
    stabilization windows), 2 chains, delay 16: the initial state, the
    uniforms and the result."""
    (jctx, jconsts), _ = _contexts(flux_theta(144), 1.0, 5, delay=16, L=12)
    assert jctx.delay == 16
    _, s0 = _jax_init(jctx, jconsts, 2, 140)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float64)
    s1, Gm, _ = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    return _np(s0), u, _np(s1), np.asarray(Gm)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sweep_pair_complex_n144_matches_jax(jax_pair_cx_n144, use_kernels):
    """The whole complex N > 128 route in complex128 at delay 16: the kernel
    path (K9 in blocks of 16 through its plain version, the library QR past
    N = 128 as in the JAX package) and the plain path (the complex
    sweep_slice_delayed) against the JAX package's XLA path. Every decision
    identical; G, G_meas, the running phase and the log-magnitude
    statistics within 1e-9."""
    s0, u, sj, Gmj = jax_pair_cx_n144
    _, (tctx, tconsts) = _contexts(flux_theta(144), 1.0, 5, delay=16, L=12,
                                   use_kernels=use_kernels)
    assert tctx.N == 144 and tctx.dtype == torch.complex128
    st, Gmt, _ = tcore.sweep_pair(tctx, tconsts, interop.state_from_numpy(s0),
                                  u=torch.from_numpy(u))
    st = interop.state_to_numpy(st)
    for k in ("conf", "acc", "neg_prob", "prop", "ls_imag_count"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert 0 < st["acc"].sum() < 2 * tctx.M * tctx.N * 2
    assert st["ls_imag_count"].sum() > 0
    assert _rel(st["G"], sj["G"]) <= 1e-9
    assert _rel(Gmt.numpy(), Gmj) <= 1e-9
    for k in ("ls_phase", "phase_meas"):
        assert np.max(np.abs(st[k] - sj[k])) <= 1e-9, k
    for k in tcore.NEG_KEYS + tcore.CX_COUNTER_KEYS[1:]:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)
