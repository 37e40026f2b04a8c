"""The Hubbard sessions whose site sweeps the port's last kernel layouts
took on (montecarlo_tpu_torch): a ring of 130 sites in float64 (K6-f64 on G
padded to a multiple of 8, since 4 does not divide N), a ring of 132 sites
in complex128 with a flux (K9-c128 on padded G: 8 does not divide N), the
10x10 repulsive model in a flux (K8-c128 at F = 2 in the rank-1 layout,
G of a chain on chip in a cluster of two blocks) and one slice of the 16x16 repulsive model in a flux at its
default delay 32 (K9-c128 in two flavor stages). On the CPU each runs
through its kernel's plain version, held against the JAX package's XLA
path from the same state and uniforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from test_torch_complex import _rel as _rel_cx
from test_torch_fp64_runs import TOL_RUN, _run_against_jax
from torch_port_inputs import (cx_sweep_inputs, flux_theta,  # noqa: F401
                               one_torch_thread)

F64, C128 = torch.float64, torch.complex128


def _pair(repulsive, **kw):
    name = "HubbardModelRepulsive" if repulsive else "HubbardModelAttractive"
    return getattr(jmc, name)(U=4.0, **kw), getattr(tmc, name)(U=4.0, **kw)


@pytest.mark.parametrize("repulsive,dims,L,flux,dtype,F", [
    (False, 1, 130, False, F64, 1),      # K6-f64, G padded to 136
    (False, 1, 132, True, C128, 1),      # K9-c128, G padded to 136
    (True, 2, 10, True, C128, 2)])       # K8-c128 in the rank-1 layout
def test_item4_session_matches_jax(repulsive, dims, L, flux, dtype, F):
    """DQMC at the default dtype on the CPU through DQMC.run against two
    XLA sweep pairs of the JAX package from the same state and uniforms:
    the CUDA route check takes the session, every decision and count is
    identical, G within TOL_RUN (complex: the imaginary-weight count equal
    and the running phase within TOL_RUN)."""
    N = L ** dims
    kw = dict(dims=dims, L=L)
    if flux:
        kw["peierls"] = flux_theta(N)
    jm, tm = _pair(repulsive, **kw)
    jctx, jconsts = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                       dtype=jnp.float64)
    sim = tmc.DQMC(tm, beta=1.0, safe_mult=5, n_chains=2, device="cpu",
                   measure_rate=1, measurements={})
    ctx = sim.ctx
    assert (ctx.N, ctx.F, ctx.dtype, ctx.udtype, ctx.delay) == (
        N, F, dtype, dtype, 0) and ctx.use_kernels
    tcore._check_cuda_kernels(N, F, ctx.delay, ctx.dtype, ctx.udtype)
    sim, sj = _run_against_jax(jctx, jconsts, sim, 2, 50 + N)
    st = interop.state_to_numpy(sim.state)
    np.testing.assert_array_equal(st["conf"], sj["conf"])
    assert sim.analysis.acc_local == int(sj["acc"].sum()) > 0
    assert sim.analysis.prop_local == int(sj["prop"].sum())
    if flux:
        assert sim.analysis.imaginary_probability.count == int(
            sj["ls_imag_count"].sum())
        assert _rel_cx(st["G"], sj["G"]) <= TOL_RUN
        assert np.max(np.abs(st["ls_phase"] - sj["ls_phase"])) <= TOL_RUN
    else:
        assert sim.analysis.negative_probability.count == int(
            sj["neg_prob"].sum())
        assert _rel_cx(st["G"], sj["G"]) <= TOL_RUN


def test_delayed_cx_f2_n256_slice_matches_jax():
    """One slice of the 16x16 repulsive model in a flux at its default
    delay 32 in complex128: site_sweep_delayed_cx_plain (K9-c128's plain
    version, whose kernel runs this shape in two flavor stages) against
    the JAX package's XLA sweep_slice_delayed from the same G, sigma and
    uniforms: decisions, the accepted, negative-weight and imaginary-weight
    counts identical, G within 1e-12."""
    jm, tm = _pair(True, dims=2, L=16, peierls=flux_theta(256))
    jctx, _ = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                 dtype=jnp.float64)
    tctx, _ = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                 device="cpu")
    assert jctx.delay == tctx.delay == 32 and tctx.F == 2
    tcore._check_cuda_kernels(256, 2, 32, C128, C128)
    G, sigma, u = cx_sweep_inputs(256, 2, 2, 256)
    G, u = G.astype(np.complex128), u.astype(np.float64)

    def jax_sweep(G, s, u):
        return jcore.sweep_slice_delayed(jctx, G, s, u,
                                         jcore.init_local_stats(jctx))

    Gj, sj, lj = jax.jit(jax.vmap(jax_sweep))(
        jnp.asarray(G), jnp.asarray(sigma), jnp.asarray(u))
    Gt, st, accept, det = ssdcx.site_sweep_delayed_cx_plain(
        torch.from_numpy(G), torch.from_numpy(sigma), torch.from_numpy(u),
        dk=32, lamb=tctx.lamb, signs=tctx.signs, det_power=tctx.det_power,
        use_boson=tctx.use_boson)
    ls = tcore.fresh_counters(tctx, 2)
    ls["ls_phase"] = torch.ones(2, dtype=C128)
    ls = tcore._track_detratio_batch(ls, det, accept)
    lj = {jcore._ls_key(k): np.asarray(v) for k, v in lj.items()}
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for k in ("acc", "neg_prob", "ls_imag_count"):
        np.testing.assert_array_equal(ls[k].numpy(), lj[k], err_msg=k)
    assert 0 < accept.sum() < 2 * 256
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-12


# every lattice of the goal: squares L = 2..16 and rings up to 256 sites
GRID = ([(2, L) for L in range(2, 17)]
        + [(1, n) for n in (4, 10, 64, 128, 130, 132, 150, 200, 250, 256)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("peierls", [False, True])
@pytest.mark.parametrize("repulsive", [False, True])
@pytest.mark.parametrize("dims,L", GRID)
def test_cuda_route_takes_every_hubbard_session(dims, L, repulsive, peierls,
                                                dtype):
    """Every Hubbard session of the goal (square lattices L = 2..16 and
    rings of up to 256 sites, both models, with and without Peierls
    phases, float32 and float64 sessions: complex64 and complex128 with
    phases) at its default delay has a hand site sweep on the card: the
    CUDA route check refuses none of them. The session's shape, dtype and
    delay as make_context derives them before it checks the route (its
    hopping exponentials, which the check does not read, are left out)."""
    N = L ** dims
    cls = tmc.HubbardModelRepulsive if repulsive else tmc.HubbardModelAttractive
    model = cls(dims=dims, L=L, U=4.0,
                peierls=flux_theta(N) if peierls else None)
    assert len(model.lattice) == N and model.nflavors == 1 + repulsive
    complex_ = np.iscomplexobj(np.asarray(model.hopping_matrix()))
    assert complex_ == peierls
    if complex_:
        dtype = tcore._COMPLEX[dtype]
    tcore._check_cuda_kernels(N, model.nflavors, tcore._delay(N, None),
                              dtype, dtype)
