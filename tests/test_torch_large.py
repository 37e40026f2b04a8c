"""The large-lattice route of the PyTorch/CUDA port (montecarlo_tpu_torch):
the delay rule of make_context, the delayed rank-k plain sweep, and whole
sweep pairs at N > 128 (kernels K6 and K7 through their plain versions on
the CPU), against montecarlo_tpu on the same numpy inputs and uniforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams

from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from test_torch_dqmc import (_assert_stacks_close, _contexts, _jax_init,
                             _jax_uniforms, _models, _np, _rel)
from torch_port_inputs import one_torch_thread, sweep_inputs  # noqa: F401


@pytest.mark.parametrize("L,delay", [(4, 8), (12, 32), (16, None), (8, None),
                                     (4, 1)])
def test_make_context_delay_matches_jax(L, delay):
    """Auto is rank-32 from N = 256 and rank-1 below; the block is clamped
    to the largest divisor of N (32 -> 24 at N = 144); 1 means rank-1."""
    jm, tm = _models(L)
    jctx, _ = jcore.make_context(jm, JParams(beta=1.0), delay=delay)
    tctx, _ = tcore.make_context(tm, TParams(beta=1.0), device="cpu",
                                 delay=delay)
    assert tctx.delay == jctx.delay
    assert tctx.delay == {(4, 8): 8, (12, 32): 24, (16, None): 32,
                          (8, None): 0, (4, 1): 0}[(L, delay)]


def test_cuda_kernel_routes():
    """Which shapes a float32 CUDA kernel session takes (checked without a
    card): K1 + K2/K3 for 8 | N <= 64, K1 + K4 for 64 < N <= 128 with 8 | N,
    K6 + K7 for 8 | N > 128 at F <= 2, and the site-sweep kernel with the
    library QR where 8 does not divide N (N = 100, 9; 132 with K6), as the
    JAX package runs XLA's QR there; no site sweep for F = 3 or for K6's
    buffers at N = 1024; float64 beyond N = 128 runs K6-f64."""
    ok = lambda *a: tcore._check_cuda_kernels(*a, torch.float32,
                                              torch.float32)
    for N, F, delay in ((64, 1, 0), (16, 2, 0), (144, 1, 0), (144, 2, 24),
                        (256, 1, 32), (256, 2, 32), (72, 1, 0), (128, 2, 0),
                        (100, 1, 0), (9, 1, 0), (132, 1, 0)):
        ok(N, F, delay)
    for N, F, delay, item in ((256, 3, 32, "item 4"),
                              (1024, 2, 32, "item 4")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            ok(N, F, delay)
    tcore._check_cuda_kernels(256, 1, 32, torch.float64, torch.float64)


@pytest.mark.parametrize("repulsive", [False, True])
def test_sweep_slice_delayed_matches_jax_f64(repulsive):
    """The plain rank-k sweep against the JAX package's XLA one (vmapped),
    in float64 on the same G, sigma and uniforms: decisions identical, G to
    1e-12, the negative weights' log-magnitudes (min, max, sum per chain)
    to 1e-12."""
    (jctx, _), (tctx, _) = _contexts(1.0, 5, "f64", use_kernels=False,
                                     delay=8, repulsive=repulsive)
    assert jctx.delay == tctx.delay == 8
    G, sigma, u = sweep_inputs(31 + repulsive, 3, tctx.F, tctx.N)
    G, u = G.astype(np.float64), u.astype(np.float64)

    def jax_sweep(G, s, u):
        G, s, ls = jcore.sweep_slice_delayed(jctx, G, s, u,
                                             jcore.init_local_stats(jctx))
        return G, s, ls["acc"], ls["nneg"], jnp.stack(
            [ls["neg_min"], ls["neg_max"], ls["neg_sum"]], -1)

    Gj, sj, aj, nj, negj = jax.jit(jax.vmap(jax_sweep))(
        jnp.asarray(G), jnp.asarray(sigma), jnp.asarray(u))
    Gt, st, at, nt, negt = tcore.sweep_slice(tctx, torch.from_numpy(G),
                                             torch.from_numpy(sigma),
                                             torch.from_numpy(u))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(negt.numpy(), np.asarray(negj), rtol=1e-12,
                               atol=1e-12)
    assert 0 < at.sum() < 3 * tctx.N
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-12


def test_delayed_plain_sweep_matches_rank1():
    """delay=8 and delay=0 give the same Markov chain over two sweep pairs
    (the port of tests/test_delayed_updates.py::test_delayed_matches_rank1):
    identical decisions, G to 1e-9."""
    _, tm = _models(4)
    params = TParams(beta=1.0, safe_mult=5)
    out = []
    for delay in (8, 0):
        ctx, consts = tcore.make_context(tm, params, device="cpu",
                                         use_kernels=False, delay=delay)
        assert ctx.delay == delay
        conf = tm.rand_conf(torch.Generator().manual_seed(2), 3, ctx.M)
        state = tcore.init_state(ctx, consts, conf)
        gen = torch.Generator().manual_seed(3)
        for _ in range(2):
            state = tcore.sweep_pair(ctx, consts, state, generator=gen)[0]
        out.append(state)
    assert torch.equal(out[0]["conf"], out[1]["conf"])
    assert torch.equal(out[0]["acc"], out[1]["acc"])
    assert (out[0]["G"] - out[1]["G"]).abs().max().item() < 1e-9


@pytest.fixture(scope="module")
def jax_pair_n144():
    """One float64 sweep pair of the JAX package's XLA path at 12x12
    (N = 144 > 128), beta = 1, safe_mult = 5, 2 chains, delay 32 (clamped
    to 24): the initial state, the uniforms and the result."""
    (jctx, jconsts), _ = _contexts(1.0, 5, "f64", L=12, delay=32)
    assert not jctx.use_pallas and jctx.delay == 24
    _, s0 = _jax_init(jctx, jconsts, 2, 17)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float64)
    s1, Gm, _ = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    return _np(s0), u, _np(s1), np.asarray(Gm)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sweep_pair_large_n_matches_jax_f64(jax_pair_n144, use_kernels):
    """The whole N > 128 route in float64: the kernel path (K6 at dk = 24 and
    K7 through their plain versions) and the plain path (sweep_slice_delayed,
    torch.linalg.qr) against the JAX package's XLA path. Every decision
    identical; G, G_meas and the stacks within 1e-9 (the stacks up to the
    sign of a U column, which K7 chooses differently from LAPACK on a zero
    tail)."""
    s0, u, sj, Gmj = jax_pair_n144
    _, (tctx, tconsts) = _contexts(1.0, 5, "f64", L=12, delay=32,
                                   use_kernels=use_kernels)
    assert tctx.delay == 24 and tctx.N == 144
    st, Gmt, _ = tcore.sweep_pair(tctx, tconsts, interop.state_from_numpy(s0),
                                  u=torch.from_numpy(u))
    st = interop.state_to_numpy(st)
    for k in ("conf", "acc", "neg_prob", "prop_err_n"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert 0 < st["acc"].sum() < 2 * tctx.M * tctx.N * 2
    assert _rel(st["G"], sj["G"]) <= 1e-9
    assert _rel(Gmt.numpy(), Gmj) <= 1e-9
    _assert_stacks_close(st, sj, 1e-9)


def test_interop_roundtrip_n144():
    """An N = 144 state (the kernel path's init_state) through numpy and
    back: every key, dtype and value as it was."""
    _, tm = _models(12)
    ctx, consts = tcore.make_context(tm, TParams(beta=0.5, safe_mult=5),
                                     device="cpu")
    conf = tm.rand_conf(torch.Generator().manual_seed(4), 2, ctx.M)
    state = tcore.init_state(ctx, consts, conf)
    back = interop.state_from_numpy(interop.state_to_numpy(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    assert tuple(back["G"].shape) == (2, 1, 144, 144)
