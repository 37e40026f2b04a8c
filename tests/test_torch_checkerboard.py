"""The checkerboard slice matrices of the PyTorch/CUDA port
(montecarlo_tpu_torch/dqmc/checkerboard.py, ``make_context(checkerboard=
True)``) and the lattice colorings against montecarlo_tpu, on the CPU.

L >= 3 throughout: periodic L = 2 lattices double their bonds, which the
checkerboard applies once per bond occurrence (tests/test_checkerboard.py
uses L >= 3 for the same reason). The sessions run at 3x3: on the 4x4
torus the groups' exponentials commute and the checkerboard operator equals
exp(-dtau T) to 7e-16, at 3x3 it differs by 6.7e-4.

Tolerances: the colorings equal; the assembled operators and the session's
constants within 1e-14 absolute (the JAX package assembles them with jnp
ops, which may contract differently); the sparse appliers against the dense
operator within 1e-12 (inverses 1e-10, the JAX test's bounds); a float64
sweep pair: identical decisions, G within 1e-9 of max|G|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import checkerboard as jcb
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import checkerboard as tcb
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.lattices import library as tlib
from test_torch_dqmc import _jax_init, _jax_uniforms, _np, _rel

LATTICES = {"square3": ("SquareLattice", 3), "square4": ("SquareLattice", 4),
            "chain6": ("Chain", 6)}


def _flux(N, seed=1, amp=0.6):
    a = np.random.default_rng(seed).uniform(-amp, amp, (N, N))
    return a - a.T


def _models(L=3, peierls=False, mu=0.3):
    kw = dict(dims=2, L=L, U=4.0, mu=mu)
    if peierls:
        kw["peierls"] = _flux(L * L)
    return jmc.HubbardModelAttractive(**kw), tmc.HubbardModelAttractive(**kw)


def _max(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_colorings_match_jax(name):
    """checkerboard_groups (greedy edge coloring) and site_colors (greedy
    site coloring) equal the JAX package's, group by group; every group's
    bonds are vertex-disjoint and every color holds no neighbors."""
    fn, L = LATTICES[name]
    jl, tl = getattr(jmc, fn)(L), getattr(tlib, fn)(L)
    for attr in ("checkerboard_groups", "site_colors"):
        a, b = getattr(jl, attr), getattr(tl, attr)
        assert len(a) == len(b), attr
        for x, y in zip(a, b):
            assert y.dtype == np.int32
            np.testing.assert_array_equal(x, y, err_msg=attr)
    for g in tl.checkerboard_groups:
        assert len(np.unique(g)) == g.size
    for c in tl.site_colors:
        nb = tl.neighbor_table[c]
        assert not np.isin(nb[nb >= 0], c).any()


@pytest.mark.parametrize("peierls", [False, True])
def test_assemble_dense_operator_matches_jax(peierls):
    """The assembled operator and its inverse (float64, complex128 with
    Peierls phases) within 1e-14 of the JAX package's, and exact inverses
    of each other to 1e-13."""
    jm, tm = _models(peierls=peierls)
    T = np.asarray(jm.hopping_matrix())
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref = jcb.assemble_dense_operator(jm.lattice, T, 0.1)
    op, op_inv = tcb.assemble_dense_operator(tm.lattice, T, 0.1)
    assert op.dtype == (torch.complex128 if peierls else torch.float64)
    assert _max(op, ref[0]) <= 1e-14 and _max(op_inv, ref[1]) <= 1e-14
    eye = np.eye(op.shape[0])
    assert _max((op @ op_inv).numpy(), eye) <= 1e-13


@pytest.mark.parametrize("peierls,dtype", [
    (False, "f64"), (False, "f32"), (True, "f64"), (True, "f32")])
def test_make_context_checkerboard_consts_match_jax(peierls, dtype):
    """make_context(checkerboard=True): every constant within 1e-14 of the
    JAX package's (cast to the session dtype: float32 and complex64 hold
    the same roundings), the dense exponentials swapped for the
    checkerboard operators, the hopping matrix unchanged."""
    jm, tm = _models(peierls=peierls)
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    p = dict(beta=1.0, safe_mult=5)
    jctx, jc = jcore.make_context(jm, JParams(**p), dtype=jdt,
                                  checkerboard=True)
    tctx, tc = tcore.make_context(tm, TParams(**p), dtype=tdt, device="cpu",
                                  checkerboard=True)
    _, dense = tcore.make_context(tm, TParams(**p), dtype=tdt, device="cpu")
    assert tctx.checkerboard and tctx.dtype.is_complex == peierls
    for k in jc:
        assert tc[k].dtype == (tctx.udtype if k.endswith("_u")
                               else tctx.dtype), k
        assert _max(tc[k].numpy(), jc[k]) <= 1e-14, k
    assert _max(tc["hopping"], dense["hopping"]) == 0.0
    assert 0 < _max(tc["eT2"], dense["eT2"]) < 2 * 0.1


def _cb_setup(peierls=False):
    jm, tm = _models(peierls=peierls)
    p = dict(beta=1.0, safe_mult=5)
    jctx, jconsts = jcore.make_context(jm, JParams(**p))
    tctx, tconsts = tcore.make_context(tm, TParams(**p), device="cpu")
    T = np.asarray(jm.hopping_matrix())
    cb_j = jcb.build_checkerboard(jm.lattice, T, 0.1)
    cb_t = tcb.build_checkerboard(tm.lattice, T, 0.1)
    conf = tm.rand_conf(torch.Generator().manual_seed(2), 3, tctx.M)
    return (jctx, jconsts, cb_j), (tctx, tconsts, cb_t), conf


@pytest.mark.parametrize("peierls", [False, True])
def test_sparse_appliers_match_dense_and_jax(peierls):
    """mult_B_{left,right}_cb on (C, F, N, N) against the dense slice
    matrix slice_matrix_cb (1e-12), their inverses back to the input
    (1e-10), and each chain against the JAX package's per-chain appliers
    (1e-13)."""
    (jctx, jconsts, cb_j), (ctx, consts, cb), conf = _cb_setup(peierls)
    sigma = conf[:, :, 0]
    rng = np.random.default_rng(0)
    shape = (3, ctx.F, ctx.N, ctx.N)
    Mn = rng.normal(size=shape)
    if peierls:
        Mn = Mn + 1j * rng.normal(size=shape)
    Mt = torch.from_numpy(Mn)
    B = tcb.slice_matrix_cb(ctx, consts, cb, sigma)
    left = tcb.mult_B_left_cb(ctx, consts, cb, sigma, Mt)
    right = tcb.mult_B_right_cb(ctx, consts, cb, sigma, Mt)
    assert _max(left, B @ Mt) <= 1e-12 and _max(right, Mt @ B) <= 1e-12
    assert _max(tcb.mult_B_inv_left_cb(ctx, consts, cb, sigma, left),
                Mt) <= 1e-10
    assert _max(tcb.mult_B_inv_right_cb(ctx, consts, cb, sigma, right),
                Mt) <= 1e-10
    for c in range(3):
        s = jnp.asarray(sigma[c].numpy())
        for name, out in (("mult_B_left_cb", left),
                          ("mult_B_right_cb", right)):
            ref = getattr(jcb, name)(jctx, jconsts, cb_j, s,
                                     jnp.asarray(Mn[c]))
            assert _max(out[c], ref) <= 1e-13, name


def test_checkerboard_slice_matches_context_and_trotter():
    """A checkerboard session's slice multiply equals the factor-by-factor
    product (1e-12) and stays within the 2·dtau Trotter envelope of the
    dense one (tests/test_checkerboard.py's gate)."""
    _, (ctx_d, consts_d, cb), conf = _cb_setup()
    tm = _models()[1]
    ctx, consts = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                     device="cpu", checkerboard=True)
    sigma = conf[:, :, 0]
    I = torch.eye(ctx.N, dtype=ctx.dtype).expand(3, ctx.F, ctx.N, ctx.N)
    B_core = tcore.mult_B_left(ctx, consts, sigma, I)
    assert _max(B_core, tcb.slice_matrix_cb(ctx_d, consts_d, cb, sigma)) \
        <= 1e-12
    assert _max(B_core, tcore.mult_B_left(ctx_d, consts_d, sigma, I)) \
        < 2 * 0.1


@pytest.mark.parametrize("g_refresh", [False, True])
def test_checkerboard_sweep_pair_matches_jax(g_refresh):
    """One float64 sweep pair of a checkerboard session (3x3, mu = 0,
    beta = 1, safe_mult 5, 4 chains; under g_refresh too) against the JAX
    package's from the same state and uniforms: identical decisions and
    drift counts, G_meas and the turnaround G within 1e-9."""
    jm, tm = _models(mu=0.0)
    p = dict(beta=1.0, safe_mult=5)
    jctx, jconsts = jcore.make_context(jm, JParams(**p), checkerboard=True,
                                       g_refresh=g_refresh)
    tctx, tconsts = tcore.make_context(tm, TParams(**p), device="cpu",
                                       checkerboard=True, g_refresh=g_refresh)
    _, s0 = _jax_init(jctx, jconsts, 4, 31)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float64)
    sj, Gmj, _ = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    st, Gmt, _ = tcore.sweep_pair(tctx, tconsts,
                                  interop.state_from_numpy(_np(s0)),
                                  u=torch.from_numpy(u))
    sj, st = _np(sj), interop.state_to_numpy(st)
    for k in ("conf", "acc", "neg_prob", "prop_err_n"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert 0 < st["acc"].sum() < 2 * jctx.M * jctx.N * 4
    assert _rel(Gmt.numpy(), Gmj) <= 1e-9
    assert _rel(st["G"], sj["G"]) <= 1e-9


def test_checkerboard_run_half_filling():
    """DQMC(checkerboard=True) on the port (3x3, mu = 0, beta = 1, float64,
    8 chains, 5 + 20 sweeps): occupation within 0.05 of 1/2 (the JAX
    package's end-to-end test runs 16 chains and 170 sweeps), drift below
    1e-9."""
    tm = _models(mu=0.0)[1]
    sim = tmc.DQMC(tm, beta=1.0, safe_mult=5, n_chains=8, seed=7,
                   device="cpu", checkerboard=True, measure_rate=1)
    assert sim.ctx.checkerboard
    sim.run(thermalization=5, sweeps=20, verbose=False)
    occ = float(np.mean(sim.observables()["occ"]["occ"].mean))
    assert abs(occ - 0.5) < 0.05
    assert sim.analysis.propagation_error.max < 1e-9
