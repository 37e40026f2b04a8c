"""The DQMC slice of the PyTorch/CUDA port (montecarlo_tpu_torch) against
montecarlo_tpu, on the CPU: lattice, models, parameters, context, slice
matrices, init_state, sweep_pair, the binner and the DQMC driver.

Both sides start from the same numpy data (interop.state_from_numpy) and, for
sweep_pair, the same uniforms: the JAX package draws one uniform vector per
slice visit from its per-chain key with ``key, sub = split(key)``, and the
test rebuilds those draws and hands them to the port in visit order.
"""

import math
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.lattices.library import choose_lattice as j_lattice
from montecarlo_tpu.measurements import dqmc_measurements as jdm
from montecarlo_tpu.ops import pallas_qr
from montecarlo_tpu.utils.binner import LogBinner as JBinner

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.lattices.library import choose_lattice as t_lattice
from montecarlo_tpu_torch.measurements import Measurement
from montecarlo_tpu_torch.measurements import dqmc_measurements as tdm
from montecarlo_tpu_torch.ops.site_sweep import site_sweep_plain
from montecarlo_tpu_torch.utils.binner import LogBinner as TBinner
from torch_port_inputs import sweep_inputs

STACK_KEYS = ("S_U", "S_D", "S_T")
F32, F64 = torch.float32, torch.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _models(L=4, repulsive=False):
    if repulsive:
        return (jmc.HubbardModelRepulsive(dims=2, L=L, U=4.0),
                tmc.HubbardModelRepulsive(dims=2, L=L, U=4.0))
    return (jmc.HubbardModelAttractive(dims=2, L=L, U=4.0, mu=0.0),
            tmc.HubbardModelAttractive(dims=2, L=L, U=4.0, mu=0.0))


def _contexts(beta, sm, dtype, L=4, use_pallas=False, use_kernels=True,
              delay=None, repulsive=False):
    jm, tm = _models(L, repulsive)
    jctx, jconsts = jcore.make_context(
        jm, JParams(beta=beta, safe_mult=sm),
        dtype={"f64": jnp.float64, "f32": jnp.float32}[dtype],
        use_pallas=use_pallas, delay=delay)
    tctx, tconsts = tcore.make_context(
        tm, TParams(beta=beta, safe_mult=sm),
        dtype={"f64": torch.float64, "f32": torch.float32}[dtype],
        device="cpu", use_kernels=use_kernels, delay=delay)
    return (jctx, jconsts), (tctx, tconsts)


def _jax_init(jctx, jconsts, C, seed):
    rng = np.random.default_rng(seed)
    conf = rng.choice(np.array([-1, 1], np.int8), size=(C, jctx.N, jctx.M))
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    state = jcore.jitted_vmapped("init_state", jctx, jconsts)(
        jnp.asarray(conf), keys)
    return conf, state


def _jax_uniforms(keys, n_visits, N, dtype):
    """(C, n_visits, N): the per-visit draws of core._scan_slices and the
    peeled slice 0, in visit order, rebuilt from each chain's key."""
    def chain(key):
        def step(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.uniform(sub, (N,), dtype)
        return jax.lax.scan(step, key, None, length=n_visits)[1]
    return np.array(jax.vmap(chain)(keys))


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _assert_stacks_close(st, sj, tol):
    """Stacks agree up to the sign of each U column (and the matching T row),
    which the kernel path's QR chooses differently from LAPACK's for a
    column with a zero tail."""
    np.testing.assert_allclose(st["S_D"], sj["S_D"], rtol=tol)
    s = np.sign(np.einsum("...ij,...ij->...j", st["S_U"], sj["S_U"]))
    assert _rel(st["S_U"] * s[..., None, :], sj["S_U"]) <= tol
    assert _rel(st["S_T"] * s[..., :, None], sj["S_T"]) <= tol


# ---------------------------------------------------------------------------
# host-side geometry, models, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [2, 4, 8])
def test_square_lattice_tables_identical(L):
    lj, lt = j_lattice(2, L), t_lattice(2, L)
    assert len(lj) == len(lt) == L * L
    np.testing.assert_array_equal(lt.neighbor_table, lj.neighbor_table)
    np.testing.assert_array_equal(lt.bonds, lj.bonds)
    np.testing.assert_array_equal(lt.positions, lj.positions)
    np.testing.assert_array_equal(lt.neighbors(directed=True),
                                  lj.neighbors(directed=True))


def test_unported_lattices_raise():
    """dims=3 takes the cubic lattice (ported with the classical flavor),
    as the JAX package's; dims=4 has no default; a checkpoint of an ALPS
    (arbitrary) lattice rebuilds the model on an ArbitraryLattice from the
    lattice's state, not from the saved dims and L."""
    np.testing.assert_array_equal(t_lattice(3, 4).neighbor_table,
                                  j_lattice(3, 4).neighbor_table)
    with pytest.raises(ValueError):
        t_lattice(4, 4)
    from montecarlo_tpu_torch.io.checkpoint import _reconstruct_model
    from montecarlo_tpu_torch.lattices import ArbitraryLattice
    ring = ArbitraryLattice(n_sites=3, bonds=[[0, 1, 0], [1, 2, 0],
                                              [2, 0, 0]])
    model = _reconstruct_model({"type": "HubbardModelAttractive",
                                "parameters": {"U": 2.0, "dims": 1, "L": 3},
                                "lattice": ring.state_dict()})
    assert isinstance(model.lattice, ArbitraryLattice)
    np.testing.assert_array_equal(model.lattice.bonds, ring.bonds)


@pytest.mark.parametrize("repulsive", [False, True])
def test_models_identical(repulsive):
    jm, tm = _models(4, repulsive)
    np.testing.assert_array_equal(tm.hopping_matrix(), jm.hopping_matrix())
    assert tm.lamb(0.1) == jm.lamb(0.1)
    assert (tm.nflavors, tuple(tm.flavor_signs), tm.use_boson_weight) == \
        (jm.nflavors, tuple(jm.flavor_signs), jm.use_boson_weight)
    assert tm.parameters() == jm.parameters()


def test_hubbard_dispatch_and_checks():
    assert isinstance(tmc.HubbardModel(dims=2, L=2, U=4.0),
                      tmc.HubbardModelRepulsive)
    m = tmc.HubbardModel(dims=2, L=2, U=-4.0)
    assert isinstance(m, tmc.HubbardModelAttractive) and m.U == 4.0
    with pytest.raises(ValueError):
        tmc.HubbardModelRepulsive(dims=2, L=2, U=4.0, mu=0.5)
    with pytest.raises(ValueError):
        tmc.HubbardModelAttractive(dims=2)


def test_rand_conf_from_generator():
    _, tm = _models(4)
    draw = lambda s: tm.rand_conf(torch.Generator().manual_seed(s), 3, 10, "cpu")
    c = draw(7)
    assert c.dtype == torch.int8 and tuple(c.shape) == (3, 16, 10)
    assert set(c.unique().tolist()) == {-1, 1}
    assert torch.equal(c, draw(7)) and not torch.equal(c, draw(8))


@pytest.mark.parametrize("kw", [
    dict(beta=2.0), dict(beta=2.0, delta_tau=0.05), dict(beta=2.0, slices=16),
    dict(delta_tau=0.1, slices=30), dict(beta=1.0, delta_tau=0.1, slices=10),
    dict(beta=1.0, delta_tau=0.1, safe_mult=3), dict(beta=0.5, safe_mult=7)])
def test_parameters_identical(kw):
    pj, pt = JParams(**kw), TParams(**kw)
    assert pt.as_dict() == pj.as_dict()


def test_parameters_reject_underdetermined_and_mismatched():
    for kw in ({}, dict(delta_tau=0.1),
               dict(beta=1.0, delta_tau=0.1, slices=12)):
        with pytest.raises(ValueError):
            TParams(**kw)


# ---------------------------------------------------------------------------
# context and slice matrices
# ---------------------------------------------------------------------------

def test_make_context_consts_bit_identical():
    (jctx, jconsts), (tctx, tconsts) = _contexts(2.0, 5, "f64")
    assert set(tconsts) == set(jconsts)
    for k in jconsts:
        np.testing.assert_array_equal(tconsts[k].numpy(), np.asarray(jconsts[k]))
    for f in ("N", "M", "sm", "F", "lamb", "det_power", "use_boson", "signs",
              "prop_err_threshold", "n_seg", "n_el"):
        assert getattr(tctx, f) == getattr(jctx, f), f


def test_make_context_pins_full_float32_matmuls():
    """TF32 passes on the propagation path bias the chain (the JAX package
    measured occupation 0.44-0.49 against an exact 0.5); make_context turns
    them off process-wide."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        _contexts(1.0, 5, "f32")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


@pytest.mark.parametrize("kw,exc,match", [
    (dict(fuse_wrap=True, g_refresh=True, dtype=F32), ValueError,
     "g_refresh=True"),
    (dict(qr_wy=True, L=3, dtype=F32, stab_method="qr_colscaled"),
     ValueError, "QR route library"),
    (dict(stab_method="cholqr"), NotImplementedError, "ROADMAP")])
def test_make_context_rejects_unported_options(kw, exc, match):
    """What make_context refuses: fuse_wrap under g_refresh (the refresh
    loop never runs K13), qr_wy where no float32 QR is on K4's route
    (8 does not divide N = 9: the library QR) and the retired cholqr."""
    kw = dict(kw)
    L = kw.pop("L", 2)
    model = tmc.HubbardModelAttractive(dims=2, L=L, U=4.0)
    with pytest.raises(exc, match=match):
        tcore.make_context(model, TParams(beta=1.0), device="cpu", **kw)


@pytest.mark.parametrize("N,F,dtype,item", [
    (64, 1, torch.complex64, None), (64, 2, torch.complex64, None),
    (16, 1, torch.complex64, None),
    (100, 1, torch.complex64, None), (128, 1, torch.complex64, None),
    (256, 1, torch.complex64, None), (12, 1, torch.complex64, None),
    (64, 1, torch.complex128, "item 4"), (16, 2, torch.complex128, "item 4"),
    (112, 2, torch.complex64, None), (120, 2, torch.complex64, "item 4"),
    (128, 2, torch.complex64, "item 4")])
def test_check_cuda_kernels_complex_routes(N, F, dtype, item):
    """A complex CUDA session runs K8 at N <= 128 in complex64 (F = 2 to
    N = 119: flavor 1 in shared memory past N = 64), with K10 at 8 | N and
    the library QR at 8 ∤ N (N = 100, 12), and K9 beyond (here rank-1
    blocks); complex128 updates wait for ROADMAP item 4 (they run the plain
    path, use_kernels=False). The complex64 refusal states K8's register
    layout and its F = 2 limit."""
    if item is None:
        tcore._check_cuda_kernels(N, F, 0, dtype, dtype)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}") as e:
        tcore._check_cuda_kernels(N, F, 0, dtype, dtype)
    if dtype == torch.complex64:
        assert ("K8 with G of one chain over the block's registers and "
                "flavor 1 in shared memory at F = 2 past N = 64, so F = 2 "
                "stops at N = 119") in str(e.value), str(e.value)


def test_cuda_session_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tmc.DQMC(_models(2)[1], beta=1.0, n_chains=2)


def test_slice_matrices_match_jax_f64():
    (jctx, jconsts), (tctx, tconsts) = _contexts(1.0, 5, "f64")
    rng = np.random.default_rng(3)
    C, N = 3, tctx.N
    sig = rng.choice(np.array([-1, 1], np.int8), size=(C, N))
    G = rng.normal(size=(C, 1, N, N))
    js, jG = jnp.asarray(sig), jnp.asarray(G)
    ts, tG = torch.from_numpy(sig), torch.from_numpy(G)
    v = lambda f: jax.vmap(f)(js, jG)
    pairs = [
        (v(lambda s, g: jcore.mult_B_left(jctx, jconsts, s, g)),
         tcore.mult_B_left(tctx, tconsts, ts, tG)),
        (v(lambda s, g: jcore.mult_B_dagger_left(jctx, jconsts, s, g)),
         tcore.mult_B_dagger_left(tctx, tconsts, ts, tG)),
        (v(lambda s, g: jcore.wrap_up(jctx, jconsts, s, g)),
         tcore.wrap_up(tctx, tconsts, ts, tG)),
        (v(lambda s, g: jcore.wrap_down(jctx, jconsts, s, g)),
         tcore.wrap_down(tctx, tconsts, ts, tG)),
        (jax.vmap(lambda g: jcore.unwrap_greens(jctx, jconsts, g))(jG),
         tcore.unwrap_greens(tctx, tconsts, tG)),
        (jax.vmap(lambda s: jcore.eV_diag(jctx, s, -1.0))(js),
         tcore.eV_diag(tctx, ts, -1.0)),
    ]
    for ref, out in pairs:
        assert _rel(out.numpy(), ref) <= 1e-13


def test_track_prop_err_matches_jax():
    (jctx, _), (tctx, _) = _contexts(1.0, 5, "f64")
    diffs = np.array([3e-8, 2e-4, 5.0, 0.0])
    perr_j = (jnp.zeros(()), jnp.zeros((), jnp.int32), jnp.zeros(()),
              jnp.zeros((), jnp.int32), jnp.zeros((4,), jnp.int32))
    for d in diffs:
        perr_j = jcore._track_prop_err(jctx, perr_j, jnp.asarray(d))
    G = torch.zeros(1, 1, 2, 2, dtype=torch.float64)
    perr_t = {k: torch.zeros(1, dtype=torch.float64) for k in
              ("prop_err_max", "prop_err_sum")}
    perr_t.update({k: torch.zeros(1, dtype=torch.int64) for k in
                   ("prop_err_count", "prop_err_n")})
    perr_t["prop_err_hist"] = torch.zeros(1, 4, dtype=torch.int64)
    for d in diffs:
        tcore._track_prop_err(tctx, perr_t, G, G + d)
    names = ("prop_err_max", "prop_err_count", "prop_err_sum", "prop_err_n",
             "prop_err_hist")
    for name, ref in zip(names, perr_j):
        np.testing.assert_allclose(perr_t[name][0].numpy(), np.asarray(ref),
                                   rtol=1e-15)
    assert tcore.PROP_ERR_EDGES == jcore.PROP_ERR_EDGES


# ---------------------------------------------------------------------------
# init_state and sweep_pair against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
def test_init_state_matches_jax_f64(use_kernels):
    (jctx, jconsts), (tctx, tconsts) = _contexts(2.0, 5, "f64",
                                                 use_kernels=use_kernels)
    conf, sj = _jax_init(jctx, jconsts, 4, 11)
    st = tcore.init_state(tctx, tconsts, torch.from_numpy(conf))
    sj = _np(sj)
    _assert_stacks_close(interop.state_to_numpy(st), sj, 1e-9)
    assert _rel(st["G"].numpy(), sj["G"]) <= 1e-9
    for k in tcore.COUNTER_KEYS:
        np.testing.assert_array_equal(st[k].numpy(), sj[k])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sweep_pair_matches_jax_f64(use_kernels):
    """The full [down; up] sweep pair in float64 from the same state and
    uniforms: every Metropolis decision identical (conf, acc, neg_prob),
    G, G_meas and the stacks within 1e-9. The port's site sweep computes
    delta as exp(x) - 1 like the TPU kernel, the XLA loop as expm1(x): they
    differ at 1e-16 and no decision of this run depends on it."""
    (jctx, jconsts), (tctx, tconsts) = _contexts(2.0, 5, "f64",
                                                 use_kernels=use_kernels)
    C = 4
    _, s0 = _jax_init(jctx, jconsts, C, 12)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float64)
    sj, Gmj, cmj = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    t0 = interop.state_from_numpy(_np(s0))
    before = {k: v.clone() for k, v in t0.items()}
    st, Gmt, cmt = tcore.sweep_pair(tctx, tconsts, t0, u=torch.from_numpy(u))
    for k, v in before.items():                      # input left as it was
        assert torch.equal(t0[k], v), k
    sj, st = _np(sj), interop.state_to_numpy(st)
    for k in ("conf", "acc", "neg_prob", "prop", "prop_err_n"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    np.testing.assert_array_equal(cmt.numpy(), np.asarray(cmj))
    assert 0 < st["acc"].sum() < 2 * jctx.M * jctx.N * C
    assert _rel(st["G"], sj["G"]) <= 1e-9
    assert _rel(Gmt.numpy(), Gmj) <= 1e-9
    _assert_stacks_close(st, sj, 1e-9)


def _spy_site_sweeps(monkeypatch):
    """Count the calls of each site-sweep wrapper sweep_slice dispatches to."""
    calls = dict.fromkeys(("site_sweep", "site_sweep_f64", "site_sweep_pair",
                           "site_sweep_plain"), 0)
    for name in calls:
        fn = getattr(tcore, name)

        def spy(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tcore, name, spy)
    return calls


@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_sweep_pair_matches_jax_pallas_f32(monkeypatch, model):
    """float32 with the TPU kernels on the JAX side (Pallas site sweep and
    fused UDT kernels in interpret mode; the repulsive model's F = 2 takes
    the pair kernel _batched_kernel_pair) against the port's kernel path
    (their plain versions on the CPU: K5's for the repulsive model):
    identical decisions, G within 1e-4."""
    monkeypatch.setattr(pallas_qr, "ENABLED", True)
    repulsive = model == "repulsive"
    (jctx, jconsts), (tctx, tconsts) = _contexts(1.0, 5, "f32",
                                                 use_pallas=True,
                                                 repulsive=repulsive)
    assert jctx.use_pallas
    C = 4
    _, s0 = _jax_init(jctx, jconsts, C, 13)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float32)
    sj, Gmj, _ = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    calls = _spy_site_sweeps(monkeypatch)
    st, Gmt, _ = tcore.sweep_pair(tctx, tconsts,
                                  interop.state_from_numpy(_np(s0)),
                                  u=torch.from_numpy(u))
    visits = 2 * jctx.M
    assert calls["site_sweep_pair" if repulsive else "site_sweep"] == visits
    assert sum(calls.values()) == visits
    sj = _np(sj)
    for k in ("conf", "acc", "neg_prob"):
        np.testing.assert_array_equal(st[k].numpy(), sj[k], err_msg=k)
    assert np.max(np.abs(st["G"].numpy() - sj["G"])) <= 1e-4
    assert np.max(np.abs(Gmt.numpy() - np.asarray(Gmj))) <= 1e-4


def test_sweep_pair_matches_jax_mixed_precision():
    """float64 stacks with float32 updates (update_dtype): G and the site
    sweeps in float32, the stabilization in float64; the drift monitor
    compares the float32 G with the float64 recomputation."""
    jm, tm = _models(4)
    jctx, jconsts = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                       dtype=jnp.float64,
                                       update_dtype=jnp.float32)
    tctx, tconsts = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                       dtype=torch.float64,
                                       update_dtype=torch.float32,
                                       device="cpu")
    assert tctx.prop_err_threshold == jctx.prop_err_threshold == 1.0
    _, s0 = _jax_init(jctx, jconsts, 4, 14)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float32)
    sj = _np(jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)[0])
    st = tcore.sweep_pair(tctx, tconsts, interop.state_from_numpy(_np(s0)),
                          u=torch.from_numpy(u))[0]
    assert st["G"].dtype == torch.float32 and st["S_U"].dtype == torch.float64
    for k in ("conf", "acc", "neg_prob"):
        np.testing.assert_array_equal(st[k].numpy(), sj[k], err_msg=k)
    assert np.max(np.abs(st["G"].numpy() - sj["G"])) <= 1e-4
    _assert_stacks_close(interop.state_to_numpy(st), sj, 1e-6)


@pytest.mark.parametrize("L,repulsive,dtype,udtype,use_kernels,route", [
    (4, True, F32, None, True, "site_sweep_pair"),     # F = 2, even N: K5
    (4, True, F64, F32, True, "site_sweep_pair"),      # mixed: K5
    (3, True, F32, None, True, "site_sweep"),          # odd N = 9: K1
    (4, False, F32, None, True, "site_sweep"),         # F = 1: K1
    (4, True, F64, None, True, "site_sweep_f64"),      # float64: K1-f64
    (4, True, F32, None, False, "site_sweep_plain")])  # the plain path
def test_sweep_slice_routes(monkeypatch, L, repulsive, dtype, udtype,
                            use_kernels, route):
    """sweep_slice's kernel for each kind of real session at N <= 128, as
    the JAX package routes it: the pair kernel K5 for float32 updates with
    F >= 2 at even N, K1 in the update dtype otherwise (float64 updates stay
    unpaired, as the JAX package's float64 XLA loop)."""
    tm = _models(L, repulsive)[1]
    ctx, _ = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                dtype=dtype, update_dtype=udtype,
                                device="cpu", use_kernels=use_kernels)
    calls = _spy_site_sweeps(monkeypatch)
    G, sigma, u = (torch.from_numpy(x) for x in sweep_inputs(
        L, 2, tm.nflavors, ctx.N))
    G, u = G.to(ctx.udtype), u.to(ctx.udtype)
    out = tcore.sweep_slice(ctx, G, sigma, u)
    assert calls == {k: int(k == route) for k in calls}
    ref = site_sweep_plain(G, sigma, u, lamb=ctx.lamb, signs=ctx.signs,
                           det_power=ctx.det_power, use_boson=ctx.use_boson)
    assert len(out) == len(ref) == 5
    for a, b in zip(out[:4], ref[:4]):
        assert torch.equal(a, b)
    # the float32 kernels keep the negative count alone
    assert (out[4] is None) == (route in ("site_sweep", "site_sweep_pair"))
    assert out[4] is None or torch.equal(out[4], ref[4])


def test_sweep_pair_draws_uniforms_in_visit_order():
    """With a generator, sweep_pair draws u of shape (C, 2M, N) once, in
    visit order: the same as handing it that draw."""
    _, (tctx, tconsts) = _contexts(1.0, 5, "f64")
    conf = _models(4)[1].rand_conf(torch.Generator().manual_seed(1), 2, tctx.M)
    s0 = tcore.init_state(tctx, tconsts, conf)
    a = tcore.sweep_pair(tctx, tconsts, s0,
                         generator=torch.Generator().manual_seed(5))
    u = torch.rand((2, 2 * tctx.M, tctx.N), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(5))
    b = tcore.sweep_pair(tctx, tconsts, s0, u=u)
    assert torch.equal(a[0]["conf"], b[0]["conf"])
    assert torch.equal(a[0]["G"], b[0]["G"])


# ---------------------------------------------------------------------------
# binner, measurements, the driver
# ---------------------------------------------------------------------------

def test_binner_matches_jax():
    rng = np.random.default_rng(4)
    C, shape, n = 3, (2,), 77
    xs = rng.normal(size=(n, C) + shape).cumsum(0) * 0.1  # correlated
    jb, tb = JBinner(shape=shape), TBinner(shape=shape)
    sj = jax.vmap(lambda _: jb.empty_state())(jnp.arange(C))
    st = tb.empty_state(C, "cpu")
    push = jax.jit(jax.vmap(jb.push))
    for x in xs:
        sj = push(sj, jnp.asarray(x))
        tb.push(st, torch.from_numpy(x))
    for f in ("mean", "std_error", "tau", "var", "combined_mean",
              "combined_std_error"):
        np.testing.assert_allclose(getattr(TBinner, f)(st),
                                   getattr(JBinner, f)(sj), rtol=1e-12,
                                   err_msg=f)
    assert TBinner.count(st) == JBinner.count(sj) == n
    assert st["total"].dtype == torch.float64


@pytest.mark.parametrize("repulsive", [False, True])
def test_measurement_shapes_match_jax(repulsive):
    """Every ported factory has the JAX factory's name, observables and
    per-chain shapes."""
    jm, tm = _models(4, repulsive=repulsive)
    mc = SimpleNamespace(parameters=SimpleNamespace(delta_tau=0.1))
    pairs = [(getattr(jdm, n), getattr(tdm, n)) for n in (
        "occupation", "greens_measurement", "sign_measurement",
        "boson_energy_measurement", "charge_density_correlation",
        "charge_density", "pairing_correlation", "pairing")]
    pairs += [(lambda *a, _f=jdm.pairing_correlation: _f(*a, K=4),
               lambda *a, _f=tdm.pairing_correlation: _f(*a, K=4))]
    for d in ("x", "y", "z"):
        for n in ("spin_density_correlation", "spin_density", "magnetization"):
            pairs.append((lambda *a, _f=getattr(jdm, n), _d=d: _f(*a, _d),
                          lambda *a, _f=getattr(tdm, n), _d=d: _f(*a, _d)))
    for jf, tf in pairs:
        mj, mt = jf(mc, jm), tf(mc, tm)
        assert (mt.name, mt.obs_shapes) == (mj.name, mj.obs_shapes)


def test_unported_entry_points_raise():
    tm = _models(2)[1]
    # the time-displaced kinds are ported; an unknown kind is refused
    assert tdm.greens_measurement(None, tm, greens_at=(1, 0)).kind == "greens_at"
    assert Measurement("x", {"x": ()}, lambda **_: {},
                       kind="combined").kind == "combined"
    with pytest.raises(ValueError, match="unknown measurement kind"):
        Measurement("x", {"x": ()}, lambda **_: {}, kind="unequal")
    # recorders, checkpoints and replay are ported (tests/
    # test_torch_fileio.py): a recorder is taken, replay of nothing measures
    # nothing, and a retired stabilization still names the ROADMAP
    sim = tmc.DQMC(tm, beta=1.0, n_chains=2, device="cpu",
                   recorder=tmc.ConfigRecorder(rate=1))
    assert sim.replay() and sim.observables()["occ"]["occ"].count == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmc.DQMC(tm, beta=1.0, n_chains=2, device="cpu", stab_method="cholqr")


def test_dqmc_item_access_and_reset():
    """sim[key] = measurement adds one with empty binners, sim[key] reads
    its observables, del sim[key] drops it; reset() empties every binner and
    restarts the sweep count, keeping the chain state."""
    sim = tmc.DQMC(_models(2, repulsive=True)[1], beta=1.0, n_chains=2,
                   device="cpu", measure_rate=1, safe_mult=5)
    sim["sdc_z"] = tdm.spin_density_correlation(sim, sim.model, "z")
    sim.run(thermalization=1, sweeps=2, verbose=False)
    assert set(sim["sdc_z"]) == {"sdc_z"} and set(sim["occ"]) == {"occ"}
    assert sim["sdc_z"]["sdc_z"].count == sim["occ"]["occ"].count == 2
    del sim["greens"]
    assert set(sim.observables()) == {"occ", "sdc_z"}
    conf = sim.conf.clone()
    assert sim.reset() is sim and sim.last_sweep == 0
    assert sim["sdc_z"]["sdc_z"].count == sim["occ"]["occ"].count == 0
    assert torch.equal(sim.conf, conf)
    sim.run(thermalization=0, sweeps=1, verbose=False)
    assert sim["sdc_z"]["sdc_z"].count == 1 and sim.last_sweep == 1


def _run(seed, **kw):
    sim = tmc.DQMC(_models(4)[1], beta=1.0, n_chains=8, device="cpu",
                   seed=seed, measure_rate=1, safe_mult=5, **kw)
    sim.run(thermalization=2, sweeps=4, verbose=False)
    return sim


def test_dqmc_run_smoke_cpu():
    sim = _run(3)
    obs = sim.observables()
    assert set(obs) == {"occ", "greens"}
    occ, greens = obs["occ"]["occ"], obs["greens"]["greens"]
    assert occ.count == greens.count == 4
    assert np.shape(occ.mean) == (1, 16)
    assert np.shape(greens.mean) == (1, 16, 16)
    assert np.shape(occ.per_chain_mean) == (8, 1, 16)
    assert np.all(np.isfinite(greens.mean))
    assert abs(float(np.mean(occ.mean)) - 0.5) < 0.1
    a = sim.analysis
    assert a.prop_local == 6 * 2 * sim.ctx.M * 16 * 8
    assert 0 < a.acc_rate < 1
    # one drift check per stabilized boundary: n_seg down, n_seg - 1 up
    assert a.prop_err_n == 6 * (2 * sim.ctx.n_seg - 1) * 8
    assert a.propagation_error.max < 1e-7         # float64
    fresh = tcore.fresh_counters(sim.ctx, 8)
    assert all(torch.equal(sim.state[k], fresh[k]) for k in tcore.COUNTER_KEYS)
    # the same seed gives the same run; another seed does not
    again = _run(3)
    np.testing.assert_array_equal(again.observables()["greens"]["greens"].mean,
                                  greens.mean)
    assert torch.equal(again.conf, sim.conf)
    assert not torch.equal(_run(4).conf, sim.conf)


def test_interop_roundtrip():
    (jctx, jconsts), _ = _contexts(1.0, 5, "f64")
    _, sj = _jax_init(jctx, jconsts, 2, 21)
    st = interop.state_from_numpy(_np(sj))
    assert "key" not in st and st["conf"].dtype == torch.int8
    assert st["acc"].dtype == torch.int64
    back = interop.state_to_numpy(st)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(sj[k]))
    consts = interop.consts_from_numpy({k: np.asarray(v)
                                        for k, v in jconsts.items()})
    np.testing.assert_array_equal(consts["eT2"].numpy(),
                                  np.asarray(jconsts["eT2"]))


def test_port_never_imports_jax():
    code = ("import sys, montecarlo_tpu_torch, montecarlo_tpu_torch.interop, "
            "montecarlo_tpu_torch.ops.linalg, montecarlo_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'montecarlo_tpu.'))] + "
            "(['montecarlo_tpu'] if 'montecarlo_tpu' in sys.modules else []); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
