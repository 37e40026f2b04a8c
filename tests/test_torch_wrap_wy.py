"""The JAX package's two A/B modes and its one-chain site sweep in the
PyTorch/CUDA port (montecarlo_tpu_torch), against montecarlo_tpu on the CPU:
kernel K13 (``site_sweep.site_sweep_wrap``, the site sweep with the slice's
wrap fused in; ``fuse_wrap=True``, the JAX package's MC_TPU_FUSE_WRAP=1),
kernel K14 (``qr_householder.qr_vtau``, the Householder QR emitting its
reflectors, and ``qr_wy`` with Q assembled in WY form; ``qr_wy=True``, the
JAX package's MC_TPU_QR_WY=1) and kernel K12 (``site_sweep.site_sweep_single``,
the one-chain entry ``site_sweep_pallas``).

Each wrapper runs its plain version here; the Pallas kernels run in interpret
mode, as the JAX package's own tests run them. The same numpy inputs go to
both sides; the sweep pairs take the JAX package's uniforms in visit order
(see test_torch_dqmc.py).

Tolerances: decisions (sigma, acc, nneg, conf) exact everywhere. K13's G
within 2e-5 of the JAX package's fused visit (its own bound against the
separate wrap, tests/test_pallas_kernel.py::test_fused_wrap_matches_
separate_wrap: float32 products summed in another order). The site sweeps'
G within 1e-5 and the QRs' factors within 1e-5 of their largest entries, as
tests/test_torch_kernels.py; tau (which spans decades on graded columns)
within 1e-4 of each entry. Sweep pairs: G and G_meas within 1e-4, the bound
of the port's other float32 pair tests against the Pallas path.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.ops import pallas_qr
from montecarlo_tpu.ops import pallas_site_sweep as pss

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.ops import linalg as tl
from montecarlo_tpu_torch.ops import qr_householder as qh
from montecarlo_tpu_torch.ops import site_sweep as ss
from test_torch_dqmc import _jax_init, _jax_uniforms, _np
from torch_port_inputs import LAMB, MODELS, graded, sweep_inputs

F32, F64 = torch.float32, torch.float64


def _close(a, b, tol):
    """max|a - b| <= tol * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b))
    assert err <= tol * np.max(np.abs(b)), (err, np.max(np.abs(b)))


def _models(F=1, L=4):
    if F == 2:
        return (jmc.HubbardModelRepulsive(dims=2, L=L, U=4.0),
                tmc.HubbardModelRepulsive(dims=2, L=L, U=4.0))
    return (jmc.HubbardModelAttractive(dims=2, L=L, U=4.0, mu=0.0),
            tmc.HubbardModelAttractive(dims=2, L=L, U=4.0, mu=0.0))


def _spy(monkeypatch, module, names):
    """Count the calls of module.<name> for each name."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(module, name, spy)
    return calls


# ---------------------------------------------------------------------------
# K13: the site sweep with the wrap fused in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("direction", [1, -1])
def test_fused_wrap_matches_jax(F, direction):
    """K13's plain version (through core._sweep_slice_fused_wrap) against
    the JAX package's _sweep_slice_fused_wrap with the Pallas kernel in
    interpret mode, at N = 16: sigma, acc and nneg equal, G within 2e-5;
    and against the port's own unfused visit (wrap_down / wrap_up around
    sweep_slice, another association) to the same bounds."""
    jm, tm = _models(F)
    jctx, jconsts = jcore.make_context(jm, JParams(beta=2.0),
                                       update_dtype=jnp.float32,
                                       use_pallas=True)
    tctx, tconsts = tcore.make_context(tm, TParams(beta=2.0), dtype=F32,
                                       device="cpu", fuse_wrap=True)
    C, N = 3, tctx.N
    G, sigma, u = sweep_inputs(40 + 2 * F + direction, C, F, N)

    def fused(g, s, uu):
        with jctx.matmul_precision():
            return jcore._sweep_slice_fused_wrap(
                jctx, jconsts, g, s, uu, jcore.init_local_stats(jctx),
                direction)
    Gj, sj, lj = jax.vmap(fused)(jnp.asarray(G), jnp.asarray(sigma),
                                 jnp.asarray(u))
    args = [torch.from_numpy(x) for x in (G, sigma, u)]
    out = tcore._sweep_slice_fused_wrap(tctx, tconsts, *args, direction)
    unfused = tcore.visit_slice(dataclasses.replace(tctx, fuse_wrap=False),
                                tconsts, *args, direction)
    assert out[4] is None
    for ref in ((np.asarray(Gj), np.asarray(sj), np.asarray(lj["acc"]),
                 np.asarray(lj["nneg"])), [t.numpy() for t in unfused[:4]]):
        for a, b in zip(out[1:4], ref[1:4]):
            np.testing.assert_array_equal(a.numpy(), b)
        assert np.max(np.abs(out[0].numpy() - ref[0])) <= 2e-5
    assert 0 < out[2].sum() < C * N


def test_site_sweep_wrap_leaves_inputs_and_checks_direction():
    G, sigma, u = (torch.from_numpy(x) for x in sweep_inputs(7, 2, 1, 8))
    M = torch.eye(8)
    G0, s0 = G.clone(), sigma.clone()
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    out = ss.site_sweep_wrap(G, sigma, u, M, M, wrap_dir=1, **kw)
    assert torch.equal(G, G0) and torch.equal(sigma, s0)
    # identity operands: the wrap is the diagonal scaling alone, and the
    # decisions are K1's
    ref = ss.site_sweep_plain(G, sigma, u, **kw)
    for a, b in zip(out[1:], ref[1:4]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="wrap_dir"):
        ss.site_sweep_wrap(G, sigma, u, M, M, wrap_dir=0, **kw)


@pytest.mark.parametrize("scratch", [True, False])
def test_gt_modes_match_site_sweep_plain(scratch):
    """The Pallas kernel's transposed-G modes without a wrap (Gt in VMEM
    scratch, or a materialized Gt input/output pair), which the JAX package
    states bit-identical to col_read, against K1's plain version: decisions
    equal, G within 1e-5."""
    kw = dict(lamb=LAMB, **MODELS["repulsive" if scratch else "attractive"])
    F = len(kw["signs"])
    G, sigma, u = sweep_inputs(60 + scratch, 3, F, 16)
    Gj, sj, aj, nj = pss._site_sweep_batched(
        jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u),
        _force_colread=False, _force_scratch=scratch, **kw)
    Gt, st, at, nt, _ = ss.site_sweep_plain(
        *(torch.from_numpy(x) for x in (G, sigma, u)), **kw)
    for a, b in ((st, sj), (at, aj), (nt, nj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < at.sum() < 3 * 16
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


# ---------------------------------------------------------------------------
# K12: the one-chain site sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_site_sweep_single_matches_site_sweep_pallas(model):
    """K12's wrapper against the JAX package's site_sweep_pallas (interpret
    mode) on one chain: the JAX signature's shapes and types (sigma int32
    in, int32 out; acc and nneg 0-d int32), decisions equal, G within
    1e-5."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = sweep_inputs(70 + F, 1, F, 16)
    G, sigma, u = G[0], sigma[0].astype(np.int32), u[0]
    Gj, sj, aj, nj = pss.site_sweep_pallas(
        jnp.asarray(G), jnp.asarray(sigma), jnp.asarray(u), **kw)
    Gt, st, at, nt = ss.site_sweep_single(
        *(torch.from_numpy(x) for x in (G, sigma, u)), **kw)
    assert Gt.shape == (F, 16, 16) and st.dtype == torch.int32
    assert at.shape == nt.shape == () and at.dtype == nt.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert int(at) == int(aj) and int(nt) == int(nj) and 0 < int(at) < 16
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


def test_one_chain_session_runs_k12(monkeypatch):
    """A one-chain float32 session sweeps every slice through K12 (its plain
    version here), with the decisions of chain 0 of the same pair run on two
    chains through K1."""
    tm = _models()[1]
    params = TParams(beta=1.0, safe_mult=5)
    ctx, consts = tcore.make_context(tm, params, dtype=F32, device="cpu")
    conf = tm.rand_conf(torch.Generator().manual_seed(3), 2, params.slices,
                        "cpu")
    u = torch.rand(2, 2 * ctx.M, ctx.N, generator=torch.Generator().manual_seed(4))
    calls = _spy(monkeypatch, tcore, ("site_sweep", "site_sweep_single"))
    two, _, _ = tcore.sweep_pair(ctx, consts, tcore.init_state(ctx, consts, conf),
                                 u=u)
    assert calls == {"site_sweep": 2 * ctx.M, "site_sweep_single": 0}
    one, _, _ = tcore.sweep_pair(
        ctx, consts, tcore.init_state(ctx, consts, conf[:1]), u=u[:1])
    assert calls == {"site_sweep": 2 * ctx.M, "site_sweep_single": 2 * ctx.M}
    assert torch.equal(one["conf"], two["conf"][:1])
    assert torch.equal(one["acc"], two["acc"][:1])
    assert (one["G"] - two["G"][:1]).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# K14: the QR emitting (V, tau), and the WY assembly of Q
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,panel", [(16, 1), (16, 8), (24, 8)])
def test_qr_vtau_matches_pallas(monkeypatch, N, panel):
    """K14's plain V, tau and R against the Pallas kernel's, per column
    (panel 1: _qr_kernel_vtau) and in KB=8 panels (_blocked_kernel_vtau):
    one function, which K14 computes at every N. V is zero above its
    diagonal."""
    Ap, _ = graded(N + panel, 4, N)
    # the Pallas route assembles Q at once: keep its V and tau instead
    monkeypatch.setattr(pallas_qr, "_wy_assemble_q", lambda V, tau: (V, tau))
    (Vj, tj), Rj = pallas_qr._qr_batched_vtau(jnp.asarray(Ap.numpy()),
                                              panel=panel)
    Vt, tt, Rt = qh.qr_vtau(Ap)
    assert Vt.dtype == tt.dtype == F32 and tt.shape == (4, N)
    _close(Vt, Vj, 1e-5)
    _close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-4)
    assert torch.equal(torch.triu(Vt, 1), torch.zeros_like(Vt))
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))


@pytest.mark.parametrize("kind", ["graded", "triangular", "zero_columns"])
def test_qr_wy_matches_qr_lanes_wy(kind):
    """qr_wy (K14 + wy_assemble_q) against the JAX package's qr_lanes_wy on
    graded input, on already-triangular input (zero tails: the reflector
    of each column flips its sign) and with zero columns (tau = 0, v = 0:
    the column drops out of the assembly): Q and R within 1e-5 of their
    largest entries, Q orthogonal and QR = A to float32 rounding; the
    assembly alone, on the same V and tau, within 1e-5 of
    pallas_qr._wy_assemble_q."""
    Ap, _ = graded({"graded": 1, "triangular": 2, "zero_columns": 3}[kind],
                   3, 16, decades=4.0)
    if kind == "triangular":
        Ap = torch.triu(Ap)
    elif kind == "zero_columns":
        Ap[:, :, -3:] = 0.0
    Qj, Rj = pallas_qr.qr_lanes_wy()(jnp.asarray(Ap.numpy()))
    Qt, Rt = qh.qr_wy(Ap)
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    eye = torch.eye(16)
    assert (Qt.mT @ Qt - eye).abs().max().item() <= 1e-5
    _close((Qt.double() @ Rt.double()).numpy(), Ap.double().numpy(), 1e-5)
    V, tau, _ = qh.qr_vtau(Ap)
    if kind == "zero_columns":
        assert torch.equal(tau[:, -3:], torch.zeros(3, 3))
        assert torch.equal(V[:, :, -3:], torch.zeros(3, 16, 3))
    _close(qh.wy_assemble_q(V, tau),
           pallas_qr._wy_assemble_q(jnp.asarray(V.numpy()),
                                    jnp.asarray(tau.numpy())), 1e-5)


def test_qr_vtau_subnormal_reflector_is_dropped():
    """A column whose tail has a subnormal v.v: tau = 0 (the TPU's flushed
    result) and its V column 0, so Q is finite and orthogonal."""
    A = torch.eye(16) * 2.0 ** 40
    A[:, 1] = 3e-21                              # v·v ~ 1e-40 at column 1
    V, tau, R = qh.qr_vtau(A[None])
    assert tau[0, 1] == 0 and torch.equal(V[0, :, 1], torch.zeros(16))
    Q, _ = qh.qr_wy(A[None])
    assert bool(torch.isfinite(Q).all())
    assert (Q[0].mT @ Q[0] - torch.eye(16)).abs().max().item() <= 1e-5


def test_qr_routes_with_qr_wy(monkeypatch):
    """The kernel path's float32 QR with qr_wy: K14 + the WY assembly in
    K4's place (inside the column-scaled UDT, and in udt_dirty past N = 64);
    the fused K2 keeps udt_dirty at N <= 64, as in the JAX package; without
    the flag K4; the library path calls none of them."""
    calls = _spy(monkeypatch, tl, ("qr_f32", "_qr_wy", "udt_qr"))

    def route(A, fn, **kw):
        for k in calls:
            calls[k] = 0
        fn(A, **kw)
        return {k for k, v in calls.items() if v}

    A16 = graded(5, 2, 16)[0]
    A72 = graded(6, 1, 72)[0]
    cs, ud = tl.udt_dirty_colscaled, tl.udt_dirty
    assert route(A16, cs, qr_wy=True) == {"_qr_wy"}
    assert route(A16, cs) == {"qr_f32"}
    assert route(A72, ud, qr_wy=True) == {"_qr_wy"}
    assert route(A16, ud, qr_wy=True) == {"udt_qr"}
    assert route(A16, cs, use_kernels=False, qr_wy=True) == set()


# ---------------------------------------------------------------------------
# whole sweep pairs against the JAX package's A/B modes
# ---------------------------------------------------------------------------

def _ab_pair(monkeypatch, env, stab_method, seed, **modes):
    """One float32 sweep pair at 4x4, beta = 1, safe_mult = 5, 4 chains, on
    the JAX package's Pallas path (interpret mode) under the environment
    switch env and on the port's kernel path with the matching keyword,
    from the same state and uniforms. Returns (port state, JAX state, port
    G_meas, JAX G_meas) as numpy, and the JAX and the port context."""
    monkeypatch.setenv(env, "1")
    monkeypatch.setattr(pallas_qr, "ENABLED", True)
    jm, tm = _models()
    jctx, jconsts = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                       dtype=jnp.float32, use_pallas=True,
                                       stab_method=stab_method)
    tctx, tconsts = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                       dtype=F32, device="cpu",
                                       stab_method=stab_method, **modes)
    _, s0 = _jax_init(jctx, jconsts, 4, seed)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float32)
    # a fresh trace: the switch is read when sweep_pair is traced
    sj, Gmj, _ = jax.jit(jax.vmap(partial(jcore.sweep_pair, jctx,
                                          jconsts)))(s0)
    st, Gmt, _ = tcore.sweep_pair(tctx, tconsts,
                                  interop.state_from_numpy(_np(s0)),
                                  u=torch.from_numpy(u))
    return (interop.state_to_numpy(st), _np(sj), Gmt.numpy(),
            np.asarray(Gmj), jctx, tctx)


def _assert_pair_agrees(st, sj, Gmt, Gmj):
    for k in ("conf", "acc", "neg_prob"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert 0 < st["acc"].sum() < 2 * 10 * 16 * 4
    assert np.max(np.abs(st["G"] - sj["G"])) <= 1e-4
    assert np.max(np.abs(Gmt - Gmj)) <= 1e-4


def test_sweep_pair_fuse_wrap_matches_jax(monkeypatch):
    """fuse_wrap=True against MC_TPU_FUSE_WRAP=1: every slice visit but the
    measurement point's through K13 (2M - 1 of them), that one through
    K1 and the separate wrap_up; identical decisions, G within 1e-4."""
    calls = _spy(monkeypatch, tcore, ("site_sweep", "site_sweep_wrap",
                                      "wrap_up", "wrap_down"))
    st, sj, Gmt, Gmj, jctx, tctx = _ab_pair(
        monkeypatch, "MC_TPU_FUSE_WRAP", "qr", 21, fuse_wrap=True)
    assert jcore._fuse_wrap_enabled(jctx) and tcore._fuse_wrap_enabled(tctx)
    assert calls == {"site_sweep": 1, "site_sweep_wrap": 2 * tctx.M - 1,
                     "wrap_up": 1, "wrap_down": 0}
    _assert_pair_agrees(st, sj, Gmt, Gmj)


def test_sweep_pair_qr_wy_matches_jax(monkeypatch):
    """qr_wy=True under stab_method="qr_colscaled" against MC_TPU_QR_WY=1
    with the Pallas QR enabled: every QR of the pair through K14 + the WY
    assembly (4 per segment), none through K4; identical decisions, G
    within 1e-4."""
    calls = _spy(monkeypatch, tl, ("qr_f32", "_qr_wy"))
    st, sj, Gmt, Gmj, _, tctx = _ab_pair(
        monkeypatch, "MC_TPU_QR_WY", "qr_colscaled", 22, qr_wy=True)
    assert calls == {"qr_f32": 0, "_qr_wy": 4 * tctx.n_seg}
    _assert_pair_agrees(st, sj, Gmt, Gmj)


# ---------------------------------------------------------------------------
# make_context: where each mode applies
# ---------------------------------------------------------------------------

def _theta(N):
    a = np.random.default_rng(2).uniform(-0.5, 0.5, (N, N))
    return a - a.T


@pytest.mark.parametrize("mode,lattice,kw,ok", [
    # fuse_wrap: real hopping, float32 updates, N <= 128, delay <= 1
    ("fuse_wrap", (2, 4), dict(dtype=F32), True),
    ("fuse_wrap", (2, 4), dict(dtype=F64, update_dtype=F32), True),
    ("fuse_wrap", (2, 4, "repulsive"), dict(dtype=F32), True),
    ("fuse_wrap", (2, 4), dict(dtype=F64), False),
    ("fuse_wrap", (2, 4), dict(dtype=F32, update_dtype=F64), False),
    ("fuse_wrap", (2, 4, "peierls"), dict(dtype=F32), False),
    ("fuse_wrap", (2, 4), dict(dtype=F32, delay=4), False),
    ("fuse_wrap", (2, 12), dict(dtype=F32), False),
    # qr_wy: a float32 QR on K4's route
    ("qr_wy", (2, 4), dict(dtype=F32, stab_method="qr_colscaled"), True),
    ("qr_wy", (1, 72), dict(dtype=F32), True),
    ("qr_wy", (2, 4), dict(dtype=F32), False),
    ("qr_wy", (2, 8), dict(dtype=F32), False),
    ("qr_wy", (2, 4), dict(dtype=F64, stab_method="qr_colscaled"), False),
    ("qr_wy", (2, 4), dict(dtype=F64, update_dtype=F32,
                           stab_method="qr_colscaled"), False),
    ("qr_wy", (2, 4, "peierls"), dict(dtype=F32,
                                      stab_method="qr_colscaled"), False),
    ("qr_wy", (2, 12), dict(dtype=F32, stab_method="qr_colscaled"), False)])
def test_ab_mode_route_table(mode, lattice, kw, ok):
    """Each mode engages where its kernel takes part of the session and
    raises ValueError naming its rule elsewhere: it never quietly leaves
    the session unchanged."""
    dims, L, *extra = lattice
    model_kw = dict(dims=dims, L=L, U=4.0)
    if "peierls" in extra:
        model_kw["peierls"] = _theta(L ** dims)
    cls = (tmc.HubbardModelRepulsive if "repulsive" in extra
           else tmc.HubbardModelAttractive)
    make = partial(tcore.make_context, cls(**model_kw), TParams(beta=1.0),
                   device="cpu", **{mode: True}, **kw)
    if ok:
        ctx, _ = make()
        assert getattr(ctx, mode)
        return
    with pytest.raises(ValueError, match=mode):
        make()


def test_modes_leave_the_plain_path_unchanged(monkeypatch):
    """With use_kernels=False both modes leave the plain unfused path, as
    use_pallas=False does in the JAX package: no K13, no K14, and the same
    state as a session without them."""
    tm = _models()[1]
    params = TParams(beta=1.0, safe_mult=5)
    conf = tm.rand_conf(torch.Generator().manual_seed(5), 2, params.slices,
                        "cpu")
    out = []
    for modes in ({}, dict(fuse_wrap=True, qr_wy=True)):
        ctx, consts = tcore.make_context(
            tm, params, dtype=F32, device="cpu", use_kernels=False,
            stab_method="qr_colscaled", **modes)
        u = torch.rand(2, 2 * ctx.M, ctx.N,
                       generator=torch.Generator().manual_seed(6))
        calls = _spy(monkeypatch, tcore, ("site_sweep_wrap",))
        calls.update(_spy(monkeypatch, tl, ("_qr_wy",)))
        out.append(tcore.sweep_pair(ctx, consts,
                                    tcore.init_state(ctx, consts, conf),
                                    u=u)[0])
        assert calls == {"site_sweep_wrap": 0, "_qr_wy": 0}
        monkeypatch.undo()
    for k in ("conf", "G", "S_U", "S_D", "S_T"):
        assert torch.equal(out[0][k], out[1][k]), k


def test_dqmc_passes_the_modes():
    sim = tmc.DQMC(_models()[1], beta=1.0, n_chains=2, device="cpu",
                   dtype=F32, fuse_wrap=True, measurements={})
    assert sim.ctx.fuse_wrap and not sim.ctx.qr_wy
    sim.run(thermalization=0, sweeps=1, verbose=False)
    assert bool(torch.isfinite(sim.state["G"]).all())
    with pytest.raises(ValueError, match="qr_wy"):
        tmc.DQMC(_models()[1], beta=1.0, n_chains=2, device="cpu",
                 dtype=F32, qr_wy=True)


def test_new_wrappers_raise_off_cpu_without_kernel():
    """A tensor on another device (here `meta`) goes to the kernel checks,
    which raise; nothing falls back to the plain version."""
    m = dict(device="meta")
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    G = torch.empty(2, 1, 16, 16, **m)
    s = torch.empty(2, 16, dtype=torch.int8, **m)
    u = torch.empty(2, 16, **m)
    M = torch.empty(16, 16, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.site_sweep_wrap(G, s, u, M, M, wrap_dir=1, **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.site_sweep_single(G[0], s[0], u[0], **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        qh.qr_vtau(torch.empty(2, 16, 16, **m))


@pytest.mark.parametrize("F", [1, 2])
def test_wrap_supports_every_shape_k13_took(F):
    """The shapes of K13's first design (G of one chain and its wrap's
    middle term in shared memory: every N <= 128 at F = 1 and 2) are all
    still taken on the tiled layout, within a block's shared memory."""
    assert [n for n in range(1, 200) if ss.wrap_supports(n, F)] == \
        list(range(1, 129))
    assert max(ss.wrap_smem_bytes(n, F) for n in range(1, 129)) == \
        ss.wrap_smem_bytes(128, F) <= 232448
    assert ss.wrap_smem_bytes(64, 1) == (1408 + 2 * 64 * 68 * 4)


def test_kernel_shapes_of_k13():
    assert ss.wrap_supports(64, 1) and ss.wrap_supports(128, 2)
    assert not ss.wrap_supports(129, 1) and not ss.wrap_supports(64, 3)
    assert not ss.wrap_supports(64, 1, torch.float64)
