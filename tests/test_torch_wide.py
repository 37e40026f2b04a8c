"""Complex hopping past N = 64 in the PyTorch/CUDA port (montecarlo_tpu_torch)
against montecarlo_tpu, on the CPU: kernel K9 (the delayed complex site-major
sweep, N > 128) and the wide K10 (complex QR with Q formed backward,
64 < N <= 128) through their plain versions against the Pallas kernels in
interpret mode, the complex delayed plain sweep against the JAX package's
XLA loop, the Chain lattice, and whole complex128 sweep pairs on a 12x12
lattice (N = 144: K9 and the library QR) and on a 16-site chain (K8, K10).
The same numpy inputs (and, for sweep pairs, the same uniforms) go to both
sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.lattices.library import choose_lattice as j_lattice
from montecarlo_tpu.ops import pallas_qr
from montecarlo_tpu.ops import pallas_site_sweep as pss

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.lattices.library import choose_lattice as t_lattice
from montecarlo_tpu_torch.ops import linalg
from montecarlo_tpu_torch.ops import qr_cx as qcx
from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from test_torch_dqmc import _jax_init, _jax_uniforms, _np
from torch_port_inputs import LAMB, MODELS, cx_sweep_inputs, flux_theta
from torch_port_inputs import graded


def _rel(a, b):
    """max|a - b| / max|b|, complex-safe."""
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _models(theta, dims=2, L=4, repulsive=False):
    name = "HubbardModelRepulsive" if repulsive else "HubbardModelAttractive"
    kw = dict(dims=dims, L=L, U=4.0, peierls=theta)
    return getattr(jmc, name)(**kw), getattr(tmc, name)(**kw)


def _contexts(theta, beta, sm, delay=None, use_kernels=True, dims=2, L=4,
              repulsive=False):
    """complex128 contexts of both packages (the JAX package's XLA path:
    complex128 has no Pallas kernel)."""
    jm, tm = _models(theta, dims, L, repulsive)
    jctx, jconsts = jcore.make_context(jm, JParams(beta=beta, safe_mult=sm),
                                       dtype=jnp.float64, delay=delay)
    tctx, tconsts = tcore.make_context(tm, TParams(beta=beta, safe_mult=sm),
                                       dtype=torch.float64, device="cpu",
                                       use_kernels=use_kernels, delay=delay)
    assert not jctx.use_pallas and jctx.delay == tctx.delay
    return (jctx, jconsts), (tctx, tconsts)


def _pure_gauge(N, seed=0):
    phi = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, N)
    return phi[:, None] - phi[None, :]


# ---------------------------------------------------------------------------
# K9: the delayed complex site-major sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,dk", [(16, 1), (16, 4), (16, 16), (32, 1),
                                  (32, 4), (32, 32)])
def test_site_sweep_delayed_cx_matches_pallas(N, dk):
    """complex64, C = 3 (padded to the chain block of 8 on the JAX side):
    sigma and accept identical to _sitemajor_kernel_cx's in interpret mode,
    G within 1e-4 and det within 1e-5 of its largest magnitude (XLA's CPU
    compiler may fuse a product and a sum into one FMA where the plain
    version rounds twice; det ~ 10 here)."""
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    G, sigma, u = cx_sweep_inputs(110 + N + dk, 3, 1, N)
    Gj, sj, aj, dj = pss._site_sweep_sitemajor_cx(
        jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u),
        force_cb=8, **kw)
    Gt, st, at, dt = ssdcx.site_sweep_delayed_cx(
        torch.from_numpy(G), torch.from_numpy(sigma), torch.from_numpy(u),
        dk=dk, **kw)
    assert st.dtype == torch.int8 and at.dtype == torch.bool
    assert Gt.dtype == dt.dtype == torch.complex64
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert 0 < at.sum() < 3 * N
    dj = np.asarray(dj)
    assert np.max(np.abs(dt.numpy() - dj)) <= 1e-5 * np.max(np.abs(dj))
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-4


@pytest.mark.parametrize("model,N,dk", [("attractive", 24, 4),
                                        ("attractive", 24, 24),
                                        ("repulsive", 24, 8),
                                        ("repulsive", 16, 1)])
def test_site_sweep_delayed_cx_plain_matches_k8_complex128(model, N, dk):
    """In complex128 the delayed sweep is K8's rank-1 Markov chain: sigma,
    accept and det identical to K8's plain version, G within 1e-12; the
    inputs are left as they were."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x) for x in cx_sweep_inputs(
        120 + dk, 3, F, N))
    G, u = G.to(torch.complex128), u.double()
    G0, s0 = G.clone(), sigma.clone()
    out = ssdcx.site_sweep_delayed_cx_plain(G, sigma, u, dk=dk, **kw)
    ref = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a, b)
    assert 0 < out[2].sum() < 3 * N
    assert (out[0] - ref[0]).abs().max().item() <= 1e-12
    assert torch.equal(G, G0) and torch.equal(sigma, s0)


def test_site_sweep_delayed_cx_kernel_shapes():
    assert ssdcx.kernel_supports(256, 1, 32)
    assert ssdcx.kernel_supports(144, 1, 1)
    assert ssdcx.kernel_supports(144, 2, 8)
    assert ssdcx.kernel_supports(256, 2, 16)
    assert ssdcx.kernel_supports(256, 2, 32)        # two column passes
    assert ssdcx.plan(256, 2, 32, 2) == (2, 1)     # passes, flavor stages
    assert not ssdcx.kernel_supports(256, 2, 128)   # no layout fits
    assert not ssdcx.kernel_supports(128, 1, 1)     # K8's range
    assert ssdcx.kernel_supports(260, 1, 4)         # 8 ∤ N: G padded to 264
    assert ssdcx.padded(260) == 264
    assert not ssdcx.kernel_supports(256, 1, 24)    # dk does not divide N
    with pytest.raises(ValueError, match="dk=24"):
        ssdcx.site_sweep_delayed_cx_plain(
            torch.zeros(1, 1, 256, 256, dtype=torch.complex64),
            torch.ones(1, 256, dtype=torch.int8), torch.zeros(1, 256), dk=24,
            lamb=LAMB, **MODELS["attractive"])


def test_sweep_slice_delayed_complex_matches_jax():
    """The plain complex rank-k sweep (delay 4) against the JAX package's
    XLA sweep_slice_delayed in complex128 on a flux pattern (the repulsive
    model: with random G, Re(r_up r_dn) < 0 happens), from the same G,
    sigma and uniforms: decisions identical, G within 1e-12, and the
    negative-weight, imaginary-weight and phase statistics folded from the
    per-site accept flags and detratios within 1e-12 of the JAX package's
    sequential bookkeeping."""
    (jctx, _), (tctx, _) = _contexts(flux_theta(16, amp=1.0), 1.0, 5,
                                     delay=4, use_kernels=False,
                                     repulsive=True)
    assert tctx.delay == 4
    G, sigma, u = cx_sweep_inputs(130, 4, 2, 16)
    G, u = G.astype(np.complex128), u.astype(np.float64)

    def jax_sweep(G, s, u):
        return jcore.sweep_slice_delayed(jctx, G, s, u,
                                         jcore.init_local_stats(jctx))

    Gj, sj, lj = jax.jit(jax.vmap(jax_sweep))(
        jnp.asarray(G), jnp.asarray(sigma), jnp.asarray(u))
    Gt, st, accept, det, neg = tcore.sweep_slice(tctx, torch.from_numpy(G),
                                                 torch.from_numpy(sigma),
                                                 torch.from_numpy(u))
    assert neg is None and accept.shape == det.shape == (4, 16) and det.is_complex()
    ls = tcore.fresh_counters(tctx, 4)
    ls["ls_phase"] = torch.ones(4, dtype=torch.complex128)
    ls = tcore._track_detratio_batch(ls, det, accept)
    lj = {jcore._ls_key(k): np.asarray(v) for k, v in lj.items()}
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for k in ("acc", "neg_prob", "ls_imag_count"):
        np.testing.assert_array_equal(ls[k].numpy(), lj[k], err_msg=k)
    assert ls["neg_prob"].sum() > 0 and ls["ls_imag_count"].sum() > 0
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-12
    for k in tcore.NEG_KEYS + tcore.CX_COUNTER_KEYS[1:] + ("ls_phase",):
        np.testing.assert_allclose(ls[k].numpy(), lj[k], rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_complex_delayed_session_runs_on_cpu():
    """16x16 with Peierls phases (N = 256, delay auto 32) builds on the CPU
    in float32 (complex64, K9's route through its plain version) and
    float64 (complex128, the plain rank-k path); one sweep of the complex128
    session keeps the pure gauge's weights real."""
    model = tmc.HubbardModelAttractive(dims=2, L=16, U=4.0,
                                       peierls=_pure_gauge(256))
    sim = tmc.DQMC(model, dtype=torch.float32, beta=0.2, n_chains=2,
                   device="cpu")
    assert sim.ctx.dtype == torch.complex64 and sim.ctx.delay == 32
    sim = tmc.DQMC(model, beta=0.2, n_chains=2, device="cpu",
                   use_kernels=False, measurements={})
    sim.run(thermalization=0, sweeps=1, verbose=False)
    assert sim.ctx.dtype == torch.complex128 and sim.analysis.acc_local > 0
    assert sim.analysis.imaginary_probability.count == 0
    assert abs(sim.analysis.avg_phase - 1.0) < 1e-9


C64, C128 = torch.complex64, torch.complex128


@pytest.mark.parametrize("N,stacks,updates,item", [
    (256, C128, C64, None), (128, C128, C64, None), (64, C128, C64, None),
    (100, C128, C64, None), (64, C64, C128, None)])
def test_check_cuda_kernels_complex128_stacks(N, stacks, updates, item):
    """complex128 stacks over complex64 updates run the complex64 site
    sweep kernels (K8 to N = 128, at 8 ∤ N too, K9 beyond) with the
    library QR, as the JAX package runs its Pallas sweep with XLA's QR;
    complex128 updates over complex64 stacks run K8-c128."""
    if item is None:
        tcore._check_cuda_kernels(N, 1, 0, stacks, updates)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        tcore._check_cuda_kernels(N, 1, 0, stacks, updates)


@pytest.mark.parametrize("N,dtype,kernel", [
    (64, C64, True), (128, C64, True), (136, C64, False), (64, C128, False),
    (128, C128, False)])
def test_complex_qr_route(monkeypatch, N, dtype, kernel):
    """On the kernel path the complex QR is K10 for complex64 at
    N <= 128 and the library QR otherwise: past N = 128 and for complex128
    at every N, where the JAX package runs XLA's QR."""
    calls = []

    def spy(A):
        calls.append(A.shape)
        return qcx.qr_cx(A)
    monkeypatch.setattr(linalg, "qr_cx", spy)
    A, _ = graded(N, 2, N, complex_=True)
    Q, R = linalg._qr(A.to(dtype), True)
    assert bool(calls) == kernel
    ref = (qcx.qr_cx if kernel else linalg._library_qr)(A.to(dtype))
    assert torch.equal(Q, ref[0]) and torch.equal(R, ref[1])


# ---------------------------------------------------------------------------
# the wide K10: complex QR with Q formed backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [72, 128])
def test_qr_cx_wide_matches_pallas(N):
    """complex64 on graded, prescaled, pivoted input: the backward plain
    version (qr_cx's CPU route) against _qr_kernel_cx in
    interpret mode, phase-normalized Q and R within 1e-5 of their largest
    entries (the Pallas kernel accumulates Q forward and sums in another
    order); R exactly upper triangular."""
    Ap, _ = graded(150 + N, 3, N, complex_=True)
    Qj, Rj = pallas_qr._qr_batched_cx(jnp.asarray(Ap.numpy()))
    Qt, Rt = qcx.qr_cx(Ap)
    Qf, Rf = qcx.qr_cx_plain(Ap)
    ref = qcx.phase_normalized(torch.from_numpy(np.array(Qj)),
                               torch.from_numpy(np.array(Rj)))
    for other in ((Qt, Rt), (Qf, Rf)):
        for a, b in zip(qcx.phase_normalized(*other), ref):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))


def test_qr_cx_backward_plain_matches_library():
    """complex128: the backward Q against torch.linalg.qr (LAPACK) up to
    one unit phase per column; Q unitary to 1e-13; a zero column and a
    subnormal v^H v stay finite (tau = 0)."""
    rng = np.random.default_rng(151)
    A = torch.from_numpy(rng.normal(size=(2, 80, 80))
                         + 1j * rng.normal(size=(2, 80, 80)))
    Qt, Rt = qcx.qr_cx_backward_plain(A)
    for a, b in zip(qcx.phase_normalized(Qt, Rt),
                    qcx.phase_normalized(*torch.linalg.qr(A))):
        assert _rel(a.numpy(), b.numpy()) <= 1e-12
    assert (Qt.mH @ Qt - torch.eye(80)).abs().max().item() <= 1e-13
    Az = torch.eye(72, dtype=torch.complex64)[None] * 2.0 ** 40
    Az[:, :, 1] = 2e-21 + 2e-21j
    Az[:, :, -1] = 0.0
    Q, R = qcx.qr_cx(Az)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert R[0, -1, -1].item() == 0


# ---------------------------------------------------------------------------
# the Chain lattice and complex sweep pairs on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [4, 16, 128])
def test_chain_matches_jax(L):
    """choose_lattice(1, L): neighbor table, bonds, positions, directed
    neighbors and direction bins identical; the hopping matrix with
    pure-gauge Peierls phases identical bit for bit."""
    lj, lt = j_lattice(1, L), t_lattice(1, L)
    assert len(lj) == len(lt) == L
    np.testing.assert_array_equal(lt.neighbor_table, lj.neighbor_table)
    np.testing.assert_array_equal(lt.bonds, lj.bonds)
    np.testing.assert_array_equal(lt.positions, lj.positions)
    np.testing.assert_array_equal(lt.neighbors(directed=True),
                                  lj.neighbors(directed=True))
    np.testing.assert_array_equal(lt.directions, lj.directions)
    jm, tm = _models(_pure_gauge(L, 3), dims=1, L=L)
    np.testing.assert_array_equal(tm.hopping_matrix(), jm.hopping_matrix())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sweep_pair_chain_complex_matches_jax(use_kernels):
    """A complex128 sweep pair on a 16-site chain with Peierls phases (K8
    and K10 through their plain versions, or the library path) against the
    JAX package's: every decision identical; G, G_meas and the running
    phase within 1e-12."""
    (jctx, jconsts), (tctx, tconsts) = _contexts(
        flux_theta(16), 1.0, 5, use_kernels=use_kernels, dims=1, L=16)
    _, s0 = _jax_init(jctx, jconsts, 3, 160)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float64)
    sj, Gmj, cmj = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    st, Gmt, cmt = tcore.sweep_pair(tctx, tconsts,
                                    interop.state_from_numpy(_np(s0)),
                                    u=torch.from_numpy(u))
    sj, st = _np(sj), interop.state_to_numpy(st)
    for k in ("conf", "acc", "neg_prob", "prop", "ls_imag_count"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    np.testing.assert_array_equal(cmt.numpy(), np.asarray(cmj))
    assert 0 < st["acc"].sum() < 2 * jctx.M * jctx.N * 3
    assert _rel(st["G"], sj["G"]) <= 1e-12
    assert _rel(Gmt.numpy(), Gmj) <= 1e-12
    for k in ("ls_phase", "phase_meas"):
        assert np.max(np.abs(st[k] - sj[k])) <= 1e-12, k
