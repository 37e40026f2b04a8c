"""Complex hopping (Peierls phases) in the PyTorch/CUDA port
(montecarlo_tpu_torch) against montecarlo_tpu, on the CPU: the complex
promotion of make_context, the complex linear algebra, kernels K8 (complex
site sweep) and K10 (complex QR) through their plain versions against the
Pallas kernels in interpret mode, the phase-problem statistics, and whole
sweep pairs.

Two flux patterns: a pure gauge theta_ij = phi_i - phi_j, under which the
complex chain is the real chain in a rotated basis (G_cx = L G_real L^H with
L = diag(e^{i phi}), identical decisions, weights exactly real), and a
random antisymmetric theta, which threads flux through the plaquettes and
gives the weights a genuine phase. The same numpy inputs (and, for sweep
pairs, the same uniforms) go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.ops import linalg as jl
from montecarlo_tpu.ops import pallas_qr
from montecarlo_tpu.ops import pallas_site_sweep as pss
from montecarlo_tpu.utils.binner import LogBinner as JBinner

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.ops import linalg as tl
from montecarlo_tpu_torch.ops import qr_cx as qcx
from montecarlo_tpu_torch.ops import site_sweep as ss
from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
from montecarlo_tpu_torch.utils.binner import LogBinner as TBinner
from test_torch_dqmc import _jax_init, _jax_uniforms, _np
from torch_port_inputs import LAMB, MODELS, cx_sweep_inputs, flux_theta
from torch_port_inputs import sweep_inputs

TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _gauge(N, seed=0):
    """(phi, theta) of a pure gauge: theta_ij = phi_i - phi_j."""
    phi = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, N)
    return phi, phi[:, None] - phi[None, :]


def _models(theta, L=4, repulsive=False):
    name = "HubbardModelRepulsive" if repulsive else "HubbardModelAttractive"
    kw = dict(dims=2, L=L, U=4.0, peierls=theta)
    return getattr(jmc, name)(**kw), getattr(tmc, name)(**kw)


def _contexts(theta, beta=1.0, sm=5, dtype="f64", use_kernels=True, L=4):
    jm, tm = _models(theta, L)
    jctx, jconsts = jcore.make_context(
        jm, JParams(beta=beta, safe_mult=sm),
        dtype={"f64": jnp.float64, "f32": jnp.float32}[dtype])
    tctx, tconsts = tcore.make_context(
        tm, TParams(beta=beta, safe_mult=sm),
        dtype={"f64": torch.float64, "f32": torch.float32}[dtype],
        device="cpu", use_kernels=use_kernels)
    return (jctx, jconsts), (tctx, tconsts)


def _phase_normalized(Q, R):
    """(Q S, S^H R) with S = diag(R_jj / |R_jj|): free of the QR's phase
    choice per column."""
    Q, R = np.asarray(Q), np.asarray(R)
    d = np.diagonal(R, axis1=-2, axis2=-1)
    s = np.where(np.abs(d) > 0, d / np.maximum(np.abs(d), 1e-300), 1.0)
    return Q * s[..., None, :], R * s.conj()[..., :, None]


# ---------------------------------------------------------------------------
# make_context and the slice matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_make_context_promotes_to_complex(dtype):
    """float64 -> complex128 and float32 -> complex64; the real dtype stays
    for D, uniforms and drift; the constants are the JAX package's bit for
    bit, and exp(-dtau T) is Hermitian."""
    (jctx, jconsts), (tctx, tconsts) = _contexts(_gauge(16)[1], dtype=dtype)
    cdt, rdt = {"f64": (torch.complex128, torch.float64),
                "f32": (torch.complex64, torch.float32)}[dtype]
    assert tctx.is_complex and jctx.is_complex
    assert (tctx.dtype, tctx.rdtype, tctx.urdtype) == (cdt, rdt, rdt)
    assert set(tconsts) == set(jconsts)
    for k in jconsts:
        assert tconsts[k].dtype == cdt, k
        np.testing.assert_array_equal(tconsts[k].numpy(), np.asarray(jconsts[k]))
    eT2, eT2inv = tconsts["eT2"].to(torch.complex128), tconsts["eT2inv"].to(
        torch.complex128)
    tol = 1e-14 if dtype == "f64" else 1e-6
    assert (eT2 - eT2.mH).abs().max().item() <= tol
    assert (eT2 @ eT2inv - torch.eye(16)).abs().max().item() <= 10 * tol


def test_make_context_promotes_update_dtype():
    _, tm = _models(flux_theta(16))
    ctx, consts = tcore.make_context(tm, TParams(beta=1.0), device="cpu",
                                     dtype=torch.float64,
                                     update_dtype=torch.float32)
    assert (ctx.dtype, ctx.udtype) == (torch.complex128, torch.complex64)
    assert consts["eT2_u"].dtype == torch.complex64
    assert ctx.prop_err_threshold == 1.0


def test_complex_delayed_updates_raise():
    """Complex delayed updates build and run (they raised before K9 and the
    complex plain rank-k sweep were ported): delay 4 takes the rank-1
    Markov chain on the plain path, two sweeps on a flux pattern."""
    _, tm = _models(flux_theta(16))
    out = []
    for delay in (4, 0):
        sim = tmc.DQMC(tm, beta=1.0, n_chains=3, seed=2, device="cpu",
                       use_kernels=False, delay=delay, safe_mult=5,
                       measurements={})
        assert sim.ctx.delay == delay and sim.ctx.is_complex
        sim.run(thermalization=0, sweeps=2, verbose=False)
        out.append(sim)
    assert torch.equal(out[0].conf, out[1].conf)
    assert out[0].analysis.acc_local == out[1].analysis.acc_local > 0
    assert (out[0].analysis.imaginary_probability.count
            == out[1].analysis.imaginary_probability.count > 0)
    assert (out[0].state["G"] - out[1].state["G"]).abs().max().item() <= 1e-9


def test_slice_matrices_match_jax_complex():
    """B, B^H (eT2^H, not its plain transpose), the wraps and the unwrap on
    complex G against the JAX package's."""
    (jctx, jconsts), (tctx, tconsts) = _contexts(flux_theta(16))
    rng = np.random.default_rng(3)
    C, N = 3, tctx.N
    sig = rng.choice(np.array([-1, 1], np.int8), size=(C, N))
    G = rng.normal(size=(C, 1, N, N)) + 1j * rng.normal(size=(C, 1, N, N))
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
    ]
    for ref, out in pairs:
        assert _rel(out.numpy(), ref) <= 1e-13
    # B^H M is the adjoint of B applied to M
    eV = tcore.eV_diag(tctx, ts)
    B = tconsts["eT2"] @ torch.diag_embed(eV.to(tctx.dtype))
    ref = B.mH @ tG
    assert _rel(tcore.mult_B_dagger_left(tctx, tconsts, ts, tG).numpy(),
                ref.numpy()) <= 1e-13


# ---------------------------------------------------------------------------
# K8: complex site sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["attractive", "repulsive"])
def test_site_sweep_cx_matches_pallas(model):
    """F = 1 and F = 2: sigma and accept identical, det and G within 1e-5
    (XLA's CPU compiler may fuse a product and a sum into one FMA where the
    plain version rounds twice)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = cx_sweep_inputs(60 + F, 3, F, 16)
    Gj, sj, aj, dj = pss._site_sweep_batched_cx(
        jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u), **kw)
    Gt, st, at, dt = sscx.site_sweep_cx(
        torch.from_numpy(G), torch.from_numpy(sigma), torch.from_numpy(u), **kw)
    assert st.dtype == torch.int8 and at.dtype == torch.bool
    assert Gt.dtype == dt.dtype == torch.complex64
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert 0 < at.sum() < 3 * 16
    assert np.max(np.abs(dt.numpy() - np.asarray(dj))) <= 1e-5
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


def test_site_sweep_cx_plain_is_gauge_rotated_k1():
    """On G_cx = L G L^H the complex sweep takes K1's decisions on G, with
    a real det equal to K1's, and returns the rotated G (float64)."""
    kw = dict(lamb=LAMB, **MODELS["repulsive"])
    G, sigma, u = (torch.from_numpy(x) for x in sweep_inputs(65, 3, 2, 12))
    G, u = G.double(), u.double()
    phi, _ = _gauge(12, 5)
    Lam = torch.from_numpy(np.diag(np.exp(1j * phi)))
    Gc = Lam @ G.to(torch.complex128) @ Lam.mH
    G0, s0 = Gc.clone(), sigma.clone()
    Gk, sk, acck, _, _ = ss.site_sweep_plain(G, sigma, u, **kw)
    Gx, sx, acc, det = sscx.site_sweep_cx_plain(Gc, sigma, u, **kw)
    assert torch.equal(sx, sk) and torch.equal(acc.sum(-1).int(), acck)
    assert det.imag.abs().max().item() <= 1e-14
    rot = Lam @ Gk.to(torch.complex128) @ Lam.mH
    assert (Gx - rot).abs().max().item() <= 1e-13
    assert torch.equal(Gc, G0) and torch.equal(sigma, s0)


def test_site_sweep_cx_kernel_shapes():
    assert sscx.kernel_supports(64, 1) and sscx.kernel_supports(64, 2)
    assert sscx.kernel_supports(128, 1) and sscx.kernel_supports(119, 2)
    assert sscx.kernel_supports(128, 2)           # flavor 1 in shared memory
    assert sscx.smem_bytes(128, 2) == 141184
    assert not sscx.kernel_supports(129, 1) and not sscx.kernel_supports(64, 3)


# ---------------------------------------------------------------------------
# K10: complex QR
# ---------------------------------------------------------------------------

def _cx_qr_input(kind, seed=70):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, 16, 16)) + 1j * rng.normal(size=(3, 16, 16))
    if kind == "graded":
        A = A * np.exp(np.linspace(12.0, -12.0, 16))[None, None, :]
    if kind == "zero_tail":
        A = np.triu(A)
        A[:, :, 5] = 0.0
    return A.astype(np.complex64)


@pytest.mark.parametrize("kind", ["random", "graded", "zero_tail"])
def test_qr_cx_matches_pallas(kind):
    """Q and R within 1e-5 of their largest entries against the Pallas
    kernel (the same reflector convention, sums in another order); R exactly
    upper triangular; Q R = A."""
    A = _cx_qr_input(kind)
    Qj, Rj = pallas_qr._qr_batched_cx(jnp.asarray(A))
    Qt, Rt = qcx.qr_cx(torch.from_numpy(A))
    Qj, Rj = np.asarray(Qj), np.asarray(Rj)
    assert np.max(np.abs(Qt.numpy() - Qj)) <= 1e-5 * np.max(np.abs(Qj))
    assert np.max(np.abs(Rt.numpy() - Rj)) <= 1e-5 * np.max(np.abs(Rj))
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))
    rec = Qt.to(torch.complex128) @ Rt.to(torch.complex128)
    assert np.max(np.abs(rec.numpy() - A)) <= 1e-5 * np.max(np.abs(A))
    if kind == "zero_tail":
        assert np.all(Rt.numpy()[:, 5, 5] == 0.0)


def test_qr_cx_plain_matches_library_up_to_phases():
    """complex128: against torch.linalg.qr (LAPACK zgeqrf) up to one unit
    phase per column of Q and row of R; Q unitary."""
    rng = np.random.default_rng(71)
    A = torch.from_numpy(rng.normal(size=(4, 12, 12))
                         + 1j * rng.normal(size=(4, 12, 12)))
    Qt, Rt = qcx.qr_cx_plain(A)
    Ql, Rl = torch.linalg.qr(A)
    for a, b in zip(_phase_normalized(Qt, Rt), _phase_normalized(Ql, Rl)):
        assert _rel(a, b) <= 1e-12
    assert (Qt.mH @ Qt - torch.eye(12)).abs().max().item() <= 1e-13


def test_qr_cx_subnormal_reflector_stays_finite():
    """A column whose remaining tail has a subnormal v^H v: tau = 0 (the
    TPU's flush-to-zero result) instead of 2 / v^H v = inf and NaN."""
    A = torch.eye(8, dtype=torch.complex64) * 2.0 ** 40
    A[:, 1] = 2e-21 + 2e-21j                      # v^H v ~ 6e-41 at column 1
    Q, R = qcx.qr_cx(A[None])
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(torch.tril(R, -1), torch.zeros_like(R))


def _cx_qr_input_n(kind, N, seed=72):
    rng = np.random.default_rng(seed + N)
    A = rng.normal(size=(3, N, N)) + 1j * rng.normal(size=(3, N, N))
    if kind == "graded":
        A = A * np.exp(np.linspace(12.0, -12.0, N))[None, None, :]
    if kind == "zero_tail":
        A = np.triu(A)
        A[:, :, N // 2 + 3] = 0.0
    return A.astype(np.complex64)


@pytest.mark.parametrize("N", [8, 32, 64])
@pytest.mark.parametrize("kind", ["random", "graded", "zero_tail"])
def test_qr_cx_blocked_plain_matches_pallas(kind, N):
    """K10's plain version, the blocked compact-WY QR (panels of 8: one,
    four and eight panels), against the Pallas kernel: Q and R within 1e-5
    of their largest entries, as test_qr_cx_matches_pallas holds them, but
    phase-normalized: past N = 16 rounding turns the phase of small alphas
    (the unblocked port's raw Q differs from the kernel's by 1.1e-5 of its
    largest entry on the random N = 64 input, 1.9e-6 normalized); R exactly
    upper triangular; QR = A and Q^H Q = I."""
    A = _cx_qr_input_n(kind, N)
    Qj, Rj = pallas_qr._qr_batched_cx(jnp.asarray(A))
    Qt, Rt = qcx.qr_cx_blocked_plain(torch.from_numpy(A))
    for a, b in zip(_phase_normalized(Qt.numpy(), Rt.numpy()),
                    _phase_normalized(Qj, Rj)):
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b))
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))
    Qd, Rd = Qt.to(torch.complex128), Rt.to(torch.complex128)
    assert np.max(np.abs((Qd @ Rd).numpy() - A)) <= 1e-5 * np.max(np.abs(A))
    assert (Qd.mH @ Qd - torch.eye(N)).abs().max().item() <= 1e-5
    if kind == "zero_tail":
        c = N // 2 + 3
        assert np.all(Rt.numpy()[:, c, c] == 0.0)


@pytest.mark.parametrize("N", [16, 48])
def test_qr_cx_blocked_plain_subnormal_reflector_stays_finite(N):
    """The blocked plain version, a subnormal v^H v in the second panel:
    tau = 0, finite factors, QR = A."""
    A = torch.eye(N, dtype=torch.complex64) * 2.0 ** 40
    A[:, N - 5] = 2e-21 + 2e-21j
    A[N - 5, N - 5] = 0.0
    Q, R = qcx.qr_cx_blocked_plain(A[None])
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(torch.tril(R, -1), torch.zeros_like(R))
    rec = Q.to(torch.complex128) @ R.to(torch.complex128)
    assert (rec[0] - A).abs().max().item() <= 1e-5 * 2.0 ** 40


def test_qr_cx_blocked_plain_matches_unblocked():
    """complex128: the blocked version against the unblocked one with Q
    formed backward (K10's algorithm before the panels), phase-normalized,
    at N = 40 (five panels of 8)."""
    rng = np.random.default_rng(73)
    A = torch.from_numpy(rng.normal(size=(2, 40, 40))
                         + 1j * rng.normal(size=(2, 40, 40)))
    for a, b in zip(qcx.phase_normalized(*qcx.qr_cx_blocked_plain(A)),
                    qcx.phase_normalized(*qcx.qr_cx_backward_plain(A))):
        assert _rel(a, b) <= 1e-12


def test_qr_cx_kernel_shapes():
    assert [n for n in range(1, 300) if qcx.kernel_supports(n)] == \
        list(range(8, 129, 8))


def test_qr_cx_panel_width_is_the_kernels():
    """The plain version's panel width is the one csrc/qr_cx.cu is built
    for (the kernel refuses another, which the wrapper passes it)."""
    import re
    from pathlib import Path
    src = (Path(qcx.__file__).parents[1] / "csrc" / "qr_cx.cu").read_text()
    assert re.findall(r"constexpr int kPanel = (\d+);", src) == \
        [str(qcx.PANEL)]


# ---------------------------------------------------------------------------
# complex linear algebra against the JAX package
# ---------------------------------------------------------------------------

def _cx_graded(seed, shape, decades=12.0):
    rng = np.random.default_rng(seed)
    N = shape[-1]
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * np.exp(
        rng.uniform(-decades, decades, size=shape[:-2] + (1, N)))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_udt_dirty_complex_matches_jax(use_kernels):
    """Pivot identical, D to 1e-10, U and R to 1e-10 up to the phase of each
    column (K10 reflects zero tails where LAPACK does not); D = |R_jj|
    positive, Rs with a unit-magnitude diagonal; A P = U D R."""
    A = _cx_graded(80, (3, 16, 16))
    Uj, Dj, Rj, pj = jl.udt_dirty(jnp.asarray(A))
    Ut, Dt, Rt, pt = tl.udt_dirty(torch.from_numpy(A), use_kernels)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert Dt.dtype == torch.float64
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-10)
    for a, b in zip(_phase_normalized(Ut, Rt), _phase_normalized(Uj, Rj)):
        assert _rel(a, b) <= 1e-10
    diag = torch.diagonal(Rt, dim1=-2, dim2=-1)
    assert (diag.abs() - 1).abs().max().item() <= 1e-12
    Ap = np.take_along_axis(A, pt.numpy()[..., None, :], axis=-1)
    assert _rel(((Ut * Dt[..., None, :]) @ Rt).numpy(), Ap) <= 1e-10


def test_library_qr_is_column_scaling_equivariant():
    """The library path's complex QR scales columns by powers of two before
    torch.linalg.qr and back after: the factors are LAPACK's, to the bit
    for Q."""
    A = torch.from_numpy(_cx_graded(82, (3, 16, 16), decades=30.0))
    Ql, Rl = torch.linalg.qr(A)
    Qe, Re = tl._library_qr(A)
    assert torch.equal(Qe, Ql)
    assert _rel(Re.numpy(), Rl.numpy()) <= 1e-15


def _rand_udt_cx(rng, B, N, decades):
    X = rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N))
    U, _ = np.linalg.qr(X)
    D = np.sort(np.exp(rng.uniform(-decades, decades, size=(B, N))))[:, ::-1]
    T = np.triu(0.3 * (rng.normal(size=(B, N, N))
                       + 1j * rng.normal(size=(B, N, N))), 1) + np.eye(N)
    return U, D.copy(), T


@pytest.mark.parametrize("use_kernels", [True, False])
def test_calculate_greens_complex_matches_jax(use_kernels):
    """Complex stacks (unitary U, graded D, unit upper T): the port's G
    against the JAX package's within 1e-10, and against the direct inverse
    of I + B_l B_r^H at a grading where that is still accurate."""
    rng = np.random.default_rng(81)
    l, r = _rand_udt_cx(rng, 3, 16, 4.0), _rand_udt_cx(rng, 3, 16, 4.0)
    Gj = jl.calculate_greens(*map(jnp.asarray, l + r))
    Gt = tl.calculate_greens(*map(torch.from_numpy, l + r),
                             use_kernels=use_kernels)
    assert Gt.dtype == torch.complex128
    assert _rel(Gt.numpy(), Gj) <= 1e-10
    (Ul, Dl, Tl), (Ur, Dr, Tr) = l, r
    P = (Ul * Dl[:, None, :]) @ Tl @ np.swapaxes(
        (Ur * Dr[:, None, :]) @ Tr, -1, -2).conj()
    assert _rel(Gt.numpy(), np.linalg.inv(np.eye(16) + P)) <= 1e-8


# ---------------------------------------------------------------------------
# the phase-problem statistics and the weight phase
# ---------------------------------------------------------------------------

def test_track_detratio_batch_matches_jax():
    (jctx, _), (tctx, _) = _contexts(flux_theta(16))
    rng = np.random.default_rng(90)
    C, N = 4, 16
    det = (rng.normal(size=(C, N)) + 1j * rng.normal(size=(C, N))
           * np.where(rng.uniform(size=(C, N)) < 0.5, 1e-8, 1.0))
    accept = rng.uniform(size=(C, N)) < 0.5
    ph0 = np.exp(1j * rng.uniform(0, 2 * np.pi, C))
    ls0 = jax.vmap(lambda p: jcore.init_local_stats(jctx, p))(jnp.asarray(ph0))
    track = jax.vmap(lambda ls, d, a: jcore._normalize_phase(
        jctx, jcore._track_detratio_batch(jctx, ls, d, a)))
    lj = {jcore._ls_key(k): np.asarray(v) for k, v in
          track(ls0, jnp.asarray(det), jnp.asarray(accept)).items()}
    st = tcore.fresh_counters(tctx, C)
    st["ls_phase"] = torch.from_numpy(ph0)
    out = tcore._track_detratio_batch(st, torch.from_numpy(det),
                                      torch.from_numpy(accept))
    assert set(out) == set(lj)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), lj[k], rtol=1e-13, err_msg=k)
    assert out["ls_imag_count"].sum() > 0 and out["neg_prob"].sum() > 0


@pytest.mark.parametrize("use_kernels", [True, False])
def test_init_state_complex_matches_jax(use_kernels):
    """Stack, G_eff(M) and the initial weight phase (udt_weight_phase of the
    full product) against the JAX package's in complex128; the phase_from_conf
    recomputation agrees with both."""
    (jctx, jconsts), (tctx, tconsts) = _contexts(flux_theta(16), beta=2.0,
                                                 use_kernels=use_kernels)
    conf, sj = _jax_init(jctx, jconsts, 4, 91)
    st = tcore.init_state(tctx, tconsts, torch.from_numpy(conf))
    sj = _np(sj)
    np.testing.assert_allclose(st["S_D"].numpy(), sj["S_D"], rtol=TOL)
    assert _rel(st["G"].numpy(), sj["G"]) <= TOL
    for k in ("ls_phase", "phase_meas"):
        assert np.max(np.abs(st[k].numpy() - sj[k])) <= TOL, k
    assert np.max(np.abs(np.abs(sj["ls_phase"]) - 1)) <= 1e-12
    assert np.max(np.abs(sj["ls_phase"] - 1)) > 1e-3      # a genuine phase
    ph = tcore.phase_from_conf(tctx, tconsts, torch.from_numpy(conf))
    assert np.max(np.abs(ph.numpy() - sj["ls_phase"])) <= TOL
    for k in tcore.counter_keys(tctx):
        np.testing.assert_array_equal(st[k].numpy(), sj[k], err_msg=k)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sweep_pair_complex_matches_jax_f64(use_kernels):
    """The whole complex128 sweep pair on a flux pattern against the JAX
    package's XLA path (use_pallas=False), from the same state and uniforms:
    every decision identical (conf, acc, neg_prob, imaginary-weight count),
    G, G_meas, the running phase and its measurement snapshot within 1e-9,
    the log-magnitude statistics to 1e-9."""
    (jctx, jconsts), (tctx, tconsts) = _contexts(flux_theta(16), beta=2.0,
                                                 use_kernels=use_kernels)
    C = 4
    _, s0 = _jax_init(jctx, jconsts, C, 92)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jnp.float64)
    sj, Gmj, cmj = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    t0 = interop.state_from_numpy(_np(s0))
    st, Gmt, cmt = tcore.sweep_pair(tctx, tconsts, t0, u=torch.from_numpy(u))
    sj, st = _np(sj), interop.state_to_numpy(st)
    for k in ("conf", "acc", "neg_prob", "prop", "ls_imag_count"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    np.testing.assert_array_equal(cmt.numpy(), np.asarray(cmj))
    assert 0 < st["acc"].sum() < 2 * jctx.M * jctx.N * C
    assert st["ls_imag_count"].sum() > 0
    assert _rel(st["G"], sj["G"]) <= TOL
    assert _rel(Gmt.numpy(), Gmj) <= TOL
    for k in ("ls_phase", "phase_meas"):
        assert np.max(np.abs(st[k] - sj[k])) <= TOL, k
    for k in ("ls_neg_min", "ls_neg_max", "ls_neg_sum", "ls_imag_min",
              "ls_imag_max", "ls_imag_sum"):
        np.testing.assert_allclose(st[k], sj[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_pure_gauge_matches_gauge_rotated_real(use_kernels):
    """Three sweeps of the pure-gauge complex model reproduce the real
    model's run from the same seed: the same HS fields, G_cx = L G_real L^H
    (port of test_complex_sweep_runs_and_matches_gauge_rotated_real)."""
    phi, theta = _gauge(16, 7)
    kw = dict(beta=1.0, n_chains=4, seed=3, device="cpu", measurements={},
              safe_mult=5, use_kernels=use_kernels)
    mc_c = tmc.DQMC(_models(theta)[1], **kw)
    mc_r = tmc.DQMC(tmc.HubbardModelAttractive(dims=2, L=4, U=4.0), **kw)
    mc_c.run(sweeps=3, thermalization=0, verbose=False)
    mc_r.run(sweeps=3, thermalization=0, verbose=False)
    assert torch.equal(mc_c.conf, mc_r.conf)
    assert mc_c.analysis.acc_local == mc_r.analysis.acc_local > 0
    Lam = torch.from_numpy(np.diag(np.exp(1j * phi)))
    rot = Lam @ mc_r.state["G"].to(torch.complex128) @ Lam.mH
    assert (mc_c.state["G"] - rot).abs().max().item() <= TOL


def test_flux_fires_phase_monitors():
    """Flux through the plaquettes: the imaginary-probability monitor fires
    with its magnitude statistics, the default sign observable deviates
    from 1, and the running phase equals its recomputation from the final
    configuration (port of test_flux_ring_fires_phase_monitors)."""
    sim = tmc.DQMC(_models(flux_theta(16, amp=1.0))[1], beta=2.0, n_chains=8,
                   seed=4, device="cpu", measure_rate=2, safe_mult=5)
    sim.run(thermalization=4, sweeps=16, verbose=False)
    a = sim.analysis
    assert a.imaginary_probability.count > 0
    assert 0.0 < a.imaginary_probability.min <= a.imaginary_probability.max
    assert a.imaginary_probability.mean > 0.0
    s = complex(sim.observables()["sign"]["sign"].mean)
    assert abs(s - 1.0) > 1e-3, s
    assert abs(a.avg_phase) <= 1.0 + 1e-9
    exact = tcore.phase_from_conf(sim.ctx, sim.consts, sim.conf)
    assert (sim.state["ls_phase"] - exact).abs().max().item() <= 1e-7


def test_pure_gauge_keeps_monitors_silent():
    """A pure gauge keeps every weight real: no imaginary probability,
    ⟨s⟩ = 1 to 1e-9; occupation, G and the sign binned in complex128."""
    sim = tmc.DQMC(_models(_gauge(16, 8)[1])[1], beta=1.0, n_chains=4,
                   seed=5, device="cpu", measure_rate=2, safe_mult=5)
    sim.run(thermalization=2, sweeps=8, verbose=False)
    obs = sim.observables()
    assert set(obs) == {"occ", "greens", "sign"}
    assert sim.analysis.imaginary_probability.count == 0
    s = obs["sign"]["sign"]
    assert s.count == 4 and abs(complex(s.mean) - 1.0) < 1e-9
    assert abs(sim.analysis.avg_phase - 1.0) < 1e-9
    assert np.iscomplexobj(obs["greens"]["greens"].mean)
    assert not np.iscomplexobj(obs["occ"]["occ"].mean)
    assert sim.measurements.states["greens"]["greens"]["total"].dtype == \
        torch.complex128
    assert all(int(sim.state[k].sum()) == 0 for k in
               ("acc", "neg_prob", "ls_imag_count"))


def test_binner_complex_matches_jax():
    """Complex values: complex128 sums, real sums of |x|^2, and the JAX
    binner's error convention (variance of |x| about the complex mean)."""
    rng = np.random.default_rng(93)
    C, n = 3, 70
    xs = (rng.normal(size=(n, C)) + 1j * rng.normal(size=(n, C))).cumsum(0) * 0.1
    jb = JBinner(shape=(), dtype=jnp.complex128)
    tb = TBinner(shape=(), dtype=torch.complex128)
    sj = jax.vmap(lambda _: jb.empty_state())(jnp.arange(C))
    st = tb.empty_state(C, "cpu")
    push = jax.jit(jax.vmap(jb.push))
    for x in xs:
        sj = push(sj, jnp.asarray(x))
        tb.push(st, torch.from_numpy(x))
    assert st["total"].dtype == torch.complex128
    assert st["sumsq"].dtype == torch.float64
    for f in ("mean", "std_error", "tau", "var", "combined_mean",
              "combined_std_error"):
        np.testing.assert_allclose(getattr(TBinner, f)(st),
                                   getattr(JBinner, f)(sj), rtol=1e-12,
                                   err_msg=f)


def test_complex_interop_roundtrip():
    """A complex JAX state carries its phase statistics across and back."""
    (jctx, jconsts), (tctx, _) = _contexts(flux_theta(16))
    _, sj = _jax_init(jctx, jconsts, 2, 94)
    st = interop.state_from_numpy(_np(sj))
    assert "key" not in st
    assert st["G"].dtype == st["ls_phase"].dtype == torch.complex128
    assert st["ls_imag_count"].dtype == torch.int64
    assert set(tcore.counter_keys(tctx)) <= set(st)
    back = interop.state_to_numpy(st)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(sj[k]), err_msg=k)
    consts = interop.consts_from_numpy({k: np.asarray(v)
                                        for k, v in jconsts.items()})
    assert consts["eT2"].dtype == torch.complex128
    np.testing.assert_array_equal(consts["eT2"].numpy(),
                                  np.asarray(jconsts["eT2"]))
