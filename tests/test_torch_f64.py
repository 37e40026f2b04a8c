"""The strict-float64 route and the unfused Householder QR of the PyTorch/CUDA
port (montecarlo_tpu_torch) against montecarlo_tpu, on the CPU.

Kernels K4 (``qr_householder.qr_f32``) and K11 (``qr_householder.qr_f64``)
run their plain version ``householder_qr_plain`` here; the Pallas kernels
they replace (``pallas_qr._qr_batched`` and ``pallas_qr.qr_lanes_df``) run in
interpret mode, as the JAX package's own tests run them. The float64 site
sweep (``site_sweep.site_sweep_f64``) runs ``site_sweep_plain``. The same
numpy inputs go to both sides; the sweep pairs take the JAX package's
uniforms in visit order (see test_torch_dqmc.py).

Tolerances: K4 within 1e-5 of the largest entry (float32 sums taken in
another order); K11 within 1e-11 (the TPU kernel's double-float arithmetic
carries ~2^-49 per operation, native float64 2^-53); float64 sweep pairs:
identical decisions, G and stacks within 1e-9, as the port's other float64
sweep-pair tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.dqmc import MagnitudeStats as JMagnitudeStats
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.ops import linalg as jl
from montecarlo_tpu.ops import pallas_qr

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.ops import linalg as tl
from montecarlo_tpu_torch.ops import qr_householder as qh
from montecarlo_tpu_torch.ops import site_sweep as ss
from test_torch_dqmc import (_assert_stacks_close, _jax_init, _jax_uniforms,
                             _np, _rel)
from test_torch_linalg import _graded as _graded_np
from test_torch_linalg import _rand_udt, _sign_normalized
from torch_port_inputs import LAMB, MODELS, graded, sweep_inputs


def _close(a, b, tol):
    """max|a - b| <= tol * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b))
    assert err <= tol * np.max(np.abs(b)), (err, np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# K4: float32 Householder QR against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,panel", [(16, 1), (16, 8), (24, None)])
def test_qr_f32_matches_pallas(N, panel):
    """Per-column kernel (panel 1, and auto at N = 24) and the KB=8 panel
    variant: one function, which K4 computes at every N."""
    Ap, _ = graded(N + (panel or 0), 4, N)
    Qj, Rj = pallas_qr._qr_batched(jnp.asarray(Ap.numpy()), panel=panel)
    Qt, Rt = qh.qr_f32(Ap)
    assert Qt.dtype == torch.float32
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))
    rec = Qt.double() @ Rt.double()
    _close(rec, Ap.double(), 1e-5)


def test_qr_f32_zero_columns_match_pallas():
    """Exactly-zero columns: H = I, R_jj = 0, exact zero fill."""
    Ap, _ = graded(7, 2, 16, decades=2.0)
    Ap[:, :, -4:] = 0.0
    Qj, Rj = pallas_qr._qr_batched(jnp.asarray(Ap.numpy()))
    Qt, Rt = qh.qr_f32(Ap)
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    assert torch.equal(Rt[:, -4:, -4:], torch.zeros(2, 4, 4))


def test_qr_f32_subnormal_reflector_stays_finite():
    """A column whose remaining tail has a subnormal v·v: tau = 0 (the TPU's
    flush-to-zero result) instead of 2 / v·v = inf and a NaN matrix."""
    A = torch.eye(16) * 2.0 ** 40
    A[:, 1] = 3e-21                              # v·v ~ 1e-40 at column 1
    Q, R = qh.qr_f32(A[None])
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(torch.tril(R, -1), torch.zeros_like(R))


# ---------------------------------------------------------------------------
# K11: float64 Householder QR against the double-float Pallas kernel
# ---------------------------------------------------------------------------

def _graded_f64(seed, B, N):
    """tests/test_pallas_qr.py::test_df_qr_strict_f64_contract's operands:
    Gaussian columns graded over 36 e-folds, prescaled to a largest entry
    of 2^50."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N)) * np.exp(
        rng.uniform(-18.0, 18.0, (B, 1, N)))
    mx = np.max(np.abs(A), axis=(-2, -1), keepdims=True)
    return A / np.exp2(np.ceil(np.log2(mx)) - 50.0)


@pytest.mark.parametrize("N,zero_tail", [(8, False), (16, False), (16, True)])
def test_qr_f64_matches_pallas_df(N, zero_tail):
    """K11's LAPACK-normalized reflector in float64 against the TPU kernel's
    double-float one: Q and R within 1e-11 of their largest entries; Q
    orthogonal and Q R = A to float64 rounding. zero_tail: an upper
    triangular block (the H = I columns)."""
    A = _graded_f64(N + zero_tail, 3, N)
    if zero_tail:
        A[:, N // 2:, : N // 2] = 0.0
    Qj, Rj = pallas_qr.qr_lanes_df()(jnp.asarray(A))
    Qt, Rt = qh.qr_f64(torch.from_numpy(A))
    assert Qt.dtype == torch.float64
    _close(Qt, Qj, 1e-11)
    _close(Rt, Rj, 1e-11)
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))
    eye = torch.eye(N, dtype=torch.float64)
    assert (Qt.mT @ Qt - eye).abs().max().item() < 1e-13
    _close(Qt @ Rt, A, 1e-12)


@pytest.mark.parametrize("scale", [0.0, 1e-175])
def test_qr_f64_small_column_is_identity_reflector(scale):
    """||x||^2 = 0, or subnormal (a column scaled to ~1e-160 after the 2^50
    prescale): H = I, finite, Q orthogonal and Q R = A to float64
    rounding; R_jj = 0 for the zero column."""
    A = _graded_f64(5, 2, 8)
    A[:, :, 3] *= scale
    Q, R = qh.qr_f64(torch.from_numpy(A))
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    if scale == 0.0:
        assert torch.equal(R[:, 3:, 3], torch.zeros(2, 5, dtype=torch.float64))
    eye = torch.eye(8, dtype=torch.float64)
    assert (Q.mT @ Q - eye).abs().max().item() < 1e-13
    _close(Q @ R, A, 1e-12)


def test_qr_householder_kernel_shapes():
    assert [n for n in range(1, 200) if qh.kernel_supports(n)] == \
        list(range(8, 129, 8))
    assert [n for n in range(1, 200)
            if qh.kernel_supports(n, torch.float64)] == list(range(8, 65, 8))
    assert not qh.kernel_supports(64, torch.complex64)


# ---------------------------------------------------------------------------
# ops/linalg.py: the routes by dtype and the column-scaled UDT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 2, 24, 24)])
def test_udt_dirty_colscaled_matches_jax_f64(use_kernels, shape):
    """K11 (kernel path) or LAPACK (library path) under the column-scaled
    UDT, against the JAX package's: the same pivot, D and the
    sign-normalized U and Rs within 1e-10; A[:, piv] = U D Rs."""
    A = _graded_np(sum(shape) + 1, shape)
    Uj, Dj, Rj, pj = jl.udt_dirty_colscaled(jnp.asarray(A))
    Ut, Dt, Rt, pt = tl.udt_dirty_colscaled(torch.from_numpy(A), use_kernels)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-10)
    for a, b in zip(_sign_normalized(Ut, Rt), _sign_normalized(Uj, Rj)):
        assert _rel(a, b) <= 1e-10
    Ap = np.take_along_axis(A, pt.numpy()[..., None, :], axis=-1)
    assert _rel(((Ut * Dt[..., None, :]) @ Rt).numpy(), Ap) <= 1e-10


@pytest.mark.parametrize("use_kernels", [True, False])
def test_udt_dirty_colscaled_matches_jax_f32(monkeypatch, use_kernels):
    """float32: K4's plain version against the Pallas K4 in interpret mode
    (pallas_qr.ENABLED), or the library QR on both sides: the same pivot, D
    to 1e-5 relative, sign-normalized U and Rs within 1e-5."""
    monkeypatch.setattr(pallas_qr, "ENABLED", use_kernels)
    A = _graded_np(31, (3, 16, 16)).astype(np.float32)
    Uj, Dj, Rj, pj = jl.udt_dirty_colscaled(jnp.asarray(A))
    Ut, Dt, Rt, pt = tl.udt_dirty_colscaled(torch.from_numpy(A), use_kernels)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-5)
    for a, b in zip(_sign_normalized(Ut, Rt), _sign_normalized(Uj, Rj)):
        assert _rel(a, b) <= 1e-5


def test_udt_dirty_routes_by_dtype(monkeypatch):
    """The kernel path's QR: K11 for float64, K4 for float32 at
    64 < N <= 128 and inside the column-scaled UDT, the fused K2 for float32
    at N <= 64; the library path calls none of them."""
    calls = []
    for name in ("qr_f32", "qr_f64", "udt_qr"):
        fn = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])

    def route(A, fn=tl.udt_dirty, use_kernels=True):
        calls.clear()
        fn(torch.from_numpy(A), use_kernels)
        return calls[:]

    A = _graded_np(3, (2, 16, 16))
    assert route(A) == ["qr_f64"]
    assert route(A, tl.udt_dirty_colscaled) == ["qr_f64"]
    assert route(A.astype(np.float32)) == ["udt_qr"]
    assert route(A.astype(np.float32), tl.udt_dirty_colscaled) == ["qr_f32"]
    assert route(_graded_np(4, (1, 72, 72)).astype(np.float32)) == ["qr_f32"]
    assert route(A, use_kernels=False) == []


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("decades", [4.0, 20.0])
def test_calculate_greens_colscaled_matches_jax_f64(use_kernels, decades):
    """calculate_greens with the column-scaled UDT (udt_fn), against the JAX
    package's, within 1e-10."""
    rng = np.random.default_rng(int(decades) + 7)
    l, r = _rand_udt(rng, 3, 16, decades), _rand_udt(rng, 3, 16, decades)
    Gj = jl.calculate_greens(*map(jnp.asarray, l + r),
                             udt_fn=jl.udt_dirty_colscaled)
    Gt = tl.calculate_greens(*map(torch.from_numpy, l + r),
                             use_kernels=use_kernels,
                             udt_fn=tl.udt_dirty_colscaled)
    assert _rel(Gt.numpy(), Gj) <= 1e-10


# ---------------------------------------------------------------------------
# make_context: stab_method and the CUDA route table
# ---------------------------------------------------------------------------

def test_make_context_takes_qr_colscaled():
    model = tmc.HubbardModelAttractive(dims=2, L=2, U=4.0)
    for stab, fn in (("qr", tl.udt_dirty),
                     ("qr_colscaled", tl.udt_dirty_colscaled)):
        ctx, _ = tcore.make_context(model, TParams(beta=1.0), device="cpu",
                                    stab_method=stab)
        assert ctx.stab_method == stab and ctx.greens_udt_fn is fn
    with pytest.raises(ValueError, match="stab_method"):
        tcore.make_context(model, TParams(beta=1.0), device="cpu",
                           stab_method="svd")


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("N,F,dtype,udtype,item", [
    (64, 1, F64, F64, None),      # f64: K1-f64 + K11
    (64, 2, F64, F64, None),
    (16, 1, F64, F32, None),      # mixed: K1 + K11
    (64, 2, F64, F32, None),
    (64, 1, F32, F32, None),      # float32 (both stabilizations): K1 + K2-K4
    (72, 1, F32, F32, None),      # 64 < N <= 128: K1 + K4
    (128, 2, F32, F32, None),
    (72, 1, F64, F64, None),      # float64 beyond N = 64: the library QR
    (256, 1, F64, F64, None),     # float64 past N = 128: K6-f64 + library QR
    (12, 1, F64, F64, None),      # 8 does not divide N: the library QR
    (64, 1, F32, F64, None),      # float64 updates over float32 stacks
    (100, 1, F32, F32, None),     # 8 does not divide N: the library QR
    (9, 2, F32, F32, None),
    (130, 1, F32, F32, None),     # 4 does not divide N: K6 on padded G
    (64, 3, F64, F64, "item 4")])     # no site sweep for F = 3
def test_check_cuda_kernels_real_routes(N, F, dtype, udtype, item):
    """Every QR shape has a route (a kernel, or the library QR where the
    JAX package runs XLA's); each refusal names its item and states the
    limits of the site-sweep kernels that refuse."""
    if item is None:
        tcore._check_cuda_kernels(N, F, 0, dtype, udtype)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}") as e:
        tcore._check_cuda_kernels(N, F, 0, dtype, udtype)
    text = _REFUSAL_TEXT.get((N, F, dtype))
    if text is not None:
        assert text in str(e.value), str(e.value)


# the site-sweep limits each refusal states, by (N, F, stack dtype)
_REFUSAL_TEXT = {
    (64, 3, F64): "K1 takes N <= 128, K6 and K6-f64 beyond in float32 and "
                  "float64, with their buffers in shared memory, G padded "
                  "to a multiple of 8 where 4 does not divide N; both F <= 2"}


C64, C128 = torch.complex64, torch.complex128


@pytest.mark.parametrize("N,dtype,route", [
    (64, F32, "K2/K3"), (16, F32, "K2/K3"), (36, F32, "library"),
    (4, F32, "library"), (72, F32, "K4"), (128, F32, "K4"),
    (100, F32, "library"), (136, F32, "K7"), (256, F32, "K7"),
    (132, F32, "library"), (64, F64, "K11"), (12, F64, "library"),
    (72, F64, "library"), (128, F64, "library"), (64, C64, "K10"),
    (128, C64, "K10"), (100, C64, "library"), (256, C64, "library"),
    (64, C128, "library")])
def test_qr_route(N, dtype, route):
    """One table decides every QR shape (the JAX package's qr_supported,
    maybe_qr and df_qr_ok): a hand kernel where one takes the shape, the
    library QR elsewhere. _fused follows it: K2/K3 only at 8 | N <= 64 in
    float32 (not at N = 36), and _qr calls the route's QR."""
    assert tl.qr_route(N, dtype) == route
    A = torch.zeros(1, N, N, dtype=dtype)
    assert tl._fused(A, True) == (route == "K2/K3")
    assert not tl._fused(A, False)


def test_qr_calls_the_routes_qr(monkeypatch):
    """_qr on the kernel path: K4 for float32 at N = 16 and 72, the library
    QR at N = 36 and 100 (8 ∤ N) and for float64 at N = 72; K11 at N = 16."""
    calls = []
    for name in ("qr_f32", "qr_f64", "_library_qr"):
        fn = getattr(tl, name)

        def spy(A, _f=fn, _n=name):
            calls.append(_n)
            return _f(A)
        monkeypatch.setattr(tl, name, spy)
    for N, dtype, name in ((16, F32, "qr_f32"), (72, F32, "qr_f32"),
                           (36, F32, "_library_qr"),
                           (100, F32, "_library_qr"), (16, F64, "qr_f64"),
                           (72, F64, "_library_qr")):
        calls.clear()
        A = graded(N, 1, N, float64=dtype == F64)[0]
        Q, R = tl._qr(A, True)
        assert calls == [name], (N, dtype)
        assert (Q @ R - A).abs().max() <= 1e-4 * A.abs().max()


# ---------------------------------------------------------------------------
# whole sweep pairs against the JAX package
# ---------------------------------------------------------------------------

def _models(repulsive):
    if repulsive:
        return (jmc.HubbardModelRepulsive(dims=2, L=4, U=4.0),
                tmc.HubbardModelRepulsive(dims=2, L=4, U=4.0))
    return (jmc.HubbardModelAttractive(dims=2, L=4, U=4.0, mu=0.0),
            tmc.HubbardModelAttractive(dims=2, L=4, U=4.0, mu=0.0))


def _pair(dtype, stab_method, repulsive=False, use_pallas=False, seed=15):
    """One sweep pair at 4x4, beta = 1, safe_mult = 5, 4 chains, on the JAX
    side and on the port's kernel path from the same state and uniforms.
    Returns (port state, JAX state, port G_meas, JAX G_meas)."""
    jm, tm = _models(repulsive)
    jdt, tdt = {"f64": (jnp.float64, F64), "f32": (jnp.float32, F32)}[dtype]
    jctx, jconsts = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                       dtype=jdt, stab_method=stab_method,
                                       use_pallas=use_pallas)
    assert jctx.use_pallas == use_pallas
    tctx, tconsts = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                       dtype=tdt, stab_method=stab_method,
                                       device="cpu")
    _, s0 = _jax_init(jctx, jconsts, 4, seed)
    u = _jax_uniforms(s0["key"], 2 * jctx.M, jctx.N, jdt)
    sj, Gmj, _ = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)(s0)
    st, Gmt, _ = tcore.sweep_pair(tctx, tconsts,
                                  interop.state_from_numpy(_np(s0)),
                                  u=torch.from_numpy(u))
    return interop.state_to_numpy(st), _np(sj), Gmt.numpy(), np.asarray(Gmj)


def _same_decisions(st, sj):
    for k in ("conf", "acc", "neg_prob", "prop_err_n"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    for k in tcore.NEG_KEYS:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-12, err_msg=k)
    assert 0 < st["acc"].sum() < 2 * 10 * 16 * 4


@pytest.mark.parametrize("repulsive", [False, True])
def test_sweep_pair_f64_kernel_route_matches_jax(monkeypatch, repulsive):
    """The float64 kernel route (K11 and K1-f64 through their plain
    versions) against the JAX package's XLA float64 path: identical
    decisions, G, G_meas and the stacks within 1e-9."""
    calls = {"qr_f64": 0, "site_sweep_f64": 0}
    for mod, name in ((tl, "qr_f64"), (tcore, "site_sweep_f64")):
        fn = getattr(mod, name)

        def spy(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    st, sj, Gmt, Gmj = _pair("f64", "qr", repulsive)
    assert calls == {"qr_f64": 4 * 2, "site_sweep_f64": 2 * 10}
    _same_decisions(st, sj)
    assert _rel(st["G"], sj["G"]) <= 1e-9
    assert _rel(Gmt, Gmj) <= 1e-9
    _assert_stacks_close(st, sj, 1e-9)
    assert st["prop_err_max"].max() < 1e-9


@pytest.mark.parametrize("repulsive", [False, True])
def test_sweep_pair_colscaled_matches_jax_f64(repulsive):
    """stab_method="qr_colscaled" in float64 (K11's plain version under the
    column-scaled UDT) against the JAX package's: identical decisions, G,
    G_meas and the stacks within 1e-9."""
    st, sj, Gmt, Gmj = _pair("f64", "qr_colscaled", repulsive, seed=16)
    _same_decisions(st, sj)
    assert _rel(st["G"], sj["G"]) <= 1e-9
    assert _rel(Gmt, Gmj) <= 1e-9
    _assert_stacks_close(st, sj, 1e-9)


def test_sweep_pair_colscaled_matches_jax_pallas_f32(monkeypatch):
    """float32 qr_colscaled with the TPU kernels on the JAX side (the Pallas
    site sweep and K4 in interpret mode) against the port's kernel path
    (their plain versions): identical decisions, G within 1e-4."""
    monkeypatch.setattr(pallas_qr, "ENABLED", True)
    st, sj, Gmt, Gmj = _pair("f32", "qr_colscaled", use_pallas=True, seed=17)
    for k in ("conf", "acc", "neg_prob"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert np.max(np.abs(st["G"] - sj["G"])) <= 1e-4
    assert np.max(np.abs(Gmt - Gmj)) <= 1e-4


def test_dqmc_default_dtype_is_float64_on_the_kernel_route():
    """DQMC(model) with its defaults: float64 stacks and updates, the kernel
    path, drift at float64 rounding."""
    sim = tmc.DQMC(tmc.HubbardModelAttractive(dims=2, L=4, U=4.0), beta=1.0,
                   n_chains=4, device="cpu", safe_mult=5, measure_rate=1)
    assert sim.ctx.dtype == sim.ctx.udtype == F64 and sim.ctx.use_kernels
    sim.run(thermalization=1, sweeps=2, verbose=False)
    assert sim.analysis.propagation_error.max < 1e-9
    assert abs(float(sim.observables()["occ"]["occ"].mean.mean()) - 0.5) < 0.1


# ---------------------------------------------------------------------------
# the magnitudes of negative weights in real sessions
# ---------------------------------------------------------------------------

def test_negative_magnitudes_match_jax():
    """float64 F = 2 repulsive-sign inputs with random G, where r_up r_dn < 0
    happens: the JAX package's XLA site loop records log10|detratio| of
    every negative proposal (min, max, sum per chain). The port records the
    same on every float64 route: the plain sweep, K1-f64 (its plain version
    here) and sweep_slice on the kernel and the plain path; the counts are
    identical and the magnitudes within 1e-12. A session's drain then reads
    the JAX package's negative_probability min, geo-mean and max (its real
    sessions read min inf, max 0 and mean 0 before the port recorded
    them)."""
    C, N = 6, 16
    jm, tm = _models(True)
    jctx, _ = jcore.make_context(jm, JParams(beta=1.0, safe_mult=5),
                                 dtype=jnp.float64)
    G, sigma, u = sweep_inputs(170, C, 2, N)
    G, u = G.astype(np.float64), u.astype(np.float64)

    def jax_sweep(G, s, u):
        return jcore.sweep_slice(jctx, G, s, u, jcore.init_local_stats(jctx))

    _, _, lj = jax.jit(jax.vmap(jax_sweep))(
        jnp.asarray(G), jnp.asarray(sigma), jnp.asarray(u))
    lj = {k: np.asarray(v) for k, v in lj.items()}
    assert lj["nneg"].sum() > 0 and np.isfinite(lj["neg_min"]).sum() > 0
    Gt, st, ut = (torch.from_numpy(x) for x in (G, sigma, u))
    kw = dict(lamb=jctx.lamb, **MODELS["repulsive"])
    routes = [ss.site_sweep_plain(Gt, st, ut, **kw),
              ss.site_sweep_f64(Gt, st, ut, **kw)]
    for use_kernels in (True, False):
        tctx, _ = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                     device="cpu", use_kernels=use_kernels)
        routes.append(tcore.sweep_slice(tctx, Gt, st, ut))
    for out in routes:
        np.testing.assert_array_equal(out[3].numpy(), lj["nneg"])
        neg = out[4].numpy()
        for i, k in enumerate(("neg_min", "neg_max", "neg_sum")):
            np.testing.assert_allclose(neg[:, i], lj[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
    sim = tmc.DQMC(tm, beta=1.0, safe_mult=5, n_chains=C, device="cpu",
                   measurements={})
    sim.state.update(neg_prob=routes[-1][3].to(torch.int64),
                     **tcore._track_negative(sim.state, routes[-1][4]))
    sim._drain_counters()
    ref = JMagnitudeStats()
    ref.absorb_device(np.min(lj["neg_min"]), np.max(lj["neg_max"]),
                      np.sum(lj["neg_sum"]), np.sum(lj["nneg"]))
    got = sim.analysis.negative_probability
    assert got.count == ref.count > 0
    for f in ("min", "max", "mean"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-12, err_msg=f)
