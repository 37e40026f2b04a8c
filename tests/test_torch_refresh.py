"""The conservative mode (g_refresh) of the PyTorch/CUDA port
(montecarlo_tpu_torch) against montecarlo_tpu, on the CPU:
``calculate_greens_inv``, the refresh sweep pair (``core._pair_refresh``)
against the JAX package's ``sweep_pair_refresh``, the port's refresh mode
against its own wrap mode, the launch schedule and a short run at half
filling.

Both sides start from the same numpy data and the same uniforms, drawn as
the JAX package draws them (one per slice visit in visit order, see
test_torch_dqmc.py). Tolerances: float64 decisions identical and G_meas
within 1e-10 (relative to max|G|), as the JAX package's own refresh tests
hold float64; float32 G within 1e-3 (its test_refresh_matches_wrap_f32
bound); the drift counts prop_err_n equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_tpu as jmc
from montecarlo_tpu.dqmc import core as jcore
from montecarlo_tpu.dqmc.parameters import DQMCParameters as JParams
from montecarlo_tpu.ops import linalg as jl

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import interop
from montecarlo_tpu_torch.dqmc import core as tcore
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters as TParams
from montecarlo_tpu_torch.ops import linalg as tl
from test_torch_dqmc import _jax_init, _jax_uniforms, _np, _rel
from test_torch_linalg import _rand_udt

F32, F64 = torch.float32, torch.float64
DTYPES = {"f64": (jnp.float64, F64, None, None),
          "f32": (jnp.float32, F32, None, None),
          "mixed": (jnp.float64, F64, jnp.float32, F32)}


# ---------------------------------------------------------------------------
# calculate_greens_inv
# ---------------------------------------------------------------------------

def _inv_factors(seed, B=3, N=16, decades=4.0):
    """Stack-like factors (U, D, T) for both sides whose U is not unitary:
    an orthogonal U times a well-conditioned random matrix, as the refresh
    carries accumulate raw B multiplications between boundaries. Returns
    (Ulinv, Dl, Tl, Urinv, Dr, Tr) and the dense G they define."""
    rng = np.random.default_rng(seed)
    out, dense = [], []
    for _ in range(2):
        U, D, T = _rand_udt(rng, B, N, decades)
        U = U @ (np.eye(N) + 0.3 / np.sqrt(N) * rng.normal(size=(B, N, N)))
        out += [np.linalg.inv(U), D, T]
        dense.append(U @ (D[..., :, None] * T))
    G = np.linalg.inv(np.eye(N) + dense[0] @ np.swapaxes(dense[1], -1, -2))
    return out, G


@pytest.mark.parametrize("use_kernels", [True, False])
def test_calculate_greens_inv_matches_jax_f64(use_kernels):
    """float64 (K11's plain version, or the library QR) against the JAX
    package's calculate_greens_inv and the dense inverse: within 1e-12 of
    max|G|; for unitary factors it equals calculate_greens of U^H."""
    args, G = _inv_factors(1)
    ref = np.asarray(jl.calculate_greens_inv(*map(jnp.asarray, args)))
    out = tl.calculate_greens_inv(*map(torch.from_numpy, args), use_kernels)
    assert _rel(out.numpy(), ref) <= 1e-12
    assert _rel(out.numpy(), G) <= 1e-12
    rng = np.random.default_rng(2)
    Ul, Dl, Tl = _rand_udt(rng, 3, 16, 4.0)
    Ur, Dr, Tr = _rand_udt(rng, 3, 16, 4.0)
    t = lambda *a: [torch.from_numpy(x) for x in a]
    inv = tl.calculate_greens_inv(*t(np.swapaxes(Ul, -1, -2), Dl, Tl,
                                     np.swapaxes(Ur, -1, -2), Dr, Tr),
                                  use_kernels)
    plain = tl.calculate_greens(*t(Ul, Dl, Tl, Ur, Dr, Tr), use_kernels)
    assert _rel(inv.numpy(), plain.numpy()) <= 1e-12


def test_calculate_greens_inv_matches_jax_f32():
    """float32 on the plain path (the library QR and solve) against the JAX
    package's jnp path on the same float32 factors, and the kernel path
    (K3's plain version, Ur^{-H} / Drp as its right-hand side) beside
    them: within 1e-4 of max|G| at four decades of grading."""
    args, G = _inv_factors(3)
    args = [a.astype(np.float32) for a in args]
    ref = np.asarray(jl.calculate_greens_inv(*map(jnp.asarray, args)))
    for use_kernels in (False, True):
        out = tl.calculate_greens_inv(*map(torch.from_numpy, args),
                                      use_kernels)
        assert out.dtype == F32
        assert _rel(out.numpy(), ref) <= 1e-4, use_kernels
        assert _rel(out.numpy(), G) <= 1e-4, use_kernels


def test_calculate_greens_inv_routes(monkeypatch):
    """K3 on the "K2/K3" route with udt_dirty, never with the column-scaled
    UDT (whose QR is K4's) nor at 8 ∤ N (the library QR)."""
    calls = {"udt_qr_solve": 0, "qr_f32": 0}
    for name in calls:
        fn = getattr(tl, name)

        def spy(*a, _f=fn, _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(tl, name, spy)

    def run(N, udt_fn=None):
        for k in calls:
            calls[k] = 0
        args, _ = _inv_factors(4, B=2, N=N)
        tl.calculate_greens_inv(
            *(torch.from_numpy(a.astype(np.float32)) for a in args),
            True, udt_fn)
        return dict(calls)

    assert run(16) == {"udt_qr_solve": 1, "qr_f32": 0}
    assert run(16, tl.udt_dirty_colscaled) == {"udt_qr_solve": 0,
                                               "qr_f32": 1}
    assert run(12) == {"udt_qr_solve": 0, "qr_f32": 0}


# ---------------------------------------------------------------------------
# refresh sweep pairs against the JAX package
# ---------------------------------------------------------------------------

def _models(theta=None):
    if theta is not None:       # tests/test_g_refresh.py's complex session
        kw = dict(dims=1, L=4, U=4.0, mu=0.0, peierls=theta)
    else:                       # tests/test_g_refresh.py's _mk
        kw = dict(dims=2, L=2, U=4.0)
    return jmc.HubbardModelAttractive(**kw), tmc.HubbardModelAttractive(**kw)


def _contexts(dtype, g_refresh=True, stab_method="qr", theta=None,
              beta=2.0):
    jm, tm = _models(theta)
    jdt, tdt, jud, tud = DTYPES[dtype]
    jctx, jconsts = jcore.make_context(
        jm, JParams(beta=beta, delta_tau=0.1, safe_mult=5), dtype=jdt,
        update_dtype=jud, stab_method=stab_method, g_refresh=g_refresh)
    tctx, tconsts = tcore.make_context(
        tm, TParams(beta=beta, delta_tau=0.1, safe_mult=5), dtype=tdt,
        update_dtype=tud, stab_method=stab_method, g_refresh=g_refresh,
        device="cpu")
    assert jctx.g_refresh == tctx.g_refresh == g_refresh
    return (jctx, jconsts), (tctx, tconsts)


def _pairs(jside, tside, n_pairs, seed):
    """n_pairs sweep pairs on both sides from one JAX init_state, each pair
    with the JAX chain keys' uniforms. Returns per pair (port state, JAX
    state, port G_meas, JAX G_meas), as numpy."""
    (jctx, jconsts), (tctx, tconsts) = jside, tside
    _, sj = _jax_init(jctx, jconsts, 4, seed)
    st = interop.state_from_numpy(_np(sj))
    fj = jcore.jitted_vmapped("sweep_pair", jctx, jconsts)
    out = []
    for _ in range(n_pairs):
        u = _jax_uniforms(sj["key"], 2 * jctx.M, jctx.N,
                          jnp.dtype(jctx.urdtype))
        sj, Gmj, _ = fj(sj)
        st, Gmt, _ = tcore.sweep_pair(tctx, tconsts, st,
                                      u=torch.from_numpy(u))
        out.append((interop.state_to_numpy(st), _np(sj), Gmt.numpy(),
                    np.asarray(Gmj)))
    return out


@pytest.mark.parametrize("dtype,stab_method,n_pairs", [
    ("f64", "qr", 1), ("f64", "qr", 3), ("f64", "qr_colscaled", 1),
    ("mixed", "qr", 1)])
def test_refresh_pair_matches_jax(dtype, stab_method, n_pairs):
    """float64 (K11's plain version; under qr_colscaled the unfused UDT)
    and mixed precision (float64 carries, float32 G: calculate_greens_inv's
    result cast to the update dtype): after each pair the decisions and the
    drift counts equal the JAX package's, G_meas and the turnaround G
    within 1e-10 (mixed: 1e-4) of max|G|; both sides' drift maxima below
    1e-11 (mixed: 1e-5)."""
    jside, tside = _contexts(dtype, stab_method=stab_method)
    tol = 1e-4 if dtype == "mixed" else 1e-10
    for st, sj, Gmt, Gmj in _pairs(jside, tside, n_pairs, seed=21):
        for k in ("conf", "acc", "neg_prob", "prop", "prop_err_n",
                  "prop_err_count", "prop_err_hist"):
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
        assert _rel(Gmt, Gmj) <= tol
        assert _rel(st["G"], sj["G"]) <= tol
        # the drift maxima are rounding of either side: bounded, not equal
        assert max(st["prop_err_max"].max(), sj["prop_err_max"].max()) < (
            1e-5 if dtype == "mixed" else 1e-11)
    M = tside[0].M
    assert np.all(st["prop_err_n"] == 2 * M * n_pairs)


def test_refresh_pair_matches_jax_f32():
    """float32 (the library QR at N = 4 on both sides): G_meas and the
    turnaround G within the JAX package's 1e-3, the drift counts equal."""
    jside, tside = _contexts("f32")
    [(st, sj, Gmt, Gmj)] = _pairs(jside, tside, 1, seed=22)
    np.testing.assert_array_equal(st["prop_err_n"], sj["prop_err_n"])
    assert np.max(np.abs(Gmt - Gmj)) < 1e-3
    assert np.max(np.abs(st["G"] - sj["G"])) < 1e-3


def test_refresh_pair_matches_jax_complex():
    """tests/test_g_refresh.py's complex session (a 4-site ring with
    pure-gauge Peierls phases, complex128) at beta = 1: decisions and drift
    counts equal, G_meas within 1e-10, the running weight phase within
    1e-10."""
    N = 4
    phis = np.linspace(0.0, 1.1, N)
    theta = phis[:, None] - phis[None, :]
    jside, tside = _contexts("f64", theta=theta, beta=1.0)
    assert tside[0].dtype == torch.complex128
    [(st, sj, Gmt, Gmj)] = _pairs(jside, tside, 1, seed=23)
    for k in ("conf", "acc", "prop_err_n"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert np.max(np.abs(Gmt - Gmj)) <= 1e-10 * np.max(np.abs(Gmj))
    assert np.max(np.abs(st["ls_phase"] - sj["ls_phase"])) <= 1e-10


def test_refresh_matches_wrap_f64():
    """The port's own modes, as tests/test_g_refresh.py holds the JAX
    package's: from one state and the same uniforms, three float64 refresh
    pairs take the decisions of three wrap pairs, G_meas within 1e-9."""
    (_, (ctx_w, consts)), (_, (ctx_r, _)) = (
        _contexts("f64", g_refresh=False), _contexts("f64"))
    conf = _models()[1].rand_conf(torch.Generator().manual_seed(3), 4,
                                  ctx_w.M)
    sw = sr = tcore.init_state(ctx_w, consts, conf)
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):
        u = torch.rand((4, 2 * ctx_w.M, ctx_w.N), generator=gen,
                       dtype=torch.float64)
        sw, Gw, cw = tcore.sweep_pair(ctx_w, consts, sw, u=u)
        sr, Gr, cr = tcore.sweep_pair(ctx_r, consts, sr, u=u)
    assert torch.equal(cw, cr)
    assert 0 < int(sr["acc"].sum()) < int(sr["prop"].sum())
    assert (Gw - Gr).abs().max().item() < 1e-9
    assert sr["prop_err_max"].max().item() < 1e-9


# ---------------------------------------------------------------------------
# the launch schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g_refresh", [False, True])
def test_pair_launch_schedule(monkeypatch, g_refresh):
    """On the K2/K3 route (float32, N = 16, stab_method "qr") one sweep
    pair runs pair_udt_launches' K2 (udt_qr) and K3 (udt_qr_solve) calls
    and one K1 per slice visit: wrap (4, 4), refresh (4, 2M + 1 = 21) at
    M = 10, safe_mult 5; the headline's refresh pair (M = 100) (40, 201)."""
    calls = {"udt_qr": 0, "udt_qr_solve": 0, "site_sweep": 0}
    for mod, name in ((tl, "udt_qr"), (tl, "udt_qr_solve"),
                      (tcore, "site_sweep")):
        fn = getattr(mod, name)

        def spy(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    tm = tmc.HubbardModelAttractive(dims=2, L=4, U=4.0)
    ctx, consts = tcore.make_context(tm, TParams(beta=1.0, safe_mult=5),
                                     dtype=F32, device="cpu",
                                     g_refresh=g_refresh)
    conf = tm.rand_conf(torch.Generator().manual_seed(5), 2, ctx.M)
    state = tcore.init_state(ctx, consts, conf)
    for k in calls:
        calls[k] = 0
    tcore.sweep_pair(ctx, consts, state,
                     generator=torch.Generator().manual_seed(6))
    udt, greens = tcore.pair_udt_launches(ctx)
    assert (udt, greens) == ((4, 21) if g_refresh else (4, 4))
    assert calls == {"udt_qr": udt, "udt_qr_solve": greens,
                     "site_sweep": 2 * ctx.M}
    head, _ = tcore.make_context(tm, TParams(beta=10.0, safe_mult=5),
                                 dtype=F32, device="cpu",
                                 g_refresh=g_refresh)
    assert tcore.pair_udt_launches(head) == ((40, 201) if g_refresh
                                             else (40, 40))


# ---------------------------------------------------------------------------
# DQMC.run
# ---------------------------------------------------------------------------

def test_refresh_end_to_end_half_filling():
    """tests/test_g_refresh.py's end-to-end run on the port (2x2, beta = 2,
    safe_mult 5, 8 chains, float64, 15 + 30 sweeps): occupation within
    0.04 of 1/2, drift below 1e-9, 2M drift checks per chain and pair."""
    sim = tmc.DQMC(_models()[1], beta=2.0, delta_tau=0.1, safe_mult=5,
                   n_chains=8, seed=3, g_refresh=True, device="cpu",
                   measure_rate=1)
    assert sim.ctx.g_refresh
    sim.run(thermalization=15, sweeps=30, verbose=False)
    occ = float(np.mean(sim.observables()["occ"]["occ"].mean))
    assert abs(occ - 0.5) < 0.04
    assert sim.analysis.propagation_error.max < 1e-9
    assert sim.analysis.prop_err_n == 8 * 45 * 2 * sim.ctx.M
