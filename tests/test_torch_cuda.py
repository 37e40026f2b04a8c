"""The CUDA halves of the PyTorch/CUDA port's tests: each hand-written kernel
against its plain PyTorch version on the card, the wrappers' input checks,
and a CUDA session's refusal of shapes that have no kernel.

Every test carries the ``cuda`` marker and skips without a card. The file
imports neither JAX nor the JAX package, so it runs on a GPU machine without
JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch.dqmc import core
from montecarlo_tpu_torch.dqmc.parameters import DQMCParameters
from montecarlo_tpu_torch.ops import qr, qr_blocked as qb
from montecarlo_tpu_torch.ops import qr_cx as qcx
from montecarlo_tpu_torch.ops import qr_householder as qh
from montecarlo_tpu_torch.ops import site_sweep as ss
from montecarlo_tpu_torch.ops import site_sweep_cx as sscx
from montecarlo_tpu_torch.ops import site_sweep_delayed as ssd
from montecarlo_tpu_torch.ops import site_sweep_delayed_cx as ssdcx
from torch_port_inputs import (LAMB, MODELS, accept_patterns,
                               cx_sweep_inputs, flux_theta, graded,
                               pair_inputs, sweep_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see README: PyTorch/CUDA port)")
    return torch.device("cuda")


def _close(a, b, tol):
    """max|a - b| <= tol * max|b|."""
    err = (a - b).abs().max().item()
    assert err <= tol * b.abs().max().item(), err


@pytest.mark.parametrize("model,N", [("attractive", 64), ("repulsive", 64),
                                     ("attractive", 128), ("repulsive", 128),
                                     ("attractive", 20)])
def test_site_sweep_kernel_matches_plain(cuda, model, N):
    """Decisions identical; G equal to 1e-5 (the kernel rounds every
    operation as the plain version does, so it is bit-equal in practice)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in sweep_inputs(N, 16, F, N))
    n0 = ss.site_sweep.launches
    out_k = ss.site_sweep(G, sigma, u, **kw)
    assert ss.site_sweep.launches == n0 + 1
    out_p = ss.site_sweep_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b.to(a.dtype))
    assert 0 < out_k[2].sum().item() < 16 * N
    assert (out_k[0] - out_p[0]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("model,N", [("attractive", 16), ("repulsive", 16),
                                     ("attractive", 64), ("repulsive", 64),
                                     ("attractive", 128), ("repulsive", 128)])
def test_site_sweep_pair_kernel_matches_plain_and_k1(cuda, model, N):
    """K5 against its plain version and against K1 on the same inputs:
    sigma, acc, nneg and G bit-equal (every operation is K1's _rn operation
    in K1's order); every accept pattern of a pair occurs."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in pair_inputs(N + 80, 8, F, N))
    n5, n1 = ss.site_sweep_pair.launches, ss.site_sweep.launches
    out_k = ss.site_sweep_pair(G, sigma, u, **kw)
    assert ss.site_sweep_pair.launches == n5 + 1
    out_1 = ss.site_sweep(G, sigma, u, **kw)
    assert ss.site_sweep.launches == n1 + 1
    out_p = ss.site_sweep_pair_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(out_k, out_p, out_1):
        assert torch.equal(a, b.to(a.dtype)) and torch.equal(a, c)
    assert accept_patterns(sigma.cpu(), out_k[1].cpu()) == {
        (False, False), (False, True), (True, False), (True, True)}


@pytest.mark.parametrize("F,N", [(1, 128), (2, 128), (2, 64)])
def test_site_sweep_pair_and_f64_repeat_bit_equal(cuda, F, N):
    """K5 and K1 in float64 relaunched on the same inputs give outputs
    bit-equal to their first launch (a race between the block's threads
    over the staging buffers would show as a difference)."""
    model = "attractive" if F == 1 else "repulsive"
    kw = dict(lamb=LAMB, **MODELS[model])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in pair_inputs(N + 30, 16, F, N))
    G64, u64 = G.double(), u.double()
    first = ss.site_sweep_pair(G, sigma, u, **kw)
    first64 = ss.site_sweep_f64(G64, sigma, u64, **kw)
    for _ in range(10):
        for a, b in zip(first, ss.site_sweep_pair(G, sigma, u, **kw)):
            assert torch.equal(a, b)
        for a, b in zip(first64, ss.site_sweep_f64(G64, sigma, u64, **kw)):
            assert torch.equal(a, b)


def test_repulsive_session_launches_k5(cuda):
    """A float32 or mixed repulsive session at even N runs its site sweeps
    through K5 and never through K1."""
    model = tmc.HubbardModelRepulsive(dims=2, L=4, U=4.0)
    params = DQMCParameters(beta=1.0, safe_mult=5)
    for kw in (dict(dtype=torch.float32),
               dict(dtype=torch.float64, update_dtype=torch.float32)):
        ctx, consts = core.make_context(model, params, device="cuda", **kw)
        conf = model.rand_conf(torch.Generator(device="cuda").manual_seed(0),
                               4, params.slices)
        state = core.init_state(ctx, consts, conf)
        n5, n1 = ss.site_sweep_pair.launches, ss.site_sweep.launches
        core.sweep_pair(ctx, consts, state,
                        generator=torch.Generator(device="cuda").manual_seed(1))
        assert ss.site_sweep_pair.launches - n5 == 2 * ctx.M
        assert ss.site_sweep.launches == n1


@pytest.mark.parametrize("model,N,dk", [
    ("attractive", 256, 32), ("repulsive", 256, 32), ("attractive", 144, 24),
    ("attractive", 144, 1), ("repulsive", 136, 8),
    # 4 does not divide N: G padded to a multiple of 8
    ("attractive", 169, 1), ("repulsive", 130, 1), ("attractive", 225, 15)])
def test_site_sweep_delayed_kernel_matches_plain(cuda, model, N, dk):
    """Decisions identical; G equal to 1e-5 of its largest entry (the kernel
    rounds every decision, slab and fold operation as the plain version
    does and folds in the same order, so it is bit-equal in practice; the
    zero pad rows and columns never enter a real entry)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in sweep_inputs(N + dk, 8, F, N))
    n0 = ssd.site_sweep_delayed.launches
    out_k = ssd.site_sweep_delayed(G, sigma, u, dk=dk, **kw)
    assert ssd.site_sweep_delayed.launches == n0 + 1
    out_p = ssd.site_sweep_delayed_plain(G, sigma, u, dk=dk, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:4], out_p[1:4]):
        assert torch.equal(a, b.to(a.dtype))
    assert out_k[4] is None
    assert 0 < out_k[2].sum().item() < 8 * N
    _close(out_k[0], out_p[0], 1e-5)


# (chains, model, N, dk, blocks per chain): None runs cluster_plan's
# layout; 160 chains at CS = 2 are 320 blocks, more than one wave of
# clusters
DELAYED_LAYOUTS = [
    (160, "attractive", 256, 32, None), (1, "attractive", 256, 32, None),
    (8, "attractive", 256, 32, 4), (8, "attractive", 256, 32, 1),
    (8, "repulsive", 256, 32, None), (8, "repulsive", 256, 32, 4),
    (8, "repulsive", 136, 8, None), (8, "attractive", 144, 16, None),
    (8, "attractive", 256, 1, None), (8, "attractive", 256, 64, None)]


@pytest.mark.parametrize("chains,model,N,dk,cs", DELAYED_LAYOUTS)
def test_site_sweep_delayed_layouts_match_plain(cuda, chains, model, N, dk,
                                               cs):
    """K6 in each layout cluster_plan can pick (and at chain counts of one
    and of more than one wave of clusters): decisions identical to the plain
    version's, G within 1e-5 of its largest entry (bit-equal in practice);
    the wrapper takes cluster_plan's layout."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in sweep_inputs(N + dk + chains, chains, F, N))
    n0 = ssd.site_sweep_delayed.launches
    out_k = (ssd.site_sweep_delayed(G, sigma, u, dk=dk, **kw) if cs is None
             else ssd.launch(G, sigma, u, ssd.cluster_layout(N, F, dk, cs),
                             dk=dk, **kw))
    assert ssd.site_sweep_delayed.launches == n0 + 1
    out_p = ssd.site_sweep_delayed_plain(G, sigma, u, dk=dk, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:4], out_p[1:4]):
        assert torch.equal(a, b.to(a.dtype))
    assert out_k[4] is None
    assert 0 < out_k[2].sum().item() < chains * N
    _close(out_k[0], out_p[0], 1e-5)


@pytest.mark.parametrize("N", [136, 144, 256])
def test_qr_blocked_kernel_matches_plain(cuda, N):
    """Q and R within 1e-5 of their largest entries on graded, prescaled,
    pivoted input (the kernel sums in another order than the plain
    version's library products); R exactly upper triangular."""
    Ap, _ = (t.to(cuda) for t in graded(N, 16, N))
    n0 = qb.qr_blocked.launches
    Qk, Rk = qb.qr_blocked(Ap)
    assert qb.qr_blocked.launches == n0 + 1
    Qp, Rp = qb.qr_blocked_plain(Ap)
    _close(Qk, Qp, 1e-5)
    _close(Rk, Rp, 1e-5)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))


def test_qr_blocked_kernel_zero_and_subnormal_columns(cuda):
    """A zero column gets tau = 0 and R_jj = 0; a subnormal v.v gets tau = 0,
    not inf."""
    Ap, _ = (t.to(cuda) for t in graded(5, 4, 136, decades=2.0))
    Ap[:, :, -4:] = 0.0
    Ap[:, :, 1] = Ap[:, :, 1] * 1e-35
    Q, R = qb.qr_blocked(Ap)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(R[:, -4:, -4:], torch.zeros_like(R[:, -4:, -4:]))
    _close(Q, qb.qr_blocked_plain(Ap)[0], 1e-5)


@pytest.mark.parametrize("B", [1, 32, 256, 512])
@pytest.mark.parametrize("N", [8, 16, 24, 32, 40, 48, 56, 64])
def test_udt_kernels_match_plain(cuda, N, B):
    """K2 and K3 at every N they take, one matrix to the repulsive model's
    512, columns graded over 16 decades (chip_smoke.py's range)."""
    Ap, mx = (t.to(cuda) for t in graded(N, B, N, decades=16.0))
    Z = torch.randn(B, N, N, device=cuda)
    n2, n3 = qr.udt_qr.launches, qr.udt_qr_solve.launches
    Qk, Rk, dk = qr.udt_qr(Ap, mx)
    Qp, Rp, dp = qr.udt_qr_plain(Ap, mx)
    _close(Qk, Qp, 1e-5)
    _close(Rk, Rp, 1e-5)
    np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(), rtol=1e-5)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))
    Qk, Xk = qr.udt_qr_solve(Ap, Z, mx)
    Qp, Xp = qr.udt_qr_solve_plain(Ap, Z, mx)
    _close(Qk, Qp, 1e-5)
    _close(Xk, Xp, 1e-5)
    assert (qr.udt_qr.launches, qr.udt_qr_solve.launches) == (n2 + 1, n3 + 1)


@pytest.mark.parametrize("decades", [2.0, 8.0])
def test_udt_kernels_match_plain_mild_grading(cuda, decades):
    """K2 and K3 on columns graded over fewer decades, at the headline's
    (256, 64, 64): the dots of the trailing columns do not vanish."""
    Ap, mx = (t.to(cuda) for t in graded(7, 256, 64, decades=decades))
    Z = torch.randn(256, 64, 64, device=cuda)
    Qk, Rk, dk = qr.udt_qr(Ap, mx)
    Qp, Rp, dp = qr.udt_qr_plain(Ap, mx)
    _close(Qk, Qp, 1e-5)
    _close(Rk, Rp, 1e-5)
    np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(), rtol=1e-5)
    Qk, Xk = qr.udt_qr_solve(Ap, Z, mx)
    Qp, Xp = qr.udt_qr_solve_plain(Ap, Z, mx)
    _close(Qk, Qp, 1e-5)
    _close(Xk, Xp, 1e-5)


def test_udt_kernel_flushed_and_subnormal_columns(cuda):
    """Zero columns get R_jj = +floor (unit normalized diagonal); a subnormal
    v.v gets tau = 0, not inf."""
    Ap, mx = (t.to(cuda) for t in graded(4, 4, 16, decades=2.0))
    Ap[:, :, -4:] = 0.0
    Ap[:, :, 1] = Ap[:, :, 1] * 1e-35
    Q, Rs, d = qr.udt_qr(Ap, mx)
    assert all(bool(torch.isfinite(t).all()) for t in (Q, Rs, d))
    diag = torch.diagonal(Rs, dim1=-2, dim2=-1)
    assert torch.equal(diag[:, -4:], torch.ones_like(diag[:, -4:]))
    _close(Q, qr.udt_qr_plain(Ap, mx)[0], 1e-5)


@pytest.mark.parametrize("model,N", [("attractive", 64), ("repulsive", 64),
                                     ("attractive", 128), ("attractive", 20)])
def test_site_sweep_cx_kernel_matches_plain(cuda, model, N):
    """Complex64 K8: sigma, accept and det identical; G equal to 1e-5 (the
    kernel rounds every operation as the plain version does, so it is
    bit-equal in practice)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in cx_sweep_inputs(N, 16, F, N))
    n0 = sscx.site_sweep_cx.launches
    out_k = sscx.site_sweep_cx(G, sigma, u, **kw)
    assert sscx.site_sweep_cx.launches == n0 + 1
    out_p = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert 0 < out_k[2].sum().item() < 16 * N
    assert (out_k[0] - out_p[0]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("N", [8, 16, 40, 64])
def test_qr_cx_kernel_matches_plain(cuda, N):
    """Complex64 K10 on graded, prescaled, pivoted input: the
    phase-normalized Q and R within 1e-5 of their largest entries against
    its plain version and against the forward accumulation (the raw ones
    differ where rounding turns the phase of a small alpha, see
    qr_cx.phase_normalized); R exactly upper triangular."""
    Ap, _ = (t.to(cuda) for t in graded(N, 32, N, complex_=True))
    n0 = qcx.qr_cx.launches
    Qk, Rk = qcx.qr_cx(Ap)
    assert qcx.qr_cx.launches == n0 + 1
    ref = qcx.phase_normalized(Qk, Rk)
    for plain in (qcx.qr_cx_backward_plain, qcx.qr_cx_plain):
        for a, b in zip(ref, qcx.phase_normalized(*plain(Ap))):
            _close(a, b, 1e-5)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))


def test_qr_cx_kernel_zero_and_subnormal_columns(cuda):
    """A zero column gets tau = 0 and R_jj = 0; a subnormal v^H v gets
    tau = 0, not inf."""
    Ap, _ = (t.to(cuda) for t in graded(5, 4, 16, decades=2.0, complex_=True))
    Ap[:, :, -4:] = 0.0
    Ap[:, :, 1] = Ap[:, :, 1] * 1e-35
    Q, R = qcx.qr_cx(Ap)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(R[:, -4:, -4:], torch.zeros_like(R[:, -4:, -4:]))
    _close(qcx.phase_normalized(Q, R)[0],
           qcx.phase_normalized(*qcx.qr_cx_backward_plain(Ap))[0], 1e-5)


@pytest.mark.parametrize("model,N,dk", [
    ("attractive", 256, 1), ("attractive", 256, 8), ("attractive", 256, 32),
    ("attractive", 144, 1), ("attractive", 144, 8), ("attractive", 144, 16),
    ("repulsive", 144, 8),
    # 8 does not divide N (G padded), and F = 2 at N = 256, dk = 32 (two
    # column passes)
    ("attractive", 196, 1), ("repulsive", 132, 1), ("attractive", 225, 1),
    ("repulsive", 256, 32)])
def test_site_sweep_delayed_cx_kernel_matches_plain(cuda, model, N, dk):
    """Complex64 K9: sigma, accept and det identical to its plain version's
    and to K8's plain rank-1 sweep on the same inputs (the same Markov
    chain, every value K8's operation in K8's order); G within 1e-5 of its
    largest entry (bit-equal in practice)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in cx_sweep_inputs(N + dk, 8, F, N))
    n0 = ssdcx.site_sweep_delayed_cx.launches
    out_k = ssdcx.site_sweep_delayed_cx(G, sigma, u, dk=dk, **kw)
    assert ssdcx.site_sweep_delayed_cx.launches == n0 + 1
    out_p = ssdcx.site_sweep_delayed_cx_plain(G, sigma, u, dk=dk, **kw)
    out_8 = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(out_k[1:], out_p[1:], out_8[1:]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert 0 < out_k[2].sum().item() < 8 * N
    _close(out_k[0], out_p[0], 1e-5)
    _close(out_k[0], out_8[0], 1e-5)


CX_DELAYED_LAYOUTS = [
    (160, "attractive", 256, 32, None), (1, "attractive", 256, 32, None),
    (8, "attractive", 256, 32, 4), (8, "attractive", 256, 32, 1),
    (8, "attractive", 144, 16, 4), (8, "repulsive", 256, 16, None),
    (8, "repulsive", 256, 16, 1), (8, "repulsive", 136, 8, None),
    (8, "repulsive", 144, 24, None)]


@pytest.mark.parametrize("chains,model,N,dk,cs", CX_DELAYED_LAYOUTS)
def test_site_sweep_delayed_cx_layouts_match_plain(cuda, chains, model, N, dk,
                                                  cs):
    """Complex64 K9 in each layout cluster_plan can pick (and at one chain
    and more than one wave of clusters): sigma, accept and det identical to
    its plain version's, G within 1e-5 of its largest entry."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in cx_sweep_inputs(N + dk + chains, chains, F, N))
    n0 = ssdcx.site_sweep_delayed_cx.launches
    out_k = (ssdcx.site_sweep_delayed_cx(G, sigma, u, dk=dk, **kw)
             if cs is None else ssdcx.launch(
                 G, sigma, u, ssdcx.cluster_layout(N, F, dk, cs), dk=dk,
                 **kw))
    assert ssdcx.site_sweep_delayed_cx.launches == n0 + 1
    out_p = ssdcx.site_sweep_delayed_cx_plain(G, sigma, u, dk=dk, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert 0 < out_k[2].sum().item() < chains * N
    _close(out_k[0], out_p[0], 1e-5)


@pytest.mark.parametrize("N", [72, 96, 128])
def test_qr_cx_wide_kernel_matches_plain(cuda, N):
    """Complex64 K10 past N = 64 (Q formed backward from the packed
    reflectors, as at every N) on graded, prescaled, pivoted input: the phase-normalized Q
    and R within 1e-5 of their largest entries against its plain version
    and against the forward accumulation; R exactly upper triangular."""
    Ap, _ = (t.to(cuda) for t in graded(N, 32, N, complex_=True))
    n0 = qcx.qr_cx.launches
    Qk, Rk = qcx.qr_cx(Ap)
    assert qcx.qr_cx.launches == n0 + 1
    ref = qcx.phase_normalized(Qk, Rk)
    for plain in (qcx.qr_cx_backward_plain, qcx.qr_cx_plain):
        for a, b in zip(ref, qcx.phase_normalized(*plain(Ap))):
            _close(a, b, 1e-5)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))


@pytest.mark.parametrize("N", [72, 96, 128])
def test_qr_cx_wide_kernel_zero_and_subnormal_columns(cuda, N):
    """Past N = 64 as below it: a zero column gets tau = 0 and R_jj = 0, a
    subnormal v^H v tau = 0; the factors stay finite, QR = A and Q is
    unitary to 1e-5."""
    Ap, _ = (t.to(cuda) for t in graded(N + 5, 4, N, decades=2.0,
                                        complex_=True))
    Ap[:, :, -4:] = 0.0
    Ap[:, :, 1] = Ap[:, :, 1] * 1e-35
    Q, R = qcx.qr_cx(Ap)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(R[:, -4:, -4:], torch.zeros_like(R[:, -4:, -4:]))
    wide = torch.complex128
    Qd, Rd, Ad = Q.to(wide), R.to(wide), Ap.to(wide)
    _close(Qd @ Rd, Ad, 1e-5)
    eye = torch.eye(N, dtype=wide, device=cuda)
    assert (Qd.mH @ Qd - eye).abs().max().item() <= 1e-5


@pytest.mark.parametrize("N", [8, 64, 120, 128])
def test_qr_cx_kernel_matches_blocked_plain(cuda, N):
    """The blocked K10 with 256 threads (N <= 64: one panel of 8, eight
    panels) and 512 (N = 120, 128) against its plain version with the same
    panels: the phase-normalized Q and R within 1e-5
    of their largest entries; R exactly upper triangular, QR = A and
    Q^H Q = I to 1e-5."""
    Ap, _ = (t.to(cuda) for t in graded(N + 1, 24, N, complex_=True))
    Qk, Rk = qcx.qr_cx(Ap)
    for a, b in zip(qcx.phase_normalized(Qk, Rk),
                    qcx.phase_normalized(*qcx.qr_cx_blocked_plain(Ap))):
        _close(a, b, 1e-5)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))
    wide = torch.complex128
    Qd, Rd, Ad = Qk.to(wide), Rk.to(wide), Ap.to(wide)
    _close(Qd @ Rd, Ad, 1e-5)
    eye = torch.eye(N, dtype=wide, device=cuda)
    assert (Qd.mH @ Qd - eye).abs().max().item() <= 1e-5


def test_qr_cx_refuses_another_panel_width(cuda):
    """qr_cx_c64 runs only at the panel width of qr_cx.PANEL, which its
    plain version uses: another width is refused, and nothing is written."""
    from montecarlo_tpu_torch.ops import _build
    A = torch.eye(64, dtype=torch.complex64, device=cuda)[None].contiguous()
    Q, R = torch.zeros_like(A), torch.zeros_like(A)
    for kb in (2 * qcx.PANEL, qcx.PANEL // 2):
        code = _build.load().qr_cx_c64(
            A.data_ptr(), Q.data_ptr(), R.data_ptr(), 1, 64, kb,
            torch.cuda.current_stream().cuda_stream)
        assert code != 0
    torch.cuda.synchronize()
    assert not Q.any() and not R.any()


@pytest.mark.parametrize("B,N", [(16, 256), (64, 256), (80, 256), (8, 136),
                                 (70, 136), (4, 264), (4, 512), (2, 1424)])
def test_qr_blocked_layouts_match_plain(cuda, B, N):
    """K7 in both cluster sizes (1 and 2 blocks per matrix) against its
    plain version and the forward-Q reference, Q and R within 1e-5 of their
    largest entries, R exactly upper triangular; cluster_plan's choice runs
    through qr_blocked and counts one launch. Past 256 rows a panel keeps
    its columns in shared memory (N = 264, 512, 1424: the first panels);
    N = 1424 stages chunks of 4 columns in one buffer."""
    Ap, _ = (t.to(cuda) for t in graded(B + N, B, N))
    cs = qb.cluster_plan(N, B)
    assert cs == (2 if B <= 66 else 1)
    n0 = qb.qr_blocked.launches
    Qk, Rk = qb.qr_blocked(Ap)
    assert qb.qr_blocked.launches == n0 + 1
    Qp, Rp = qb.qr_blocked_plain(Ap)
    Qf, _ = qb.qr_blocked_forward_plain(Ap)
    for other in (1, 2):
        Qo, Ro = qb.launch(Ap, other)
        _close(Qo, Qp, 1e-5)
        _close(Ro, Rp, 1e-5)
        assert torch.equal(torch.tril(Ro, -1), torch.zeros_like(Ro))
    _close(Qk, Qf, 1e-5)
    _close(Rk, Rp, 1e-5)


def test_site_sweep_f64_negative_magnitudes_match_plain(cuda):
    """K1 in float64 on repulsive (F = 2) inputs with random G, where
    r_up r_dn < 0 happens: the per-chain min, max and sum of log10|det| over
    the negative detratios agree with its plain version's to 1e-12; the
    counts are equal."""
    kw = dict(lamb=LAMB, **MODELS["repulsive"])
    G, sigma, u = sweep_inputs(41, 16, 2, 64)
    G, u = (torch.from_numpy(x.astype(np.float64)).to(cuda) for x in (G, u))
    sigma = torch.from_numpy(sigma).to(cuda)
    out_k = ss.site_sweep_f64(G, sigma, u, **kw)
    out_p = ss.site_sweep_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k[3], out_p[3]) and out_k[3].sum().item() > 0
    has = out_p[3] > 0
    assert torch.equal(torch.isfinite(out_k[4][:, 0]), has)
    assert (out_k[4][has] - out_p[4][has]).abs().max().item() <= 1e-12
    assert torch.equal(out_k[4][~has], out_p[4][~has])


@pytest.mark.parametrize("model,N", [("attractive", 64), ("repulsive", 64),
                                     ("attractive", 128), ("attractive", 20),
                                     ("repulsive", 119), ("repulsive", 128),
                                     ("repulsive", 20)])
def test_site_sweep_f64_kernel_matches_plain(cuda, model, N):
    """K1 in float64: decisions identical; G within 1e-13 (every operation a
    __d*_rn intrinsic in the plain version's order, so bit-equal in
    practice); at F = 2 past N = 64 with flavor 1 in shared memory, and
    with padded N (20: NP = 32)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = sweep_inputs(N + 7, 16, F, N)
    G, u = (torch.from_numpy(x.astype(np.float64)).to(cuda) for x in (G, u))
    sigma = torch.from_numpy(sigma).to(cuda)
    n0, n1 = ss.site_sweep_f64.launches, ss.site_sweep.launches
    out_k = ss.site_sweep_f64(G, sigma, u, **kw)
    assert (ss.site_sweep_f64.launches, ss.site_sweep.launches) == (n0 + 1, n1)
    out_p = ss.site_sweep_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:4], out_p[1:4]):
        assert torch.equal(a, b.to(a.dtype))
    assert 0 < out_k[2].sum().item() < 16 * N
    assert (out_k[0] - out_p[0]).abs().max().item() <= 1e-13


@pytest.mark.parametrize("dtype,N", [("f32", n) for n in range(8, 129, 8)] + [
    ("f64", n) for n in range(8, 65, 8)])
def test_qr_householder_kernel_matches_plain(cuda, dtype, N):
    """K4 (float32, at every 8 | N <= 128) and K11 (float64, at every
    8 | N <= 64): each N is an instantiation of its own. On
    graded, prescaled, pivoted input: Q and R within 1e-5 (float32) or
    1e-12 (float64) of their largest entries (the kernels sum in another
    order than the plain version); R exactly upper triangular; K11's Q
    orthogonal to 1e-13."""
    f64 = dtype == "f64"
    fn, tol = (qh.qr_f64, 1e-12) if f64 else (qh.qr_f32, 1e-5)
    Ap, _ = (t.to(cuda) for t in graded(N, 32, N, float64=f64))
    n0 = fn.launches
    Qk, Rk = fn(Ap)
    assert fn.launches == n0 + 1
    Qp, Rp = qh.householder_qr_plain(Ap)
    _close(Qk, Qp, tol)
    _close(Rk, Rp, tol)
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))
    if f64:
        eye = torch.eye(N, dtype=Qk.dtype, device=cuda)
        assert (Qk.mT @ Qk - eye).abs().max().item() < 1e-13


@pytest.mark.parametrize("dtype,N", [("f32", 16), ("f32", 128), ("f64", 16),
                                     ("f64", 64)])
def test_qr_householder_kernel_zero_and_subnormal_columns(cuda, dtype, N):
    """Zero columns get H = I and R_jj = 0; a float32 subnormal v.v gets
    tau = 0, not inf, and a float64 subnormal ||x||^2 H = I: finite, and Q
    stays orthogonal (K4 also at its widest N = 128, in 16 warps; K11 at
    the f64 run's N = 64)."""
    f64 = dtype == "f64"
    fn = qh.qr_f64 if f64 else qh.qr_f32
    Ap, _ = (t.to(cuda) for t in graded(5, 4, N, decades=2.0, float64=f64))
    Ap[:, :, -4:] = 0.0
    Ap[:, :, 1] = Ap[:, :, 1] * (1e-175 if f64 else 1e-35)
    Q, R = fn(Ap)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    eye = torch.eye(N, dtype=Q.dtype, device=cuda)
    assert (Q.mT @ Q - eye).abs().max().item() < (1e-13 if f64 else 1e-5)
    assert torch.equal(R[:, -4:, -4:], torch.zeros_like(R[:, -4:, -4:]))
    _close(Q, qh.householder_qr_plain(Ap)[0], 1e-12 if f64 else 1e-5)


def test_wrappers_check_inputs(cuda):
    G = torch.zeros(2, 1, 16, 16, device=cuda, dtype=torch.float64)
    s = torch.ones(2, 16, device=cuda, dtype=torch.int8)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ss.site_sweep(G, s, u, lamb=LAMB, **MODELS["attractive"])
    with pytest.raises(ValueError, match="N=129"):
        ss.site_sweep(torch.zeros(2, 1, 129, 129, device=cuda),
                      torch.ones(2, 129, device=cuda, dtype=torch.int8),
                      torch.zeros(2, 129, device=cuda), lamb=LAMB,
                      **MODELS["attractive"])
    with pytest.raises(ValueError, match="N=12"):
        qr.udt_qr(torch.zeros(2, 12, 12, device=cuda),
                  torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        qr.udt_qr(torch.zeros(2, 16, 16, device=cuda).mT,
                  torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="dk=24"):
        ssd.site_sweep_delayed(torch.zeros(2, 1, 256, 256, device=cuda),
                               torch.ones(2, 256, device=cuda, dtype=torch.int8),
                               torch.zeros(2, 256, device=cuda), dk=24,
                               lamb=LAMB, **MODELS["attractive"])
    with pytest.raises(ValueError, match="N=128"):
        qb.qr_blocked(torch.zeros(2, 128, 128, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        qb.qr_blocked(torch.zeros(2, 136, 136, device=cuda,
                                  dtype=torch.float64))
    c64 = dict(device=cuda, dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        sscx.site_sweep_cx(torch.zeros(2, 1, 16, 16, device=cuda,
                                       dtype=torch.complex128), s, u,
                           lamb=LAMB, **MODELS["attractive"])
    with pytest.raises(ValueError, match="N=129, F=2"):
        sscx.site_sweep_cx(torch.zeros(2, 2, 129, 129, **c64),
                           torch.ones(2, 129, device=cuda, dtype=torch.int8),
                           torch.zeros(2, 129, device=cuda), lamb=LAMB,
                           **MODELS["repulsive"])
    with pytest.raises(ValueError, match="N=136"):
        qcx.qr_cx(torch.zeros(2, 136, 136, **c64))
    with pytest.raises(ValueError, match="N=256, F=2, dk=128"):
        ssdcx.site_sweep_delayed_cx(
            torch.zeros(2, 2, 256, 256, **c64),
            torch.ones(2, 256, device=cuda, dtype=torch.int8),
            torch.zeros(2, 256, device=cuda), dk=128, lamb=LAMB,
            **MODELS["repulsive"])
    with pytest.raises(ValueError, match="complex64"):
        qcx.qr_cx(torch.zeros(2, 16, 16, device=cuda))
    f64 = dict(device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="N=136"):
        qh.qr_f32(torch.zeros(2, 136, 136, device=cuda))
    with pytest.raises(ValueError, match="N=72"):
        qh.qr_f64(torch.zeros(2, 72, 72, **f64))
    with pytest.raises(ValueError, match="float64"):
        qh.qr_f64(torch.zeros(2, 16, 16, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        qh.qr_f32(torch.zeros(2, 16, 16, **f64))
    with pytest.raises(ValueError, match="float64"):
        ss.site_sweep_f64(torch.zeros(2, 1, 16, 16, device=cuda), s, u,
                          lamb=LAMB, **MODELS["attractive"])
    with pytest.raises(ValueError, match="N=129, F=2"):
        ss.site_sweep_f64(torch.zeros(2, 2, 129, 129, **f64),
                          torch.ones(2, 129, device=cuda, dtype=torch.int8),
                          torch.zeros(2, 129, **f64), lamb=LAMB,
                          **MODELS["repulsive"])
    rep = dict(lamb=LAMB, **MODELS["repulsive"])
    s2 = torch.ones(2, 15, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="N=15, F=2.*even N"):
        ss.site_sweep_pair(torch.zeros(2, 2, 15, 15, device=cuda), s2,
                           torch.zeros(2, 15, device=cuda), **rep)
    G2 = torch.zeros(2, 2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ss.site_sweep_pair(G2.double(), s, u.double(), **rep)
    with pytest.raises(ValueError, match="one device"):
        ss.site_sweep_pair(G2, s.cpu(), u, **rep)
    with pytest.raises(ValueError, match="one device"):
        ss.site_sweep_pair(G2, s, u.cpu(), **rep)


def test_cuda_session_rejects_shapes_without_kernels(cuda):
    """What a CUDA session takes and what it still refuses (ROADMAP Queue 1
    item 4): every QR shape has a route (8 does not divide N: the library
    QR beside K1, K1-f64 or K8), float64 past N = 128 runs K6-f64 and
    complex128 K8-c128 or K9-c128, also where 4 does not divide N past 128
    (G padded), F = 2 in complex64 at N = 128 and in complex128 past
    N = 64; float64 F = 2 at N = 256 with delay 64 is refused."""
    params = DQMCParameters(beta=1.0)
    model = lambda L, dims=2, cls=tmc.HubbardModelAttractive, **kw: cls(
        dims=dims, L=L, U=4.0, **kw)
    f32 = dict(dtype=torch.float32, device="cuda")
    for L in (10, 3):       # N=100 and N=9: K1 and the library QR
        ctx, _ = core.make_context(model(L), params, **f32)
        assert ctx.use_kernels
    for L in (12, 16):      # K6 and K7: N=144 rank-1 blocks, N=256 delay 32
        ctx, _ = core.make_context(model(L), params, **f32)
        assert ctx.use_kernels and ctx.delay == (32 if L == 16 else 0)
    # float64 (the default dtype) and mixed: K1 in float64 or float32 with
    # K11 at 8 | N <= 64, the library QR beyond; K6-f64 past N = 128
    for L, kw in ((4, dict()), (4, dict(update_dtype=torch.float32)),
                  (4, dict(stab_method="qr_colscaled")), (9, dict()),
                  (12, dict()), (16, dict())):
        ctx, _ = core.make_context(model(L), params, device="cuda", **kw)
        assert ctx.use_kernels and ctx.dtype == torch.float64
    for m in (model(130, dims=1),
              model(130, dims=1, cls=tmc.HubbardModelRepulsive)):
        for kw in (f32, dict(device="cuda")):   # 4 does not divide N = 130
            ctx, _ = core.make_context(m, params, **kw)
            assert ctx.use_kernels and ctx.N == 130
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        core.make_context(model(16, cls=tmc.HubbardModelRepulsive), params,
                          device="cuda", delay=64)
    ctx, _ = core.make_context(model(4), params, device="cuda",
                               use_kernels=False)
    assert ctx.device.type == "cuda" and not ctx.use_kernels
    # complex hopping in complex64: K8 + K10 to N = 128 (the 128-site
    # chain), K8 + the library QR at 8 ∤ N, K9 + the library QR beyond
    # (16x16, delay 32)
    cx = lambda L, dims=2, **kw: model(L, dims, peierls=flux_theta(L ** dims),
                                       **kw)
    for m in (cx(8), cx(128, dims=1), cx(16), cx(10)):
        ctx, _ = core.make_context(m, params, **f32)
        assert ctx.dtype == torch.complex64 and ctx.use_kernels
    rep = dict(cls=tmc.HubbardModelRepulsive)
    ctx, _ = core.make_context(cx(128, dims=1, **rep), params, **f32)
    assert ctx.dtype == torch.complex64 and ctx.use_kernels and ctx.F == 2
    # complex128 (the default dtype's promotion): K8-c128 to N = 128 (past
    # N = 64 the rank-1 layout where it ran faster), K9-c128 beyond (8 ∤ N: G
    # padded; the 16x16 repulsive model at delay 32 in two flavor stages),
    # each with the library QR
    for m in (cx(4), cx(8), cx(8, **rep), cx(128, dims=1), cx(16),
              cx(72, dims=1, **rep), cx(10, **rep), cx(14), cx(16, **rep)):
        ctx, _ = core.make_context(m, params, device="cuda")
        assert ctx.dtype == ctx.udtype == torch.complex128 and ctx.use_kernels
    # complex128 stacks over complex64 updates: K9 and the library QR
    ctx, _ = core.make_context(cx(16), params, device="cuda",
                               update_dtype=torch.float32)
    assert (ctx.dtype, ctx.udtype) == (torch.complex128, torch.complex64)
    ctx, _ = core.make_context(cx(4), params, device="cuda", use_kernels=False)
    assert ctx.dtype == torch.complex128


@pytest.mark.parametrize("L,delay", [(4, None), (12, 24)])
def test_sweep_pair_kernel_path_matches_cpu(cuda, L, delay):
    """One float32 sweep pair on the card's kernel path and on the CPU's
    plain versions, from the same state and uniforms: at 4x4 (K1-K3) and at
    12x12 (N = 144: K6 in blocks of 24 and K7)."""
    model = tmc.HubbardModelAttractive(dims=2, L=L, U=4.0)
    params = DQMCParameters(beta=2.0, safe_mult=5)
    out = {}
    for dev in ("cpu", "cuda"):
        ctx, consts = core.make_context(model, params, dtype=torch.float32,
                                        device=dev, delay=delay)
        conf = model.rand_conf(torch.Generator().manual_seed(0), 8,
                               params.slices, "cpu").to(dev)
        u = torch.rand(8, 2 * ctx.M, ctx.N,
                       generator=torch.Generator().manual_seed(1)).to(dev)
        state = core.init_state(ctx, consts, conf)
        out[dev] = core.sweep_pair(ctx, consts, state, u=u)[0]
    same = (out["cpu"]["conf"] == out["cuda"]["conf"].cpu()).flatten(1).all(1)
    assert same.float().mean().item() >= 0.9
    dG = (out["cpu"]["G"] - out["cuda"]["G"].cpu()).abs().flatten(1).amax(1)
    assert dG[same].max().item() <= 1e-3


@pytest.mark.parametrize("stab_method", ["qr", "qr_colscaled"])
def test_f64_sweep_pair_kernel_path_matches_cpu(cuda, stab_method):
    """One float64 sweep pair (the default dtype: K1 in float64 and K11) on
    the card's kernel path and on the CPU's plain versions, from the same
    state and uniforms: float64 rounding does not grow to O(1), so every
    chain decides the same and G agrees to 1e-8."""
    model = tmc.HubbardModelAttractive(dims=2, L=4, U=4.0)
    params = DQMCParameters(beta=2.0, safe_mult=5)
    out = {}
    for dev in ("cpu", "cuda"):
        ctx, consts = core.make_context(model, params, device=dev,
                                        stab_method=stab_method)
        conf = model.rand_conf(torch.Generator().manual_seed(0), 8,
                               params.slices, "cpu").to(dev)
        u = torch.rand(8, 2 * ctx.M, ctx.N, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1)).to(dev)
        state = core.init_state(ctx, consts, conf)
        out[dev] = core.sweep_pair(ctx, consts, state, u=u)[0]
    assert torch.equal(out["cpu"]["conf"], out["cuda"]["conf"].cpu())
    assert (out["cpu"]["G"] - out["cuda"]["G"].cpu()).abs().max().item() <= 1e-8


def test_complex_sweep_pair_kernel_path_matches_cpu(cuda):
    """One complex64 sweep pair on a flux pattern, on the card's kernel path
    (K8, K10) and on the CPU's plain versions, from the same state and
    uniforms: the same decisions in >= 0.9 of the chains, G and the running
    weight phase close where they agree."""
    model = tmc.HubbardModelAttractive(dims=2, L=4, U=4.0,
                                       peierls=flux_theta(16))
    params = DQMCParameters(beta=2.0, safe_mult=5)
    out = {}
    for dev in ("cpu", "cuda"):
        ctx, consts = core.make_context(model, params, dtype=torch.float32,
                                        device=dev)
        conf = model.rand_conf(torch.Generator().manual_seed(0), 8,
                               params.slices, "cpu").to(dev)
        u = torch.rand(8, 2 * ctx.M, ctx.N,
                       generator=torch.Generator().manual_seed(1)).to(dev)
        state = core.init_state(ctx, consts, conf)
        out[dev] = {k: v.cpu() for k, v in
                    core.sweep_pair(ctx, consts, state, u=u)[0].items()}
    same = (out["cpu"]["conf"] == out["cuda"]["conf"]).flatten(1).all(1)
    assert same.float().mean().item() >= 0.9
    dG = (out["cpu"]["G"] - out["cuda"]["G"]).abs().flatten(1).amax(1)
    assert dG[same].max().item() <= 1e-3
    dph = (out["cpu"]["ls_phase"] - out["cuda"]["ls_phase"]).abs()
    assert dph[same].max().item() <= 1e-3


def test_complex_large_session_launches_k9(cuda):
    """A complex64 session past N = 128 runs every site sweep through K9
    (12x12: N = 144, rank-1 blocks) and its QRs through the library (as the
    JAX package runs XLA's QR there): no K8, no K10."""
    model = tmc.HubbardModelAttractive(dims=2, L=12, U=4.0,
                                       peierls=flux_theta(144))
    params = DQMCParameters(beta=0.5, safe_mult=5)
    ctx, consts = core.make_context(model, params, dtype=torch.float32,
                                    device="cuda")
    conf = model.rand_conf(torch.Generator(device="cuda").manual_seed(0), 4,
                           params.slices)
    state = core.init_state(ctx, consts, conf)
    n = (ssdcx.site_sweep_delayed_cx.launches, sscx.site_sweep_cx.launches,
         qcx.qr_cx.launches)
    out = core.sweep_pair(ctx, consts, state,
                          generator=torch.Generator(device="cuda").manual_seed(1))[0]
    assert (ssdcx.site_sweep_delayed_cx.launches - n[0],
            sscx.site_sweep_cx.launches - n[1],
            qcx.qr_cx.launches - n[2]) == (2 * ctx.M, 0, 0)
    assert bool(torch.isfinite(out["G"]).all())


def _wrap_operands(F, N):
    """(ctx, consts) of a float32 session on the card whose hopping gives
    K13's wrap operands at N: the square lattice where N is a square (8x8
    at N = 64), else the N-site chain (N = 128); repulsive (F = 2) or
    attractive (F = 1)."""
    cls = tmc.HubbardModelRepulsive if F == 2 else tmc.HubbardModelAttractive
    side = int(round(N ** 0.5))
    dims, L = (2, side) if side * side == N else (1, N)
    # the plain path's context: a session with kernels refuses 8 ∤ N
    return core.make_context(cls(dims=dims, L=L, U=4.0),
                             DQMCParameters(beta=1.0), dtype=torch.float32,
                             device="cuda", use_kernels=False)


@pytest.mark.parametrize("N", [16, 36, 64, 100, 128])
@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("direction", [1, -1])
def test_site_sweep_wrap_kernel_matches_plain(cuda, F, N, direction):
    """K13 against its plain version on the same card inputs, at N on each
    of the tiled layouts (padded to 32, 64 and 128; 36 and 100 with padded
    rows): sigma, acc and nneg equal, G within 1e-5 of its largest entry
    (the wrap's FMAs sum in another order than cuBLAS's products). Up: the
    decisions come from K1's site loop on the input G, so they are K1's,
    bit for bit."""
    ctx, consts = _wrap_operands(F, N)
    kw = dict(lamb=ctx.lamb, signs=ctx.signs, det_power=ctx.det_power,
              use_boson=ctx.use_boson)
    Ml, Mr = ((consts["eT2_u"], consts["eT2inv_u"]) if direction > 0
              else (consts["eT2inv_u"], consts["eT2_u"]))
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in sweep_inputs(N + F + direction, 16, F, N))
    n0 = ss.site_sweep_wrap.launches
    out_k = ss.site_sweep_wrap(G, sigma, u, Ml, Mr, wrap_dir=direction, **kw)
    assert ss.site_sweep_wrap.launches == n0 + 1
    out_p = ss.site_sweep_wrap_plain(G, sigma, u, Ml, Mr, wrap_dir=direction,
                                     **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b.to(a.dtype))
    assert 0 < out_k[2].sum().item() < 16 * N
    _close(out_k[0], out_p[0], 1e-5)
    if direction > 0:
        for a, b in zip(out_k[1:], ss.site_sweep(G, sigma, u, **kw)[1:]):
            assert torch.equal(a, b)


def test_site_sweep_single_kernel_matches_plain(cuda):
    """K12 (K1's launch for one chain) against the plain version: the JAX
    signature's shapes, decisions equal, G within 1e-5."""
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    G, sigma, u = (torch.from_numpy(x[0]).to(cuda)
                   for x in sweep_inputs(64, 1, 1, 64))
    n0, n1 = ss.site_sweep_single.launches, ss.site_sweep.launches
    Gk, sk, ak, nk = ss.site_sweep_single(G, sigma.int(), u, **kw)
    assert (ss.site_sweep_single.launches, ss.site_sweep.launches) == (
        n0 + 1, n1)
    Gp, sp, ap, np_, _ = ss.site_sweep_plain(G[None], sigma[None], u[None],
                                             **kw)
    torch.cuda.synchronize()
    assert sk.dtype == torch.int32 and ak.shape == ()
    assert torch.equal(sk, sp[0].int()) and int(ak) == int(ap[0]) > 0
    assert int(nk) == int(np_[0])
    assert (Gk - Gp[0]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("N", range(8, 129, 8))
def test_qr_vtau_kernel_matches_plain(cuda, N):
    """K14 at every 8 | N <= 128 (each N an instantiation of its own) on
    graded, prescaled, pivoted input against its plain version: V
    and R within 1e-5 of their largest entries, tau within 1e-4 of each
    entry (the kernel sums in another order); V zero above its diagonal, R
    below; Q = I - V T V^T (qr_wy) orthogonal to 1e-5, as K4's Q."""
    Ap, _ = (t.to(cuda) for t in graded(N + 3, 32, N))
    n0, n4 = qh.qr_vtau.launches, qh.qr_f32.launches
    Vk, tk, Rk = qh.qr_vtau(Ap)
    assert (qh.qr_vtau.launches, qh.qr_f32.launches) == (n0 + 1, n4)
    Vp, tp, Rp = qh.householder_qr_vtau_plain(Ap)
    _close(Vk, Vp, 1e-5)
    _close(Rk, Rp, 1e-5)
    assert ((tk - tp).abs() <= 1e-4 * tp.abs()).all()
    assert torch.equal(torch.triu(Vk, 1), torch.zeros_like(Vk))
    assert torch.equal(torch.tril(Rk, -1), torch.zeros_like(Rk))
    Q, _ = qh.qr_wy(Ap)
    eye = torch.eye(N, device=cuda)
    assert (Q.mT @ Q - eye).abs().max().item() <= 1e-5
    _close(Q, qh.householder_qr_plain(Ap)[0], 1e-5)


@pytest.mark.parametrize("N", [16, 128])
def test_qr_vtau_kernel_zero_and_subnormal_columns(cuda, N):
    """Zero columns and a subnormal v.v: tau = 0 and V's column 0, R's
    block zero; the assembled Q finite and orthogonal (also at the widest
    N = 128)."""
    Ap, _ = (t.to(cuda) for t in graded(5, 4, N, decades=2.0))
    Ap[:, :, -4:] = 0.0
    Ap[:, :, 1] = Ap[:, :, 1] * 1e-35
    V, tau, R = qh.qr_vtau(Ap)
    torch.cuda.synchronize()
    assert torch.equal(tau[:, -4:], torch.zeros_like(tau[:, -4:]))
    assert bool(((tau != 0) | (V.abs().amax(-2) == 0)).all())
    assert torch.equal(R[:, -4:, -4:], torch.zeros_like(R[:, -4:, -4:]))
    Q, _ = qh.qr_wy(Ap)
    assert bool(torch.isfinite(Q).all())
    eye = torch.eye(N, device=cuda)
    assert (Q.mT @ Q - eye).abs().max().item() < 1e-5


@pytest.mark.parametrize("repulsive", [False, True])
def test_fuse_wrap_session_launches_k13(cuda, repulsive):
    """A float32 session with fuse_wrap=True visits 2M - 1 slices of a
    sweep pair through K13 (at F = 2 too: wrap fusion turns K5 off, as in
    the JAX package) and the measurement point's through K1 (K5 at F = 2)
    and the separate wrap; the same decisions as the unfused session from
    the same state and uniforms in >= 0.9 of the chains."""
    cls = tmc.HubbardModelRepulsive if repulsive else tmc.HubbardModelAttractive
    model = cls(dims=2, L=4, U=4.0)
    params = DQMCParameters(beta=2.0, safe_mult=5)
    out = []
    for fuse in (False, True):
        ctx, consts = core.make_context(model, params, dtype=torch.float32,
                                        device="cuda", fuse_wrap=fuse)
        conf = model.rand_conf(torch.Generator().manual_seed(0), 8,
                               params.slices, "cpu").to(cuda)
        u = torch.rand(8, 2 * ctx.M, ctx.N,
                       generator=torch.Generator().manual_seed(1)).to(cuda)
        state = core.init_state(ctx, consts, conf)
        k1 = ss.site_sweep_pair if repulsive else ss.site_sweep
        n = (ss.site_sweep_wrap.launches, k1.launches)
        out.append(core.sweep_pair(ctx, consts, state, u=u)[0])
        if fuse:
            assert (ss.site_sweep_wrap.launches - n[0],
                    k1.launches - n[1]) == (2 * ctx.M - 1, 1)
    same = (out[0]["conf"] == out[1]["conf"]).flatten(1).all(1)
    assert same.float().mean().item() >= 0.9


def test_qr_wy_session_launches_k14(cuda):
    """A float32 qr_colscaled session with qr_wy=True runs every QR through
    K14 and none through K4."""
    model = tmc.HubbardModelAttractive(dims=2, L=4, U=4.0)
    params = DQMCParameters(beta=2.0, safe_mult=5)
    ctx, consts = core.make_context(model, params, dtype=torch.float32,
                                    device="cuda", stab_method="qr_colscaled",
                                    qr_wy=True)
    conf = model.rand_conf(torch.Generator(device="cuda").manual_seed(0), 4,
                           params.slices)
    n = (qh.qr_vtau.launches, qh.qr_f32.launches)
    state = core.init_state(ctx, consts, conf)
    out = core.sweep_pair(ctx, consts, state,
                          generator=torch.Generator(device="cuda").manual_seed(1))[0]
    assert (qh.qr_vtau.launches - n[0], qh.qr_f32.launches - n[1]) == (
        5 * ctx.n_seg + 1, 0)
    assert bool(torch.isfinite(out["G"]).all())


def test_new_wrappers_check_inputs(cuda):
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    G = torch.zeros(2, 1, 16, 16, device=cuda)
    s = torch.ones(2, 16, device=cuda, dtype=torch.int8)
    u = torch.zeros(2, 16, device=cuda)
    M = torch.eye(16, device=cuda)
    with pytest.raises(ValueError, match="Ml and Mr"):
        ss.site_sweep_wrap(G, s, u, M.double(), M, wrap_dir=1, **kw)
    with pytest.raises(ValueError, match="Ml and Mr"):
        ss.site_sweep_wrap(G, s, u, M[:8, :8], M, wrap_dir=1, **kw)
    with pytest.raises(ValueError, match="float32"):
        ss.site_sweep_wrap(G.double(), s, u.double(), M, M, wrap_dir=1, **kw)
    with pytest.raises(ValueError, match="wrap_dir"):
        ss.site_sweep_wrap(G, s, u, M, M, wrap_dir=2, **kw)
    with pytest.raises(ValueError, match="N=136"):
        qh.qr_vtau(torch.zeros(2, 136, 136, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        qh.qr_vtau(torch.zeros(2, 16, 16, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="N=129"):
        ss.site_sweep_single(torch.zeros(1, 129, 129, device=cuda),
                             torch.ones(129, device=cuda, dtype=torch.int8),
                             torch.zeros(129, device=cuda), **kw)


# ---------------------------------------------------------------------------
# K1 in float32 and K8 on the tiled layout (csrc/site_sweep_tiled.cuh): bit
# for bit against their plain versions
# ---------------------------------------------------------------------------

def _equal_outputs(out_k, out_p):
    """Every result of a kernel equal to its plain version's, bit for bit."""
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("inputs", ["sweep", "pair"])
@pytest.mark.parametrize("C,F,N", [(256, 1, 64), (128, 1, 64), (3, 2, 128),
                                   (5, 1, 100), (7, 2, 9)])
def test_site_sweep_tiled_bit_equal(cuda, C, F, N, inputs):
    """K1 in float32 at its plan's layout: G, sigma, acc and nneg equal to
    the plain version's (tolerance 0.0), on inputs with few rejections
    (sweep: at (3, 2, 128, 128) none) and with a few in ten (pair)."""
    kw = dict(lamb=LAMB, **MODELS["attractive" if F == 1 else "repulsive"])
    make = sweep_inputs if inputs == "sweep" else pair_inputs
    G, sigma, u = (torch.from_numpy(x).to(cuda) for x in make(C + N, C, F, N))
    n0 = ss.site_sweep.launches
    out_k = ss.site_sweep(G, sigma, u, **kw)
    assert ss.site_sweep.launches == n0 + 1
    _equal_outputs(out_k, ss.site_sweep_plain(G, sigma, u, **kw)[:4])
    n_acc = out_k[2].sum().item()
    assert 0 < n_acc and (inputs == "sweep" or n_acc < C * N)


@pytest.mark.parametrize("N", [64, 100])
def test_site_sweep_single_tiled_bit_equal(cuda, N):
    """K12 (K1 at C = 1, in the plan's layout for one chain) bit for bit."""
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    G, sigma, u = (torch.from_numpy(x[0]).to(cuda)
                   for x in pair_inputs(N, 1, 1, N))
    n0 = ss.site_sweep_single.launches
    out_k = ss.site_sweep_single(G, sigma, u, **kw)
    assert ss.site_sweep_single.launches == n0 + 1
    out_p = ss.site_sweep_plain(G[None], sigma[None], u[None], **kw)
    _equal_outputs(out_k, [x[0] for x in out_p[:4]])


@pytest.mark.parametrize("det_power,use_boson", [(1, False), (1, True),
                                                 (2, False), (2, True)])
@pytest.mark.parametrize("C,F,N", [(256, 1, 64), (256, 1, 128), (3, 2, 119),
                                   (5, 1, 100), (7, 2, 9), (3, 2, 120),
                                   (64, 2, 128)])
def test_site_sweep_cx_tiled_bit_equal(cuda, C, F, N, det_power, use_boson):
    """K8 at its plan's layout: G, sigma, the accept flags and the complex
    detratios equal to the plain version's (tolerance 0.0)."""
    kw = dict(lamb=LAMB, signs=(1.0,) if F == 1 else (1.0, -1.0),
              det_power=det_power, use_boson=use_boson)
    G, sigma, u = (torch.from_numpy(x).to(cuda)
                   for x in cx_sweep_inputs(C + N, C, F, N))
    n0 = sscx.site_sweep_cx.launches
    out_k = sscx.site_sweep_cx(G, sigma, u, **kw)
    assert sscx.site_sweep_cx.launches == n0 + 1
    _equal_outputs(out_k, sscx.site_sweep_cx_plain(G, sigma, u, **kw))
    assert 0 < out_k[2].sum().item() < C * N


@pytest.mark.parametrize("cx,F,N", [
    (False, 1, 64), (False, 2, 64), (False, 1, 128), (False, 2, 128),
    (False, 2, 30), (False, 1, 77), (True, 1, 64), (True, 2, 64),
    (True, 1, 128), (True, 2, 119), (True, 1, 17), (True, 2, 72)])
def test_site_sweep_tiled_shapes_bit_equal(cuda, cx, F, N):
    """K1 in float32 (cx: K8) at padded and unpadded N of each of its three
    layouts, bit for bit against the plain version."""
    kw = dict(lamb=LAMB, **MODELS["attractive" if F == 1 else "repulsive"])
    make = cx_sweep_inputs if cx else pair_inputs
    G, sigma, u = (torch.from_numpy(x).to(cuda) for x in make(N, 5, F, N))
    if cx:
        out_k = sscx.site_sweep_cx(G, sigma, u, **kw)
        out_p = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    else:
        out_k = ss.site_sweep(G, sigma, u, **kw)
        out_p = ss.site_sweep_plain(G, sigma, u, **kw)[:4]
    _equal_outputs(out_k, out_p)


# ---------------------------------------------------------------------------
# the classical flavor: K17 and K18, MC and checkpoints on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,L", [(2, 8), (2, 3), (3, 4), (1, 5), (2, 32),
                                    (2, 4), (2, 6), (2, 2)])
def test_ising_sweep_kernel_matches_plain(cuda, dims, L):
    """K17 against its plain version: conf and the per-chain counts bit for
    bit, on two, three and four color classes, in the tile layout (16 | N:
    the 8x8, 4x4 and cubic L = 4) and the shared-memory layout (the 32x32,
    and the 3x3, Chain(5), the 6x6 and the 2x2, where 16 does not divide N;
    the 2x2 lists each neighbor twice)."""
    from montecarlo_tpu_torch.ops import ising as kis
    model = tmc.IsingModel(dims=dims, L=L)
    gen = torch.Generator(device=cuda).manual_seed(L)
    tabs = kis.make_tables(model.lattice, 0.44, cuda)
    conf = model.rand_conf(gen, 1000, cuda)
    u = torch.rand(1000, tabs.N, generator=gen, device=cuda,
                   dtype=torch.float64)
    zero = lambda: torch.zeros(1000, dtype=torch.int64, device=cuda)
    n0 = kis.ising_sweep.launches
    out_k = kis.ising_sweep(conf, u, tabs, zero())
    assert kis.ising_sweep.launches == n0 + 1
    out_p = kis.ising_sweep_plain(conf, u, tabs, zero())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p))


@pytest.mark.parametrize("dims,L,C", [(2, 8, 512), (2, 32, 64), (3, 4, 256),
                                      (2, 2, 100)])
def test_wolff_step_kernel_matches_plain(cuda, dims, L, C):
    """K18 against its plain version from seeds, in batches of 1, 3 and
    N + 1 levels until no frontier is left: cluster, frontier and status
    bit for bit after every batch (the register layout at N <= 64, the
    block layout at the 32x32)."""
    from montecarlo_tpu_torch.ops import ising as kis
    model = tmc.IsingModel(dims=dims, L=L)
    N, z = len(model.lattice), model.lattice.coordination
    gen = torch.Generator(device=cuda).manual_seed(3)
    tabs = kis.make_tables(model.lattice, 1.0 / tmc.IsingTc, cuda)
    conf = model.rand_conf(gen, C, cuda)
    seeds = torch.randint(0, N, (C,), generator=gen, device=cuda)
    inc0 = torch.zeros(C, N, dtype=torch.bool, device=cuda).scatter_(
        1, seeds[:, None], True)
    spin = conf.gather(1, seeds[:, None])
    for Lb in (1, 3, N + 1):
        inc, front, left = inc0, inc0, 1
        while left:
            u = torch.rand(Lb, C, N, z, generator=gen, device=cuda,
                           dtype=torch.float64)
            out_k = kis.wolff_step(conf, inc, front, spin, u, tabs)
            out_p = kis.wolff_step_plain(conf, inc, front, spin, u, tabs)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out_k, out_p))
            inc, front, status = out_p
            left = status.tolist()[1]


def test_mc_run_launches_k17_and_k18(cuda):
    """MC.run on the card: one K17 per sweep, one K18 per batch of BFS
    levels (the move's count of host reads)."""
    from montecarlo_tpu_torch.ops import ising as kis
    kis.ising_sweep.launches = kis.wolff_step.launches = 0
    sim = tmc.MC(tmc.IsingModel(dims=2, L=8), beta=1.0 / tmc.IsingTc,
                 n_chains=256, global_moves=True, global_rate=2, device=cuda)
    sim.run(thermalization=4, sweeps=6, verbose=False)
    assert kis.ising_sweep.launches == 10
    assert kis.wolff_step.launches == sim._moves()[1].batches > 0
    assert sim.analysis.levels_global >= kis.wolff_step.launches


def test_mc_wolff_run_independent_of_batch_on_cuda(cuda, monkeypatch):
    """MC.run with Wolff moves on the card at the default batch size, one
    level a batch and N + 1 levels (batch_levels fixed; the move reads it
    at each batch): the same conf, counters and generator state (the
    stream rewound to the levels used)."""
    from montecarlo_tpu_torch.models import ising as tising
    rule, out = tising.batch_levels, []
    for lb in (None, 1, 65):
        monkeypatch.setattr(tising, "batch_levels",
                            rule if lb is None else lambda *a: lb)
        sim = tmc.MC(tmc.IsingModel(dims=2, L=8), beta=1.0 / tmc.IsingTc,
                     n_chains=512, seed=4, global_moves=True, global_rate=2,
                     device=cuda)
        sim.run(thermalization=6, sweeps=10, verbose=False)
        a = sim.analysis
        out.append((sim.conf.cpu(), sim.generator.get_state(), a.acc_local,
                    a.acc_global, a.levels_global))
    for o in out[1:]:
        assert torch.equal(o[0], out[0][0]) and torch.equal(o[1], out[0][1])
        assert o[2:] == out[0][2:]


def test_cpu_checkpoint_refused_on_cuda(cuda, tmp_path):
    """A checkpoint whose generator drew on the CPU does not load on the
    card: never silently reseeded."""
    sim = tmc.MC(tmc.IsingModel(dims=2, L=4), beta=0.4, n_chains=4,
                 device="cpu")
    sim.run(sweeps=3, verbose=False)
    fn = tmc.save(str(tmp_path / "cpu.mctorch"), sim)
    with pytest.raises(ValueError, match="draw on 'cpu'"):
        tmc.load(fn, device="cuda")


# ---------------------------------------------------------------------------
# the float64 and complex128 site sweeps: K6-f64, K8-c128, K9-c128
# ---------------------------------------------------------------------------

def _f64_inputs(cuda, seed, C, F, N, spread=0.0):
    """sweep_inputs in float64 on the card, each diagonal entry of G moved
    by spread * N(0, 1) (spread 0.8 leaves [0, 1]: r_up r_dn < 0 happens
    at F = 2, so there are negative weights to record)."""
    G, sigma, u = sweep_inputs(seed, C, F, N)
    d = np.random.default_rng(seed + 9).normal(size=(C, F, N)) * spread
    G = G.astype(np.float64) + d[..., None] * np.eye(N)
    return (torch.from_numpy(G).to(cuda), torch.from_numpy(sigma).to(cuda),
            torch.from_numpy(u.astype(np.float64)).to(cuda))


@pytest.mark.parametrize("model,C,N,dk,spread", [
    ("attractive", 64, 256, 32, 0.0), ("repulsive", 32, 256, 32, 0.8),
    ("attractive", 64, 144, 1, 0.0), ("repulsive", 16, 144, 1, 0.8),
    # 4 does not divide N: G padded to a multiple of 8
    ("attractive", 64, 169, 1, 0.0), ("repulsive", 16, 225, 1, 0.8),
    ("repulsive", 8, 289, 17, 0.8)])
def test_site_sweep_delayed_f64_kernel_matches_plain(cuda, model, C, N, dk,
                                                     spread):
    """K6-f64 at its parity shapes (the 16x16 F = 2 in two column passes):
    sigma, acc and nneg identical to its plain version's, G within 1e-10
    (bit-equal in practice), the negative weights' log10 magnitudes equal;
    counted in site_sweep_delayed_f64.launches alone."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = _f64_inputs(cuda, N + dk, C, F, N, spread)
    n0, n1 = (ssd.site_sweep_delayed_f64.launches,
              ssd.site_sweep_delayed.launches)
    out_k = ssd.site_sweep_delayed_f64(G, sigma, u, dk=dk, **kw)
    assert (ssd.site_sweep_delayed_f64.launches,
            ssd.site_sweep_delayed.launches) == (n0 + 1, n1)
    out_p = ssd.site_sweep_delayed_plain(G, sigma, u, dk=dk, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:4], out_p[1:4]):
        assert torch.equal(a, b.to(a.dtype))
    assert 0 < out_k[2].sum().item() < C * N
    assert (out_k[0] - out_p[0]).abs().max().item() <= 1e-10
    assert torch.equal(out_k[4], out_p[4])
    if spread:
        assert out_k[3].sum().item() > 0


@pytest.mark.parametrize("model,C,N", [("attractive", 256, 64),
                                       ("repulsive", 256, 64),
                                       ("attractive", 256, 128),
                                       ("attractive", 16, 20),
                                       ("repulsive", 256, 100),
                                       ("repulsive", 64, 128),
                                       ("repulsive", 16, 65)])
def test_site_sweep_cx_c128_kernel_matches_plain(cuda, model, C, N):
    """K8-c128 at its parity shapes and its largest N (past N = 64 the
    plan's layout: the rank-1 layout where it ran faster, else the
    one-block layout, at F = 1 the imaginary plane in shared memory, at
    F = 2 a cluster of two blocks per chain, one flavor each): sigma,
    accept and det identical to its plain version's, G within 1e-10
    (bit-equal in practice)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = cx_sweep_inputs(N + 3, C, F, N)
    G, sigma = (torch.from_numpy(x).to(cuda) for x in
                (G.astype(np.complex128), sigma))
    u = torch.from_numpy(u.astype(np.float64)).to(cuda)
    n0, n1 = sscx.site_sweep_cx_c128.launches, sscx.site_sweep_cx.launches
    out_k = sscx.site_sweep_cx_c128(G, sigma, u, **kw)
    assert (sscx.site_sweep_cx_c128.launches,
            sscx.site_sweep_cx.launches) == (n0 + 1, n1)
    out_p = sscx.site_sweep_cx_plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert 0 < out_k[2].sum().item() < C * N
    assert (out_k[0] - out_p[0]).abs().max().item() <= 1e-10


@pytest.mark.parametrize("model,C,N,dk", [("attractive", 64, 256, 32),
                                          ("attractive", 8, 144, 1),
                                          ("repulsive", 8, 256, 16),
                                          ("attractive", 64, 196, 1),
                                          ("repulsive", 8, 169, 1),
                                          ("repulsive", 64, 256, 32)])
def test_site_sweep_delayed_cx_c128_kernel_matches_plain(cuda, model, C, N,
                                                         dk):
    """K9-c128 (complex16: clusters of 2 blocks in two column passes; 8
    does not divide N: G padded; the 16x16 repulsive model at dk = 32:
    clusters of 4 blocks in two flavor stages and four passes): sigma,
    accept and det identical to its plain version's, G within 1e-10
    (bit-equal in practice)."""
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = cx_sweep_inputs(N + dk, C, F, N)
    G, sigma = (torch.from_numpy(x).to(cuda) for x in
                (G.astype(np.complex128), sigma))
    u = torch.from_numpy(u.astype(np.float64)).to(cuda)
    n0 = ssdcx.site_sweep_delayed_cx_c128.launches
    out_k = ssdcx.site_sweep_delayed_cx_c128(G, sigma, u, dk=dk, **kw)
    assert ssdcx.site_sweep_delayed_cx_c128.launches == n0 + 1
    out_p = ssdcx.site_sweep_delayed_cx_plain(G, sigma, u, dk=dk, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert 0 < out_k[2].sum().item() < C * N
    assert (out_k[0] - out_p[0]).abs().max().item() <= 1e-10


# the layouts of the FP64 instances redesigned for the card: (kind, model,
# chains, N, dk, diagonal spread): the rank-1 layout of K6-f64 and K9-c128
# at dk = 1 (l15_f64's, the 13x13's, F = 2, flux14_c128's, and N = 130 and
# 250, whose padded rows and columns the sweep never visits) and K9-c128's
# flavor layout at F = 2, N = 256, dk = 32 (rep_flux16_c128's), and at 16
# chains (DQMC's default) the clusters of 4 in two flavor stages that the
# plan keeps there; K9-c128 and K6-f64 at F = 2 in clusters of 8 (the
# repulsive 14x14 and 15x15 in a flux, N = 250, and 17x17 in float64); the
# flavor layout in one row and column pass (N = 130, dk = 26) and past
# one wave of clusters of 4 at N = 192
REDESIGNED = [
    ("f64", "attractive", 64, 225, 1, 0.0), ("f64", "attractive", 64, 169, 1,
                                             0.0),
    ("f64", "repulsive", 64, 144, 1, 0.8), ("f64", "attractive", 8, 130, 1,
                                            0.0),
    ("f64", "repulsive", 8, 250, 1, 0.8), ("c128", "attractive", 64, 196, 1,
                                           0.0),
    ("c128", "repulsive", 64, 144, 1, 0.0), ("c128", "repulsive", 64, 256,
                                             32, 0.0),
    ("c128", "attractive", 8, 250, 1, 0.0), ("c128", "repulsive", 8, 130, 1,
                                             0.0),
    ("c128", "repulsive", 16, 256, 32, 0.0),
    ("c128", "repulsive", 64, 196, 1, 0.0), ("c128", "repulsive", 8, 225, 1,
                                             0.0),
    ("c128", "repulsive", 8, 250, 1, 0.0), ("f64", "repulsive", 8, 289, 1,
                                            0.8),
    ("c128", "repulsive", 8, 130, 26, 0.0), ("c128", "repulsive", 40, 192,
                                             32, 0.0)]


@pytest.mark.parametrize("kind,model,C,N,dk,spread", REDESIGNED)
def test_fp64_redesigned_layouts_bit_equal(cuda, kind, model, C, N, dk,
                                           spread):
    """The rank-1, flavor and two-stage layouts against the unchanged plain
    versions:
    G bit-equal (max|dG| 0), sigma, the counts or accept flags and
    detratios, and K6-f64's negative-weight magnitudes identical; 50
    relaunches bit-equal to the first; the wrapper runs the plan's layout
    and counts one launch."""
    kw = dict(lamb=LAMB, dk=dk, **MODELS[model])
    F = len(kw["signs"])
    if kind == "f64":
        G, sigma, u = _f64_inputs(cuda, N + dk + 7, C, F, N, spread)
        mod, fn = ssd, ssd.site_sweep_delayed_f64
        plain, dtype = ssd.site_sweep_delayed_plain, torch.float64
    else:
        G, sigma, u = cx_sweep_inputs(N + dk + 7, C, F, N)
        G, sigma = (torch.from_numpy(x).to(cuda) for x in
                    (G.astype(np.complex128), sigma))
        u = torch.from_numpy(u.astype(np.float64)).to(cuda)
        mod, fn = ssdcx, ssdcx.site_sweep_delayed_cx_c128
        plain, dtype = ssdcx.site_sweep_delayed_cx_plain, torch.complex128
    one_row = dk > 1 and ssdcx.flavors_layout(N, F, dk, dtype).geometry[1] < 2
    assert mod.plan_layout(N, F, dk, dtype, C).kind == (
        "rank1" if dk == 1 else "flavors" if C > 30 or one_row
        else "cluster")
    n0 = fn.launches
    out_k = fn(G, sigma, u, **kw)
    assert fn.launches == n0 + 1
    out_p = plain(G, sigma, u, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k[0], out_p[0])
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b.to(a.dtype))
    assert 0 < (out_k[1] != sigma).sum().item() < C * N
    for _ in range(50):
        again = fn(G, sigma, u, **kw)
        assert all(torch.equal(a, b) for a, b in zip(out_k, again))


def test_fp64_wrappers_check_inputs(cuda):
    """The new wrappers refuse what their kernels do not take."""
    kw = dict(lamb=LAMB, **MODELS["attractive"])
    f64 = dict(device=cuda, dtype=torch.float64)
    s = torch.ones(2, 256, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="float64"):
        ssd.site_sweep_delayed_f64(torch.zeros(2, 1, 256, 256, device=cuda),
                                   s, torch.zeros(2, 256, device=cuda),
                                   dk=32, **kw)
    with pytest.raises(ValueError, match="N=256, F=1, dk=24"):
        ssd.site_sweep_delayed_f64(torch.zeros(2, 1, 256, 256, **f64), s,
                                   torch.zeros(2, 256, **f64), dk=24, **kw)
    c128 = dict(device=cuda, dtype=torch.complex128)
    with pytest.raises(ValueError, match="N=129, F=2"):
        sscx.site_sweep_cx_c128(
            torch.zeros(2, 2, 129, 129, **c128),
            torch.ones(2, 129, device=cuda, dtype=torch.int8),
            torch.zeros(2, 129, **f64), lamb=LAMB, **MODELS["repulsive"])
    with pytest.raises(ValueError, match="complex128"):
        ssdcx.site_sweep_delayed_cx_c128(
            torch.zeros(2, 1, 256, 256, device=cuda, dtype=torch.complex64),
            s, torch.zeros(2, 256, device=cuda), dk=32, **kw)


def test_default_dtype_sessions_run_the_fp64_kernels(cuda):
    """DQMC(model) at the default dtype on the card: a complex-hopping
    session builds with use_kernels=True and runs K8-c128 (8x8) and K9-c128
    (12x12, rank-1 blocks), a 12x12 real one K6-f64, one launch per slice
    visit and none of the float32 / complex64 sweeps."""
    params = DQMCParameters(beta=0.5, safe_mult=5)
    for L, peierls, name, mod in (
            (4, True, "site_sweep_cx_c128", sscx),
            (12, True, "site_sweep_delayed_cx_c128", ssdcx),
            (12, False, "site_sweep_delayed_f64", ssd)):
        theta = flux_theta(L * L) if peierls else None
        model = tmc.HubbardModelAttractive(dims=2, L=L, U=4.0,
                                           peierls=theta)
        sim = tmc.DQMC(model, beta=0.5, safe_mult=5, n_chains=4,
                       measurements={})
        assert sim.ctx.use_kernels and sim.ctx.udtype in (torch.float64,
                                                          torch.complex128)
        fn = getattr(mod, name)
        n0 = fn.launches
        others = (ssd.site_sweep_delayed.launches, sscx.site_sweep_cx.launches,
                  ssdcx.site_sweep_delayed_cx.launches)
        sim.run(thermalization=0, sweeps=1, verbose=False)
        assert fn.launches - n0 == 2 * sim.ctx.M == 2 * params.slices
        assert others == (ssd.site_sweep_delayed.launches,
                          sscx.site_sweep_cx.launches,
                          ssdcx.site_sweep_delayed_cx.launches)
        assert bool(torch.isfinite(sim.state["G"]).all())
