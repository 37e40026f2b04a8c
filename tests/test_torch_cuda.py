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
from montecarlo_tpu_torch.ops import qr
from montecarlo_tpu_torch.ops import site_sweep as ss
from torch_port_inputs import LAMB, MODELS, graded, sweep_inputs

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


@pytest.mark.parametrize("N", [8, 16, 40, 64])
def test_udt_kernels_match_plain(cuda, N):
    Ap, mx = (t.to(cuda) for t in graded(N, 32, N))
    Z = torch.randn(32, N, N, device=cuda)
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


def test_cuda_session_rejects_shapes_without_kernels(cuda):
    params = DQMCParameters(beta=1.0)
    model = lambda L: tmc.HubbardModelAttractive(dims=2, L=L, U=4.0)
    f32 = dict(dtype=torch.float32, device="cuda")
    for L in (12, 3):       # N=144 > 128 (site sweep); N=9, not 8 | N (UDT)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            core.make_context(model(L), params, **f32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        core.make_context(model(4), params, device="cuda")   # float64
    ctx, _ = core.make_context(model(4), params, device="cuda",
                               use_kernels=False)
    assert ctx.device.type == "cuda" and not ctx.use_kernels


def test_sweep_pair_kernel_path_matches_cpu(cuda):
    """One float32 sweep pair at 4x4 on the card's kernel path and on the
    CPU's plain versions, from the same state and uniforms."""
    model = tmc.HubbardModelAttractive(dims=2, L=4, U=4.0)
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
        out[dev] = core.sweep_pair(ctx, consts, state, u=u)[0]
    same = (out["cpu"]["conf"] == out["cuda"]["conf"].cpu()).flatten(1).all(1)
    assert same.float().mean().item() >= 0.9
    dG = (out["cpu"]["G"] - out["cuda"]["G"].cpu()).abs().flatten(1).amax(1)
    assert dG[same].max().item() <= 1e-3
