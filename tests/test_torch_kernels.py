"""Kernels K1-K3 of the PyTorch/CUDA port (montecarlo_tpu_torch) against the
Pallas kernels they replace.

On the CPU each wrapper runs its kernel's plain PyTorch version; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them. The
same numpy inputs go to both. Bounds are those of the JAX package's kernel
tests (test_pallas_matches_xla_sweep, test_fused_udt_*): decisions exact,
G within 1e-5, Q/Rs/X within 1e-5 of their largest entry, d to 1e-6
relative -- float32 sums taken in another order differ at that level.

The CUDA halves (each kernel against its plain version on the card) are in
test_torch_cuda.py.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import pallas_qr
from montecarlo_tpu.ops import pallas_site_sweep as pss
from montecarlo_tpu_torch.ops import KERNELS, _build, qr
from montecarlo_tpu_torch.ops import site_sweep as ss
from torch_port_inputs import LAMB, MODELS, graded as _graded
from torch_port_inputs import sweep_inputs as _sweep_inputs


def _close(a, b, tol):
    """max|a - b| <= tol * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b))
    assert err <= tol * np.max(np.abs(b)), (err, np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# K1: site sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,N", [("attractive", 16), ("repulsive", 16),
                                     ("attractive", 32)])
def test_site_sweep_matches_pallas(model, N):
    kw = dict(lamb=LAMB, **MODELS[model])
    F = len(kw["signs"])
    G, sigma, u = _sweep_inputs(N + F, 3, F, N)
    Gj, sj, aj, nj = pss._site_sweep_batched(
        jnp.asarray(G), jnp.asarray(sigma, jnp.int32), jnp.asarray(u),
        _force_colread=True, _force_pair=False, **kw)
    Gt, st, at, nt = ss.site_sweep(torch.from_numpy(G), torch.from_numpy(sigma),
                                   torch.from_numpy(u), **kw)
    assert st.dtype == torch.int8
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 0 < at.sum() < 3 * N                  # both branches exercised
    assert np.max(np.abs(Gt.numpy() - np.asarray(Gj))) <= 1e-5


def test_site_sweep_plain_leaves_inputs():
    G, sigma, u = _sweep_inputs(5, 2, 1, 8)
    Gt, st = torch.from_numpy(G.copy()), torch.from_numpy(sigma.copy())
    ss.site_sweep_plain(Gt, st, torch.from_numpy(u), lamb=LAMB,
                        **MODELS["attractive"])
    np.testing.assert_array_equal(Gt.numpy(), G)
    np.testing.assert_array_equal(st.numpy(), sigma)


def test_site_sweep_kernel_shapes():
    assert ss.kernel_supports(64, 1) and ss.kernel_supports(128, 2)
    assert not ss.kernel_supports(129, 1)
    assert not ss.kernel_supports(64, 3)


# ---------------------------------------------------------------------------
# K2 / K3: fused UDT and fused UDT + solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N", [(3, 16), (6, 32)])
def test_udt_qr_matches_pallas(B, N):
    Ap, mx = _graded(B * N, B, N)
    Qj, Rj, dj = pallas_qr._udt_fused_batched(jnp.asarray(Ap.numpy()),
                                              jnp.asarray(mx.numpy()))
    Qt, Rt, dt = qr.udt_qr(Ap, mx)
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    # the decomposition itself: Ap = Q diag(d/mx) Rs
    rec = (Qt.double() * (dt.double() / mx.double()[:, None])[:, None, :]
           @ Rt.double())
    _close(rec, Ap.double(), 2e-5)


def test_udt_qr_flushed_columns_match_pallas():
    """Exactly-zero columns: tau = 0, exact zero fill, R_jj = +floor, so the
    normalized diagonal is exactly +1 and d is the floor (times mx)."""
    Ap, mx = _graded(4, 2, 16, decades=2.0)
    Ap[:, :, -4:] = 0.0
    Qj, Rj, dj = pallas_qr._udt_fused_batched(jnp.asarray(Ap.numpy()),
                                              jnp.asarray(mx.numpy()))
    Qt, Rt, dt = qr.udt_qr(Ap, mx)
    _close(Qt, Qj, 1e-5)
    _close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    diag = torch.diagonal(Rt, dim1=-2, dim2=-1)
    assert torch.equal(diag[:, -4:], torch.ones(2, 4))
    assert torch.equal(dt[:, -4:], qr.F32_FLOOR * mx[:, None].expand(2, 4))
    assert torch.equal(torch.tril(Rt, -1), torch.zeros_like(Rt))
    assert bool(torch.isfinite(Rt).all())


@pytest.mark.parametrize("B,N", [(3, 16), (6, 32)])
def test_udt_qr_solve_matches_pallas(B, N):
    Ap, mx = _graded(B * N + 1, B, N, decades=6.0)
    Z = torch.from_numpy(np.random.default_rng(B).normal(
        size=(B, N, N)).astype(np.float32))
    Qj, Xj = pallas_qr._udt_solve_batched(jnp.asarray(Ap.numpy()),
                                          jnp.asarray(Z.numpy()),
                                          jnp.asarray(mx.numpy()))
    Qt, Xt = qr.udt_qr_solve(Ap, Z, mx)
    _close(Qt, Qj, 1e-5)
    _close(Xt, Xj, 1e-5)
    # X solves X R = Z / mx with R the unnormalized triangular factor
    _, Rs, d = qr.udt_qr_plain(Ap.double(), mx.double())
    R = Rs * (d / mx.double()[:, None])[:, :, None]
    _close(Xt.double() @ R, Z.double() / mx.double()[:, None, None], 1e-5)


@pytest.mark.parametrize("solve", [False, True])
def test_udt_qr_subnormal_reflector_stays_finite(solve):
    """A column whose remaining tail has a subnormal v·v: tau = 0 (the TPU's
    flush-to-zero result) instead of 2 / v·v = inf and a NaN matrix."""
    A = torch.eye(8) * 2.0 ** 40
    A[:, 1] = 3e-21                              # v·v ~ 1e-40 at column 1
    mx = torch.ones(1)
    if solve:
        outs = qr.udt_qr_solve(A[None], torch.ones(1, 8, 8), mx)
    else:
        outs = qr.udt_qr(A[None], mx)
        assert torch.equal(torch.diagonal(outs[1][0]).abs(), torch.ones(8))
    assert all(bool(torch.isfinite(t).all()) for t in outs)


def test_udt_qr_plain_float64_floor():
    """The float64 plain path floors at finfo.tiny, not at 2^-70."""
    A = torch.zeros(1, 8, 8, dtype=torch.float64)
    A[0, :, 0] = 1.0
    Q, Rs, d = qr.udt_qr_plain(A, torch.ones(1, dtype=torch.float64))
    assert d[0, 1].item() == torch.finfo(torch.float64).tiny
    assert torch.equal(torch.diagonal(Rs[0]), torch.tensor(
        [-1.0] + [1.0] * 7, dtype=torch.float64))


def test_udt_kernel_shapes():
    assert [n for n in range(1, 129) if qr.kernel_supports(n)] == \
        [8, 16, 24, 32, 40, 48, 56, 64]


# ---------------------------------------------------------------------------
# wrappers: a tensor off the CPU never runs the plain version
# ---------------------------------------------------------------------------

def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on another device (here `meta`) goes to the kernel checks,
    which raise; nothing falls back to the plain version."""
    m = dict(device="meta")
    G = torch.empty(2, 1, 16, 16, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.site_sweep(G, torch.empty(2, 16, dtype=torch.int8, **m),
                      torch.empty(2, 16, **m), lamb=LAMB,
                      **MODELS["attractive"])
    A = torch.empty(2, 16, 16, **m)
    with pytest.raises(ValueError, match="no kernel for device"):
        qr.udt_qr(A, torch.empty(2, **m))
    with pytest.raises(ValueError, match="no kernel for device"):
        qr.udt_qr_solve(A, A, torch.empty(2, **m))
    assert all(fn.launches == 0 for fn in KERNELS.values())


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_build_command_targets_sm90a_into_ignored_dir(tmp_path):
    out = _build.library_path()
    cmd = _build.nvcc_command("nvcc", out)
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert [p.name for p in _build.sources()] == ["site_sweep.cu", "udt_qr.cu"]
    assert all(str(p) in cmd for p in _build.sources())
    assert out.parent == _build.PACKAGE_DIR / "_build"
    # the build directory is listed in .gitignore
    root = _build.PACKAGE_DIR.parent
    rel = out.parent.relative_to(root)
    res = subprocess.run(["git", "check-ignore", "-q", f"{rel}/x.so"],
                         cwd=root, capture_output=True)
    assert res.returncode == 0, f"{rel}/ is not ignored by git"


def test_build_key_follows_sources(monkeypatch, tmp_path):
    """The library name hashes the sources: an edited kernel is rebuilt."""
    before = _build.library_path()
    src = tmp_path / "site_sweep.cu"
    src.write_text("// edited\n")
    monkeypatch.setattr(_build, "sources", lambda: [src])
    assert _build.library_path() != before


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "CUDA_NVCC", _build.Path("/nonexistent/nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_check_launch_raises_on_error_code():
    _build.check_launch("x", 0)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.check_launch("x", 1)
