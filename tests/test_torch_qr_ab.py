"""The A/B variants of the fused QR's column loop in the PyTorch/CUDA port
(montecarlo_tpu_torch.ops.qr_ab: K15 ``qr_r`` and ``qr_backward``, K16
``qr_kcol``) and the entry points ``montecarlo_tpu_torch.ab``, on the CPU.

Each plain version is held against the Pallas kernel body it replaces,
``benchmarks/q_backward_ab.py::_kernel_noq`` and ``::_kernel_backward`` and
``benchmarks/qr_step_shape_ab.py::_kernel``, run by ``pl.pallas_call(...,
interpret=True)`` with the scripts' BlockSpecs at B = CB = 128. The scripts'
runners pass no ``interpret`` flag and read the module globals B, N and CB
when the kernel is traced, so the tests set those with monkeypatch and call
``pallas_call`` themselves; importing a script sets the JAX compilation
cache directory, which the fixture puts back. The same numpy inputs go to
both sides: the scripts' column grading 2^linspace(18, -20, N) over a
well-conditioned core I + 0.3 randn / sqrt(N) (a Gaussian core's condition
numbers reach 1e4 at N = 48, where float32 Q of two correct
implementations differ by 5e-5).

Tolerances: against the Pallas bodies, within 1e-5 of the largest entry of
R and of Q (float32 sums taken in another order; XLA's CPU fusion reorders
the interpreted kernel's Q by up to 4e-7 across k). Among the plain
versions, bit for bit where they do the same operations: K16's grouping
against ``householder_qr_plain`` at every k, and K15's R against K4's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from montecarlo_tpu_torch import ab, ops
from montecarlo_tpu_torch.ab import q_backward_ab, qr_step_shape_ab
from montecarlo_tpu_torch.ops import qr_ab
from montecarlo_tpu_torch.ops import qr_householder as qh
from torch_port_inputs import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = 128
CONFIG = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_compile_time_secs",
          "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module")
def scripts():
    """The two TPU A/B scripts as modules, with the JAX settings that
    importing them changes put back."""
    saved = {k: getattr(jax.config, k) for k in CONFIG}
    mods = {}
    try:
        for name in ("q_backward_ab", "qr_step_shape_ab"):
            spec = importlib.util.spec_from_file_location(
                f"tpu_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def _inputs(seed, B, N):
    """float32 (B, N, N): the scripts' grading over a well-conditioned
    core."""
    rng = np.random.default_rng(seed)
    core = np.eye(N) + 0.3 / np.sqrt(N) * rng.normal(size=(B, N, N))
    return (core * np.exp2(np.linspace(18.0, -20.0, N))).astype(np.float32)


def _set_shape(monkeypatch, mod, B, N):
    for name, value in (("B", B), ("N", N), ("CB", CB)):
        monkeypatch.setattr(mod, name, value, raising=False)


def _spec(N, rows=None):
    i32 = jnp.int32
    return pl.BlockSpec((N, rows or N, CB),
                        lambda cb, j: (i32(0), i32(0), cb))


def _jax_noq(mod, A):
    """run_noq's pallas_call, interpreted: R of A (B, N, N)."""
    B, N, _ = A.shape
    At = jnp.transpose(jnp.asarray(A), (2, 1, 0))
    out = pl.pallas_call(
        mod._kernel_noq, grid=(B // CB, N), in_specs=[_spec(N)],
        out_specs=_spec(N),
        out_shape=jax.ShapeDtypeStruct((N, N, B), jnp.float32),
        interpret=True)(At)
    return np.transpose(np.asarray(out), (2, 1, 0))


def _jax_backward(mod, A):
    """run_backward's pallas_call, interpreted: (Q, R) of A (B, N, N); the
    kernel stores Q transposed, as run_backward reads it."""
    B, N, _ = A.shape
    At = jnp.transpose(jnp.asarray(A), (2, 1, 0))
    R, Q = pl.pallas_call(
        mod._kernel_backward, grid=(B // CB, 2 * N), in_specs=[_spec(N)],
        out_specs=[_spec(N), _spec(N)],
        out_shape=[jax.ShapeDtypeStruct((N, N, B), jnp.float32)] * 2,
        scratch_shapes=[pltpu.VMEM((N, N, CB), jnp.float32),
                        pltpu.VMEM((N, 8, CB), jnp.float32)],
        interpret=True)(At)
    return (np.transpose(np.asarray(Q), (2, 1, 0)),
            np.transpose(np.asarray(R), (2, 1, 0)))


def _jax_kcol(mod, A, k):
    """make_run(CB, k)'s pallas_call, interpreted: (Q, R) of A (B, N, N);
    Q comes in the lane layout, Q[b] = Q_out[:, :, b]."""
    B, N, _ = A.shape
    At = jnp.transpose(jnp.asarray(A), (2, 1, 0))
    R, Q = pl.pallas_call(
        lambda *refs: mod._kernel(CB, k, *refs), grid=(B // CB, N // k),
        in_specs=[_spec(N)], out_specs=[_spec(N), _spec(N)],
        out_shape=[jax.ShapeDtypeStruct((N, N, B), jnp.float32)] * 2,
        interpret=True)(At)
    return (np.transpose(np.asarray(Q), (2, 0, 1)),
            np.transpose(np.asarray(R), (2, 1, 0)))


def _close(a, b, tol=1e-5):
    """max|a - b| <= tol * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b))
    assert err <= tol * np.max(np.abs(b)), (err, np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# The plain versions against the Pallas bodies (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [16, 32])
def test_qr_r_matches_pallas_noq(scripts, monkeypatch, N):
    """K15-noq: R within 1e-5 max|R| of _kernel_noq's, through the wrapper
    on a CPU tensor."""
    mod = scripts["q_backward_ab"]
    _set_shape(monkeypatch, mod, 128, N)
    A = _inputs(N, 128, N)
    R = qr_ab.qr_r(torch.from_numpy(A))
    _close(R, _jax_noq(mod, A))
    assert torch.equal(torch.tril(R, -1), torch.zeros_like(R))


@pytest.mark.parametrize("N", [16, 32])
def test_qr_backward_matches_pallas_backward(scripts, monkeypatch, N):
    """K15-backward: Q and R within 1e-5 of the largest entry of
    _kernel_backward's; A = QR."""
    mod = scripts["q_backward_ab"]
    _set_shape(monkeypatch, mod, 128, N)
    A = _inputs(N + 1, 128, N)
    Q, R = qr_ab.qr_backward(torch.from_numpy(A))
    Qj, Rj = _jax_backward(mod, A)
    _close(Q, Qj)
    _close(R, Rj)
    _close(Q.double() @ R.double(), A)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("N", [16, 32])
def test_qr_kcol_matches_pallas_kcol(scripts, monkeypatch, N, k):
    """K16 at k columns a step: Q and R within 1e-5 of the largest entry of
    make_run's at the same k."""
    mod = scripts["qr_step_shape_ab"]
    _set_shape(monkeypatch, mod, 128, N)
    A = _inputs(N + 2, 128, N)
    Q, R = qr_ab.qr_kcol(torch.from_numpy(A), k)
    Qj, Rj = _jax_kcol(mod, A, k)
    _close(Q, Qj)
    _close(R, Rj)


# ---------------------------------------------------------------------------
# The plain versions among themselves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [8, 24, 64])
def test_kcol_plain_bit_equal_to_householder_plain(N):
    """Grouping k columns a step changes no arithmetic, so K16's plain
    version is householder_qr_plain at every k (the kernel at KC = 2 and 4
    is held to it bit for bit on the card)."""
    A = torch.from_numpy(_inputs(3 * N, 4, N))
    Q1, R1 = qh.householder_qr_plain(A)
    for k in qr_ab.COLS_PER_STEP:
        Q, R = qr_ab.householder_qr_kcol_plain(A, k)
        assert torch.equal(Q, Q1) and torch.equal(R, R1), k


@pytest.mark.parametrize("N", [8, 40, 64])
def test_noq_and_backward_r_bit_equal_to_k4(N):
    """K15's R (noq and backward) bit-equal to K4's plain R; the backward Q
    orthogonal and within 1e-5 of K4's forward Q."""
    A = torch.from_numpy(_inputs(5 * N, 4, N))
    Q4, R4 = qh.householder_qr_plain(A)
    Qb, Rb = qr_ab.householder_qr_backward_plain(A)
    assert torch.equal(qr_ab.householder_r_plain(A), R4)
    assert torch.equal(Rb, R4)
    _close(Qb, Q4)
    eye = torch.eye(N, dtype=torch.float64)
    assert (Qb.double().mT @ Qb.double() - eye).abs().max().item() < 1e-5


def test_backward_zero_and_subnormal_columns():
    """Zero columns and a subnormal v.v: tau = 0 drops the reflector, Q
    stays finite and orthogonal, R's block of zero columns is zero."""
    A = torch.from_numpy(_inputs(7, 4, 16))
    A[:, :, -4:] = 0.0
    A[:, :, 1] *= 1e-35
    Q, R = qr_ab.qr_backward(A)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert torch.equal(R[:, -4:, -4:], torch.zeros(4, 4, 4))
    eye = torch.eye(16, dtype=torch.float64)
    assert (Q.double().mT @ Q.double() - eye).abs().max().item() < 1e-5


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

WRAPPERS = {"qr_r": qr_ab.qr_r, "qr_backward": qr_ab.qr_backward,
            "qr_kcol": lambda A: qr_ab.qr_kcol(A, 2)}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrappers_run_plain_on_cpu_without_launching(name):
    """A CPU tensor takes the plain version and counts no launch; every
    wrapper is in ops.KERNELS with its count."""
    fn = ops.KERNELS[name]
    n0 = fn.launches
    A = torch.from_numpy(_inputs(11, 2, 16))
    out = WRAPPERS[name](A)
    plain = {"qr_r": qr_ab.householder_r_plain,
             "qr_backward": qr_ab.householder_qr_backward_plain,
             "qr_kcol": lambda A: qr_ab.householder_qr_kcol_plain(A, 2)}
    ref = plain[name](A)
    if name == "qr_r":
        out, ref = (out,), (ref,)
    assert all(map(torch.equal, out, ref))
    assert fn.launches == n0


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 12, 12), torch.float32, "8 | N <= 64"),
    ((2, 72, 72), torch.float32, "8 | N <= 64"),
    ((2, 0, 0), torch.float32, "8 | N <= 64"),
    ((2, 16, 8), torch.float32, "must be"),
    ((16, 16), torch.float32, "must be"),
    ((2, 16, 16), torch.float64, "float32")])
def test_wrappers_refuse_shapes_and_dtypes(name, shape, dtype, match):
    """Shapes outside 8 | N <= 64, non-square or unbatched A, and other
    dtypes raise a ValueError that names the limit, on every device."""
    with pytest.raises(ValueError, match=match):
        WRAPPERS[name](torch.zeros(shape, dtype=dtype))


def test_wrappers_refuse_k_and_device():
    """k outside {1, 2, 4} and a device with no kernel raise ValueError."""
    A = torch.zeros(2, 16, 16)
    for k in (0, 3, 8):
        with pytest.raises(ValueError, match=r"\(1, 2, 4\)"):
            qr_ab.qr_kcol(A, k)
    with pytest.raises(ValueError, match="no kernel for device"):
        qr_ab.qr_r(torch.zeros(2, 16, 16, device="meta"))


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [q_backward_ab, qr_step_shape_ab])
def test_entry_points_refuse_without_cuda(monkeypatch, capsys, mod):
    """main() exits 1 with a message where no CUDA card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_entry_points_checks_on_cpu():
    """The scripts' checks through the wrappers' plain versions at a small
    shape: the backward arm reconstructs A and is orthogonal; K16 is
    bit-equal across k and to K4; every arm runs."""
    A = ab.graded_input(4, 16, device="cpu")
    assert A.shape == (4, 16, 16) and A.dtype == torch.float32
    err = q_backward_ab.check(A)
    assert err["rec"] <= q_backward_ab.TOL_REC
    assert err["orth"] <= q_backward_ab.TOL_ORTH and err["dq"] < 1e-4
    assert all(qr_step_shape_ab.check(A).values())
    for fn in (*q_backward_ab.arms(A).values(),
               *qr_step_shape_ab.arms(A).values()):
        fn()
