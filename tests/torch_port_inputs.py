"""Inputs shared by the tests of the PyTorch/CUDA port's kernels, made with
numpy from a seed. Imports neither JAX nor the JAX package, so that the CUDA
tests (test_torch_cuda.py) run where JAX is not installed."""

import math

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.ops.linalg import _prescale_pivot


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, for a test module that imports this
    fixture: the port's plain CPU paths run many small tensor operations,
    which gain nothing from intra-op threads and slow down many times over
    when those threads compete with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAMB = math.acosh(math.exp(0.5 * 4.0 * 0.1))   # Hirsch lambda at U=4, dtau=0.1
MODELS = {"attractive": dict(signs=(1.0,), det_power=2, use_boson=True),
          "repulsive": dict(signs=(1.0, -1.0), det_power=1, use_boson=False)}


def sweep_inputs(seed, C, F, N):
    """(G, sigma, u) for a site sweep: G (C, F, N, N) float32, 0.5*I plus
    noise of size 0.8 / sqrt(N) (rows of norm ~0.8 at every N), sigma (C, N)
    int8 +-1, u (C, N) float32 uniforms."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=(C, F, N, N)) * (0.8 / np.sqrt(N))
         + 0.5 * np.eye(N)).astype(np.float32)
    sigma = rng.choice(np.array([-1, 1], np.int8), size=(C, N))
    u = rng.uniform(size=(C, N)).astype(np.float32)
    return G, sigma, u


def pair_inputs(seed, C, F, N):
    """(G, sigma, u) like sweep_inputs, with each diagonal entry of G moved
    by up to +-0.45 and the uniforms raised to the power 0.02 (pushed toward
    1): a few sites in ten are rejected, so that with 8 chains every accept
    pattern of a site pair (neither, the first, the second, both) occurs."""
    G, sigma, u = sweep_inputs(seed, C, F, N)
    d = np.random.default_rng(seed + 500).uniform(-0.45, 0.45, (C, F, N))
    G = (G + d[..., None] * np.eye(N)).astype(np.float32)
    return G, sigma, (u ** 0.02).astype(np.float32)


def accept_patterns(sigma_in, sigma_out):
    """The set of (first accepted, second accepted) over the site pairs
    (i, i+1), i even, of every chain: numpy arrays or CPU tensors (C, N)."""
    flips = np.asarray(sigma_in) != np.asarray(sigma_out)
    return {(bool(a), bool(b)) for a, b in flips.reshape(-1, 2)}


def cx_sweep_inputs(seed, C, F, N):
    """(G, sigma, u) like sweep_inputs, with G complex64: an imaginary part
    of the size of the off-diagonal noise added."""
    G, sigma, u = sweep_inputs(seed, C, F, N)
    im = np.random.default_rng(seed + 1000).normal(size=G.shape)
    im = im * (0.8 / np.sqrt(N))
    return (G + 1j * im).astype(np.complex64), sigma, u


def flux_theta(N, seed=1, amp=0.6):
    """Random antisymmetric Peierls phases (N, N): flux through the
    plaquettes, which no gauge removes."""
    a = np.random.default_rng(seed).uniform(-amp, amp, (N, N))
    return a - a.T


def graded(seed, B, N, decades=16.0, complex_=False, float64=False):
    """(Ap, mx): float32 (complex64 with complex_, float64 with float64)
    matrices whose columns are scaled over 2*decades e-folds (as
    tests/test_pallas_qr.py::_graded scales them), with the well-conditioned
    core I + 0.3 randn / sqrt(N) (complex randn of the same size), prescaled
    and pivoted as udt_dirty does before its QR. A Gaussian core's condition
    number would turn float32 rounding-order differences into errors far
    above the kernel bounds (chip_smoke.py::graded gives the numbers)."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(B, N, N))
    if complex_:        # the same size in both parts
        noise = (noise + 1j * rng.normal(size=(B, N, N))) / np.sqrt(2)
    A = (np.eye(N) + 0.3 / np.sqrt(N) * noise) * np.exp(
        rng.uniform(-decades, decades, size=(B, 1, N)))
    A = A.astype(np.complex64 if complex_ else
                 np.float64 if float64 else np.float32)
    Ap, mx, _ = _prescale_pivot(torch.from_numpy(A))
    return Ap.contiguous(), mx.reshape(-1).contiguous()
