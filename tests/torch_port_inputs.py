"""Inputs shared by the tests of the PyTorch/CUDA port's kernels, made with
numpy from a seed. Imports neither JAX nor the JAX package, so that the CUDA
tests (test_torch_cuda.py) run where JAX is not installed."""

import math

import numpy as np
import torch

from montecarlo_tpu_torch.ops.linalg import _prescale_pivot

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


def graded(seed, B, N, decades=16.0):
    """(Ap, mx): float32 matrices whose columns are scaled over 2*decades
    e-folds (as tests/test_pallas_qr.py::_graded scales them), with the
    well-conditioned core I + 0.3 randn / sqrt(N), prescaled and pivoted as
    udt_dirty does before its QR. A Gaussian core's condition number would
    turn float32 rounding-order differences into errors far above the kernel
    bounds (chip_smoke.py::graded gives the numbers)."""
    rng = np.random.default_rng(seed)
    A = (np.eye(N) + 0.3 / np.sqrt(N) * rng.normal(size=(B, N, N))) * np.exp(
        rng.uniform(-decades, decades, size=(B, 1, N)))
    Ap, mx, _ = _prescale_pivot(torch.from_numpy(A.astype(np.float32)))
    return Ap.contiguous(), mx.reshape(-1).contiguous()
