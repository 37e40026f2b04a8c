"""montecarlo_tpu_torch — the PyTorch/CUDA port of montecarlo_tpu.

The same determinant quantum Monte Carlo engine as ``montecarlo_tpu``,
written in PyTorch for one NVIDIA Hopper GPU: simulation state is a dict of
tensors with a leading ``chains`` axis (natively batched, no ``vmap``), the
imaginary-time loop is a Python loop, and the hot kernels of the DQMC sweep
(the Metropolis site sweeps, the Householder QRs and UDTs, the fused UDT +
triangular solve) are hand-written CUDA C++ under ``csrc/``, built with nvcc
at first use. Every kernel has a plain PyTorch version beside it, which is
what runs on the CPU.

This package never imports JAX. The module layout mirrors ``montecarlo_tpu``.
"""

from .dqmc import DQMC, DQMCParameters
from .measurements import (
    CombinedGreensIterator, Greens, GreensAt, boson_energy_measurement,
    charge_density, charge_density_correlation, greens_measurement,
    magnetization, occupation, pairing, pairing_correlation, spin_density,
    spin_density_correlation)
from .models import HubbardModel, HubbardModelAttractive, HubbardModelRepulsive

__version__ = "0.1.0"

__all__ = ["DQMC", "DQMCParameters", "HubbardModel", "HubbardModelAttractive",
           "HubbardModelRepulsive", "CombinedGreensIterator", "Greens",
           "GreensAt", "boson_energy_measurement", "charge_density",
           "charge_density_correlation", "greens_measurement",
           "magnetization", "occupation", "pairing", "pairing_correlation",
           "spin_density", "spin_density_correlation"]
