"""montecarlo_tpu_torch — the PyTorch/CUDA port of montecarlo_tpu.

The same two Monte Carlo flavors as ``montecarlo_tpu``, written in PyTorch
for one NVIDIA Hopper GPU: determinant quantum Monte Carlo of Hubbard models
(``DQMC``) and classical Monte Carlo of the Ising model (``MC``). Simulation
state is tensors with a leading ``chains`` axis (natively batched, no
``vmap``), the sweep loops are Python loops, and the hot kernels (the DQMC
site sweeps, the Householder QRs and UDTs, the fused UDT + triangular solve,
the Ising model's checkerboard Metropolis sweep and Wolff BFS level) are
hand-written CUDA C++ under ``csrc/``, built with nvcc at first use. Every
kernel has a plain PyTorch version beside it, which is what runs on the CPU.
``save`` / ``load`` / ``resume`` checkpoint either flavor; ``replay``
measures recorded configurations again.

This package never imports JAX. The module layout mirrors ``montecarlo_tpu``.
"""

from .dqmc import DQMC, DQMCParameters
from .io import ConfigRecorder, Discarder, load, resume, save
from .lattices import (Chain, CubicLattice, GenericLattice, Honeycomb,
                       SquareLattice, TriangularLattice)
from .mc import MC, MCParameters
from .measurements import (
    CombinedGreensIterator, Greens, GreensAt, boson_energy_measurement,
    charge_density, charge_density_correlation,
    charge_density_susceptibility, current_current_susceptibility,
    greens_measurement, magnetization, occupation, pairing,
    pairing_correlation, pairing_susceptibility, spin_density,
    spin_density_correlation, spin_density_susceptibility)
from .models import (HubbardModel, HubbardModelAttractive,
                     HubbardModelRepulsive, IsingModel, IsingTc)

__version__ = "0.1.0"


def run(mc, **kwargs):
    """Run a simulation: ``mc.run(**kwargs)``."""
    return mc.run(**kwargs)


def greens(mc, *args):
    """The current physical Green's function of a DQMC simulation:
    ``mc.greens(*args)`` (equal-time at a slice, or G(k, l))."""
    return mc.greens(*args)


__all__ = ["DQMC", "DQMCParameters", "MC", "MCParameters", "HubbardModel",
           "HubbardModelAttractive", "HubbardModelRepulsive", "IsingModel",
           "IsingTc", "Chain", "CubicLattice", "GenericLattice", "Honeycomb",
           "SquareLattice", "TriangularLattice", "ConfigRecorder",
           "Discarder", "load", "resume", "run", "save",
           "CombinedGreensIterator", "Greens",
           "GreensAt", "boson_energy_measurement", "charge_density",
           "charge_density_correlation", "charge_density_susceptibility",
           "current_current_susceptibility", "greens", "greens_measurement",
           "magnetization", "occupation", "pairing", "pairing_correlation",
           "pairing_susceptibility", "spin_density",
           "spin_density_correlation", "spin_density_susceptibility"]
