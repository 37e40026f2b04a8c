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
measures recorded configurations again. Lattices come from the library,
from a unit cell or from an ALPS file (``ALPSLattice``); user kernels
become measurements with ``custom_measurement``; ``structure_factor`` and
its kin post-process binned results; ``timer`` times named sections.

This package never imports JAX. The module layout and the names exported
here mirror ``montecarlo_tpu``'s.
"""

from .dqmc import DQMC, DQMCParameters
from .io import ConfigRecorder, Discarder, load, resume, save
from .lattices import (ALPSLattice, ArbitraryLattice, Chain, CubicLattice,
                       EachLocalQuadByDistance,
                       EachLocalQuadBySyncedDistance, EachSite,
                       EachSiteAndFlavor, EachSitePair,
                       EachSitePairByDistance, GenericLattice, Honeycomb,
                       Lattice, OnSite, SquareLattice, TriangularLattice,
                       UnitCell, choose_lattice)
from .mc import MC, MCParameters
from .measurements import (
    CombinedGreensIterator, Greens, GreensAt, boson_energy_measurement,
    charge_density, charge_density_correlation,
    charge_density_susceptibility, current_current_susceptibility,
    custom_measurement, greens_measurement, magnetization, occupation,
    pairing, pairing_correlation, pairing_susceptibility,
    selection_matrices, spin_density, spin_density_correlation,
    spin_density_susceptibility)
from .measurements.postprocessing import (apply_symmetry, fourier_transform,
                                          structure_factor,
                                          superfluid_density,
                                          uniform_fourier)
from .models import (HubbardModel, HubbardModelAttractive,
                     HubbardModelRepulsive, IsingModel, IsingTc)
from .utils import (LogBinner, absdiff, compare, disable_benchmarks,
                    effreldiff, enable_benchmarks, print_timer, reldiff,
                    reset_timer, timer)

__version__ = "0.1.0"


# The functions below are defined after the imports above on purpose:
# ``measurements`` rebinds the name of the subpackage, which is imported by
# then, so ``montecarlo_tpu_torch.measurements`` stays this function.
def run(mc, **kwargs):
    """Run a simulation: ``mc.run(**kwargs)``."""
    return mc.run(**kwargs)


def replay(mc, **kwargs):
    """Measure the recorded configurations again: ``mc.replay(**kwargs)``."""
    return mc.replay(**kwargs)


def greens(mc, *args):
    """The current physical Green's function of a DQMC simulation:
    ``mc.greens(*args)`` (equal-time at a slice, or G(k, l))."""
    return mc.greens(*args)


def reset(mc):
    """Empty every measurement's binners: ``mc.reset()``."""
    return mc.reset()


def measurements(mc, stage="ME"):
    """The measurement registry of a stage ("ME" measurement, else
    thermalization)."""
    return (mc.measurements if stage == "ME"
            else mc.thermalization_measurements)


def observables(mc, stage="ME"):
    """All observable results of a stage: ``mc.observables(stage)``."""
    return mc.observables(stage)


def lattice(model_or_mc):
    """The lattice of a model or of a simulation's model."""
    obj = getattr(model_or_mc, "model", model_or_mc)
    return obj.lattice


def model(mc):
    return mc.model


def parameters(mc):
    """The simulation's parameters merged with its model's."""
    out = dict(mc.parameters.as_dict())
    out.update(mc.model.parameters())
    return out


__all__ = [
    # flavors and models
    "DQMC", "DQMCParameters", "MC", "MCParameters", "HubbardModel",
    "HubbardModelAttractive", "HubbardModelRepulsive", "IsingModel",
    "IsingTc",
    # lattices and iterators
    "ALPSLattice", "ArbitraryLattice", "Chain", "CubicLattice",
    "GenericLattice", "Honeycomb", "Lattice", "SquareLattice",
    "TriangularLattice", "UnitCell", "choose_lattice", "EachSite",
    "EachSiteAndFlavor", "OnSite", "EachSitePair", "EachSitePairByDistance",
    "EachLocalQuadByDistance", "EachLocalQuadBySyncedDistance",
    # measurements and post-processing
    "CombinedGreensIterator", "Greens", "GreensAt",
    "boson_energy_measurement", "charge_density",
    "charge_density_correlation", "charge_density_susceptibility",
    "current_current_susceptibility", "custom_measurement",
    "greens_measurement", "magnetization", "occupation", "pairing",
    "pairing_correlation", "pairing_susceptibility", "selection_matrices",
    "spin_density", "spin_density_correlation",
    "spin_density_susceptibility", "apply_symmetry", "fourier_transform",
    "structure_factor", "superfluid_density", "uniform_fourier",
    # io
    "ConfigRecorder", "Discarder", "load", "resume", "save",
    # utils
    "LogBinner", "absdiff", "compare", "disable_benchmarks", "effreldiff",
    "enable_benchmarks", "print_timer", "reldiff", "reset_timer", "timer",
    # module-level functions
    "run", "replay", "greens", "reset", "measurements", "observables",
    "lattice", "model", "parameters"]
