from .core import Measurement, MeasurementRegistry, ObservableResult
from .dqmc_measurements import (
    CombinedGreensIterator, Greens, GreensAt, boson_energy_measurement,
    charge_density, charge_density_correlation,
    charge_density_susceptibility, current_current_susceptibility,
    greens_measurement, magnetization, occupation, pairing,
    pairing_correlation, pairing_susceptibility, sign_measurement,
    spin_density, spin_density_correlation, spin_density_susceptibility)
from .custom import custom_measurement, selection_matrices
from . import postprocessing

__all__ = ["Measurement", "MeasurementRegistry", "ObservableResult",
           "CombinedGreensIterator", "Greens", "GreensAt",
           "boson_energy_measurement", "charge_density",
           "charge_density_correlation", "charge_density_susceptibility",
           "current_current_susceptibility", "custom_measurement",
           "greens_measurement", "magnetization", "occupation", "pairing",
           "pairing_correlation", "pairing_susceptibility", "postprocessing",
           "selection_matrices", "sign_measurement", "spin_density",
           "spin_density_correlation", "spin_density_susceptibility"]
