from .core import Measurement, MeasurementRegistry, ObservableResult
from .dqmc_measurements import (
    CombinedGreensIterator, Greens, GreensAt, boson_energy_measurement,
    charge_density, charge_density_correlation, greens_measurement,
    magnetization, occupation, pairing, pairing_correlation, sign_measurement,
    spin_density, spin_density_correlation)

__all__ = ["Measurement", "MeasurementRegistry", "ObservableResult",
           "CombinedGreensIterator", "Greens", "GreensAt",
           "boson_energy_measurement", "charge_density",
           "charge_density_correlation", "greens_measurement",
           "magnetization", "occupation", "pairing", "pairing_correlation",
           "sign_measurement", "spin_density", "spin_density_correlation"]
