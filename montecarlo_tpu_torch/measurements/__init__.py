from .core import Measurement, MeasurementRegistry, ObservableResult
from .dqmc_measurements import greens_measurement, occupation

__all__ = ["Measurement", "MeasurementRegistry", "ObservableResult",
           "greens_measurement", "occupation"]
