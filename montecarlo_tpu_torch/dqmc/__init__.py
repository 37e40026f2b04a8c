from .dqmc import DQMC
from .parameters import DQMCParameters

__all__ = ["DQMC", "DQMCParameters"]
