from .base import Model
from .hubbard import HubbardModel, HubbardModelAttractive, HubbardModelRepulsive
from .ising import IsingModel, IsingTc

__all__ = ["Model", "HubbardModel", "HubbardModelAttractive",
           "HubbardModelRepulsive", "IsingModel", "IsingTc"]
